"""In-memory log ring buffer for UI/API display (a copy of `acestep_tpu/utils/logbuffer.py`).

Role parity with the reference's `LogBuffer`/`StderrLogger`
(`api_server.py:1173-1202`): the last N log records are kept in memory and
served over `/v1/logs` so the studio page (or an operator) can inspect what
the server did without shell access.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List


class LogRingBuffer(logging.Handler):
    def __init__(self, maxlen: int = 2000):
        super().__init__()
        self._buf: deque = deque(maxlen=maxlen)
        self._lock2 = threading.Lock()
        self.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # pragma: no cover
            return
        with self._lock2:
            self._buf.append({"t": time.time(), "line": line})

    def append(self, line: str) -> None:
        """Direct append for non-logging sources (job lifecycle events)."""
        with self._lock2:
            self._buf.append({"t": time.time(), "line": line})

    def tail(self, n: int = 200) -> List[Dict[str, Any]]:
        with self._lock2:
            items = list(self._buf)
        return items[-n:]


_GLOBAL: LogRingBuffer | None = None


def install(maxlen: int = 2000) -> LogRingBuffer:
    """Install (once) on the root logger; returns the shared buffer."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = LogRingBuffer(maxlen)
        logging.getLogger().addHandler(_GLOBAL)
    return _GLOBAL
