"""Tiny persistent key-value cache with a Redis-like API (a copy of
`acestep_tpu/utils/local_cache.py`).

Replaces the reference's diskcache-backed pseudo-Redis (`acestep/local_cache.py`)
with stdlib sqlite3 (no diskcache dependency).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Optional

_instances: dict = {}
_lock = threading.Lock()


class LocalCache:
    def __init__(self, path: str = ".cache/acestep_tpu_torch/cache.sqlite3"):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT, expires REAL)"
        )
        self._db.commit()
        self._mu = threading.Lock()

    def set(self, key: str, value: Any, ex: Optional[float] = None) -> None:
        expires = time.time() + ex if ex else None
        with self._mu:
            self._db.execute(
                "REPLACE INTO kv (k, v, expires) VALUES (?, ?, ?)",
                (key, json.dumps(value, default=str), expires),
            )
            self._db.commit()

    def get(self, key: str) -> Optional[Any]:
        with self._mu:
            row = self._db.execute("SELECT v, expires FROM kv WHERE k = ?", (key,)).fetchone()
        if row is None:
            return None
        v, expires = row
        if expires is not None and time.time() > expires:
            self.delete(key)
            return None
        return json.loads(v)

    def delete(self, key: str) -> None:
        with self._mu:
            self._db.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._db.commit()

    def exists(self, key: str) -> bool:
        return self.get(key) is not None


def get_cache(path: str = ".cache/acestep_tpu_torch/cache.sqlite3") -> LocalCache:
    """One LocalCache per DB path — a single global would silently bind every
    later caller (e.g. a second server with a different output_dir) to
    whichever DB happened to open first."""
    key = os.path.abspath(path)
    with _lock:
        inst = _instances.get(key)
        if inst is None:
            inst = _instances[key] = LocalCache(path)
        return inst
