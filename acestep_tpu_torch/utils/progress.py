"""Persisted per-step-time progress estimates (a copy of `acestep_tpu/utils/progress.py`).

Role parity with the reference's progress estimator
(`acestep/core/generation/handler/progress.py`): duration-bucketed moving
averages of diffusion per-step seconds, persisted across runs, used to stream
progress fractions to the UI/API while a denoise runs opaquely.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

_BUCKETS = (30, 60, 120, 240, 600)


def _bucket(duration_s: float) -> int:
    for b in _BUCKETS:
        if duration_s <= b:
            return b
    return _BUCKETS[-1]


class ProgressEstimator:
    def __init__(self, path: str = ".cache/acestep_tpu_torch/progress_estimates.json"):
        self.path = path
        self._lock = threading.Lock()
        self._estimates: Dict[str, float] = {}
        try:
            with open(path) as f:
                self._estimates = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass

    def _key(self, duration_s: float, batch: int) -> str:
        return f"d{_bucket(duration_s)}_b{batch}"

    def update(self, duration_s: float, batch: int, per_step_sec: float) -> None:
        key = self._key(duration_s, batch)
        with self._lock:
            prev = self._estimates.get(key)
            self._estimates[key] = (
                per_step_sec if prev is None else 0.7 * prev + 0.3 * per_step_sec
            )
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._estimates, f)
            os.replace(tmp, self.path)

    def estimate_per_step(self, duration_s: float, batch: int) -> Optional[float]:
        with self._lock:
            return self._estimates.get(self._key(duration_s, batch))

    def progress_fraction(
        self, started_at: float, duration_s: float, batch: int, num_steps: int
    ) -> float:
        """Interpolated 0–1 progress based on the persisted per-step estimate."""
        per_step = self.estimate_per_step(duration_s, batch)
        if per_step is None or num_steps <= 0:
            return 0.0
        frac = (time.time() - started_at) / (per_step * num_steps)
        return max(0.0, min(frac, 0.99))
