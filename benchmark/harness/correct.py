"""The comparison that decides `correct`.

After the window a sample of the finished requests, drawn from the run's
seed, is worked out again by the plain reference (`reference/model.py`,
fp32, TF32 off) from the same weights and request. Two numbers are compared,
each the worst over the sample's rows:

- `latent_rel_l2`: the relative L2 distance of the DiT's final latents (the
  text encoder, the condition encoders and every DiT step, guidance
  included) from the reference's;
- `pcm_rel_l2`: the relative L2 distance of the int16 PCM (the VAE decode
  and the conversion on top of all that).

Each number has its limit in `limits/<cell>.json`. A request that failed,
or a number that is not finite, is not correct.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def sample(n_done: int, k: int, seed: int) -> List[int]:
    rng = np.random.Generator(np.random.PCG64([int(seed) & 0xFFFFFFFFFFFF, 7]))
    return sorted(int(i) for i in rng.choice(n_done, size=min(k, n_done), replace=False))


def distances(rows_got: Dict[str, np.ndarray], rows_want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Worst row of each compared number of one request."""
    out = {}
    for key, name in (("latents", "latent_rel_l2"), ("pcm", "pcm_rel_l2")):
        got, want = rows_got[key], rows_want[key]
        if got.shape[0] != want.shape[0]:
            out[name] = float("inf")
            continue
        out[name] = max(rel_l2(got[i], want[i]) for i in range(got.shape[0]))
    return out


def verdict(readings: List[Dict[str, float]], limits: Dict[str, float], failed: int) -> Dict[str, Any]:
    """{"correct": bool, "compared": {name: {"value", "limit"}}}: the worst of
    each number over the compared requests, held to its limit."""
    compared = {}
    ok = failed == 0 and bool(readings)
    for name, limit in limits.items():
        vals = [r[name] for r in readings if name in r]
        value = max(vals) if vals else float("inf")
        good = bool(np.isfinite(value)) and value <= limit
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return {"correct": ok, "compared": compared}
