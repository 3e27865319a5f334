"""The one generator of text2music requests, driven by a traffic file.

A request is drawn from (run seed, request index) alone, so the same seed
gives the same requests in the same order, and every request of a mix has
the same shapes: `batch` rows of `duration_s` seconds, a caption from the
frozen list, and lyrics of whole frozen lines whose length in bytes lies in
`lyric_bytes` (one lyric bucket of the byte-level tokenizer).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from harness.spec import BENCH_DIR, load_json

WARMUP_INDEX = -1


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([int(seed) & 0xFFFFFFFFFFFF, index + 1]))


def prompts(traffic: Dict[str, Any]) -> Dict[str, Any]:
    return load_json(os.path.join(BENCH_DIR, "traffic", traffic["prompts"]))


def request(traffic: Dict[str, Any], material: Dict[str, Any], seed: int, index: int) -> Dict[str, Any]:
    """{"index", "captions", "lyrics", "language", "duration_s", "seeds"}."""
    rng = _rng(seed, index)
    lo, hi = traffic["lyric_bytes"]
    lines = []
    while len("\n".join(lines).encode("utf-8")) < lo:
        lines.append(material["lyric_lines"][int(rng.integers(len(material["lyric_lines"])))])
    lyrics = "\n".join(lines)
    if not lo <= len(lyrics.encode("utf-8")) <= hi:
        raise ValueError(f"lyric lines overshoot {traffic['lyric_bytes']}: {len(lyrics)} bytes")
    caption = material["captions"][int(rng.integers(len(material["captions"])))]
    b = int(traffic["batch"])
    return {"index": index, "captions": [caption] * b, "lyrics": [lyrics] * b, "language": traffic["language"],
            "duration_s": float(traffic["duration_s"]), "seeds": [int(s) for s in rng.integers(0, 2**31 - 1, b)]}
