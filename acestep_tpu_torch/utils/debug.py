"""Env-gated debug lines and timed spans, by domain.

Port of `acestep_tpu/utils/debug.py`. Enable with
ACESTEP_TPU_DEBUG="generation,lm" (a comma list) or "all" / "1"; the lines go
to stderr, and a disabled domain costs one environment read. Work on the card
is asynchronous: a span brackets the launches unless the code inside reads a
result back; `torch.profiler` traces attribute the device's time.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator

DOMAINS = ("generation", "lm", "vae", "training", "service", "io")


def _enabled_domains() -> set:
    raw = os.environ.get("ACESTEP_TPU_DEBUG", "")
    if raw in ("1", "all"):
        return set(DOMAINS)
    return {d.strip() for d in raw.split(",") if d.strip()}


def enabled(domain: str) -> bool:
    return domain in _enabled_domains()


def log(domain: str, msg: str) -> None:
    if enabled(domain):
        print(f"[debug:{domain}] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def span(domain: str, name: str) -> Iterator[None]:
    """A timed span; nothing unless the domain is enabled."""
    if not enabled(domain):
        yield
        return
    t0 = time.time()
    print(f"[debug:{domain}] {name} ...", file=sys.stderr, flush=True)
    try:
        yield
    finally:
        print(f"[debug:{domain}] {name} took {time.time() - t0:.3f}s", file=sys.stderr, flush=True)
