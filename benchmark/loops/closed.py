"""A closed loop: one client sends the next request when the last completes.

`warmup` runs one request of the mix's shapes (set-up). `window` sends
requests back to back from index 0 and stops after the request that is
running when `seconds` have passed completes; the window runs from the
first send to that completion.
"""

from __future__ import annotations

import time

from harness.traffic import WARMUP_INDEX


def warmup(ctx) -> None:
    ctx.call(ctx.request(WARMUP_INDEX))


def window(ctx, seconds: float) -> dict:
    done = []
    with ctx.window_span():
        t0 = time.perf_counter()
        while True:
            req = ctx.request(len(done))
            start = time.perf_counter()
            rec = ctx.call(req)
            rec.update(sent_s=start - t0, done_s=time.perf_counter() - t0)
            done.append(rec)
            if rec["done_s"] >= seconds:
                break
    return {"records": done, "window_s": done[-1]["done_s"]}
