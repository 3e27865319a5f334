"""Isolate the attention kernel's per-stage cost with stripped variants.

Port of `tools/probe_kernel_parts.py` onto the Hopper kernel
`csrc/attention_probe.cu` (`ops/attention_probe.py`), same flags and the same
printed lines. Variants at (b=1, seq, nq=16, nkv=8, h=128), seq rounded up to
a multiple of 128:
  dots    QK^T then P@V with P = scaled scores (no softmax)
  +max    adds the row max + subtract
  +exp    adds exp
  +expf   adds the polynomial exp2 instead
  full    max + exp + sum + div (the real kernel math)
  fullf   full with the polynomial exp
A mode with a ``T`` suffix (``dotsT``, ...) reads K stored transposed.
``--bq`` is the kernel's query rows per CTA (64 or 128: 4 or 8 warps sharing
each K/V tile). Each timing feeds the output back as q ``--loop`` times
between two CUDA events; the best of 3 repetitions is printed.

Usage: python -m acestep_tpu_torch.tools.probe_kernel_parts [--seq 3840] [--bq 64] [--loop 8]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from acestep_tpu_torch.device import resolve_device
from acestep_tpu_torch.ops.attention_probe import attention_probe


def run_mode(mode: str, q, k, v, bq: int, loop: int, reps: int = 3) -> float:
    """Seconds per launch of one variant (best of `reps`)."""
    kt = mode.endswith("T")
    base = mode[:-1] if kt else mode
    if kt:
        k = k.transpose(2, 3).contiguous()  # (b, nkv, h, lk)

    def looped():
        c = q
        for _ in range(loop):
            c = attention_probe(c, k, v, base, k_transposed=kt, block_q=bq)
        return c

    cuda = q.is_cuda
    looped()
    ts = []
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            looped()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            looped()
            ts.append(time.perf_counter() - t0)
    return min(ts) / loop


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=3840)
    ap.add_argument("--bq", type=int, default=64)
    ap.add_argument("--loop", type=int, default=8)
    ap.add_argument("--modes", default="dots,+max,+exp,+expf,full,fullf")
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the plain version")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    b, nq, nkv, h = 1, 16, 8, 128
    lq = lk = (args.seq + 127) // 128 * 128
    q = torch.ones((b, nq, lq, h), dtype=torch.bfloat16, device=dev) * 0.02
    k = torch.ones((b, nkv, lk, h), dtype=torch.bfloat16, device=dev) * 0.02
    flops = 4 * b * nq * lq * lk * h

    for mode in args.modes.split(","):
        t = run_mode(mode, q, k, k, args.bq, args.loop)
        print(f"{mode}: {t*1e3:.2f}ms ({flops/t/1e12:.0f} TFLOPS)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
