"""Time the attention kernels (kernels 1 and 4) of several checkouts on one card.

Each DIR holds an `acestep_tpu_torch` package: a `git archive` of a commit
unpacked into a directory that `.gitignore` lists, or the working tree
itself. All checkouts are built first, in parallel; then each one is timed in
its own process, in turns (forward, then reverse order), so that two versions
are compared on the same card in the same call. Per checkout and shape:
kernel 1 at the main path's attention shapes (the DiT at 2 x 60 s and
1 x 600 s: full, sliding w = 128, cross onto a padded 769-key condition; the
text encoder; the 4B planner's prefill buckets) with its max abs error
against the plain version; kernel 1's fp32 route at the training path's
shapes (`chip_smoke.f32_attention_cases`: sliding w = 128, full and cross
onto 512 encoder rows at 1 x 750 and 1 x 768, and the narrow config's three
at 2 x 512 with 2 / 1 heads) with its max abs error against the plain
version in fp32 (TF32 off) and, as the yardstick, SDPA in fp32 on the same
inputs and boolean mask ("sdpa f32 ..."); and kernel 4 in four modes at seq
3840 and 7552 with 64 and 128 query rows per CTA. Times are ms from CUDA
events, mean of 20 (kernel 1 bf16), 50 (fp32 route, SDPA) or 10 (kernel 4)
launches after 3 warm-up launches.

Usage: python -m acestep_tpu_torch.tools.compare_attention DIR [DIR ...] [--out FILE]
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from acestep_tpu_torch.tools import compare

# Runs inside one checkout (argv[1]); argv[2] is "build" or "time".
_CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from acestep_tpu_torch.ops import cuda_lib
if sys.argv[2] == "build":
    cuda_lib.build(["flash_attention", "flash_attention_f32", "attention_probe"])
    sys.exit(0)
import torch.nn.functional as F
from acestep_tpu_torch.ops.attention import make_attention_bias
from acestep_tpu_torch.ops.attention_probe import attention_probe
from acestep_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
rn = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)


def ms(fn, n):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def mask(b, l, valid=()):
    m = torch.ones((b, l), dtype=torch.int32, device=dev)
    for i, n in enumerate(valid):
        m[i, n:] = 0
    return m


out = {}
for name, b, lq, lk, nq, nkv, kw in [
    ("full_1x7500", 1, 7500, 7500, 16, 8, dict(kv_mask=mask(1, 7500))),
    ("sliding_1x7500", 1, 7500, 7500, 16, 8, dict(kv_mask=mask(1, 7500), window=128)),
    ("cross_1x7500", 1, 7500, 769, 16, 8, dict(kv_mask=mask(1, 769, [700]))),
    ("full_2x750", 2, 750, 750, 16, 8, dict(kv_mask=mask(2, 750))),
    ("sliding_2x750", 2, 750, 750, 16, 8, dict(kv_mask=mask(2, 750), window=128)),
    ("cross_2x750", 2, 750, 769, 16, 8, dict(kv_mask=mask(2, 769, [700, 600]))),
    ("text_causal_2x256", 2, 256, 256, 16, 8, dict(causal=True)),
    ("prefill_2x1024", 2, 1024, 1024, 32, 8, dict(kv_mask=mask(2, 1024, [761, 703]), causal=True)),
    ("prefill_2x2048", 2, 2048, 2048, 32, 8, dict(kv_mask=mask(2, 2048, [1130, 778]), causal=True)),
]:
    q, k, v = rn(b, lq, nq, 128), rn(b, lk, nkv, 128), rn(b, lk, nkv, 128)
    run = lambda: flash_attention(q, k, v, kw.get("kv_mask"), window=kw.get("window"),
                                  causal=kw.get("causal", False))
    ref = flash_attention_plain(q.float(), k.float(), v.float(), kw.get("kv_mask"),
                                window=kw.get("window"), causal=kw.get("causal", False))
    err = (run().float() - ref).abs().max().item()
    del ref
    out["flash " + name] = dict(ms=ms(run, 20), max_abs_err=err)
torch.backends.cuda.matmul.allow_tf32 = False  # the plain version and SDPA stay fp32
rn32 = lambda *s: torch.randn(s, generator=gen, device=dev)
for name, b, lq, lk, nq, nkv, kw in [
    ("sliding_1x750", 1, 750, 750, 16, 8, dict(kv_mask=mask(1, 750), window=128)),
    ("full_1x750", 1, 750, 750, 16, 8, dict(kv_mask=mask(1, 750))),
    ("cross_1x750", 1, 750, 512, 16, 8, dict(kv_mask=mask(1, 512, [480]))),
    ("sliding_1x768", 1, 768, 768, 16, 8, dict(kv_mask=mask(1, 768, [750]), window=128)),
    ("full_1x768", 1, 768, 768, 16, 8, dict(kv_mask=mask(1, 768, [750]))),
    ("cross_1x768", 1, 768, 512, 16, 8, dict(kv_mask=mask(1, 512, [480]))),
    ("narrow_sliding_2x512", 2, 512, 512, 2, 1, dict(kv_mask=mask(2, 512, [512, 500]), window=128)),
    ("narrow_full_2x512", 2, 512, 512, 2, 1, dict(kv_mask=mask(2, 512, [512, 500]))),
    ("narrow_cross_2x512", 2, 512, 300, 2, 1, dict(kv_mask=mask(2, 300, [300, 260]))),
]:
    q, k, v = rn32(b, lq, nq, 128), rn32(b, lk, nkv, 128), rn32(b, lk, nkv, 128)
    run = lambda: flash_attention(q, k, v, kw["kv_mask"], window=kw.get("window"))
    ref = flash_attention_plain(q, k, v, kw["kv_mask"], window=kw.get("window"))
    out["flash f32 " + name] = dict(ms=ms(run, 50), max_abs_err=(run() - ref).abs().max().item())
    allowed = make_attention_bias(lq, lk, kv_mask=kw["kv_mask"], window=kw.get("window"), device=dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kt, vt = kt.repeat_interleave(nq // nkv, 1), vt.repeat_interleave(nq // nkv, 1)
    out["sdpa f32 " + name] = dict(ms=ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed), 50))
    del ref, qt, kt, vt
for l in (3840, 7552):
    q, k, v = rn(1, 16, l, 128), rn(1, 8, l, 128), rn(1, 8, l, 128)
    for mode in ("dots", "+max", "+exp", "full"):
        for bq in (64, 128):
            out[f"probe {mode} L{l} bq{bq}"] = dict(
                ms=ms(lambda: attention_probe(q, k, v, mode, block_q=bq), 10))
print(json.dumps(out))
"""


def main(argv: Optional[Sequence[str]] = None) -> int:
    return compare.main(_CHILD, "compare_attention", argv)


if __name__ == "__main__":
    sys.exit(main())
