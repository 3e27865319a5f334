"""Time the Oobleck decoder kernels (kernels 2 and 3) of several checkouts on one card.

Each DIR holds an `acestep_tpu_torch` package: a `git archive` of a commit
unpacked into a directory that `.gitignore` lists, or the working tree
itself. All checkouts are built first, in parallel; then each one is timed in
its own process, in turns (forward, then reverse order), so that two versions
are compared on the same card in the same call. Per checkout and shape: the
full-width decoder's block 0 residual chain (kernel 3, 1024 channels) and
blocks 1-4 (kernel 2) at the 224-frame decode chunk of a 30 s request and the
544-frame chunk of the 240 s and 600 s requests, on the same random weights
(seed 11, random Snake logs) and inputs, each with its max abs error against
the plain version in fp32 (and, in the --out file, the root mean square of
that error). For kernel 3 the --out file also holds the error against the
plain chain run on the bf16 input, which rounds to bf16 at the kernel's
points and sums in fp32 in another order (the largest difference and the
share of elements that differ), and the max abs and RMS errors of 8 more
inputs (seeds 1000-1007). Times are ms from CUDA events, mean of 10 calls
after 2 warm-up calls.

Usage: python -m acestep_tpu_torch.tools.compare_oobleck DIR [DIR ...] [--out FILE]
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
    cuda_lib.build([n for n in cuda_lib.SOURCES if n.startswith("oobleck")])
    sys.exit(0)
from acestep_tpu_torch.config import OobleckConfig
from acestep_tpu_torch.ops.oobleck_kernels import (
    decoder_block_kernel, decoder_block_plain, res_units_kernel, res_units_plain)
from acestep_tpu_torch.params import init_oobleck_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
cfg = OobleckConfig()
p = init_oobleck_params(cfg, seed=11, device=dev)["decoder"]
for blk in p["block"]:
    for part in [blk["snake1"]] + [blk[f"res_unit{i}"][s] for i in (1, 2, 3) for s in ("snake1", "snake2")]:
        for key in ("alpha", "beta"):
            part[key] = 0.3 * torch.randn(part[key].shape, generator=gen, device=dev)


def ms(fn, n):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


out = {}
strides = tuple(reversed(cfg.downsampling_ratios))
for chunk in (224, 544):
    l = chunk
    for i, s in enumerate(strides):
        bp = p["block"][i]
        ci, co = bp["conv_t1"]["kernel"].shape[1:]
        if i == 0:
            units = (bp["res_unit1"], bp["res_unit2"], bp["res_unit3"])
            x = torch.randn((1, l * s, co), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda: res_units_kernel(x, units)
            ref = res_units_plain(x.float(), units)
            name = f"k3 block0 c{chunk}"
        else:
            x = torch.randn((1, l, ci), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda: decoder_block_kernel(x, bp, s)
            ref = decoder_block_plain(x.float(), bp, s)
            name = f"k2 block{i} c{chunk}"
        got = run().float()
        diff = got - ref
        out[name] = dict(ms=ms(run, 10), max_abs_err=diff.abs().max().item(),
                         rms_err=diff.square().mean().sqrt().item(), ref_max=ref.abs().max().item())
        if i == 0:
            m = res_units_plain(x, units).float()
            out[name].update(matched_max_abs_err=(got - m).abs().max().item(),
                             matched_differ_share=(got != m).float().mean().item())
            more = []
            for sd in range(1000, 1008):
                xs = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(sd),
                                 device=dev).to(torch.bfloat16)
                ds = res_units_kernel(xs, units).float() - res_units_plain(xs.float(), units)
                more.append(dict(seed=sd, max_abs_err=ds.abs().max().item(),
                                 rms_err=ds.square().mean().sqrt().item()))
                del xs, ds
            out[name]["seeds"] = more
            del m
        del got
        del x, ref, diff
        torch.cuda.empty_cache()
        l *= s
print(json.dumps(out))
"""


def main(argv: Optional[Sequence[str]] = None) -> int:
    return compare.main(_CHILD, "compare_oobleck", argv)


if __name__ == "__main__":
    sys.exit(main())
