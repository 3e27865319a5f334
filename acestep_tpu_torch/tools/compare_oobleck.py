"""Time the Oobleck decoder kernels (kernels 2 and 3) of several checkouts on one card.

Each DIR holds an `acestep_tpu_torch` package: a `git archive` of a commit
unpacked into a directory that `.gitignore` lists, or the working tree
itself. All checkouts are built first, in parallel; then each one is timed in
its own process, in turns (forward, then reverse order), so that two versions
are compared on the same card in the same call. Per checkout and shape:

- the Hopper route: the full-width decoder's block 0 residual chain (kernel
  3, 1024 channels) and blocks 1-4 (kernel 2) at the 224-frame decode chunk
  of a 30 s request and the 544-frame chunk of the 240 s and 600 s requests,
  on the same random weights (seed 11, random Snake logs) and inputs, each
  with its max abs error against the plain version in fp32 (and, in the
  --out file, the root mean square of that error). For kernel 3 the --out
  file also holds the error against the plain chain run on the bf16 input,
  which rounds to bf16 at the kernel's points and sums in fp32 in another
  order (the largest difference and the share of elements that differ), and
  the max abs and RMS errors of 8 more inputs (seeds 1000-1007);
- the narrow route (`csrc/oobleck_generic.cu`), in bf16 and fp32, at
  `chip_smoke.run_narrow_phase`'s shapes (the tiny VAE's three 16-channel
  blocks over a 224-frame chunk, a 384 -> 192 block at stride 4 over 544
  frames, the chain at 64 channels over 2240 rows; fp32 weights, seed 12)
  and, in fp32, the full-width decoder at the 544-frame chunk (the chain at
  1024 channels over 5440 rows, blocks 1-4), which a handler built in fp32
  runs there; max abs error against the plain version in fp32 (TF32 off).

Times are ms from CUDA events, the mean of 10 calls after 2 warm-up calls
(3 calls for the full-width fp32 rows), and `device_ms`, the kernels' own
time per call from `torch.profiler` (every device kernel in a window of 5
calls, or 2 at full width, without the host's share).

Usage: python -m acestep_tpu_torch.tools.compare_oobleck DIR [DIR ...] [--out FILE]
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from acestep_tpu_torch.tools import compare

# Runs inside one checkout (argv[1]); argv[2] is "build" or "time".
_CHILD = r"""
import json, sys, time, torch
sys.path.insert(0, sys.argv[1])
from acestep_tpu_torch.ops import cuda_lib
if sys.argv[2] == "build":
    cuda_lib.build([n for n in cuda_lib.SOURCES if n.startswith("oobleck")])
    sys.exit(0)
from torch.profiler import ProfilerActivity, profile
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


def ms(fn, n, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n, tries=3):
    # Every device kernel of n calls in one profiler window (a window that holds
    # fewer kernels than launch calls is taken again), 10 ms pauses at its edges.
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        ev = prof.events()
        ks = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(("Memcpy", "Memset"))]
        calls = sum(e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                    for e in ev)
        if len(ks) == calls:
            by = {}
            for e in ks:
                name = e.name.split("<")[0].split("::")[-1].split("(")[0]
                by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
            return sum(by.values()), by
    return None, None


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
        out[name] = dict(ms=ms(run, 10), device_ms=device_ms(run, 5)[0], max_abs_err=diff.abs().max().item(),
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

# The narrow route: chip_smoke.run_narrow_phase's shapes with fp32 weights.
ng = torch.Generator(device=dev).manual_seed(12)
rnd = lambda *shape, scale=1.0: scale * torch.randn(shape, generator=ng, device=dev)
snake = lambda c: {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)}
units_of = lambda c: [{"snake1": snake(c), "snake2": snake(c),
                       "conv1": {"kernel": rnd(7, c, c, scale=(7 * c) ** -0.5), "bias": rnd(c, scale=0.3)},
                       "conv2": {"kernel": rnd(1, c, c, scale=c**-0.5), "bias": rnd(c, scale=0.3)}} for _ in range(3)]


def block_of(ci, co, s):
    u = units_of(co)
    return {"snake1": snake(ci), "conv_t1": {"kernel": rnd(2 * s, ci, co, scale=(2 * ci) ** -0.5),
                                             "bias": rnd(co, scale=0.3)},
            "res_unit1": u[0], "res_unit2": u[1], "res_unit3": u[2]}


cases = [(f"tiny_block{i}_c224", (1, 224 * (1, 4, 16)[i], 16), block_of(16, 16, s), s)
         for i, s in enumerate((4, 4, 2))]
cases += [("c384to192_s4", (1, 544, 384), block_of(384, 192, 4), 4), ("chain64", (1, 2240, 64), units_of(64), None)]
full = [("full_chain1024_c544", (1, 5440, 1024), [p["block"][0][f"res_unit{i}"] for i in (1, 2, 3)], None)]
l = 5440
for i, s in enumerate(strides[1:], 1):
    bp = p["block"][i]
    full.append((f"full_block{i}_c544", (1, l, bp["conv_t1"]["kernel"].shape[1]), bp, s))
    l *= s
for dtype, rows in ((torch.bfloat16, cases), (torch.float32, cases + full)):
    for name, shape, prm, s in rows:
        x = torch.randn(shape, generator=ng, device=dev).to(dtype)
        run = (lambda: res_units_kernel(x, prm)) if s is None else (lambda: decoder_block_kernel(x, prm, s))
        ref = res_units_plain(x.float(), prm) if s is None else decoder_block_plain(x.float(), prm, s)
        err = (run().float() - ref).abs().max().item()
        big = name.startswith("full")
        d_ms, by_kernel = device_ms(run, 2 if big else 5)
        out[f"narrow {'bf16' if dtype == torch.bfloat16 else 'fp32'} {name}"] = dict(
            ms=ms(run, 3 if big else 10, 1 if big else 2), device_ms=d_ms, kernels=by_kernel,
            max_abs_err=err, ref_max=ref.abs().max().item())
        del x, ref
        torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main(argv: Optional[Sequence[str]] = None) -> int:
    return compare.main(_CHILD, "compare_oobleck", argv)


if __name__ == "__main__":
    sys.exit(main())
