"""Where the time of the Oobleck narrow route's residual unit goes, on one card.

`csrc/oobleck_generic.cu` is built five more times, each with one part left
out or changed (its `NARROW_*` switches): the products and their
shared-memory reads (`no_mma`), the weights' copies into shared memory
(`no_bload`), both (`no_mma_no_bload`), the epilogues (`no_epi`), and a ring
of 2 stages instead of 3 (`st2`). Each build's residual chain runs on the same
random weights and inputs (seed 12) through `res_units_narrow`, and the line
gives the unit kernel's device time per unit (`torch.profiler`, the mean over
the three units of 10 calls, 3 at the large shapes) for each build. The
builds without a part compute wrong results: they only time what is left.

Shapes: the units of the 384 -> 192 block over 2176 rows (68 CTAs, fewer
than the SMs), the full-width decoder's block 3 (128 channels, 522240 rows)
and block 0 chain (1024 channels, 5440 rows) at the 544-frame decode chunk,
and the chain at 64 channels over 2240 rows; fp32 and bf16.

Usage: python -m acestep_tpu_torch.tools.narrow_parts [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Optional, Sequence

import torch

from acestep_tpu_torch.ops import cuda_lib
from acestep_tpu_torch.ops import oobleck_kernels as ok

BUILDS = {
    "base": [],
    "no_mma": ["-DNARROW_NO_MMA"],
    "no_bload": ["-DNARROW_NO_BLOAD"],
    "no_mma_no_bload": ["-DNARROW_NO_MMA", "-DNARROW_NO_BLOAD"],
    "no_epi": ["-DNARROW_NO_EPI"],
    "st2": ["-DNARROW_STAGES=2"],
}
CASES = (("c192_L2176", 192, 2176), ("c128_L522240", 128, 522240), ("c1024_L5440", 1024, 5440),
         ("c64_L2240", 64, 2240))


def build_all() -> dict:
    """Every build of BUILDS, one nvcc each, all at once; {name: loaded library}."""
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = str(cuda_lib.SRC_DIR / "oobleck_generic.cu")
    jobs = {}
    for name, flags in BUILDS.items():
        out = cuda_lib.BUILD_DIR / f"libnarrow_parts_{name}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *flags, "-o", str(out), src]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in ok._GEN_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def unit_ms(fn, calls: int) -> float:
    """Device ms of the unit kernel a unit: its time over `calls` calls of the
    chain, each 3 unit launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "narrow_unit_kernel" in e.name)
    return us / 1e3 / calls / 3


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("narrow_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(0), flush=True)
    libs = build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    rnd = lambda *shape, scale=1.0: scale * torch.randn(shape, generator=gen, device=dev)
    lines = []
    for label, c, l in CASES:
        snake = lambda: {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)}
        units = [{"snake1": snake(), "snake2": snake(),
                  "conv1": {"kernel": rnd(7, c, c, scale=(7 * c) ** -0.5), "bias": rnd(c, scale=0.3)},
                  "conv2": {"kernel": rnd(1, c, c, scale=c**-0.5), "bias": rnd(c, scale=0.3)}} for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(1, l, c).to(dtype)
            ms = {}
            for name, lib in libs.items():
                cuda_lib._libs["oobleck_generic"] = lib
                ms[name] = unit_ms(lambda: ok.res_units_narrow(x, units), 3 if l * c > 4e7 else 10)
            line = dict(case=label, dtype=str(dtype).replace("torch.", ""), unit_ms=ms)
            print(json.dumps(line), flush=True)
            lines.append(line)
            del x
    cuda_lib._libs.pop("oobleck_generic", None)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(l) for l in lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
