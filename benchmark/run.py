"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is a `workloads` entry of
`BENCHMARK.json`. With `--trace 0` the result's metrics are the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics: those read on
the host's clock from the same untraced window, the rest from a
`torch.profiler` trace of a second, shorter window. The last line of standard output is
the result (JSON); the numbers compared with the reference, each beside its
limit, are the last lines of standard error and the result's last key.

It measures `acestep_tpu_torch` (the PyTorch and CUDA port) on the card and
exits non-zero without a result when there is no CUDA device, too few
devices for the cell, no port beside it, or when JAX, Flax or the JAX
package was loaded. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.time()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ.update(USE_FLAX="0", USE_JAX="0", USE_TF="0")
sys.path[:0] = [BENCH, ROOT]

from harness import guard  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import acestep_tpu_torch
    except ImportError as e:
        print(f"the port is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    if not os.path.abspath(acestep_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"the port was found outside the checkout: {acestep_tpu_torch.__file__}", file=sys.stderr)
        return 2
    bad = guard.reference_imports(os.path.join(BENCH, "reference"))
    if bad:
        print(f"the reference imports the program: {bad}", file=sys.stderr)
        return 3

    from harness import runner

    torch.set_num_threads(4)
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    result = out["result"]
    print(json.dumps({"notes": out["notes"]}, default=str), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
