"""Readings that set a cell's correctness limits, in one process.

    python benchmark/control.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3] [--precision fp8]

For each seed it makes the cell's weights, runs the first request of the
seed's mix through the port (the same call the window makes, at the cell's
sizes) and compares it with the fp32 reference: the program's readings, of
which the largest is a limit's lower reading. For each control seed it also
runs the reference in the control's precision (fp8 for the bf16
configurations: every product's operands rounded to e4m3) in the program's
place: the control's readings, of which the least is the upper reading.
One JSON line a reading on standard output. The benchmark's runs do not run
this; it runs on the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def readings(cell, seeds, control_seeds, precision, device, dtype, out=sys.stdout):
    import torch

    from harness import correct, weights
    from harness.port import Spy, make_handler
    from harness.runner import Context, Run
    from reference import model as reference

    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.time()
        w = weights.make_weights(cell.config, seed, device, dtype)
        run = Run(cell, seed)
        handler = make_handler(cell.config, w, device, dtype)
        spy = Spy(cell.config, False).install()
        try:
            ctx = Context(run, handler, spy)
            req = ctx.request(0)
            rec = ctx.call(req)
        finally:
            spy.restore()
        del handler, ctx
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        want = reference.generate(w, cell.config, req, device)
        line = {"cell": cell.name, "seed": seed, "program_s": time.time() - t0}
        if seed in seeds:
            line["program"] = (correct.distances({"latents": rec["latents"], "pcm": rec["pcm"]}, want)
                               if rec["ok"] else {"error": rec["error"][-300:]})
        if seed in control_seeds:
            t1 = time.time()
            low = reference.generate(w, cell.config, req, device, precision=precision)
            line["control"] = dict(correct.distances(low, want), precision=precision)
            line["control_s"] = time.time() - t1
        print(json.dumps(line), file=out, flush=True)
        rows.append(line)
        del w, want
        gc.collect()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--precision", default="fp8")
    args = ap.parse_args(argv)
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    parse = lambda s: [int(x) for x in s.split(",") if x]
    readings(cell, parse(args.seeds), parse(args.control_seeds), args.precision, "cuda:0", torch.bfloat16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
