"""Driver shared by the compare tools: several checkouts timed on one card.

A tool supplies a child script that runs inside one checkout (argv[1] the
checkout, argv[2] "build" or "time") and prints, as its last line, one JSON
object {case: {"ms": ..., optional "device_ms", "max_abs_err": ...}}. All checkouts are
built first, in parallel; then each one is timed in its own process, in
turns (forward, then reverse order), so that two versions are compared on
the same card in the same call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Sequence


def main(child: str, tool: str, argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog=tool)
    ap.add_argument("dirs", nargs="+", help="checkouts, each holding acestep_tpu_torch/")
    ap.add_argument("--out", default=None, help="also write the readings as JSON here")
    args = ap.parse_args(argv)
    dirs = [os.path.abspath(d) for d in args.dirs]
    procs = [subprocess.Popen([sys.executable, "-c", child, d, "build"]) for d in dirs]
    if any(p.wait() != 0 for p in procs):
        print(f"{tool}: a build failed", file=sys.stderr)
        return 1
    runs = {d: [] for d in dirs}
    for d in dirs + dirs[::-1]:
        r = subprocess.run([sys.executable, "-c", child, d, "time"], capture_output=True, text=True)
        if r.returncode != 0:
            print(f"{tool}: {d} failed\n{r.stderr[-3000:]}", file=sys.stderr)
            return 1
        runs[d].append(json.loads(r.stdout.strip().splitlines()[-1]))
    names = [os.path.basename(d.rstrip("/")) for d in dirs]

    def cell(d: str, case: str) -> str:
        fw, rv = runs[d][0][case], runs[d][1][case]
        dev = f" [{fw['device_ms']:.4f}/{rv['device_ms']:.4f}]" if fw.get("device_ms") and rv.get("device_ms") else ""
        err = f" ({fw['max_abs_err']:.3g})" if "max_abs_err" in fw else ""
        return f"{fw['ms']:9.4f}/{rv['ms']:9.4f}{dev}{err}".rjust(52)

    print("ms forward/reverse [device ms] (max abs err)".ljust(34) + "".join(n[-20:].rjust(52) for n in names))
    for case in runs[dirs[0]][0]:
        print(case.ljust(34) + "".join(cell(d, case) for d in dirs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({n: runs[d] for n, d in zip(names, dirs)}, f, indent=1)
    return 0
