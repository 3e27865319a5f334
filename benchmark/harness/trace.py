"""The traced window: `torch.profiler` over the measured window, reduced to
device time by span, the device's busy time and its idle gaps.

The profiler records the device only (kernels, copies, and the CUDA runtime
and driver calls that launched them), not every host op: recording each
host op slowed a launch-bound request nearly threefold. The benchmark's own
spans (`port.Spy`, on `time.time_ns`) mark the program's layer entries. A
kernel belongs to a span when the host call that launched it (the runtime or
driver event with the kernel's correlation id) lies inside the span, so a
span's device time counts the work it launched, whichever kernels do it.

The window is the span "bench_window" that the loop opens around the
measured requests; a pause of WINDOW_GUARD_S before and after it keeps its
first and last kernels inside the trace (a frozen copy of `chip_smoke.py`'s
window).

Marker launches on an idle device before and after the window tie the
device's clock to the host's: there a kernel starts a few microseconds
after its launch call, so a marker's lead (device start minus launch call)
is the clocks' offset at that end. A window whose device timestamps lead
the host's past WINDOW_GUARD_S at either end, or whose markers are not in
the trace, cannot place its kernels and is rejected. Inside the window
single kernel records can still start before their own launch call (by up
to 12 ms on the H100 while both ends agreed to 0.4 ms): they are counted
(`kernels_leading`, the worst named) and kept, attributed by their launch
call as every other kernel is.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW_GUARD_S = 0.01
WINDOW_SPAN = "bench_window"
CLOCK_MARKS = 3


# Host calls of the CUDA runtime and driver, as the profiler names them
# (cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel, cudaMemcpyAsync, ...).
_LAUNCH_PREFIXES = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")


class WindowRejected(RuntimeError):
    pass


@dataclass
class Trace:
    window_s: float
    busy_s: float
    spans: Dict[str, Dict[str, float]]  # name -> count, kernels, device_s
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    kernels: int
    unattributed: int
    least_lead_us: Optional[float]
    parse_s: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)


def _marks(x, out: list) -> None:
    """CLOCK_MARKS marker launches on an idle device, each bracketed on the
    host's clock (`time.time_ns`) and waited for."""
    import torch

    torch.cuda.synchronize()
    for _ in range(CLOCK_MARKS):
        a = time.time_ns()
        x.add_(1)
        out.append((a, time.time_ns()))
        torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(enabled: bool):
    """A `torch.profiler` session of the device (kernels, copies, and the
    CUDA runtime and driver calls that launched them) around the block, or
    nothing; yields a holder whose `.prof` is the finished profiler and whose
    `.marks` and `.end_marks` are the host-clock brackets of the marker
    launches made before and after the block, which tie the trace's clocks
    to the spans' (`time.time_ns`)."""
    holder = type("Holder", (), {"prof": None, "marks": [], "end_marks": []})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():  # no device to trace: the spans alone (tests on the CPU)
        yield holder
        return
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    x = torch.zeros(1, device="cuda")
    _marks(x, holder.marks)
    time.sleep(WINDOW_GUARD_S)
    try:
        yield holder
    finally:
        torch.cuda.synchronize()
        time.sleep(WINDOW_GUARD_S)
        _marks(x, holder.end_marks)
        prof.stop()
        holder.prof = prof


def _union_s(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float) -> float:
    """Seconds covered by the union of [starts, ends) clipped to [lo, hi] (ns in)."""
    if not len(starts):
        return 0.0
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    # A new run starts where a start lies past every earlier end.
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    run_starts = s[idx]
    run_ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return float((run_ends - run_starts).sum()) / 1e9


def _gaps(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float) -> List[Tuple[float, float]]:
    """Idle intervals (ns) of the device inside [lo, hi]."""
    if not len(starts):
        return [(lo, hi)]
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    out = []
    prev = lo
    for a, b in zip(s, run_end):
        if a > prev:
            out.append((prev, min(a, hi)))
        prev = max(prev, b)
        if prev >= hi:
            break
    if prev < hi:
        out.append((prev, hi))
    return [(a, b) for a, b in out if b > a]


def events(prof) -> Tuple[list, Dict[int, int]]:
    """The device rows of a finished profiler, (start ns, end ns,
    correlation id, name, is_kernel) in start order, and each launch call's
    start (ns) by correlation id."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_rows, launch = [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        name = e.name()
        if e.device_type() == cuda:
            dev_rows.append((start, start + e.duration_ns(), e.correlation_id(), name,
                             not name.startswith(("Memcpy", "Memset"))))
        elif name.startswith(_LAUNCH_PREFIXES):
            launch[e.correlation_id()] = start
    dev_rows.sort()
    return dev_rows, launch


def _markers(kernels: list, launch: Dict[int, int], brackets: List[tuple], first: bool) -> List[tuple]:
    """(host-clock offset, device lead) of each marker launch:
    the first kernels after the zeros' fill, or the last ones, paired with
    the host-clock brackets (`time.time_ns`) of their launch calls. On an
    idle device a kernel starts a few microseconds after its launch call, so
    the lead there is the clocks' offset at that time (ns)."""
    n = len(brackets)
    rows = kernels[1:1 + n] if first else kernels[len(kernels) - n:]
    return [(launch[k[2]] - (a + b) / 2, k[0] - launch[k[2]])
            for k, (a, b) in zip(rows, brackets) if k[2] in launch]


def _lead(markers: List[tuple]) -> Optional[float]:
    """The median device lead of some marker launches (ns), or None."""
    return float(np.median([m[1] for m in markers])) if markers else None


def reduce(prof, spans: List[tuple], marks: List[tuple], end_marks: List[tuple] = ()) -> Trace:
    """Reduce a finished profiler (None: no device was traced) and the
    host's spans to the window's numbers."""
    t0 = time.time()
    dev_rows, launch = events(prof) if prof is not None else ([], {})
    if prof is not None and not launch:
        raise WindowRejected("the trace holds no CUDA runtime or driver call to tie kernels to spans")
    return reduce_rows(dev_rows, launch, spans, marks, end_marks, t0)


def reduce_rows(dev_rows: list, launch: Dict[int, int], spans: List[tuple], marks: List[tuple],
                end_marks: List[tuple] = (), t0: Optional[float] = None) -> Trace:
    """`reduce` from the device rows and launch calls (`events`)."""
    t0 = time.time() if t0 is None else t0
    kernels = [r for r in dev_rows if r[4]]
    # The marker launches tie the launch calls' clock to the spans' ...
    first = _markers(kernels, launch, marks, True)
    last = _markers(kernels, launch, end_marks, False)
    offset = float(np.median([m[0] for m in first])) if first else 0.0
    if marks and (not first or (end_marks and not last)
                  or any(abs(m[0] - offset) > WINDOW_GUARD_S * 1e9 for m in first + last)):
        raise WindowRejected("the marker launches that tie the device's clock to the host's are not in the trace")
    # ... and the device's clock to the launch calls'.
    lead_start, lead_end = _lead(first), _lead(last)
    for where, lead in (("start", lead_start), ("end", lead_end)):
        if lead is not None and lead < -WINDOW_GUARD_S * 1e9:
            raise WindowRejected(f"device timestamps lead the host's by {-lead / 1e3:.1f} us at the window's "
                                 f"{where}, past the {WINDOW_GUARD_S * 1e3:.0f} ms guard")
    window = [(a + offset, b + offset) for n, a, b, _t in spans if n == WINDOW_SPAN]
    if not window:
        raise WindowRejected("no window span")
    lo, hi = window[0]
    starts = np.array([r[0] for r in dev_rows], np.float64)
    ends = np.array([r[1] for r in dev_rows], np.float64)
    busy = _union_s(starts, ends, lo, hi)

    by_span = defaultdict(list)
    for n, a, b, _t in spans:
        if n != WINDOW_SPAN:
            by_span[n].append((a + offset, b + offset))
    idx = {}
    for n, iv in by_span.items():
        arr = np.array(sorted(iv), np.float64)
        idx[n] = (arr[:, 0], arr[:, 1])
    per_span = {n: dict(count=float(np.sum((a >= lo) & (a <= hi))), kernels=0.0, device_s=0.0)
                for n, (a, _b) in idx.items()}
    in_window = [r for r in kernels if not (r[1] < lo or r[0] > hi)]
    n_kernels = len(in_window)
    k_start = np.array([r[0] for r in in_window], np.float64)
    k_dur = np.array([r[1] - r[0] for r in in_window], np.float64) / 1e9
    by_name = defaultdict(float)
    for r, d in zip(in_window, k_dur.tolist()):
        by_name[r[3]] += d
    l_start = np.array([launch.get(r[2], np.nan) for r in in_window], np.float64)
    known = ~np.isnan(l_start)
    unattributed = int(n_kernels - known.sum())
    l_known, d_known = l_start[known], k_dur[known]
    for sname, (s_arr, e_arr) in idx.items():
        i = np.searchsorted(s_arr, l_known, side="right") - 1
        hit = (i >= 0) & (l_known <= e_arr[np.maximum(i, 0)])
        per_span[sname]["kernels"] = float(hit.sum())
        per_span[sname]["device_s"] = float(d_known[hit].sum())
    lead = k_start[known] - l_known
    least_lead_us = float(lead.min()) / 1e3 if len(lead) else None
    names_known = [r[3] for r, k in zip(in_window, known.tolist()) if k]
    far = np.flatnonzero(lead < -WINDOW_GUARD_S * 1e9)
    leading = [(names_known[j][:80], round(float(lead[j]) / 1e3, 1)) for j in far[np.argsort(lead[far])]]

    # The longest idle gaps, each named by the innermost span the host was in.
    all_spans = [(a, b, n) for n, iv in by_span.items() for a, b in iv]
    labels = []
    for a, b in sorted(_gaps(starts, ends, lo, hi), key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        inside = [(e - s, n) for s, e, n in all_spans if s <= mid <= e]
        labels.append(("host: " + (min(inside)[1] if inside else "outside the layer spans"), (b - a) / 1e9))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(hi - lo) / 1e9, busy_s=busy, spans=per_span,
                 device_ops=[(n[:120], s) for n, s in top], idle_gaps=labels, kernels=n_kernels,
                 unattributed=unattributed, least_lead_us=least_lead_us, parse_s=time.time() - t0,
                 extra={"clock_offset_us": offset / 1e3, "clock_marks": len(first) + len(last),
                        "device_lead_start_us": lead_start and lead_start / 1e3,
                        "device_lead_end_us": lead_end and lead_end / 1e3,
                        "kernels_leading": len(leading), "worst_leading_us": leading[:3]})
