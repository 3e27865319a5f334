"""The reduction of a trace: the device's busy time and gaps by hand, each
kernel's time to the span that launched it, and the window's clock guard:
a window whose device clock leads the host's at either end (by the marker
launches), or that lacks its markers, is rejected, and single kernels that
start before their launch call are counted and kept."""

import numpy as np
import pytest

from harness import trace

T0 = 10**15  # ns on the host's clock
MS = 10**6


def build(drift_ns=lambda t: 0.0, n=40, dur=80 * MS, end_marks=True):
    """A window of `n` kernels of 1 ms launched `dur / n` apart, each starting
    5 us after its launch call, on a device clock that leads the host's by
    `drift_ns(host time)`;
    three marker launches before the window and three after. Every other
    kernel is launched inside a "dit_forward" span."""
    rows, launch, spans, marks, ends = [], {}, [], [], []
    corr = 0

    def kernel(t_launch, name="k"):
        nonlocal corr
        corr += 1
        launch[corr] = t_launch
        h = t_launch + 5_000
        h_end = h + (MS if name == "k" else 2_000)
        rows.append((int(h + drift_ns(h)), int(h_end + drift_ns(h_end)), corr, name, True))

    kernel(T0 - 20 * MS, "fill")
    for i in range(3):
        t = T0 - 10 * MS + i * MS
        marks.append((t - 1_000, t + 1_000))
        kernel(t, "mark")
    for i in range(n):
        t = T0 + i * (dur // n)
        if i % 2 == 0:
            spans.append(("dit_forward", t - 100, t + 100, 1))
        kernel(t)
    spans.append((trace.WINDOW_SPAN, T0, T0 + dur, 1))
    if end_marks:
        for i in range(3):
            t = T0 + dur + 10 * MS + i * MS
            ends.append((t - 1_000, t + 1_000))
            kernel(t, "mark")
    rows.sort()
    return rows, launch, spans, marks, ends


def test_union_and_gaps_by_hand():
    s = np.array([0, 5, 20, 22], np.float64)
    e = np.array([10, 8, 25, 30], np.float64)
    assert trace._union_s(s, e, 0, 40) == pytest.approx(20e-9)
    assert trace._union_s(s, e, 6, 24) == pytest.approx(8e-9)
    assert trace._gaps(s, e, 0, 40) == [(10, 20), (30, 40)]


def test_a_steady_clock_attributes_every_kernel_to_its_span():
    rows, launch, spans, marks, ends = build()
    t = trace.reduce_rows(rows, launch, spans, marks, ends)
    assert t.kernels == 40 and t.unattributed == 0
    assert t.spans["dit_forward"]["kernels"] == 20
    assert t.spans["dit_forward"]["device_s"] == pytest.approx(0.02)
    assert t.busy_s == pytest.approx(0.04, rel=1e-3)
    assert t.least_lead_us == pytest.approx(5.0) and t.extra["device_lead_end_us"] == pytest.approx(5.0)


@pytest.mark.parametrize("where,drift", [
    ("start", lambda t: -15 * MS),
    ("end", lambda t: -15 * MS * (t - (T0 - 9 * MS)) / (100 * MS)),
])
def test_a_device_clock_ahead_at_an_end_is_rejected(where, drift):
    """The device clock runs 15 ms ahead of the host's from the start, or
    drifts there by the end markers."""
    with pytest.raises(trace.WindowRejected, match=f"window's {where}"):
        trace.reduce_rows(*build(drift))


def test_a_window_without_its_markers_is_rejected():
    rows, launch, spans, marks, ends = build()
    with pytest.raises(trace.WindowRejected, match="marker"):
        trace.reduce_rows([r for r in rows if r[3] != "mark"], launch, spans, marks, ends)


def test_single_kernels_ahead_of_their_launch_are_counted_and_kept():
    """Kernels launched in the middle of the window carry device starts 15 ms
    before their launch calls while both ends agree: each is counted, and
    every kernel still goes to the span that launched it."""
    jump = lambda t: -15 * MS if T0 + 20 * MS < t < T0 + 60 * MS else 0.0
    t = trace.reduce_rows(*build(jump))
    steady = trace.reduce_rows(*build())
    assert t.extra["kernels_leading"] == 20
    assert t.spans["dit_forward"] == steady.spans["dit_forward"]
    assert t.least_lead_us == pytest.approx(-15e3 + 5)
