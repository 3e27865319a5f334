"""Shared arithmetic of the metric readers (`metrics/<name>.py`). Each
reader returns None when its run holds nothing for it to read."""

from __future__ import annotations

from typing import Optional

from harness import measure


def audio_s_per_s(run) -> Optional[float]:
    done = [r for r in run.records if r["ok"]]
    if not done or run.window_s <= 0:
        return None
    return sum(r["audio_s"] for r in done) / run.window_s


def mfu(run) -> Optional[float]:
    """The model's operations for the untraced window's finished requests
    over that window (host clock) at the bf16 peak, in %."""
    done = [r for r in run.records if r["ok"]]
    if not done or run.window_s <= 0:
        return None
    flops = sum(run.request_flops(r["request"])["total"] for r in done)
    return 100.0 * flops / (run.window_s * measure.PEAK_BF16_FLOPS)


def dit_share(run) -> Optional[float]:
    """The card's DiT span (`diffusion_time_cost`, between two CUDA events)
    summed over the untraced window's requests, over that window, in %."""
    spans = [r["time_costs"].get("diffusion_time_cost") for r in run.records if r["ok"]]
    spans = [s for s in spans if s is not None]
    if not spans or run.window_s <= 0:
        return None
    return 100.0 * sum(spans) / run.window_s


def kernels_per_dit_forward(run) -> Optional[float]:
    if run.trace is None:
        return None
    s = run.trace.spans.get("dit_forward", {})
    if not s.get("count"):
        return None
    return s["kernels"] / s["count"]


def attn_roofline(run) -> Optional[float]:
    """Kernel 1's bound over the window's flash_attention calls (bf16 peak
    or bandwidth) over the device time of the kernels they launched, in %."""
    if run.trace is None or not run.spy.attn:
        return None
    dev = run.trace.spans.get("flash_attention", {}).get("device_s", 0.0)
    if dev <= 0:
        return None
    flops, nbytes = run.spy.attention_work()
    return 100.0 * measure.bound_ms(flops, nbytes)[0] / 1e3 / dev


def vae_decode_roofline(run) -> Optional[float]:
    """The bound of every decode call (operations at the bf16 peak, or bytes)
    over the device time of the kernels the decode calls launched, in %."""
    if run.trace is None or not run.spy.decode:
        return None
    dev = run.trace.spans.get("vae_decode", {}).get("device_s", 0.0)
    if dev <= 0:
        return None
    bound_s = sum(measure.bound_ms(f, b)[0] for f, b in run.spy.decode) / 1e3
    return 100.0 * bound_s / dev


def device_idle_share(run) -> Optional[float]:
    """The share of the untraced window in which the device runs nothing, in
    %: the device's busy time for a second of audio, from the traced window
    (the union of its device activity over its audio), times the untraced
    window's audio, over the untraced window. The profiler slows the host
    and so stretches the traced window's gaps; the busy time is the
    device's own work, which the profiler leaves as it is."""
    if run.trace is None or run.window_s <= 0:
        return None
    traced_audio = sum(r["audio_s"] for r in run.traced_records if r["ok"])
    audio = sum(r["audio_s"] for r in run.records if r["ok"])
    if traced_audio <= 0 or audio <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / traced_audio * audio / run.window_s)
