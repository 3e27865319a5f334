"""One run of one cell: set-up, the measured window, the metrics, the check.

Set-up makes the weights from the seed on the device, hands them to the
port, and runs the loop's warm-up (one request of the cell's own shapes), so
every kernel is built and every shape seen before the window. The window is
the loop's (`loops/<kind>.py`), run with the launching thread held on one
core. With tracing, a second window, half as long, follows it under
`torch.profiler`, and the benchmark's spans mark the port's layer entries
there (its length bounds the profiler's and the reduction's time): the profiler
slows a launch-bound request about twofold, so what is read on the host's
clock (the rate, `mfu`, the DiT's share) comes from the first, untraced
window, and what is read from the device (kernels, their time, the busy
time of a request) from the second. After the windows: the peak memory, the
metrics (`metrics/<name>.py`), then the program's state is dropped and the
plain reference checks every row of a sample of the finished requests.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harness import correct, measure, spec, traffic, weights
from harness.port import Spy, make_handler
from harness.trace import WINDOW_SPAN, profiled, reduce

TRACED_SHARE = 0.5  # the traced window's length, a share of the untraced one's


class Run:
    """What a metric reader sees: the cell, the untraced window's records and
    length, set-up time, the traced window's records and trace (None without
    tracing), the spy's counts and the operations of each finished request."""

    def __init__(self, cell: spec.Cell, seed: int):
        self.cell, self.seed = cell, seed
        self.config, self.traffic = cell.config, cell.traffic
        self.records: List[Dict[str, Any]] = []  # the untraced window's
        self.window_s = 0.0
        self.traced_records: List[Dict[str, Any]] = []  # the traced window's (tracing only)
        self.setup_s = 0.0
        self.trace = None
        self.spy: Optional[Spy] = None

    def request_flops(self, req: Dict[str, Any]) -> Dict[str, float]:
        from reference.model import LATENT_BUCKETS, LATENT_FPS, LYRIC_BUCKETS, TEXT_BUCKETS, pick_bucket, \
            prompt_texts, tokenize

        texts = [prompt_texts(c, l, req["language"], req["duration_s"]) for c, l in zip(req["captions"], req["lyrics"])]
        t_ids, t_mask = tokenize([t for t, _ in texts], 256, TEXT_BUCKETS)
        l_ids, l_mask = tokenize([l for _, l in texts], 2048, LYRIC_BUCKETS)
        t_exact = int(req["duration_s"] * LATENT_FPS)
        t_exact = min(t_exact, pick_bucket(t_exact, LATENT_BUCKETS))
        lyric_valid = l_mask.sum(axis=1)
        enc_valid = lyric_valid + 1 + t_mask.sum(axis=1)
        return measure.request_flops(self.config, len(req["seeds"]), t_exact, t_ids.shape[1], l_ids.shape[1],
                                     [int(v) for v in lyric_valid], [int(v) for v in enc_valid])


class Context:
    """The loop's handle on the system: requests from the seed, one call
    through the service entry, and the window's span."""

    def __init__(self, run: Run, handler, spy: Spy):
        self.run, self.handler, self.spy = run, handler, spy
        self.material = traffic.prompts(run.traffic)

    def request(self, index: int) -> Dict[str, Any]:
        return traffic.request(self.run.traffic, self.material, self.run.seed, index)

    def call(self, req: Dict[str, Any]) -> Dict[str, Any]:
        from acestep_tpu_torch.service.inference import generate_music
        from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

        s = self.run.config["sampler"]
        params = GenerationParams(
            task_type="text2music", caption=req["captions"][0], lyrics=req["lyrics"][0],
            vocal_language=req["language"], duration=req["duration_s"], inference_steps=s["inference_steps"],
            guidance_scale=s["guidance_scale"], use_adg=s["use_adg"], cfg_interval_start=s["cfg_interval_start"],
            cfg_interval_end=s["cfg_interval_end"], shift=s["shift"], infer_method=s["infer_method"],
            thinking=s["thinking"], seed=req["seeds"][0])
        config = GenerationConfig(batch_size=len(req["seeds"]), use_random_seed=False, seeds=list(req["seeds"]),
                                  audio_format="wav")
        n = len(self.spy.latents)
        res = generate_music(self.handler, None, params, config, save_audio=False)
        rec = {"request": req, "ok": bool(res.success) and len(res.audios) == len(req["seeds"]),
               "error": (res.error or "")[-2000:], "audio_s": len(req["seeds"]) * req["duration_s"],
               "time_costs": dict(res.extra_outputs.get("time_costs", {}))}
        if rec["ok"]:
            rec["pcm"] = np.stack([a["audio"] for a in res.audios])
        got = self.spy.latents[n:]
        rec["latents"] = got[-1] if got else None
        del self.spy.latents[n:]
        return rec

    def window_span(self):
        return self.spy.span(WINDOW_SPAN)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def one_core():
    """Hold the calling thread (the one that launches every kernel) on one
    core, the last it may use, for the block: it then never migrates, and
    its caches stay warm. Threads started earlier keep their cores. Yields
    the core, or None where affinity cannot be set."""
    if not hasattr(os, "sched_setaffinity"):
        yield None
        return
    allowed = os.sched_getaffinity(0)
    core = max(allowed)
    os.sched_setaffinity(0, {core})
    try:
        yield core
    finally:
        os.sched_setaffinity(0, allowed)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             dtype: torch.dtype = torch.bfloat16, reference_device=None) -> Dict[str, Any]:
    run = Run(cell, seed)
    w = weights.make_weights(cell.config, seed, device, dtype)
    handler = make_handler(cell.config, w, device, dtype)
    spy = Spy(cell.config, False).install()
    run.spy = spy
    ctx = Context(run, handler, spy)
    loop = spec.load_module("loops", cell.traffic["loop"])
    try:
        loop.warmup(ctx)
        _sync(device)
        run.setup_s = time.time() - t_start
        with one_core() as core:
            out = loop.window(ctx, seconds)
        run.records, run.window_s = out["records"], out["window_s"]
        extra: Dict[str, Any] = {"pinned_core": core}
        if trace:
            spy.trace = True
            with profiled(True) as holder:
                traced = loop.window(ctx, seconds * TRACED_SHARE)
            run.traced_records = traced["records"]
            extra.update(traced_window_s=traced["window_s"], traced_requests=len(traced["records"]))
        memory_peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
        if trace:
            run.trace = reduce(holder.prof, spy.spans, holder.marks, holder.end_marks)
            holder.prof = None
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = spec.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    finally:
        spy.restore()
    timed = run.records + run.traced_records
    attempted = len(timed)
    failed = sum(not r["ok"] for r in timed)
    # The program's state goes before the reference runs: the reference
    # reads only the benchmark's weights and the requests.
    del handler, ctx
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    from reference import model as reference

    readings = []
    t_ref = time.time()
    done = [r for r in timed if r["ok"]]
    for i in correct.sample(len(done), int(cell.traffic["compare_requests"]), seed):
        rec = done[i]
        want = reference.generate(w, cell.config, rec["request"], reference_device or device)
        got = {"latents": rec["latents"] if rec["latents"] is not None else np.zeros(0), "pcm": rec["pcm"]}
        readings.append(correct.distances(got, want))
    check = correct.verdict(readings, cell.limits, failed)
    result = {
        "correct": check["correct"], "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": device_info(device, memory_peak, run.trace),
    }
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": [[n, s] for n, s in run.trace.device_ops],
                               "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    result["compared"] = check["compared"]
    notes = dict(window_s=run.window_s, setup_s=run.setup_s, reference_s=time.time() - t_ref,
                 requests=len(run.records), errors=[r["error"][-300:] for r in timed if not r["ok"]][:2],
                 readings=readings, request_walls=[round(r["done_s"] - r["sent_s"], 4) for r in run.records
                                                   if "done_s" in r], **extra)
    if run.trace is not None:
        t = run.trace
        notes.update(trace_parse_s=t.parse_s, trace_kernels=t.kernels, trace_unattributed=t.unattributed,
                     least_lead_us=t.least_lead_us, spans=t.spans, **t.extra)
        if run.records and run.traced_records:
            # The profiler's slowdown: a traced request's wall over an untraced one's.
            notes["trace_slowdown"] = ((extra["traced_window_s"] / len(run.traced_records))
                                       / (run.window_s / len(run.records)))
    return {"result": result, "notes": notes}


def device_info(device, memory_peak: int, trace) -> Dict[str, Any]:
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info
