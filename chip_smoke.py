#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`acestep_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from `acestep_tpu_torch/csrc` (nvcc, in parallel);
  3. each kernel at main-path shapes (the Oobleck kernels at the 224- and
     544-frame decode chunks) against its plain PyTorch version in fp32 on
     the same bf16 inputs: max error and tolerance, kernel / plain / library
     times from CUDA events, the kernels' device time from `torch.profiler`
     (without the host's share of a call), and the bound
     (bf16 tensor-core peak 989 TFLOP/s, HBM 3.35 TB/s, the H100 SXM
     data-sheet rates). Attention also at the 4B
     planner's prefill (causal + right-padded prompt, 2 x 1024 and 2 x 2048,
     32/8 heads) and at 1 x 7 500 DiT tokens (full, sliding w = 128, cross onto
     769 padded keys), whole and on one rank of dp1 x sp2 x tp2 (8/4 heads,
     3 750 local queries, 4 006 halo'd sliding rows), and the planner's
     prefill on one rank of tp = 2 (16/4 heads); the narrow route of
     kernels 2 and 3 in bf16 and fp32 (the tiny checkpoint's 16-channel blocks, a 384 -> 192 block, the chain
     at 64 channels; in fp32 also the full-width chain and blocks 1-4 at the
     544-frame chunk, with the 3xTF32 bound; `run_narrow_phase`), then a
     full-width 1 x 60 s decode in fp32, the path of a handler built in fp32,
     against the plain versions on the card (`run_fp32_decode`: wall, each
     block's narrow-route calls); the stage probe (kernel 4) in every
     mode and K layout at seq 3840 and 7552;
  4. the whole pipeline at a narrow config on the card (bf16, kernels) against
     the same weights and noise on the CPU (fp32, plain versions), thinking
     off; then with thinking on (`run_small_thinking_reference`); then the
     base model's guided sampling (`run_small_base_reference`: APG at 3.0,
     ADG at batch 2, the CFG interval 0.3-0.8 at 7.0, SDE with injected
     per-step noise; latents' relative L2 within `BASE_REF_TOL`, each case at
     least `BASE_SEPARATION` tolerances from its unguided / ODE result, and
     within `BASE_BF16_TOL` of a CPU run in bf16); then
     `tests/goldens/checkpoint_tiny` loaded from disk on the card in bf16 and
     fp32 against the port's CPU load, text2music and cover, and its planner
     (`run_checkpoint_tiny`);
  5. `AceStepHandler.initialize_service(random_init=True)` at full width, one
     untimed warm-up request, then text2music requests (1 x 30 s, 2 x 60 s,
     1 x 240 s, 1 x 600 s: the longest bucket, 7 500 DiT tokens), and
     `torch.profiler` breakdowns of one 600 s DiT step and of one 544-frame
     VAE decode chunk (the 240 s / 600 s chunk; kernel 3's launches are the
     stream-K instance of the conv kernel, kernel 2's the others); then the
     audio-input requests through the service layer from WAV files (cover
     from the source's codes, repaint, a reference audio, a 120 s cover
     encoded in chunks; `run_audio_requests`) and the profile of one 20 s
     VAE encode chunk; then the base model's guided requests through the
     service after an untimed warm-up (`run_base_requests`: 1 x 60 s and
     1 x 600 s with 50 steps and APG at 7.0, 2 x 60 s with ADG, a turbo
     1 x 60 s with SDE): wall, diffusion and decode times; then the serving
     phase (`run_serving`): the REST server in this process on that handler
     (a merged batch of four 1 x 60 s FLAC jobs, `/v1/generate_stream` of a
     1 x 240 s request against its released FLAC and its time to the first
     byte, six 1 x 30 s jobs pipelined and serial, a chat completion, the
     decode ladder under an injected CUDA out-of-memory, the phase's peak
     allocated memory), then the same four 60 s requests merged by a direct
     call and run solo (held against the server's rows), then `cli serve
     --random-init --warmup 1x10` in a subprocess; then LoRA through the
     server's `/v1/lora/*` (`run_lora`: a seeded rank-32 adapter over every
     target of the 24 layers; 1 x 30 s jobs with it on, at scale 0.5 and
     off, on equal bit for bit to the merged decoder's request, off to the
     base's), and auto LRC with the lyric score (`run_lrc`: 1 x 60 s and
     1 x 240 s requests with 8 and 24 lyric lines; the capture forward's
     and the host alignment's times; the 60 s capture against the CPU in
     fp32 within `LRC_CAPTURE_TOL`); then data parallelism
     (`run_data_parallel`: two ranks from the port's launcher on the one
     card, each with the full-width handler, a 4 x 60 s request at dp = 2
     through the service and the handler, each rank's launches of kernels
     1-3, device and peak memory; rows within `DP_REL_L2_TOL` of the same
     requests at dp = 1 and `DP_SEPARATION` from other seeds; `cli generate
     --dp 2` and `cli serve --dp 2` in subprocesses, no rank left); then
     sequence and tensor parallelism (`run_sequence_tensor_parallel`: four
     ranks at dp1 x sp2 x tp2 on the one card, a 1 x 600 s request through
     the service and the handler, each rank's kernel 1 launches, kernels 2
     and 3 on the decoding rank, the device group's backend, collectives and
     peak memory; rows within `SP_TP_REL_L2_TOL` of dp = 1 and
     `SP_TP_SEPARATION` from another seed; `cli generate --sp 2 --tp 2`, no
     rank left);
  6. requests with thinking on through `service.inference.generate_music` and
     the 4B planner (`LLMHandler(LM_CONFIGS["4B"])`), 1 x 60 s and 2 x 60 s
     after an untimed 1 x 10 s warm-up, and a profile of the planner's
     decode step;
     then the planner's free-form APIs (`run_free_form`: create_sample,
     format_sample, understand on a thinking request's codes, 128 new
     tokens each; a `sample_mode` and an `analysis_only` request through the
     service): seconds, tokens per second, parsed metadata; then the LM
     reward score on a thinking request's codes (`run_scoring`), and the
     narrow planner's `sequence_log_prob` on the card against the CPU; then
     the planner's tensor parallelism (`run_planner_tensor_parallel`: two
     ranks at dp1 x sp1 x tp2 on the one card, each with the full-width DiT
     and the 4B planner split over both; a 1 x 10 s thinking request through
     the service, `create_sample_from_query` and `sequence_log_prob` on the
     split planner; each rank's slice shapes, launches, collectives and peak
     memory; the ranks' token ids equal, the prefill logits within
     `PLANNER_TP_LOGITS_TOL` of the whole planner; `cli generate --tp 2
     --thinking`, no rank left);
  7. the probe's entry point (`acestep_tpu_torch.tools.probe_kernel_parts`);
  8. training: kernel 1's fp32 route against its plain version at the
     training path's shapes (`run_f32_attention_phase`, run with phase 3's
     kernel checks: fp32, TF32 off, within `F32_ROUTE_TOL`; times beside the
     fp32 bound at 67 TFLOP/s, the 3xTF32 bound at 495 / 3 TFLOP/s and its
     share, SDPA in fp32, and the kernel's CTAs an SM); the narrow config's
     LoRA loss and gradients on the card against
     the CPU in fp32 within `TRAIN_GRAD_TOL`, and `FlashAttention`'s backward
     against the plain path's autograd on the card, bf16 and fp32, bit for bit
     (`run_train_grads`); a full-width LoRA run through `LoRATrainer.train`
     (`run_lora_training`: the turbo decoder in bf16, rank 32, fp32 60 s
     samples written with `save_sample`; 6 steps at batch 1, MultiSteps over
     2 x 2 micro-batches at batch 2, one step with a NaN that must keep the
     factors; step time, peak allocated memory, losses, and the fp32 route's
     launches, 48 a forward and none in the backward), then the adapter.npz
     it wrote served on a 1 x 30 s request, equal bit for bit to the same
     request on the decoder with the adapter merged in;
  9. a `{"kernels": [...]}` JSON line, then the `{"ok": true, ...}` line last.
     In it a kernel's `ms`, `plain_ms`, `library_ms` and `bound_ms` are sums
     over its phase-3 shapes (for fp32 rows, kernel 1's fp32 route and the
     Oobleck narrow route in fp32, `bound_ms` sums their 3xTF32 bounds: the
     least time for fp32 products at fp32 accuracy on this card),
     `max_abs_err` their maximum, and `launches` the
     sum over the paths of phases 4 (checkpoint_tiny), 5 (text2music, audio
     inputs, base, serving, the serving phase's direct calls, lora, lrc, the
     two data-parallel ranks, the four sp / tp ranks), 6
     (thinking, free-form, scoring, the two planner tp ranks), 8 (training, the trained adapter
     served; the fp32 route's launches are `flash_attention_f32`'s), 7 and
     phase 3's fp32 decode (the Oobleck kernels' narrow-route calls also in
     `narrow_launches`). Each
     path is driven with every launch counter set to 0 just before it and
     read just after, and fails if one of its kernels was never launched or
     its narrow-route calls differ from the expected count (0 at full
     width).

Imports nothing of JAX. Exits non-zero without a result line when no CUDA
device is present or the port's package is not beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12  # fp32 outside the tensor cores (H100 SXM data sheet)
# TF32 on the tensor cores (H100 SXM data sheet). Kernel 1's fp32 route takes
# three TF32 products for each fp32 product (3xTF32), so its bound at fp32
# accuracy is the operations at PEAK_TF32_FLOPS / 3.
PEAK_TF32_FLOPS = 495e12


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Host-side calls that launch one kernel each, as the profiler names them.
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _window(fn, reps: int) -> tuple:
    """One `torch.profiler` window of `reps` calls of `fn`: its device-kernel
    events (copies and fills left out) and the kernel launches it saw on the
    host. One call of `fn` runs first as the profiler's warm-up step, traced
    and discarded, so that the window's kernels run with tracing under way:
    without it, windows of short kernels lost their first kernels, or all.
    A pause of WINDOW_GUARD_S on each side of the window keeps its first and
    last kernels inside the step's range on the host clock (windows without
    the pauses lost kernels at an edge, up to all of a short window's). The
    pauses add no kernel time. The step's own range on the
    device ("ProfilerStep#") is no kernel. The third value is the least time
    from a kept kernel's launch call to its start on the device, in us,
    matched by correlation id (None when none matches): a negative value
    means the trace put a kernel before its own launch, so the device clock
    stands ahead of the host clock by at least that much."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(WINDOW_GUARD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(WINDOW_GUARD_S)
        prof.step()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "ProfilerStep"))]
    calls = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.name in _LAUNCH_CALLS]
    launched_at = {e.id: e.time_range.start for e in calls}
    leads = [e.time_range.start - launched_at[e.id] for e in kernels if e.id in launched_at]
    return kernels, len(calls), (min(leads) if leads else None)


WINDOW_GUARD_S = 0.01
# Every window `kernel_events` took: (accepted, least launch-to-start lead in
# us); summarised before the kernels line.
WINDOWS: list = []


def kernel_events(fn, reps: int, ours: Optional[dict] = None, tries: int = 3) -> list:
    """The device-kernel events of `reps` calls of `fn` from one
    `torch.profiler` window that passes two checks: no more kernels than
    launch calls the window saw on the host, and for each name part in
    `ours` (the port's own kernels, whose launches per call are known)
    exactly `reps * ours[part]` kernels whose name holds it. The profiler has
    delivered windows in part (one without the kernel of a small attention
    call, one short of a sixth of a decode chunk's kernels): a window that
    fails is reported and taken again, at most `tries` times in all, and the
    phase fails if none passes. The totals cannot be held equal: library
    and torch calls launch some kernels that the profiler never records (one
    a decode chunk)."""
    ours = ours or {}
    for _ in range(tries):
        kernels, launches, lead_us = _window(fn, reps)
        got = {part: sum(part in e.name for e in kernels) for part in ours}
        ok = len(kernels) <= launches and all(got[part] == reps * n for part, n in ours.items())
        WINDOWS.append((ok, lead_us))
        if ok:
            return kernels
        print(json.dumps(dict(phase="profiler window rejected", kernels=len(kernels), launches=launches,
                              ours=got, ours_launched={part: reps * n for part, n in ours.items()},
                              least_launch_to_start_us=lead_us)), flush=True)
    raise SystemExit(f"torch.profiler delivered no whole window in {tries} tries")


def device_ms(fn, iters: int, ours: dict) -> float:
    """Device time per call of the port's kernels named in `ours` (name part
    -> launches per call), from `torch.profiler`: the kernels alone, without
    the host's share of a call."""
    fn()
    torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in kernel_events(fn, iters, ours) if any(n in e.name for n in ours)]
    return sum(us) / 1e3 / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_cases(dev, gen):
    """Main-path attention shapes: DiT at 60 s batch 2 (750 patched tokens,
    16 q / 8 kv heads of 128), cross-attention onto a packed condition of
    lyric 512 + timbre 1 + text 256 with a padded tail, the Qwen3 text
    encoder's causal 256-token bucket, the 4B planner's prefill buckets
    (32 q / 8 kv heads, causal plus a right-padded prompt mask) and the three
    DiT attention layers of a 600 s request (7 500 tokens): full, sliding
    (w = 128) and cross onto the padded 769-key condition; and the same
    three on one rank of dp1 x sp2 x tp2 (8 / 4 heads): 3 750 local queries
    against the 7 500 gathered keys, the sliding layer's 4 006 halo'd rows
    (rank 0's: its first 128 rows lie before the sequence, masked), and the
    cross-attention's local queries; and the 4B planner's prefill buckets on
    one rank of tp = 2 (16 / 4 heads)."""

    def qkv(b, lq, lk, nq=16, nkv=8):
        mk = lambda l, n: torch.randn((b, l, n, 128), generator=gen, device=dev).to(torch.bfloat16)
        return mk(lq, nq), mk(lk, nkv), mk(lk, nkv)

    def prompt_mask(lens, l):
        m = torch.zeros((len(lens), l), dtype=torch.int32, device=dev)
        for i, n in enumerate(lens):
            m[i, :n] = 1
        return m

    enc_mask = torch.ones((2, 769), dtype=torch.int32, device=dev)
    enc_mask[0, 700:] = 0
    enc_mask[1, 600:] = 0
    lat_mask = torch.ones((2, 750), dtype=torch.int32, device=dev)
    lat_600 = torch.ones((1, 7500), dtype=torch.int32, device=dev)
    halo_600 = torch.ones((1, 3750 + 256), dtype=torch.int32, device=dev)
    halo_600[:, :128] = 0
    return [
        ("dit_self_sliding_60s_b2", qkv(2, 750, 750), dict(kv_mask=lat_mask, window=128)),
        ("dit_self_full_60s_b2", qkv(2, 750, 750), dict(kv_mask=lat_mask)),
        ("dit_cross_60s_b2", qkv(2, 750, 769), dict(kv_mask=enc_mask)),
        ("text_encoder_causal_256_b2", qkv(2, 256, 256), dict(causal=True)),
        ("lm4b_prefill_cot_2x1024", qkv(2, 1024, 1024, 32, 8),
         dict(kv_mask=prompt_mask([761, 703], 1024), causal=True)),
        ("lm4b_prefill_codes_2x2048", qkv(2, 2048, 2048, 32, 8),
         dict(kv_mask=prompt_mask([1130, 778], 2048), causal=True)),
        ("lm4b_prefill_cot_2x1024_tp2", qkv(2, 1024, 1024, 16, 4),
         dict(kv_mask=prompt_mask([761, 703], 1024), causal=True)),
        ("lm4b_prefill_codes_2x2048_tp2", qkv(2, 2048, 2048, 16, 4),
         dict(kv_mask=prompt_mask([1130, 778], 2048), causal=True)),
        ("dit_self_full_600s_b1", qkv(1, 7500, 7500), dict(kv_mask=lat_600)),
        ("dit_self_sliding_600s_b1", qkv(1, 7500, 7500), dict(kv_mask=lat_600, window=128)),
        ("dit_cross_600s_b1", qkv(1, 7500, 769), dict(kv_mask=enc_mask[:1])),
        ("dit_self_full_600s_sp2tp2", qkv(1, 3750, 7500, 8, 4), dict(kv_mask=lat_600)),
        ("dit_self_sliding_600s_sp2tp2", qkv(1, 4006, 4006, 8, 4), dict(kv_mask=halo_600, window=128)),
        ("dit_cross_600s_sp2tp2", qkv(1, 3750, 769, 8, 4), dict(kv_mask=enc_mask[:1])),
    ]


def run_attention_phase(dev, gen, results):
    import torch.nn.functional as F

    from acestep_tpu_torch.ops.attention import make_attention_bias
    from acestep_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    for name, (q, k, v), kw in attention_cases(dev, gen):
        out = flash_attention(q, k, v, kw.get("kv_mask"), window=kw.get("window"), causal=kw.get("causal", False))
        torch.cuda.synchronize()
        ref = flash_attention_plain(
            q.float(), k.float(), v.float(), kw.get("kv_mask"),
            window=kw.get("window"), causal=kw.get("causal", False),
        )
        err = (out.float() - ref).abs().max().item()
        tol = 1e-2
        ok = bool(err <= tol) and bool(torch.isfinite(out).all())
        mask = make_attention_bias(
            q.shape[1], k.shape[1], kv_mask=kw.get("kv_mask"), window=kw.get("window"),
            causal=kw.get("causal", False), device=dev,
        )
        pairs = (
            mask.expand(q.shape[0], 1, q.shape[1], k.shape[1]).sum().item()
            if mask is not None else q.shape[0] * q.shape[1] * k.shape[1]
        )
        flops = 4.0 * pairs * q.shape[2] * q.shape[3]
        mbytes = nbytes(q, k, v, out) + (kw["kv_mask"].numel() * 4 if kw.get("kv_mask") is not None else 0)
        b_ms, b_by = bound_ms(flops, mbytes)
        run = lambda: flash_attention(q, k, v, kw.get("kv_mask"), window=kw.get("window"),
                                      causal=kw.get("causal", False))
        k_ms = time_ms(run, 20)
        d_ms = device_ms(run, 10, {"attention_sm90": 1})
        p_ms = time_ms(lambda: flash_attention_plain(q, k, v, kw.get("kv_mask"), window=kw.get("window"),
                                                     causal=kw.get("causal", False)), 3)
        # Yardstick only: SDPA on the same bf16 inputs (the port never calls it).
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = q.shape[2] // k.shape[2]
        kt, vt = kt.repeat_interleave(reps, 1), vt.repeat_interleave(reps, 1)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 20)
        del qt, kt, vt
        line = dict(phase=f"kernel flash_attention {name}", ok=ok, max_abs_err=err, tol=tol,
                    kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                    bound_by=b_by,
                    shapes=dict(q=list(q.shape), k=list(k.shape)))
        print(json.dumps(line), flush=True)
        results.setdefault("flash_attention", []).append(line)
        if not ok:
            raise SystemExit(f"flash_attention {name}: max_abs_err {err} > {tol}")


PROBE_MODES = ("dots", "+max", "+exp", "+expf", "full", "fullf")


def run_probe_phase(dev, gen, results):
    """Kernel 4 in every mode and K layout at the probe's seq 3840 and at 7552
    (7 500 DiT tokens rounded up to 128): 1 batch, 16 q / 8 kv heads of 128.
    The error is relative to max|ref| (the kernel rounds P at another point
    than the plain version, which follows the TPU kernel)."""
    import torch.nn.functional as F

    from acestep_tpu_torch.ops.attention_probe import attention_probe, attention_probe_plain

    for l in (3840, 7552):
        q = torch.randn((1, 16, l, 128), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((1, 8, l, 128), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((1, 8, l, 128), generator=gen, device=dev).to(torch.bfloat16)
        k_t = k.transpose(2, 3).contiguous()
        b_ms, b_by = bound_ms(4.0 * 16 * l * l * 128, nbytes(q, k, v, q))
        for mode in PROBE_MODES:
            for kt in (False, True):
                kk = k_t if kt else k
                out = attention_probe(q, kk, v, mode, k_transposed=kt)
                torch.cuda.synchronize()
                ref = attention_probe_plain(q, kk, v, mode, k_transposed=kt).float()
                err = (out.float() - ref).abs().max().item()
                tol = 2e-2 * ref.abs().max().item()
                ok = bool(err <= tol) and bool(torch.isfinite(out).all())
                del ref
                k_ms = time_ms(lambda: attention_probe(q, kk, v, mode, k_transposed=kt), 10)
                p_ms = time_ms(lambda: attention_probe_plain(q, kk, v, mode, k_transposed=kt), 2)
                l_ms = None
                if mode == "full":  # unmasked SDPA computes the same function (yardstick only)
                    l_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True), 10)
                name = f"{mode}{'T' if kt else ''}_L{l}"
                line = dict(phase=f"kernel attention_probe {name}", ok=ok, max_abs_err=err, tol=tol,
                            kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                            shapes=dict(q=list(q.shape), k=list(kk.shape)))
                print(json.dumps(line), flush=True)
                results.setdefault("attention_probe", []).append(line)
                if not ok:
                    raise SystemExit(f"attention_probe {name}: max_abs_err {err} > {tol}")
        del q, k, v, k_t
        torch.cuda.empty_cache()


def _perturb_snakes(tree, gen):
    """Random Snake logs (the init's zeros would make every channel alike)."""
    if isinstance(tree, dict):
        if set(tree) == {"alpha", "beta"}:
            for key in ("alpha", "beta"):
                tree[key] = 0.3 * torch.randn(tree[key].shape, generator=gen, device=tree[key].device)
            return
        for v in tree.values():
            _perturb_snakes(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            _perturb_snakes(v, gen)


def run_vae_phase(dev, gen, results):
    from acestep_tpu_torch.config import OobleckConfig
    from acestep_tpu_torch.ops.oobleck_kernels import (
        decoder_block_kernel,
        decoder_block_plain,
        res_units_kernel,
        res_units_plain,
    )
    from acestep_tpu_torch.params import init_oobleck_params

    cfg = OobleckConfig()
    p = init_oobleck_params(cfg, seed=11, device=dev)["decoder"]
    _perturb_snakes(p, gen)
    strides = tuple(reversed(cfg.downsampling_ratios))
    cases = []
    # Decode chunks: 1 x 30 s (core 192 + 2 x 16 overlap) and the 240 s / 600 s
    # requests (core 512 + 2 x 16), where a 600 s request runs 30 of them.
    for chunk in (224, 544):
        l_in = chunk
        for i, s in enumerate(strides):
            bp = p["block"][i]
            ci, co = bp["conv_t1"]["kernel"].shape[1:]
            if i == 0:
                units = (bp["res_unit1"], bp["res_unit2"], bp["res_unit3"])
                cases.append(("res_units", f"block0_c{chunk}", (1, l_in * s, co), units, None))
            else:
                cases.append(("decoder_block", f"block{i}_c{chunk}", (1, l_in, ci), bp, s))
            l_in *= s

    for kname, label, shape, prm, stride in cases:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        if kname == "res_units":
            run = lambda: res_units_kernel(x, prm)
            plain = lambda xx: res_units_plain(xx, prm)
            c = shape[2]
            l_out = shape[1]
            flops = 48.0 * l_out * c * c
            w_bytes = 3 * 8 * c * c * 2
        else:
            run = lambda: decoder_block_kernel(x, prm, stride)
            plain = lambda xx: decoder_block_plain(xx, prm, stride)
            ci, co = prm["conv_t1"]["kernel"].shape[1:]
            l_out = shape[1] * stride
            flops = 4.0 * l_out * ci * co + 48.0 * l_out * co * co
            w_bytes = (2 * stride * ci * co + 3 * 8 * co * co) * 2
        out = run()
        torch.cuda.synchronize()
        ref = plain(x.float())
        err = (out.float() - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        tol = 3e-2 * scale
        ok = bool(err <= tol) and bool(torch.isfinite(out).all())
        b_ms, b_by = bound_ms(flops, nbytes(x, out) + w_bytes)
        k_ms = time_ms(run, 10)
        # Per call: a Snake launch, then 6 conv launches (the chain), 7 (a
        # block at 512 channels) or 4 (fused units at <= 256).
        convs = 6 if kname == "res_units" else (7 if prm["conv_t1"]["kernel"].shape[2] == 512 else 4)
        d_ms = device_ms(run, 10, {"oobleck_conv_sm90": convs, "snake_kernel": 1})
        p_ms = time_ms(lambda: plain(x), 2)
        line = dict(phase=f"kernel {kname} {label}", ok=ok, max_abs_err=err, tol=tol,
                    kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                    bound_by=b_by, shapes=dict(x=list(shape), out=list(out.shape)))
        print(json.dumps(line), flush=True)
        results.setdefault(kname, []).append(line)
        del x, out, ref
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f"{kname} {label}: max_abs_err {err} > {tol}")


NARROW_TOL = {torch.bfloat16: 3e-2, torch.float32: 5e-5}  # of max(1, max|ref|)


def _narrow_units(c: int, gen) -> list:
    """Three residual units at c channels, fp32 weights as a checkpoint's VAE
    holds them, random biases and Snakes."""
    rnd = lambda *shape, scale=1.0: scale * torch.randn(shape, generator=gen, device=gen.device)
    snake = lambda: {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)}
    return [{"snake1": snake(), "snake2": snake(),
             "conv1": {"kernel": rnd(7, c, c, scale=(7 * c) ** -0.5), "bias": rnd(c, scale=0.3)},
             "conv2": {"kernel": rnd(1, c, c, scale=c**-0.5), "bias": rnd(c, scale=0.3)}} for _ in range(3)]


def _full_width_fp32_cases(dev, gen) -> list:
    """The full-width decoder's narrow-route shapes at the 544-frame decode
    chunk in fp32 (what a handler built in fp32 runs): block 0's chain at
    1024 channels over 5440 rows and blocks 1-4, random weights (seed 11,
    random Snake logs)."""
    from acestep_tpu_torch.config import OobleckConfig
    from acestep_tpu_torch.params import init_oobleck_params

    cfg = OobleckConfig()
    p = init_oobleck_params(cfg, seed=11, device=dev)["decoder"]
    _perturb_snakes(p, gen)
    strides = tuple(reversed(cfg.downsampling_ratios))
    b0 = p["block"][0]
    cases = [("res_units", "full_chain1024_c544", (1, 544 * strides[0], 1024),
              [b0["res_unit1"], b0["res_unit2"], b0["res_unit3"]], None)]
    l_in = 544 * strides[0]
    for i, s in enumerate(strides[1:], 1):
        bp = p["block"][i]
        cases.append(("decoder_block", f"full_block{i}_c544", (1, l_in, bp["conv_t1"]["kernel"].shape[1]), bp, s))
        l_in *= s
    return cases


def run_narrow_phase(dev, gen, results):
    """The narrow route of kernels 2 and 3 (`csrc/oobleck_generic.cu`)
    against `decoder_block_plain` / `res_units_plain` in fp32 on the same
    inputs, in bf16 and fp32: the tiny checkpoint's three 16-channel blocks
    (strides 4 / 4 / 2 over its 224-frame decode chunk), a block 384 -> 192
    channels (between 128 and 512, outside SM90_CHANNELS) and the chain at 64
    channels (outside CHAIN_CHANNELS); in fp32 also the full-width decoder at
    the 544-frame chunk (`_full_width_fp32_cases`). Tolerance of max(1,
    max|ref|): bf16 3e-2 (the Hopper rows' bound: bf16 rounding of every
    intermediate), fp32 5e-5 (summation order and 3xTF32's dropped lo.lo
    term). Bounds: bytes (activations in their type, fp32 weights) or
    operations at the bf16 tensor-core peak for bf16 inputs and the 67
    TFLOP/s fp32 peak for fp32 inputs (`bound_ms`); for fp32 also at the
    3xTF32 rate, 495 / 3 TFLOP/s (`bound_3xtf32_ms`), the least time for
    fp32 products at fp32 accuracy on the tensor cores, which the kernels
    line sums for fp32 rows. A block is 5
    launches (Snake, upsample, a fused launch a unit), the chain 4."""
    from acestep_tpu_torch.ops.oobleck_kernels import (
        decoder_block_kernel,
        decoder_block_plain,
        res_units_kernel,
        res_units_plain,
    )

    def block(ci, co, stride):
        units = _narrow_units(co, gen)
        return {"snake1": {"alpha": 0.3 * torch.randn(ci, generator=gen, device=dev),
                           "beta": 0.3 * torch.randn(ci, generator=gen, device=dev)},
                "conv_t1": {"kernel": torch.randn((2 * stride, ci, co), generator=gen, device=dev) * (2 * ci) ** -0.5,
                            "bias": 0.3 * torch.randn(co, generator=gen, device=dev)},
                "res_unit1": units[0], "res_unit2": units[1], "res_unit3": units[2]}

    cases = []
    l_in = 224
    for i, s in enumerate((4, 4, 2)):
        cases.append(("decoder_block", f"tiny_block{i}_c224", (1, l_in, 16), block(16, 16, s), s))
        l_in *= s
    cases.append(("decoder_block", "c384to192_s4", (1, 544, 384), block(384, 192, 4), 4))
    cases.append(("res_units", "chain64", (1, 2240, 64), _narrow_units(64, gen), None))
    full = _full_width_fp32_cases(dev, gen)
    for dtype, rows in ((torch.bfloat16, cases), (torch.float32, cases + full)):
        for kname, label, shape, prm, stride in rows:
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            wrapper = decoder_block_kernel if kname == "decoder_block" else res_units_kernel
            if kname == "res_units":
                run = lambda: res_units_kernel(x, prm)
                plain = lambda xx: res_units_plain(xx, prm)
                c, l_out = shape[2], shape[1]
                flops, w_elems = 48.0 * l_out * c * c, 3 * 8 * c * c
                ours = {"gen_snake_kernel": 1, "narrow_unit_kernel": 3}
            else:
                run = lambda: decoder_block_kernel(x, prm, stride)
                plain = lambda xx: decoder_block_plain(xx, prm, stride)
                ci, co = prm["conv_t1"]["kernel"].shape[1:]
                l_out = shape[1] * stride
                flops = 4.0 * l_out * ci * co + 48.0 * l_out * co * co
                w_elems = 2 * stride * ci * co + 3 * 8 * co * co
                ours = {"gen_snake_kernel": 1, "narrow_upsample_kernel": 1, "narrow_unit_kernel": 3}
            big = label.startswith("full")
            before = wrapper.narrow_launches
            out = run()
            torch.cuda.synchronize()
            if wrapper.narrow_launches != before + 1:
                raise SystemExit(f"{kname} {label} {dtype}: did not take the narrow route")
            ref = plain(x.float())
            err = (out.float() - ref).abs().max().item()
            tol = NARROW_TOL[dtype] * max(1.0, ref.abs().max().item())
            ok = bool(err <= tol) and bool(torch.isfinite(out).all()) and out.dtype == dtype
            moved = nbytes(x, out) + 4 * w_elems
            b_ms, b_by = bound_ms(flops, moved, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
            del ref, out
            k_ms = time_ms(run, 3 if big else 10)
            d_ms = device_ms(run, 2 if big else 10, ours)
            p_ms = time_ms(lambda: plain(x), 1 if big else 2)
            name = f"narrow_{'bf16' if dtype == torch.bfloat16 else 'fp32'}_{label}"
            line = dict(phase=f"kernel {kname} {name}", ok=ok, max_abs_err=err, tol=tol, kernel_ms=k_ms,
                        device_ms=d_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                        shapes=dict(x=list(shape), out=[shape[0], l_out, shape[2] if kname == "res_units" else co]),
                        dtype=str(dtype))
            if dtype == torch.float32:
                b3_ms, b3_by = bound_ms(flops, moved, PEAK_TF32_FLOPS / 3)
                line.update(bound_3xtf32_ms=b3_ms, bound_3xtf32_by=b3_by, share_of_3xtf32_bound=b3_ms / d_ms)
            print(json.dumps(line), flush=True)
            results.setdefault(kname, []).append(line)
            del x
            torch.cuda.empty_cache()
            if not ok:
                raise SystemExit(f"{kname} {name}: max_abs_err {err} > {tol}")
    torch.cuda.empty_cache()


def run_fp32_decode(dev, gen, smi: str):
    """The decode of a handler built in fp32 (`AceStepHandler(dtype=
    torch.float32)` decodes in its own dtype): `models/vae.tiled_decode` of
    one 1 x 60 s latent (1 500 frames) at the published `OobleckConfig`
    widths, random weights (seed 13, random Snake logs), fp32 activations, in
    544-frame chunks (core 512, the 240 s and 600 s requests' chunk): 3
    chunks, each block 0's chain at 1024 channels and blocks 1-4 on the
    narrow route (5 narrow calls a chunk). One untimed decode first (the
    route packs each weight once), then the timed one with every launch
    counter at 0. Checked against the same decode with the plain versions in
    fp32 on the card (TF32 off) within NARROW_TOL[fp32] of max(1,
    max|ref|)."""
    from acestep_tpu_torch.config import OobleckConfig
    from acestep_tpu_torch.models import vae
    from acestep_tpu_torch.ops import oobleck_kernels as ok
    from acestep_tpu_torch.params import init_oobleck_params

    cfg = OobleckConfig()
    p = init_oobleck_params(cfg, seed=13, device=dev)
    _perturb_snakes(p, gen)
    frames, chunk = 1500, 544
    z = torch.randn((1, frames, cfg.decoder_input_channels), generator=gen, device=dev)
    decode = lambda: vae.tiled_decode(p, cfg, z, chunk_frames=chunk, overlap_frames=16)
    # Each block's narrow-route calls, counted around the wrappers the decode calls.
    index = {id(bp): i for i, bp in enumerate(p["decoder"]["block"])}
    per_block: dict = {}
    saved = vae.decoder_block_kernel, vae.res_units_kernel

    def counted(wrapper, key):
        def call(x, prm, *stride):
            before = wrapper.narrow_launches
            y = wrapper(x, prm, *stride)
            name = key(prm)
            per_block[name] = per_block.get(name, 0) + wrapper.narrow_launches - before
            return y

        return call

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.time()
        decode()
        torch.cuda.synchronize()
        first_s = time.time() - t0
        vae.decoder_block_kernel = counted(saved[0], lambda bp: f"block{index[id(bp)]}")
        vae.res_units_kernel = counted(saved[1], lambda units: "block0 chain")
        _reset_counters()
        try:
            t0 = time.time()
            wav = decode()
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            vae.decoder_block_kernel, vae.res_units_kernel = saved
        chunks = -(-frames // (chunk - 32))
        launches = _path_launches("fp32 decode path", ("decoder_block", "res_units"),
                                  {"decoder_block": 4 * chunks, "res_units": chunks})
        vae.decoder_block_kernel, vae.res_units_kernel = ok.decoder_block_plain, ok.res_units_plain
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            ref = decode()
            torch.cuda.synchronize()
            plain_s = time.time() - t0
        finally:
            vae.decoder_block_kernel, vae.res_units_kernel = saved
    err = (wav - ref).abs().max().item()
    tol = NARROW_TOL[torch.float32] * max(1.0, ref.abs().max().item())
    good = (bool(err <= tol) and wav.dtype == torch.float32 and bool(torch.isfinite(wav).all())
            and tuple(wav.shape) == (1, frames * cfg.hop_length, cfg.audio_channels))
    print(json.dumps(dict(phase="fp32 decode 1x60s full width (narrow route) vs plain fp32 on the card", ok=good,
                          card=smi, wall_s=wall, first_call_s=first_s, plain_s=plain_s, chunks=chunks,
                          chunk_frames=chunk, narrow_launches_by_block=dict(sorted(per_block.items())),
                          max_abs_err=err, tol=tol, shape=list(wav.shape))), flush=True)
    if not good:
        raise SystemExit(f"fp32 decode: max_abs_err {err} > {tol} or a malformed output {tuple(wav.shape)}")
    del p, z, wav, ref
    torch.cuda.empty_cache()
    return launches


LYRICS = "\n".join(
    ["[Verse]", "Neon rivers run beneath the city lights tonight",
     "Every signal fading into static on the line",
     "[Chorus]", "Hold the echo, hold the echo, let it ring",
     "We are louder than the silence that we bring"] * 3
)
CAPTION = "a driving synthwave track with warm analog pads"


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


def _leaves(tree):
    """The tensors of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _small_cfgs():
    from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config

    return (
        AceStepConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=128, text_hidden_dim=256,
                      num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=2,
                      num_attention_pooler_hidden_layers=1, fsq_dim=256),
        OobleckConfig(downsampling_ratios=(2, 4, 4), channel_multiples=(1, 8, 8), decoder_channels=128),
        Qwen3Config(vocab_size=300, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=2, num_key_value_heads=1, head_dim=128),
    )



def run_small_reference(dev):
    """The whole pipeline on the card (bf16, kernels) against the same weights
    and noise on the CPU (fp32, plain versions), at a narrow config whose
    shapes every kernel takes: head_dim 128, 30 s (375 DiT tokens), VAE
    channels 1024 -> 128 with hop 32."""
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    gpu = AceStepHandler(*_small_cfgs(), device=dev)
    gpu.initialize_service(random_init=True, seed=5)
    cpu = AceStepHandler(*_small_cfgs(), dtype=torch.float32, device="cpu")
    cpu.initialize_service(random_init=True, seed=5)
    for name in ("params", "vae_params", "text_params"):
        setattr(cpu, name, _tree_to(getattr(gpu, name), "cpu", torch.float32))
    kw = dict(captions=CAPTION, lyrics=LYRICS, batch_size=2, audio_duration=30.0, seeds=[1, 2],
              use_random_seed=False, normalize_db=-1.0)
    got, want = gpu.generate_music(**kw), cpu.generate_music(**kw)
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))
    lat_err, wav_err = rel(got["latents"], want["latents"]), rel(got["audios"], want["audios"])
    # bf16 weights and activations on the card against fp32 on the CPU.
    tol = 5e-2
    ok = lat_err <= tol and wav_err <= tol and got["audios"].shape == want["audios"].shape
    print(json.dumps(dict(phase="small end-to-end vs CPU fp32", ok=ok, latents_rel_l2=lat_err,
                          audio_rel_l2=wav_err, tol=tol, shape=list(got["audios"].shape))), flush=True)
    if not ok:
        raise SystemExit(f"small end-to-end reference: latents {lat_err}, audio {wav_err} > {tol}")


class _StepNoise:
    """Per-step SDE noise made from a seed on the host, the same for the card
    and the CPU: step i's (B, T, 64) fp32 normal draw."""

    def __init__(self, shape, seed: int):
        self.shape, self.seed = tuple(shape), seed

    def __getitem__(self, i: int) -> torch.Tensor:
        return torch.from_numpy(np.random.default_rng(self.seed + i).standard_normal(self.shape, dtype=np.float32))


# Latents' relative L2 of the guided base path, card (bf16, kernels) against
# the CPU (fp32, plain versions): 4.6e-3 (SDE) to 7.2e-3 (the interval at
# guidance 7.0) on an H100 80GB HBM3 at 700 W, and the same requests in bf16 on
# the CPU read within 2e-5 of those. One tolerance, twice the largest. Each
# case's fp32 result must lie at least BASE_SEPARATION tolerances from the same
# request unguided (SDE: the ODE; 4.7e-2 to 1.9 there), so a card that skipped
# guidance or the SDE step fails. The card against the CPU in bf16 (the second
# reference, the same rounding points, plain versions for the kernels) read
# 2.4e-3 to 4.2e-3: BASE_BF16_TOL is twice the largest.
BASE_REF_TOL = 1.4e-2
BASE_SEPARATION = 3.0
BASE_BF16_TOL = 8.5e-3


def run_small_base_reference(dev):
    """The base model's guided sampling at the narrow config of
    `run_small_reference`: bf16 with the kernels on the card against fp32
    with the plain versions on the CPU, the same weights, initial noise and
    (SDE) per-step noise: APG at guidance 3.0, ADG at batch 2, the CFG
    interval 0.3-0.8 at guidance 7.0 (12 base steps each) and turbo SDE with
    injected per-step noise, each at 2 x 30 s (375 DiT tokens). A CPU run in
    bf16 is the second reference, within `BASE_BF16_TOL` of the card.
    Latents only (the decode is the turbo path's, checked above)."""
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    gpu = AceStepHandler(*_small_cfgs(), device=dev)
    gpu.initialize_service(random_init=True, seed=6)
    cpu, cpu16 = (AceStepHandler(*_small_cfgs(), dtype=dt, device="cpu") for dt in (torch.float32, torch.bfloat16))
    for h in (cpu, cpu16):
        h.initialize_service(random_init=True, seed=6)
        for name in ("params", "vae_params", "text_params"):
            setattr(h, name, _tree_to(getattr(gpu, name), "cpu", h.dtype))

    base = dict(inference_steps=12, guidance_scale=3.0, shift=3.0)
    unguided = dict(base, guidance_scale=1.0)
    sde_noise = _StepNoise((2, 750, 64), 500)  # 30 s at 25 latent frames/s
    cases = [  # (name, request, the same request without guidance / SDE)
        ("apg gs3", base, unguided),
        ("adg gs3 batch2", dict(base, use_adg=True), unguided),
        ("interval 0.3-0.8 gs7", dict(base, guidance_scale=7.0, cfg_interval_start=0.3, cfg_interval_end=0.8),
         unguided),
        ("sde injected noise", dict(infer_method="sde", sde_noise=sde_noise), dict()),
    ]
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))
    common = dict(captions=CAPTION, lyrics=LYRICS, batch_size=2, audio_duration=30.0, seeds=[1, 2],
                  use_random_seed=False, decode_audio=False)
    failed = []
    for name, kw, off in cases:
        t0 = time.time()
        got = gpu.generate_music(**common, **kw)
        card_s = time.time() - t0
        want = cpu.generate_music(**common, **kw)
        err = rel(got["latents"], want["latents"])
        sep = rel(cpu.generate_music(**common, **off)["latents"], want["latents"])
        ref16 = cpu16.generate_music(**common, **kw)["latents"]
        err16 = rel(got["latents"], ref16)
        ok = (err <= BASE_REF_TOL and sep >= BASE_SEPARATION * BASE_REF_TOL and err16 <= BASE_BF16_TOL
              and bool(np.isfinite(got["latents"]).all()) and got["num_steps"] == want["num_steps"])
        print(json.dumps(dict(phase=f"small base path {name} vs CPU fp32", ok=ok, latents_rel_l2=err,
                              tol=BASE_REF_TOL, unguided_rel_l2=sep, min_unguided=BASE_SEPARATION * BASE_REF_TOL,
                              cpu_bf16_rel_l2=rel(ref16, want["latents"]), card_vs_cpu_bf16_rel_l2=err16,
                              bf16_tol=BASE_BF16_TOL, steps=got["num_steps"], card_s=card_s,
                              shape=list(got["latents"].shape))), flush=True)
        if not ok:
            failed.append((name, err, sep, err16))
    if failed:
        raise SystemExit(f"small base path against the CPU: {failed}")


def _counters():
    from acestep_tpu_torch.ops.attention_probe import attention_probe
    from acestep_tpu_torch.ops.flash_attention import flash_attention
    from acestep_tpu_torch.ops.oobleck_kernels import decoder_block_kernel, res_units_kernel

    return {"flash_attention": flash_attention, "decoder_block": decoder_block_kernel,
            "res_units": res_units_kernel, "attention_probe": attention_probe}


_OOBLECK = ("decoder_block", "res_units")


def _path_launches(path: str, need, narrow: Optional[dict] = None) -> dict:
    """Read the counters after a path and fail if one of its kernels never
    ran, or if the Oobleck wrappers' narrow-route calls differ from `narrow`
    ({"decoder_block": n, "res_units": n}; none at full width, where every
    part takes a Hopper instance)."""
    counters = _counters()
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["flash_attention_f32"] = counters["flash_attention"].f32_launches
    got = {k: counters[k].narrow_launches for k in _OOBLECK}
    want = {k: (narrow or {}).get(k, 0) for k in _OOBLECK}
    print(json.dumps(dict(phase=f"{path} launches", launches=launches, narrow_launches=got,
                          narrow_launches_expected=want)), flush=True)
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels never launched on the {path}: {missing}")
    if got != want:
        raise SystemExit(f"narrow-route launches on the {path}: {got}, expected {want}")
    return launches


def _reset_counters() -> None:
    for fn in _counters().values():
        fn.launches = 0
    _counters()["flash_attention"].f32_launches = 0
    for k in _OOBLECK:
        _counters()[k].narrow_launches = 0


def run_small_thinking_reference(dev):
    """Thinking on at a narrow config: a tiny planner (head_dim 128, so its
    1024-token prefill takes the flash kernel) in bf16 on the card against the
    same weights in fp32 on the CPU, greedy with CFG 2.0 and the FSM's code
    range pointed at real token ids; then the narrow DiT/VAE of
    `run_small_reference` on both devices, fed the card planner's codes.

    Checks (fatal): both plans are well formed (CoT metadata, 150 codes per
    row in range); the prefill logits of the CoT prompt agree to 5e-2 of
    max|ref| (bf16 activations against fp32); latents and audio rel-L2 <= 5e-2.
    Reported: the CoT and codes token agreement and the first divergence
    step (greedy near-ties may flip in bf16; they are not a failure)."""
    from acestep_tpu_torch.config import Qwen3Config
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.models import qwen3

    cfg = Qwen3Config(vocab_size=1024, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1, head_dim=128)
    gpu = LLMHandler(cfg, device=dev)
    gpu.initialize(random_init=True, seed=9)
    cpu = LLMHandler(cfg, dtype=torch.float32, device="cpu")
    cpu.initialize(random_init=True, seed=9)
    cpu.params = _tree_to(gpu.params, "cpu", torch.float32)
    for h in (gpu, cpu):
        h.fsm.code_token_start, h.fsm.num_code_tokens = 259, 765
    kw = dict(temperature=0.0, cfg_scale=2.0, top_p=0.9, target_duration=30.0, seed=5, batch_size=2)
    got = gpu.generate_with_stop_condition(CAPTION, LYRICS, **kw)
    want = cpu.generate_with_stop_condition(CAPTION, LYRICS, **kw)

    def agreement(a, b):
        n = min(len(a), len(b))
        first = next((i for i in range(n) if a[i] != b[i]), None if len(a) == len(b) else n)
        same = sum(int(x == y) for x, y in zip(a, b)) / max(len(a), len(b), 1)
        return same, first

    tok = gpu.tokenizer
    cot = [agreement(tok.encode(a), tok.encode(b)) for a, b in zip(got["batch_cot_texts"], want["batch_cot_texts"])]
    codes = [agreement(a, b) for a, b in zip(got["batch_codes"], want["batch_codes"])]
    formed = all(len(c) == 150 and all(0 <= x < 765 for x in c) for c in got["batch_codes"]) and all(
        {"bpm", "duration", "keyscale"} <= set(md) for md in got["batch_metadata"])

    prompt = gpu.build_formatted_prompt(CAPTION, LYRICS)
    ids, mask, bucket = gpu._encode_prompts([prompt], budget=350)
    with torch.inference_mode():
        lg, _ = qwen3.prefill(gpu.params, cfg, gpu._tensor(ids), gpu._tensor(mask),
                              qwen3.KVCache.create(cfg, 1, bucket, gpu.dtype, dev))
        lc, _ = qwen3.prefill(cpu.params, cfg, torch.as_tensor(ids), torch.as_tensor(mask),
                              qwen3.KVCache.create(cfg, 1, bucket, torch.float32, "cpu"))
    logit_err = float((lg.float().cpu() - lc).abs().max() / lc.abs().max())

    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    dgpu = AceStepHandler(*_small_cfgs(), device=dev)
    dgpu.initialize_service(random_init=True, seed=5)
    dcpu = AceStepHandler(*_small_cfgs(), dtype=torch.float32, device="cpu")
    dcpu.initialize_service(random_init=True, seed=5)
    for name in ("params", "vae_params", "text_params"):
        setattr(dcpu, name, _tree_to(getattr(dgpu, name), "cpu", torch.float32))
    dkw = dict(captions=CAPTION, lyrics=LYRICS, batch_size=2, audio_duration=30.0, seeds=[1, 2],
               use_random_seed=False, normalize_db=-1.0, audio_code_strings=got["batch_audio_codes"])
    a, b = dgpu.generate_music(**dkw), dcpu.generate_music(**dkw)
    rel = lambda x, y: float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-12))
    lat_err, wav_err = rel(a["latents"], b["latents"]), rel(a["audios"], b["audios"])
    tol_logits, tol = 5e-2, 5e-2
    ok = formed and logit_err <= tol_logits and lat_err <= tol and wav_err <= tol
    print(json.dumps(dict(
        phase="small thinking end-to-end vs CPU fp32", ok=ok, plans_well_formed=formed,
        prefill_bucket=bucket, prefill_logits_rel_err=logit_err, tol_logits=tol_logits,
        cot_agreement=[c[0] for c in cot], cot_first_divergence=[c[1] for c in cot],
        cot_tokens=[len(tok.encode(t)) for t in got["batch_cot_texts"]],
        codes_agreement=[c[0] for c in codes], codes_first_divergence=[c[1] for c in codes],
        latents_rel_l2=lat_err, audio_rel_l2=wav_err, tol=tol,
        cot_text_card=got["cot_text"][:300], cot_text_cpu=want["cot_text"][:300])), flush=True)
    if not ok:
        raise SystemExit(f"small thinking reference failed: formed {formed}, logits {logit_err}, "
                         f"latents {lat_err}, audio {wav_err}")


def _signal(seconds: float, seed: int, sr: int) -> np.ndarray:
    """A seeded stereo test signal (2, L) in [-1, 1]: a chord whose notes
    change each second, a slow envelope and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    notes = rng.uniform(110.0, 880.0, (int(seconds) + 1, 3))[t.astype(int)]
    chord = sum(np.sin(2 * np.pi * notes[:, k] * t + k) for k in range(3)) / 3
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t)
    left = 0.5 * env * chord + 0.03 * rng.standard_normal(t.size)
    right = 0.5 * env * np.roll(chord, sr // 100) + 0.03 * rng.standard_normal(t.size)
    return np.clip(np.stack([left, right]), -1.0, 1.0).astype(np.float32)


CKPT_TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "checkpoint_tiny")


def run_checkpoint_tiny(dev):
    """The repository's reference-layout checkpoint (`tests/goldens/
    checkpoint_tiny`: 16-channel VAE, head_dim 16, so attention is the
    einsum, as in the JAX package) loaded from disk on the card, in bf16 and
    in fp32, against the same files loaded by the port on the CPU in fp32;
    the planner's directory with its genres vocabulary loaded on the card and
    asked for a CoT. Requests of 10 s (250 latent frames, two 224-frame
    decode chunks, each three 16-channel decoder blocks on the narrow route):
      text2music, in bf16 and in fp32;
      cover, bf16: the 10 s source through the card's `convert_audio_to_codes`
        (its codes' agreement with the CPU's reported), both handlers then
        covering those codes;
      cover, fp32: each handler's own encode of the source, the hints through
        the audio tokenizer chain.
    Fatal: relative L2 of latents and audio over 5e-2 in bf16 (bf16 weights
    and activations against fp32) or 1e-3 in fp32 (summation order through 8
    steps; TF32 off); a malformed CoT; decoder-block launches other than the
    narrow route's, exactly 6 a request."""
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    cpu = AceStepHandler(dtype=torch.float32, device="cpu")
    cpu.initialize_service(CKPT_TINY)
    cards = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        h = AceStepHandler(dtype=dtype, device=dev)
        t0 = time.time()
        msg = h.initialize_service(CKPT_TINY)
        print(json.dumps(dict(phase=f"checkpoint_tiny initialize_service {name}", seconds=time.time() - t0,
                              msg=msg, vae_dtype=str(h.vae_params["decoder"]["conv1"]["kernel"].dtype))), flush=True)
        cards[name] = h
    llm = LLMHandler(device=dev)
    t0 = time.time()
    msg = llm.initialize(os.path.join(CKPT_TINY, "acestep-5Hz-lm-0.6B"))
    plan = llm.generate_with_stop_condition(CAPTION, "[Instrumental]", temperature=0.8, stop_at_reasoning=True, seed=0)
    md = plan["metadata"]
    formed = (isinstance(md.get("bpm"), int) and 30 <= md["bpm"] <= 300 and isinstance(md.get("duration"), int)
              and llm.genres_vocab == ["synthwave", "ambient", "rock"])
    print(json.dumps(dict(phase="checkpoint_tiny LLMHandler.initialize + CoT", ok=formed, seconds=time.time() - t0,
                          msg=msg, tokenizer=type(llm.tokenizer).__name__,
                          metadata={k: str(v) for k, v in md.items()}, genres_vocab=llm.genres_vocab)),
          flush=True)
    if not formed:
        raise SystemExit(f"checkpoint_tiny planner: malformed CoT metadata {md}")
    del llm

    sr = cpu.vae_config.sampling_rate
    source = _signal(10.0, 21, sr)
    kw = dict(captions=CAPTION, lyrics=LYRICS, audio_duration=10.0, seeds=[5], use_random_seed=False,
              normalize_db=-1.0)
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))
    cpu_codes = cpu.convert_audio_to_codes(source)
    _reset_counters()
    expected = 0
    for name, h in cards.items():
        tol = 5e-2 if name == "bf16" else 1e-3
        if name == "bf16":
            codes = h.convert_audio_to_codes(source)
            ids, cpu_ids = h.parse_audio_codes(codes), h.parse_audio_codes(cpu_codes)
            agree = sum(int(a == b) for a, b in zip(ids, cpu_ids)) / max(len(cpu_ids), 1)
            cover = dict(task_type="cover", audio_code_strings=[codes])
            cover_cpu = cover
        else:
            agree = None
            cover = dict(task_type="cover", target_latents=h.encode_reference_audio(source))
            cover_cpu = dict(task_type="cover", target_latents=cpu.encode_reference_audio(source))
        for task, card_kw, cpu_kw in (("text2music", {}, {}), ("cover", cover, cover_cpu)):
            torch.cuda.synchronize()
            t0 = time.time()
            got = h.generate_music(**kw, **card_kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            want = cpu.generate_music(**kw, **cpu_kw)
            core = h._decode_chunk_core(250, 1)
            expected += (-(-250 // core) if 250 > core else 1) * len(h.vae_config.downsampling_ratios)
            lat_err, wav_err = rel(got["latents"], want["latents"]), rel(got["audios"], want["audios"])
            ok = (lat_err <= tol and wav_err <= tol and got["audios"].shape == want["audios"].shape == (1, 2, 250 * 32)
                  and bool(np.isfinite(got["audios"]).all()) and float(np.abs(got["audios"]).max()) > 0)
            print(json.dumps(dict(phase=f"checkpoint_tiny {task} {name} card vs CPU fp32", ok=ok, wall_s=wall,
                                  latents_rel_l2=lat_err, audio_rel_l2=wav_err, tol=tol,
                                  codes_agreement_with_cpu=agree if task == "cover" else None,
                                  shape=list(got["audios"].shape), time_costs=got["time_costs"])), flush=True)
            if not ok:
                raise SystemExit(f"checkpoint_tiny {task} {name}: latents {lat_err}, audio {wav_err} > {tol}")
    launches = _path_launches("checkpoint_tiny path", ("decoder_block",), {"decoder_block": expected, "res_units": 0})
    if launches["decoder_block"] != expected or launches["res_units"]:
        raise SystemExit(f"checkpoint_tiny path: {launches}, expected {expected} narrow decoder blocks only")
    return launches


def run_requests(dev):
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    counted = {k: v for k, v in _counters().items() if k != "attention_probe"}
    h = AceStepHandler(device=dev)
    t0 = time.time()
    msg = h.initialize_service(random_init=True, seed=0)
    print(json.dumps(dict(phase="initialize_service", seconds=time.time() - t0, msg=msg)), flush=True)
    t0 = time.time()
    h.generate_music(CAPTION, LYRICS, audio_duration=30.0, seeds=[1], use_random_seed=False)
    print(json.dumps(dict(phase="warm-up request b1x30s (untimed below)", seconds=time.time() - t0)), flush=True)
    requests = [(1, 30.0), (2, 60.0), (1, 240.0), (1, 600.0)]
    # Keep the first DiT step's arguments of the 600 s request for its profile.
    from acestep_tpu_torch.models import dit

    step_args: dict = {}
    dit_forward = dit.dit_forward

    def spy(*a, **kw):
        if not step_args and a[2].shape[1] >= 15000:
            step_args.update(a=a, kw=kw)
        return dit_forward(*a, **kw)

    dit.dit_forward = spy
    _reset_counters()
    for i, (b, dur) in enumerate(requests):
        before = {k: fn.launches for k, fn in counted.items()}
        torch.cuda.synchronize()
        t0 = time.time()
        out = h.generate_music(
            CAPTION, LYRICS, batch_size=b,
            audio_duration=dur, seeds=[100 + i + j for j in range(b)], use_random_seed=False,
            normalize_db=-1.0, return_int16=True,
        )
        torch.cuda.synchronize()
        wall = time.time() - t0
        pcm = out["audios"]
        want = (b, 2, int(dur * 48000))
        peak = int(np.abs(pcm.astype(np.int32)).max())
        finite = bool(np.isfinite(out["latents"]).all())
        ok = pcm.dtype == np.int16 and pcm.shape == want and peak > 0 and finite
        line = dict(phase=f"request b{b}x{int(dur)}s", ok=ok, wall_s=wall, audio_s_per_s=b * dur / wall,
                    shape=list(pcm.shape), dtype=str(pcm.dtype), latents_finite=finite, peak=peak,
                    time_costs=out["time_costs"],
                    launches={k: fn.launches - before[k] for k, fn in counted.items()})
        print(json.dumps(line), flush=True)
        if not ok:
            raise SystemExit(f"request b{b}x{dur}s: bad output {pcm.dtype} {pcm.shape} peak {peak}")
    dit.dit_forward = dit_forward
    launches = _path_launches("text2music path", counted)
    print(json.dumps(dict(phase="DiT step profile b1x600s", **_dit_step_profile(dit_forward, step_args))),
          flush=True)
    del step_args
    print(json.dumps(dict(phase="VAE decode chunk profile b1x544", **_vae_decode_profile(h))), flush=True)
    return h, launches


def run_audio_requests(h):
    """The audio-input tasks through the service layer at full width (the
    handler of `run_requests`: random weights, the widths of `config.py`),
    each source or reference a WAV the script writes with the port's
    `save_wav` from a seeded signal at 48 kHz, after one untimed warm-up
    (a 30 s cover of a 60 s source):
      cover 1 x 60 s: the 60 s source through `convert_audio_to_codes` (VAE
        encode, audio tokenizer), then a cover of those codes;
      repaint 1 x 60 s over 20-40 s of the 60 s source;
      text2music 1 x 60 s with a 30 s reference audio (timbre);
      cover 1 x 120 s from a 120 s source: `tiled_encode` in 20 s chunks
        (16 s cores, 2 s overlaps: 8 chunks), hints through the tokenizer.
    Each must give non-silent int16 audio of exactly its length. Then the
    profile of one 20 s encode chunk."""
    import tempfile

    from acestep_tpu_torch.config import LATENT_FPS
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams
    from acestep_tpu_torch.utils.audio import load_audio, save_wav

    counters = _counters()
    sr = h.vae_config.sampling_rate
    with tempfile.TemporaryDirectory() as tmp:
        def wav(name, seconds, seed):
            path = os.path.join(tmp, name)
            save_wav(path, _signal(seconds, seed, sr), sr)
            return path

        src60, src120, ref30 = wav("src60.wav", 60.0, 31), wav("src120.wav", 120.0, 32), wav("ref30.wav", 30.0, 33)

        def request(fields, seed):
            params = GenerationParams(caption=CAPTION, lyrics=LYRICS, seed=seed, thinking=False, **fields)
            r = generate_music(h, None, params, GenerationConfig(batch_size=1, use_random_seed=False), save_audio=False)
            if not r.success:
                raise SystemExit(f"audio-input request {fields.get('task_type')} failed: {r.error}")
            return r

        t0 = time.time()
        request(dict(task_type="cover", src_audio=src60, duration=30.0), 40)
        print(json.dumps(dict(phase="warm-up audio-input request cover b1x30s (untimed below)",
                              seconds=time.time() - t0)), flush=True)
        _reset_counters()
        cases = [
            ("cover b1x60s (codes from the source)", 60.0, dict(task_type="cover"), src60),
            ("repaint b1x60s 20-40 s", 60.0, dict(task_type="repaint", src_audio=src60, repainting_start=20.0,
                                                  repainting_end=40.0), None),
            ("text2music b1x60s + 30 s reference", 60.0, dict(reference_audio=ref30), None),
            ("cover b1x120s from a 120 s source", 120.0, dict(task_type="cover", src_audio=src120), None),
        ]
        for i, (label, dur, fields, codes_from) in enumerate(cases):
            before = {k: fn.launches for k, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.time()
            convert_s = want_codes = None
            if codes_from is not None:
                src = load_audio(codes_from)
                fields = dict(fields, audio_codes=h.convert_audio_to_codes(src))
                convert_s = time.time() - t0
                want_codes = -(-(src.shape[1] // h.vae_config.hop_length) // h.config.pool_window_size)
            r = request(dict(fields, duration=dur), 50 + i)
            torch.cuda.synchronize()
            wall = time.time() - t0
            pcm = r.audios[0]["audio"]
            tc = r.extra_outputs["time_costs"]
            peak = int(np.abs(pcm.astype(np.int32)).max())
            ok = pcm.dtype == np.int16 and pcm.shape == (2, int(dur * LATENT_FPS) * h.vae_config.hop_length) and peak > 0
            n_codes = len(h.parse_audio_codes(fields.get("audio_codes", "")))
            line = dict(phase=f"audio-input request {label}", ok=ok, wall_s=wall, audio_s_per_s=dur / wall,
                        convert_audio_to_codes_s=convert_s, n_codes=n_codes,
                        vae_encode_time_cost=tc.get("vae_encode_time_cost"),
                        diffusion_time_cost=tc.get("diffusion_time_cost"),
                        vae_decode_time_cost=tc.get("vae_decode_time_cost"), shape=list(pcm.shape), peak=peak,
                        time_costs=tc, launches={k: fn.launches - before[k] for k, fn in counters.items()})
            print(json.dumps(line), flush=True)
            if not ok or n_codes != (want_codes or 0):
                raise SystemExit(f"audio-input request {label}: bad output {pcm.dtype} {pcm.shape} peak {peak} "
                                 f"codes {n_codes}")
    launches = _path_launches("audio-input path", ("flash_attention", "decoder_block", "res_units"))
    print(json.dumps(dict(phase="VAE encode chunk profile 20s", **_vae_encode_profile(h))), flush=True)
    return launches


def run_base_requests(h):
    """The base model's guided sampling at full width through
    `service.inference.generate_music` (the handler of `run_requests`), after
    one untimed warm-up: 1 x 60 s and 1 x 600 s with 50 steps at the default
    guidance 7.0 (APG), 2 x 60 s with ADG, and a turbo 1 x 60 s with SDE.
    Each must give finite, non-silent int16 audio of exactly its length."""
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    counters = _counters()

    def request(b, dur, seed, **fields):
        params = GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=dur, seed=seed, thinking=False, **fields)
        cfg = GenerationConfig(batch_size=b, use_random_seed=False, seeds=[seed + j for j in range(b)])
        torch.cuda.synchronize()
        t0 = time.time()
        r = generate_music(h, None, params, cfg, save_audio=False)
        torch.cuda.synchronize()
        if not r.success:
            raise SystemExit(f"base request b{b}x{int(dur)}s {fields} failed: {r.error}")
        return r, time.time() - t0

    _, wall = request(1, 30.0, 60, inference_steps=12)
    print(json.dumps(dict(phase="warm-up base request b1x30s 12 steps (untimed below)", seconds=wall)), flush=True)
    _reset_counters()
    cases = [
        ("b1x60s 50 steps APG 7.0", 1, 60.0, dict(inference_steps=50)),
        ("b1x600s 50 steps APG 7.0", 1, 600.0, dict(inference_steps=50)),
        ("b2x60s 50 steps ADG 7.0", 2, 60.0, dict(inference_steps=50, use_adg=True)),
        ("b1x60s turbo SDE", 1, 60.0, dict(infer_method="sde")),
    ]
    for i, (label, b, dur, fields) in enumerate(cases):
        before = {k: fn.launches for k, fn in counters.items()}
        r, wall = request(b, dur, 70 + 10 * i, **fields)
        pcm = np.stack([a["audio"] for a in r.audios])
        tc = r.extra_outputs["time_costs"]
        peak = int(np.abs(pcm.astype(np.int32)).max())
        ok = pcm.dtype == np.int16 and pcm.shape == (b, 2, int(dur * 48000)) and peak > 0
        line = dict(phase=f"base request {label}", ok=ok, wall_s=wall, audio_s_per_s=b * dur / wall,
                    diffusion_time_cost=tc.get("diffusion_time_cost"),
                    diffusion_per_step_time_cost=tc.get("diffusion_per_step_time_cost"),
                    vae_decode_time_cost=tc.get("vae_decode_time_cost"), shape=list(pcm.shape), peak=peak,
                    time_costs=tc, launches={k: fn.launches - before[k] for k, fn in counters.items()})
        print(json.dumps(line), flush=True)
        if not ok:
            raise SystemExit(f"base request {label}: bad output {pcm.dtype} {pcm.shape} peak {peak}")
    return _path_launches("base path", ("flash_attention", "decoder_block", "res_units"))


def _http(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    """One request to a server on this host: (status, response body bytes, response)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    data = None if body is None else json.dumps(body).encode()
    conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.read()
    conn.close()
    return resp.status, out, resp


def _wait_jobs(port: int, ids, deadline_s: float = 600.0) -> dict:
    """Poll /query_result until every job is terminal; fails on a failed job."""
    t_end = time.time() + deadline_s
    while True:
        res = json.loads(_http(port, "POST", "/query_result", {"task_ids": list(ids)})[1])["results"]
        if all(r["status"] in (1, 2) for r in res):
            bad = [r for r in res if r["status"] != 1]
            if bad:
                raise SystemExit(f"serving: jobs failed: {bad}")
            return {r["task_id"]: r for r in res}
        if time.time() > t_end:
            raise SystemExit(f"serving: jobs not done after {deadline_s} s: {res}")
        time.sleep(0.02)


def _release(port: int, **fields) -> str:
    status, out, _ = _http(port, "POST", "/release_task", {**dict(caption=CAPTION, lyrics=LYRICS, thinking=False,
                                                                  batch_size=1), **fields})
    if status != 200:
        raise SystemExit(f"serving: /release_task answered {status}: {out[:300]}")
    return json.loads(out)["task_id"]


_WORKER_KNOBS = ("ACESTEP_PIPELINE_JOBS", "ACESTEP_MERGE_JOBS")


def _start_server(h, out_dir: str, pipeline: str = "1", merge: str = "1"):
    """serve(h, None, "127.0.0.1", 0, ...) in this process, its worker's
    knobs set in the environment, which the worker reads when it starts (so
    they stay set until `run_serving` ends)."""
    import threading

    from acestep_tpu_torch.service.api_server import serve

    os.environ.update(dict(zip(_WORKER_KNOBS, (pipeline, merge))))
    server = serve(h, None, "127.0.0.1", 0, output_dir=out_dir)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _pcm_of_wav_bytes(body: bytes) -> np.ndarray:
    import io
    import wave

    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, w.getnchannels()).T


# The serving phase's merged rows against solo runs of the same seeds: every
# other seed's audio must lie at least this many times farther (relative L2)
# than the row's own seed.
MERGE_SEPARATION = 3.0
# The serving phase's request lengths (seconds): the long and the streamed
# request, the merged and the ladder's, the pipelined and the chat's.
SERVE_LONG_S, SERVE_SHORT_S, SERVE_PIPE_S = 240.0, 60.0, 30.0


def run_serving(h, smi: str):
    """The REST server (`service.api_server.serve`) in this process on the
    full-width bf16 handler of phase 5, no planner; every job thinking off.

      merging: a 1 x 240 s FLAC job (seed 100) is taken by the worker, which
        is held at its lock while four 1 x 60 s jobs (seeds 1-4) queue behind
        it; they must run as one merged batch of 4. Each 60 s FLAC decodes
        with `utils/flac.py` (four processes) to 2 x 2 880 000 int16;
      streaming: `/v1/generate_stream` of the 240 s seed-100 request: >= 2
        chunks, time to the first byte, PCM bit for bit the released FLAC's;
      pipelining: six 1 x 30 s jobs, merging off, pipelining on and off:
        equal files, both walls;
      chat: one non-streaming `/v1/chat/completions` text2music request;
      the ladder: `vae.decode` raises torch.OutOfMemoryError once inside a
        streamed 1 x 60 s request: `vae_decode_hbm_retries` 1, every sample
        streamed once (the stream is the saved file's PCM);
    then the serve path's launch counters (set to 0 just before the first
    job is released: the server's jobs alone) and the peak of
    `torch.cuda.max_memory_allocated` over it beside what
    `utils/memory_config` derives from the card's memory. Then, as a path of
    its own, a direct `generate_music_merged` call of the four 60 s requests
    (rows equal to the server's; its wall against four solo `generate_music`
    runs) and the relative L2 of merged row i against the solo run of seed j:
    every i != j at least MERGE_SEPARATION times the largest i = i. Last,
    `cli serve --random-init --warmup 1x10` in a subprocess: startup,
    /health, one 1 x 10 s job. Returns both paths' launch counts."""
    import base64
    import dataclasses
    import http.client
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from acestep_tpu_torch.models import vae as vae_module
    from acestep_tpu_torch.service.inference import generate_music, generate_music_merged
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams
    from acestep_tpu_torch.utils import flac, native_audio
    from acestep_tpu_torch.utils.memory_config import get_runtime_memory_config

    readings: dict = dict(card=smi)
    sr = h.vae_config.sampling_rate
    tmp = tempfile.mkdtemp(prefix="acestep_serve_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- merging ----
    server = _start_server(h, os.path.join(tmp, "merge"))
    port, svc = server.server_address[1], server.service
    if not svc.model_lock.acquire(timeout=60):
        raise SystemExit("serving: the worker holds its lock")
    try:
        _reset_counters()  # the serve path: the server's jobs alone, up to the ladder's
        long_id = _release(port, duration=SERVE_LONG_S, seed=100, audio_format="flac")
        t_end = time.time() + 60
        while svc.queue.qsize():  # the worker took the 240 s job and waits at the lock
            if time.time() > t_end:
                raise SystemExit("serving: the worker did not take the 240 s job")
            time.sleep(0.005)
        short_ids = [_release(port, duration=SERVE_SHORT_S, seed=j, audio_format="flac") for j in (1, 2, 3, 4)]
    finally:
        svc.model_lock.release()
    t0 = time.time()
    res = _wait_jobs(port, [long_id] + short_ids)
    merged_wall = time.time() - t0
    sizes = [res[t]["result"]["extra"].get("merged_batch") for t in short_ids]
    if sizes != [4, 4, 4, 4] or "merged_batch" in res[long_id]["result"]["extra"]:
        raise SystemExit(f"serving: merged batch sizes {sizes}, expected 4 x 4 behind a solo 240 s job")
    merged_tc = res[short_ids[0]]["result"]["extra"]["time_costs"]
    paths = [res[t]["result"]["audio_paths"][0] for t in short_ids]
    if not all(p.endswith(".flac") for p in paths + res[long_id]["result"]["audio_paths"]):
        raise SystemExit(f"serving: FLAC asked for, got {paths}")
    blobs = [open(p, "rb").read() for p in paths]
    t0 = time.time()
    with ProcessPoolExecutor(max_workers=4, mp_context=get_context("spawn")) as pool:
        decoded = list(pool.map(flac.decode, blobs))
    flac_decode_s = time.time() - t0
    merged_pcm = []
    for pcm, rate, bps in decoded:
        if (rate, bps, pcm.shape) != (sr, 16, (2, int(SERVE_SHORT_S * sr))):
            raise SystemExit(f"serving: a merged FLAC decodes to {pcm.shape} at {rate} Hz, {bps} bits")
        merged_pcm.append(pcm.astype(np.float64))

    # ---- streaming ----
    released = native_audio.flac_decode(open(res[long_id]["result"]["audio_paths"][0], "rb").read())
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.time()
    conn.request("POST", "/v1/generate_stream", body=json.dumps(dict(
        caption=CAPTION, lyrics=LYRICS, thinking=False, batch_size=1, duration=SERVE_LONG_S, seed=100,
        audio_format="flac")), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    head = resp.read(48)
    first_byte_s = time.time() - t0
    body = head + resp.read()
    stream_s = time.time() - t0
    conn.close()
    tid = resp.getheader("X-Task-Id")
    st = _wait_jobs(port, [tid])[tid]
    chunks = st["result"].get("streamed_chunks", 0)
    pcm = _pcm_of_wav_bytes(body)
    diff = np.abs(pcm.astype(np.int32) - released[0]) if pcm.shape == released[0].shape else None
    ok = (resp.status == 200 and chunks >= 2 and len(body) == int(resp.getheader("Content-Length"))
          and diff is not None and int(diff.max()) == 0)
    print(json.dumps(dict(phase="serving /v1/generate_stream 1 x 240 s", ok=ok, status=resp.status,
                          time_to_first_byte_s=first_byte_s, stream_s=stream_s, streamed_chunks=chunks,
                          bytes=len(body), shape=list(pcm.shape),
                          max_abs_diff_vs_released=None if diff is None else int(diff.max()),
                          samples_differing=None if diff is None else int((diff > 0).sum()),
                          time_costs=st["result"]["extra"]["time_costs"])), flush=True)
    if not ok:
        raise SystemExit("serving: the streamed 240 s request differs from the released one")
    readings.update(time_to_first_byte_240s_s=first_byte_s, stream_240s_s=stream_s)

    # ---- pipelining ----
    files, walls = {}, {}
    for pipeline in ("1", "0"):
        srv = _start_server(h, os.path.join(tmp, f"pipe{pipeline}"), pipeline=pipeline, merge="0")
        p = srv.server_address[1]
        t0 = time.time()
        ids = [_release(p, duration=SERVE_PIPE_S, seed=200 + i, audio_format="flac") for i in range(6)]
        out = _wait_jobs(p, ids)
        walls[pipeline] = time.time() - t0
        files[pipeline] = [open(out[t]["result"]["audio_paths"][0], "rb").read() for t in ids]
        if any("merged_batch" in out[t]["result"]["extra"] for t in ids):
            raise SystemExit("serving: a job merged with merging off")
        srv.shutdown()
        srv.server_close()
    ok = files["1"] == files["0"]
    print(json.dumps(dict(phase="serving six 1 x 30 s jobs, merging off", ok=ok, pipelined_wall_s=walls["1"],
                          serial_wall_s=walls["0"])), flush=True)
    if not ok:
        raise SystemExit("serving: the pipelined worker's files differ from the serial worker's")
    readings.update(six_30s_pipelined_s=walls["1"], six_30s_serial_s=walls["0"])

    # ---- chat ----
    t0 = time.time()
    status, out, _ = _http(port, "POST", "/v1/chat/completions", dict(
        messages=[{"role": "user", "content": f"a driving synthwave track, {int(SERVE_PIPE_S)} seconds"}], seed=5))
    chat_s = time.time() - t0
    out = json.loads(out)
    audio = [c for c in out.get("choices", [{}])[0].get("message", {}).get("content", []) if c["type"] == "audio"]
    frames = _pcm_of_wav_bytes(base64.b64decode(audio[0]["audio"]["data"])).shape if audio else None
    ok = status == 200 and len(audio) == 1 and frames == (2, int(SERVE_PIPE_S * sr))
    print(json.dumps(dict(phase="serving /v1/chat/completions 1 x 30 s", ok=ok, status=status, seconds=chat_s,
                          audio_shape=frames)), flush=True)
    if not ok:
        raise SystemExit(f"serving: chat completion {status}: {str(out)[:300]}")

    # ---- the ladder ----
    real_decode, calls = vae_module.decode, []

    def decode_once_oom(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("injected by chip_smoke")
        return real_decode(*a, **kw)

    vae_module.decode = decode_once_oom
    try:
        status, body, resp = _http(port, "POST", "/v1/generate_stream", dict(
            caption=CAPTION, lyrics=LYRICS, thinking=False, batch_size=1, duration=SERVE_SHORT_S, seed=7,
            audio_format="wav"))
    finally:
        vae_module.decode = real_decode
    tid = resp.getheader("X-Task-Id")
    st = _wait_jobs(port, [tid])[tid]
    tc = st["result"]["extra"]["time_costs"]
    saved = open(st["result"]["audio_paths"][0], "rb").read()
    ok = (status == 200 and tc.get("vae_decode_hbm_retries") == 1 and body == saved
          and len(body) == 44 + 4 * int(SERVE_SHORT_S * sr))
    print(json.dumps(dict(phase="serving the decode ladder: one injected OOM in a streamed 1 x 60 s", ok=ok,
                          status=status, vae_decode_hbm_retries=tc.get("vae_decode_hbm_retries"),
                          streamed_chunks=st["result"].get("streamed_chunks"), bytes=len(body),
                          stream_equals_saved=body == saved, time_costs=tc)), flush=True)
    if not ok:
        raise SystemExit("serving: the ladder's retry or exactly-once delivery failed")
    server.shutdown()
    server.server_close()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = _path_launches("serve path", ("flash_attention", "decoder_block", "res_units"))
    readings.update(peak_max_memory_allocated_gib=peak / 2**30,
                    memory_policy=dataclasses.asdict(get_runtime_memory_config()))

    # ---- the merged batch against direct calls (a path of its own) ----
    _reset_counters()
    # The same four requests merged by a direct call (no saves): the batch's
    # own wall, and rows equal to the server's; then four solo runs.
    torch.cuda.synchronize()
    t0 = time.time()
    direct = generate_music_merged(h, [(GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=SERVE_SHORT_S,
                                                         seed=j, thinking=False), GenerationConfig(batch_size=1))
                                       for j in (1, 2, 3, 4)], save_audio=False)
    torch.cuda.synchronize()
    merged_direct_s = time.time() - t0
    same_as_server = all(r.success and np.array_equal(r.audios[0]["audio"], m) for r, m in zip(direct, merged_pcm))
    solo_pcm, solo_walls = [], []
    for j in (1, 2, 3, 4):
        torch.cuda.synchronize()
        t0 = time.time()
        r = generate_music(h, None, GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=SERVE_SHORT_S, seed=j,
                                                     thinking=False), GenerationConfig(batch_size=1),
                           save_audio=False)
        solo_walls.append(time.time() - t0)
        if not r.success:
            raise SystemExit(f"serving: solo 60 s seed {j} failed: {r.error}")
        solo_pcm.append(r.audios[0]["audio"].astype(np.float64))
    dist = [[float(np.linalg.norm(m - s) / np.linalg.norm(s)) for s in solo_pcm] for m in merged_pcm]
    same = max(dist[i][i] for i in range(4))
    other = min(dist[i][j] for i in range(4) for j in range(4) if i != j)
    ok = other >= MERGE_SEPARATION * same and same_as_server
    print(json.dumps(dict(phase="serving merged batch of 4 x 60 s vs solo runs", ok=ok, rel_l2=dist,
                          largest_same_seed=same, smallest_other_seed=other, separation=MERGE_SEPARATION,
                          direct_merged_equals_server=same_as_server, direct_merged_s=merged_direct_s,
                          solo_walls_s=solo_walls, solo_sum_s=sum(solo_walls), server_time_costs=merged_tc,
                          server_queue_to_done_s=merged_wall, flac_decode_s_4_processes=flac_decode_s)), flush=True)
    if not ok:
        raise SystemExit(f"serving: merged rows against solo seeds {dist}, direct = server {same_as_server}")
    readings.update(merged_4x60_direct_s=merged_direct_s, solo_4x60_sum_s=sum(solo_walls))
    direct_launches = _path_launches("serving's direct merged and solo calls",
                                     ("flash_attention", "decoder_block", "res_units"))

    # ---- cli serve ----
    log_path = os.path.join(tmp, "cli_serve.log")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "acestep_tpu_torch.cli", "serve", "--random-init", "--warmup", "1x10",
             "--host", "127.0.0.1", "--port", "0", "--output-dir", os.path.join(tmp, "cli")],
            cwd=here, stdout=log, stderr=subprocess.STDOUT)
    try:
        cli_port = None
        while cli_port is None:
            for ln in open(log_path).read().splitlines():
                if ln.startswith("listening on 127.0.0.1:"):
                    cli_port = int(ln.rsplit(":", 1)[1])
            if cli_port is None:
                if proc.poll() is not None or time.time() - t0 > 400:
                    raise SystemExit(f"cli serve did not start:\n{open(log_path).read()[-3000:]}")
                time.sleep(0.2)
        startup_s = time.time() - t0
        health = json.loads(_http(cli_port, "GET", "/health")[1])
        t1 = time.time()
        job = _wait_jobs(cli_port, [_release(cli_port, duration=10.0, seed=1, audio_format="flac")])
        job_s = time.time() - t1
        path = list(job.values())[0]["result"]["audio_paths"][0]
        got = native_audio.flac_decode(open(path, "rb").read())
        ok = health == {"status": "ok", "initialized": True} and got[0].shape == (2, 10 * 48000)  # full width
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    tail = [ln for ln in open(log_path).read().splitlines() if ln.startswith(("initialized", "[warmup]", "listening"))]
    print(json.dumps(dict(phase="cli serve --random-init --warmup 1x10 (subprocess)", ok=ok, startup_s=startup_s,
                          job_1x10s_s=job_s, health=health, log=tail, exit_code=proc.returncode)), flush=True)
    if not ok:
        raise SystemExit("cli serve: bad health or job")
    readings.update(cli_serve_warmup_startup_s=startup_s)
    print(json.dumps(dict(phase="serving readings", **readings)), flush=True)
    for k in _WORKER_KNOBS:
        os.environ.pop(k, None)
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, direct_launches


# The LoRA phase's adapter: A gaussian / rank (the trainer's init), alpha =
# rank, B gaussian with LORA_B_STD, so a delta element has a standard
# deviation of about LORA_B_STD / sqrt(rank) = 0.018, near the random
# kernels' 0.02. The adapted 1 x 30 s latents must lie at least
# LORA_MIN_REL_L2 (relative L2) from the base ones.
LORA_RANK, LORA_B_STD, LORA_SEED = 32, 0.1, 41
LORA_MIN_REL_L2 = 1e-2


def run_lora(h):
    """LoRA through the REST server on the full-width bf16 handler of phase 5.

    A seeded rank-32 adapter over all 11 targets x 24 layers, written in the
    trainer's `adapter.npz` layout, goes through `/v1/lora/load`, `status`,
    `scale` and `toggle`. Four 1 x 30 s jobs (seed LORA_SEED): no adapter
    (the base), the adapter on, at scale 0.5, toggled off. Checks: on, the
    latents equal bit for bit a direct service request on the base decoder
    `merge_lora`'d; off, the base job's bit for bit; 0.5 differs from both;
    on lies at least LORA_MIN_REL_L2 from the base. Prints the first adapted
    request's merge (`effective_decoder`, 264 products, timed between
    synchronises) and the adapter's bytes. The `lora` path's launches are
    the server's four jobs."""
    import shutil
    import tempfile

    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams
    from acestep_tpu_torch.training.lora import init_lora_params, merge_lora

    tmp = tempfile.mkdtemp(prefix="acestep_lora_")
    base_params = h.params
    lora = init_lora_params(LORA_SEED, base_params["decoder"], rank=LORA_RANK)
    gen = torch.Generator().manual_seed(LORA_SEED)
    for ab in lora.values():
        ab["b"] = (torch.randn(ab["b"].shape, generator=gen) * LORA_B_STD).to(ab["b"].device)
    path = os.path.join(tmp, "adapter.npz")
    meta = {"rank": LORA_RANK, "alpha": float(LORA_RANK), "adapter_type": "lora", "step": 0}
    np.savez(path, **{f"{p}|{k}": v.cpu().numpy() for p, ab in lora.items() for k, v in ab.items()},
             __meta__=np.asarray(json.dumps(meta)))
    file_bytes = os.path.getsize(path)

    latents, merges = [], []
    real_generate, real_effective = h.generate_music, h.lora.effective_decoder

    def generate_spy(*a, **kw):
        out = real_generate(*a, **kw)
        latents.append(out["latents"])
        return out

    def effective_spy(base):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real_effective(base)
        torch.cuda.synchronize()
        merges.append(time.time() - t0)
        return out

    h.generate_music, h.lora.effective_decoder = generate_spy, effective_spy
    server = _start_server(h, os.path.join(tmp, "out"))
    port = server.server_address[1]

    def job():
        torch.cuda.synchronize()
        t0 = time.time()
        _wait_jobs(port, [_release(port, duration=30.0, seed=LORA_SEED, audio_format="wav")])
        return latents[-1], time.time() - t0

    def route(op: str, body: dict) -> dict:
        status, out, _ = _http(port, "POST", f"/v1/lora/{op}", body)
        if status != 200:
            raise SystemExit(f"lora: /v1/lora/{op} answered {status}: {out[:300]}")
        return json.loads(out)

    try:
        _reset_counters()
        base, base_s = job()
        loaded = route("load", {"name": "style", "path": path})
        status = route("status", {})["adapters"]
        on, on_s = job()
        first_merge_s = merges[0] if merges else None
        route("scale", {"name": "style", "scale": 0.5})
        half, half_s = job()
        toggled = route("toggle", {"name": "style", "enabled": False})
        off, off_s = job()
        server.shutdown()
        server.server_close()
        launches = _path_launches("lora path", ("flash_attention", "decoder_block", "res_units"))
        unloaded = h.unload_lora("style")
        h.lora.invalidate_cache()
        # The same request on the base decoder with the adapter merged into it.
        h.params = {**base_params, "decoder": merge_lora(base_params["decoder"], lora, alpha=float(LORA_RANK),
                                                          rank=LORA_RANK)}
        r = generate_music(h, None, GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=30.0, seed=LORA_SEED,
                                                     thinking=False), GenerationConfig(batch_size=1),
                           save_audio=False)
        if not r.success:
            raise SystemExit(f"lora: the request on the merged decoder failed: {r.error}")
        merged = latents[-1]
    finally:
        h.params = base_params
        h.generate_music, h.lora.effective_decoder = real_generate, real_effective
        for k in _WORKER_KNOBS:
            os.environ.pop(k, None)
        shutil.rmtree(tmp, ignore_errors=True)
    rel = lambda x, y: float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-12))
    ok = (np.array_equal(on, merged) and np.array_equal(off, base) and not np.array_equal(half, on)
          and not np.array_equal(half, base) and rel(on, base) >= LORA_MIN_REL_L2
          and loaded.get("meta") == meta and status["style"]["enabled"] and toggled["enabled"] is False
          and unloaded and h.lora_status() == {})
    print(json.dumps(dict(
        phase="lora b1x30s through /v1/lora/* (rank 32, 11 targets x 24 layers)", ok=ok,
        adapter_file_bytes=file_bytes,
        adapter_factor_bytes=sum(v.numel() * v.element_size() for ab in lora.values() for v in ab.values()),
        products=len(lora), first_merge_s=first_merge_s, effective_decoder_calls_s=merges,
        on_equals_merged=bool(np.array_equal(on, merged)), off_equals_base=bool(np.array_equal(off, base)),
        rel_l2_on_base=rel(on, base), rel_l2_half_base=rel(half, base), rel_l2_half_on=rel(half, on),
        min_rel_l2=LORA_MIN_REL_L2, job_walls_s=dict(base=base_s, on=on_s, half=half_s, off=off_s))), flush=True)
    if not ok:
        raise SystemExit("lora: adapter checks failed")
    return launches


# The LRC phase's capture on the card (bf16, kernel 1) against the same
# capture on the CPU in fp32: relative L2 of each captured map at most this,
# twice the largest reading (6.2e-3, layer 6) of the first run on an H100 80GB
# HBM3; the inputs are seeded, so a run repeats it.
LRC_CAPTURE_TOL = 1.3e-2


def _lyric_lines(n: int) -> str:
    """n lyric lines: section tags and sung lines."""
    words = ("neon rain on the boulevard", "we drive until the morning light", "hold the wheel and feel the night",
             "echoes in the empty street", "hearts that race beyond the beat", "city lights are calling out")
    lines = []
    for i in range(n):
        lines.append("[Verse]" if i % 6 == 0 else ("[Chorus]" if i % 6 == 3 else words[i % len(words)]))
    return "\n".join(lines)


def run_lrc(h):
    """Auto LRC and the lyric score at full width on the handler of phase 5:
    a 1 x 60 s and a 1 x 240 s text2music request with 8 and 24 lyric lines
    and `auto_lrc`, `auto_score` through `service.inference.generate_music`.
    Checks: success; one LRC line per non-empty lyric line; sentence starts
    non-decreasing, every stamp in [0, duration]; `lyrics_score` in [0, 1].
    Prints the capture forward's time (between synchronises) and, apart, the
    host's alignment time with its DTW share (`dtw_align`, a Python double
    loop). The 60 s capture is held against the same capture on the CPU in
    fp32 from the same inputs, layers 0-6 and the embedders copied there
    (`LRC_CAPTURE_TOL`). The `lrc` path's launches are the two requests."""
    from acestep_tpu_torch.models import dit
    from acestep_tpu_torch.scoring import alignment, lyric_score
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    real_capture, real_align, real_dtw = dit.dit_cross_attention_capture, h.align_lyrics, alignment.dtw_align
    timings: dict = {"capture_s": [], "align_s": [], "dtw_s": []}
    kept: dict = {}

    def capture_spy(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real_capture(*a, **kw)
        torch.cuda.synchronize()
        timings["capture_s"].append(time.time() - t0)
        kept.setdefault("args", a)
        kept.setdefault("maps", {k: v.float().cpu() for k, v in out.items()})
        return out

    def align_spy(*a, **kw):
        t0 = time.time()
        out = real_align(*a, **kw)
        timings["align_s"].append(time.time() - t0)
        return out

    def dtw_spy(cost):
        t0 = time.time()
        out = real_dtw(cost)
        timings["dtw_s"][-1] += time.time() - t0
        return out

    dit.dit_cross_attention_capture, h.align_lyrics = capture_spy, align_spy
    alignment.dtw_align = lyric_score.dtw_align = dtw_spy
    readings = []
    try:
        _reset_counters()
        for dur, n_lines, seed in ((60.0, 8, 61), (240.0, 24, 62)):
            lyrics = _lyric_lines(n_lines)
            timings["dtw_s"].append(0.0)
            torch.cuda.synchronize()
            t0 = time.time()
            r = generate_music(h, None, GenerationParams(caption=CAPTION, lyrics=lyrics, duration=dur, seed=seed,
                                                         thinking=False, vocal_language="en", auto_lrc=True,
                                                         auto_score=True),
                               GenerationConfig(batch_size=1), save_audio=False)
            wall = time.time() - t0
            if not r.success:
                raise SystemExit(f"lrc b1x{int(dur)}s failed: {r.error}")
            a = r.audios[0]
            stamps = a.get("sentence_timestamps") or []
            starts = [s["start"] for s in stamps]
            lines = [ln for ln in lyrics.split("\n") if ln.strip()]
            score = a.get("lyrics_score")
            ok = (len((a.get("lrc") or "").split("\n")) == len(lines) == len(stamps)
                  and starts == sorted(starts)
                  and all(0.0 <= s["start"] <= dur and 0.0 <= s["end"] <= dur for s in stamps)
                  and score is not None and 0.0 <= score <= 1.0)
            line = dict(phase=f"lrc b1x{int(dur)}s, {n_lines} lyric lines, auto_lrc + auto_score", ok=ok, wall_s=wall,
                        capture_s=timings["capture_s"][-1], align_s=timings["align_s"][-1],
                        dtw_s=timings["dtw_s"][-1], lrc_lines=len(stamps), lyric_lines=len(lines),
                        lyrics_score=score, lrc_head=(a.get("lrc") or "")[:200], time_costs=r.extra_outputs["time_costs"])
            readings.append(line)
            print(json.dumps(line), flush=True)
            if not ok:
                raise SystemExit(f"lrc b1x{int(dur)}s: bad LRC or score: {line}")
        launches = _path_launches("lrc path", ("flash_attention", "decoder_block", "res_units"))
    finally:
        dit.dit_cross_attention_capture, h.align_lyrics = real_capture, real_align
        alignment.dtw_align = lyric_score.dtw_align = real_dtw

    # The 60 s capture again on the CPU in fp32 from the same inputs.
    p, cfg, *rest = kept["args"]
    sub = {k: p[k] for k in ("time_embed", "time_embed_r", "condition_embedder", "proj_in")}
    sub["layers"] = p["layers"][: max(rest[-1]) + 1]
    sub = _tree_to(sub, "cpu", torch.float32)
    cpu_args = [x.cpu().float() if torch.is_tensor(x) and x.is_floating_point() else
                (x.cpu() if torch.is_tensor(x) else x) for x in rest]
    t0 = time.time()
    with torch.inference_mode():
        want = real_capture(sub, cfg, *cpu_args)
    cpu_s = time.time() - t0
    errs = {int(k): float((kept["maps"][k] - want[k]).norm() / want[k].norm()) for k in want}
    ok = max(errs.values()) <= LRC_CAPTURE_TOL
    print(json.dumps(dict(phase="lrc capture b1x60s, card bf16 vs CPU fp32", ok=ok, rel_l2_per_layer=errs,
                          tol=LRC_CAPTURE_TOL, shape=list(kept["maps"][min(kept["maps"])].shape),
                          cpu_capture_s=cpu_s)), flush=True)
    if not ok:
        raise SystemExit(f"lrc capture against the CPU: {errs} > {LRC_CAPTURE_TOL}")
    return launches


# Data parallelism on the card (`run_data_parallel`): two ranks share the one
# H100, so the phase proves the multi-process path, not a speed-up. Its
# 4 x 60 s rows at dp = 2 (2 rows a rank) against the same request at dp = 1
# (4 rows, the script's handler, the same seed-0 weights): bf16 products at
# another M round differently, and 8 steps carry the difference. The serving
# phase's merged batch (rows at batch 4 against batch 1) read a same-seed PCM
# relative L2 of at most 0.048 (on an H100 80GB HBM3 at 700 W), so both
# the latents and the PCM must lie within twice that, and the largest
# same-seed distance DP_SEPARATION times below the smallest other-seed one.
DP_REL_L2_TOL = 0.1
DP_SEPARATION = MERGE_SEPARATION
DP_SEEDS = [71, 72, 73, 74]
DP_SECONDS = 60.0


def _rel_l2_rows(got: np.ndarray, want: np.ndarray) -> list:
    """[i][j]: relative L2 of row i of `got` against row j of `want`."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    return [[float(np.linalg.norm(g[i] - w[j]) / np.linalg.norm(w[j])) for j in range(len(w))]
            for i in range(len(g))]


def _separated(dist: list) -> tuple:
    same = max(dist[i][i] for i in range(len(dist)))
    other = min(dist[i][j] for i in range(len(dist)) for j in range(len(dist)) if i != j)
    return same, other, same <= DP_REL_L2_TOL and other >= DP_SEPARATION * same


def _dp_rank():
    """One of the two ranks of `run_data_parallel`, spawned by the port's
    launcher: the full-width handler (seed 0, bf16) on this rank's card,
    `enable_mesh(dp=2)` (its replication check timed), then rank 0 runs the
    4 x 60 s request through the service and the handler while rank 1
    follows. Every rank reads its launch counters, peak memory and device;
    rank 0 returns them with the results."""
    from acestep_tpu_torch.parallel.mesh import rank_device
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    torch.backends.cuda.matmul.allow_tf32 = False  # as the script's own process
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device()
    t0 = time.time()
    h = AceStepHandler(device=dev)
    h.initialize_service(random_init=True, seed=0)
    init_s = time.time() - t0
    t0 = time.time()
    h.enable_mesh(dp=2)
    replicate_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counters()
    out = {}
    if h.mesh.is_leader:
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            r = generate_music(h, None, GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=DP_SECONDS,
                                                         thinking=False),
                               GenerationConfig(batch_size=4, seeds=DP_SEEDS), save_audio=False)
            out["service_s"] = time.time() - t0
            if not r.success:
                raise RuntimeError(f"dp = 2 service request failed: {r.error}")
            out["service_pcm"] = np.stack([a["audio"] for a in r.audios])
            out["time_costs"] = r.extra_outputs["time_costs"]
            torch.cuda.synchronize()
            t0 = time.time()
            d = h.generate_music(CAPTION, LYRICS, batch_size=4, audio_duration=DP_SECONDS, seeds=DP_SEEDS,
                                 use_random_seed=False, normalize_db=-1.0, return_int16=True)
            out["direct_s"] = time.time() - t0
            out["latents"], out["pcm"] = d["latents"], d["audios"]
        finally:
            h.stop_followers()
    else:
        h.serve_followers()
    counters = _counters()
    mine = dict(device=str(dev), name=torch.cuda.get_device_name(dev), init_s=init_s, replicate_s=replicate_s,
                launches={k: fn.launches for k, fn in counters.items()},
                narrow_launches={k: counters[k].narrow_launches for k in _OOBLECK},
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    mine["launches"]["flash_attention_f32"] = counters["flash_attention"].f32_launches
    out["ranks"] = h.mesh.gather(mine)
    return out


def _spawned_ranks(pid: int) -> list:
    """Pids of the ranks (`spawn_main`) whose parent is `pid`."""
    pids = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid and b"spawn_main" in cmd:
            pids.append(int(d))
    return pids


def _dp_cli(tmp: str) -> dict:
    """`cli generate --dp 2` (2 x 30 s) and `cli serve --dp 2` (one 2 x 10 s
    job over loopback HTTP, then SIGTERM), each in a subprocess, at once (to
    keep the script inside its time): walls, exit codes, files, and whether
    any of the server's ranks was left."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        generate, serve = pool.submit(_dp_generate, tmp), pool.submit(_dp_serve, tmp)
        return {**generate.result(), **serve.result()}


def _dp_generate(tmp: str) -> dict:
    from acestep_tpu_torch.utils import native_audio

    out = {}
    t0 = time.time()
    gen = _cli("generate", "--random-init", "--dp", "2", "--batch-size", "2", "--duration", "30", "--seed", "5",
               "--caption", CAPTION, "--output-dir", os.path.join(tmp, "gen"))
    try:
        text, _ = gen.communicate(timeout=300)
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    out["generate_s"] = time.time() - t0
    out["generate_exit_code"] = gen.returncode
    files = sorted(f for f in os.listdir(os.path.join(tmp, "gen")) if f.endswith(".flac")) \
        if os.path.isdir(os.path.join(tmp, "gen")) else []
    shapes = [native_audio.flac_decode(open(os.path.join(tmp, "gen", f), "rb").read())[0].shape for f in files]
    out["generate_files_ok"] = shapes == [(2, 30 * 48000)] * 2
    out["generate_tail"] = text.splitlines()[-4:]
    return out


def _dp_serve(tmp: str) -> dict:
    import signal

    from acestep_tpu_torch.utils import native_audio

    out = {}
    log_path = os.path.join(tmp, "serve.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        srv = subprocess.Popen([sys.executable, "-m", "acestep_tpu_torch.cli", "serve", "--random-init", "--dp", "2",
                                "--host", "127.0.0.1", "--port", "0", "--output-dir", os.path.join(tmp, "serve")],
                               cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)
    try:
        port = None
        while port is None:
            for ln in open(log_path).read().splitlines():
                if ln.startswith("listening on 127.0.0.1:"):
                    port = int(ln.rsplit(":", 1)[1])
            if port is None:
                if srv.poll() is not None or time.time() - t0 > 300:
                    raise SystemExit(f"cli serve --dp 2 did not start:\n{open(log_path).read()[-3000:]}")
                time.sleep(0.2)
        out["serve_startup_s"] = time.time() - t0
        ranks = _spawned_ranks(srv.pid)
        t1 = time.time()
        job = list(_wait_jobs(port, [_release(port, duration=10.0, batch_size=2, seed=9)]).values())[0]
        out["serve_job_2x10s_s"] = time.time() - t1
        shapes = [native_audio.flac_decode(open(p, "rb").read())[0].shape for p in job["result"]["audio_paths"]]
        srv.send_signal(signal.SIGTERM)
        out["serve_exit_code"] = srv.wait(timeout=120)
        out["serve_ranks"] = len(ranks)
        out["serve_ranks_left"] = [p for p in ranks if os.path.exists(f"/proc/{p}")]
        out["serve_files_ok"] = shapes == [(2, 10 * 48000)] * 2
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    out["serve_log"] = [ln for ln in open(log_path).read().splitlines()
                        if ln.startswith(("initialized", "mesh enabled", "listening", "interrupted"))]
    return out


def run_data_parallel(h, smi: str):
    """Data parallelism on the card: two ranks spawned through the port's
    launcher (`parallel.mesh.launch`), both on the one H100, each with the
    full-width handler (`_dp_rank`); a 4 x 60 s text2music request at dp = 2
    through `service.inference.generate_music`, and the same through the
    handler for its latents. Each rank's device, launches of kernels 1, 2 and
    3 (each > 0, no narrow-route call), peak memory; the rows held against
    the same requests at dp = 1 on the script's handler `h` (DP_REL_L2_TOL
    and DP_SEPARATION); then `cli generate --dp 2` and `cli serve --dp 2` in
    subprocesses (`_dp_cli`). Returns the two ranks' launches summed."""
    import shutil
    import tempfile

    from acestep_tpu_torch.parallel.mesh import launch
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    torch.cuda.empty_cache()
    if h.lora_status():
        raise SystemExit(f"data parallel: the dp = 1 handler still has adapters {h.lora_status()}")
    t0 = time.time()
    got = launch(_dp_rank, 2, deadline_s=600.0)
    launch_s = time.time() - t0
    ranks = got["ranks"]
    need = ("flash_attention", "decoder_block", "res_units")
    ranks_ok = (len(ranks) == 2 and all(r["device"] == "cuda:0" for r in ranks)
                and all(r["launches"][k] > 0 for r in ranks for k in need)
                and all(not any(r["narrow_launches"].values()) for r in ranks))

    r1 = generate_music(h, None, GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=DP_SECONDS, thinking=False),
                        GenerationConfig(batch_size=4, seeds=DP_SEEDS), save_audio=False)
    if not r1.success:
        raise SystemExit(f"data parallel: the dp = 1 request failed: {r1.error}")
    d1 = h.generate_music(CAPTION, LYRICS, batch_size=4, audio_duration=DP_SECONDS, seeds=DP_SEEDS,
                          use_random_seed=False, normalize_db=-1.0, return_int16=True)
    checks = {}
    for name, a, b in (("service_pcm", got["service_pcm"], np.stack([x["audio"] for x in r1.audios])),
                       ("latents", got["latents"], d1["latents"]), ("pcm", got["pcm"], d1["audios"])):
        finite = bool(np.isfinite(a.astype(np.float64)).all()) and a.shape == b.shape
        dist = _rel_l2_rows(a, b) if finite else None
        same, other, ok = _separated(dist) if finite else (None, None, False)
        checks[name] = dict(ok=ok, shape=list(a.shape), largest_same_seed=same, smallest_other_seed=other,
                            rel_l2=dist)
    rows_ok = all(c["ok"] for c in checks.values())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        cli = _dp_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cli_ok = (cli["generate_exit_code"] == 0 and cli["generate_files_ok"] and cli["serve_exit_code"] == 0
              and cli["serve_files_ok"] and cli["serve_ranks"] == 2 and not cli["serve_ranks_left"])
    ok = ranks_ok and rows_ok and cli_ok
    print(json.dumps(dict(phase="data parallel dp = 2, two ranks on one card (proves the path, not a speed-up)",
                          ok=ok, card=smi, launch_wall_s=launch_s, ranks=ranks, service_s=got["service_s"],
                          direct_s=got["direct_s"], rank0_time_costs=got["time_costs"], tol=DP_REL_L2_TOL,
                          separation=DP_SEPARATION, rows_vs_dp1=checks, cli=cli)), flush=True)
    if not ok:
        raise SystemExit(f"data parallel: ranks {ranks_ok}, rows {rows_ok}, cli {cli_ok}")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


# Sequence and tensor parallelism on the card (`run_sequence_tensor_parallel`):
# four ranks (dp1 x sp2 x tp2) share the one H100, so the phase proves the
# path, not a speed-up. One 1 x 600 s request (7 500 patched tokens, 3 750 a
# rank, 4 006 rows on the sliding layers with their halos) against the same
# request at dp = 1 on the script's handler: tp sums each rowwise product's
# fp32 partials before its one rounding, as one card's GEMM does, and kernel 1
# runs at 8 / 4 heads on local queries; the bf16 sums differ in order only.
# The tolerance is dp's (the latents and the PCM within 0.1), and the
# distance to the same request at another seed must be SP_TP_SEPARATION times
# the same-seed one.
SP_TP_REL_L2_TOL = DP_REL_L2_TOL
SP_TP_SEPARATION = DP_SEPARATION
SP_TP_SEEDS = (81, 82)  # the request's seed; the other seed of the separation
SP_TP_SECONDS = 600.0


def _sp_tp_rank():
    """One of the four ranks of `run_sequence_tensor_parallel`, spawned by
    the port's launcher: the full-width handler (seed 0, bf16) on this rank's
    card, `enable_mesh(dp=1, sp=2, tp=2)` (its digest check and the tp plan
    timed), then rank 0 runs the 1 x 600 s request through the service and
    through the handler while the others follow. Every rank reads its launch
    counters, peak memory, device, the device group's backend and its
    collectives (count, host clock); rank 0 returns them with the results."""
    from acestep_tpu_torch.parallel.mesh import rank_device
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    torch.backends.cuda.matmul.allow_tf32 = False  # as the script's own process
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device()
    t0 = time.time()
    h = AceStepHandler(device=dev)
    h.initialize_service(random_init=True, seed=0)
    init_s = time.time() - t0
    t0 = time.time()
    h.enable_mesh(dp=1, sp=2, tp=2)
    mesh_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counters()
    h.mesh.collective_s, h.mesh.collectives = 0.0, 0
    out = {}
    if h.mesh.is_leader:
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            r = generate_music(h, None, GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=SP_TP_SECONDS,
                                                         thinking=False),
                               GenerationConfig(batch_size=1, seeds=[SP_TP_SEEDS[0]]), save_audio=False)
            out["service_s"] = time.time() - t0
            if not r.success:
                raise RuntimeError(f"sp = 2, tp = 2 service request failed: {r.error}")
            out["service_pcm"] = np.stack([a["audio"] for a in r.audios])
            out["time_costs"] = r.extra_outputs["time_costs"]
            torch.cuda.synchronize()
            t0 = time.time()
            d = h.generate_music(CAPTION, LYRICS, batch_size=1, audio_duration=SP_TP_SECONDS,
                                 seeds=[SP_TP_SEEDS[0]], use_random_seed=False, normalize_db=-1.0,
                                 return_int16=True)
            out["direct_s"] = time.time() - t0
            out["latents"], out["pcm"] = d["latents"], d["audios"]
        finally:
            h.stop_followers()
    else:
        h.serve_followers()
    counters = _counters()
    dec = h.params["decoder"]["layers"][0]
    mine = dict(device=str(dev), coord=h.mesh.coord, backend=h.mesh.backend, init_s=init_s, enable_mesh_s=mesh_s,
                q_proj=list(dec["self_attn"]["q_proj"]["kernel"].shape),
                down_proj=list(dec["mlp"]["down_proj"]["kernel"].shape),
                collectives=h.mesh.collectives, collective_s=h.mesh.collective_s,
                launches={k: fn.launches for k, fn in counters.items()},
                narrow_launches={k: counters[k].narrow_launches for k in _OOBLECK},
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    mine["launches"]["flash_attention_f32"] = counters["flash_attention"].f32_launches
    out["ranks"] = h.mesh.gather(mine)
    return out


def _mesh_cli(tmp: str, flags: list, n_ranks: int, seconds: int) -> dict:
    """`cli generate --random-init <flags> --duration <seconds>` (batch 1)
    in a subprocess: its wall, exit code, file, its load and mesh lines, and
    whether any of its `n_ranks` ranks was left."""
    from acestep_tpu_torch.utils import native_audio

    out = {}
    log_path = os.path.join(tmp, "generate.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        gen = subprocess.Popen([sys.executable, "-m", "acestep_tpu_torch.cli", "generate", "--random-init", *flags,
                                "--duration", str(seconds), "--seed", "5", "--caption", CAPTION,
                                "--output-dir", os.path.join(tmp, "gen")],
                               cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)
    ranks: list = []
    try:
        while gen.poll() is None and time.time() - t0 < 300:
            if len(ranks) < n_ranks:
                ranks = _spawned_ranks(gen.pid)
            time.sleep(0.2)
        if gen.poll() is None:
            raise SystemExit(f"cli generate {' '.join(flags)} ran past 300 s:\n{open(log_path).read()[-3000:]}")
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    out["generate_s"] = time.time() - t0
    out["generate_exit_code"] = gen.returncode
    gen_dir = os.path.join(tmp, "gen")
    files = sorted(f for f in os.listdir(gen_dir) if f.endswith(".flac")) if os.path.isdir(gen_dir) else []
    shapes = [native_audio.flac_decode(open(os.path.join(gen_dir, f), "rb").read())[0].shape for f in files]
    out["generate_files_ok"] = shapes == [(2, seconds * 48000)]
    out["generate_ranks"] = len(ranks)
    out["generate_ranks_left"] = [p for p in ranks if os.path.exists(f"/proc/{p}")]
    text = open(log_path).read()
    out["generate_log"] = [ln for ln in text.splitlines() if ln.startswith(("initialized", "mesh enabled",
                                                                            "planner mesh"))]
    if gen.returncode:
        out["generate_tail"] = text.splitlines()[-20:]
    return out


def run_sequence_tensor_parallel(h, smi: str):
    """Sequence and tensor parallelism on the card: four ranks spawned
    through the port's launcher (`parallel.mesh.launch`), all on the one
    H100, each with the full-width handler (`_sp_tp_rank`) at dp1 x sp2 x
    tp2; a 1 x 600 s text2music request through
    `service.inference.generate_music`, and the same through the handler for
    its latents. Each rank's device, coordinate, decoder slice, launches of
    kernel 1 (> 0 on every rank), kernels 2 and 3 on the decoding rank 0 (and
    none elsewhere), no narrow-route call, the device group's backend, peak
    memory, and its collectives (count, host clock: over gloo a call
    includes the wait for the slowest rank); the rows held against the same
    request at dp = 1 on the script's handler `h` (SP_TP_REL_L2_TOL) and
    SP_TP_SEPARATION from the request at another seed; `cli generate --sp 2
    --tp 2` runs in a subprocess beside them (`_mesh_cli`, to keep the script
    inside its time: the ranks' walls include its share of the card and the
    host). Returns the four ranks' launches summed."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from acestep_tpu_torch.parallel.mesh import launch
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    torch.cuda.empty_cache()
    if h.lora_status():
        raise SystemExit(f"sp / tp: the dp = 1 handler still has adapters {h.lora_status()}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_tp_")
    pool = ThreadPoolExecutor(1)
    try:
        cli_run = pool.submit(_mesh_cli, tmp, ["--sp", "2", "--tp", "2"], 4, 30)
        t0 = time.time()
        got = launch(_sp_tp_rank, 4, deadline_s=600.0)
        launch_s = time.time() - t0
        ranks = got["ranks"]
        full_heads = h.config.num_attention_heads * h.config.head_dim
        ranks_ok = (len(ranks) == 4 and all(r["device"] == "cuda:0" for r in ranks)
                    and [r["coord"] for r in ranks] == [dict(dp=0, sp=s, tp=t) for s in range(2) for t in range(2)]
                    and all(r["q_proj"] == [h.config.hidden_size, full_heads // 2] for r in ranks)
                    and all(r["launches"]["flash_attention"] > 0 and r["collectives"] > 0 for r in ranks)
                    and all((r["launches"][k] > 0) == (i == 0) for i, r in enumerate(ranks)
                            for k in ("decoder_block", "res_units"))
                    and all(not any(r["narrow_launches"].values()) for r in ranks))

        checks = {}
        outs = []
        for seed in SP_TP_SEEDS:
            r1 = generate_music(h, None, GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=SP_TP_SECONDS,
                                                          thinking=False),
                                GenerationConfig(batch_size=1, seeds=[seed]), save_audio=False)
            if not r1.success:
                raise SystemExit(f"sp / tp: the dp = 1 request failed: {r1.error}")
            d1 = h.generate_music(CAPTION, LYRICS, batch_size=1, audio_duration=SP_TP_SECONDS, seeds=[seed],
                                  use_random_seed=False, normalize_db=-1.0, return_int16=True)
            outs.append(dict(service_pcm=np.stack([x["audio"] for x in r1.audios]), latents=d1["latents"],
                             pcm=d1["audios"]))
        for name in ("service_pcm", "latents", "pcm"):
            a = got[name]
            finite = bool(np.isfinite(a.astype(np.float64)).all()) and a.shape == outs[0][name].shape
            same = _rel_l2_rows(a, outs[0][name])[0][0] if finite else None
            other = _rel_l2_rows(a, outs[1][name])[0][0] if finite else None
            ok = finite and same <= SP_TP_REL_L2_TOL and other >= SP_TP_SEPARATION * same
            checks[name] = dict(ok=ok, shape=list(a.shape), same_seed=same, other_seed=other)
        rows_ok = all(c["ok"] for c in checks.values())
        cli = cli_run.result()
    finally:
        pool.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    cli_ok = (cli["generate_exit_code"] == 0 and cli["generate_files_ok"] and cli["generate_ranks"] == 4
              and not cli["generate_ranks_left"])
    ok = ranks_ok and rows_ok and cli_ok
    print(json.dumps(dict(phase="sequence and tensor parallel dp1 x sp2 x tp2, four ranks on one card (proves the "
                                "path, not a speed-up)", ok=ok, card=smi, launch_wall_s=launch_s, ranks=ranks,
                          service_s=got["service_s"], direct_s=got["direct_s"], rank0_time_costs=got["time_costs"],
                          tol=SP_TP_REL_L2_TOL, separation=SP_TP_SEPARATION, rows_vs_dp1=checks, cli=cli)),
          flush=True)
    if not ok:
        raise SystemExit(f"sequence / tensor parallel: ranks {ranks_ok}, rows {rows_ok}, cli {cli_ok}")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


# The narrow planner's sequence log-prob on the card (bf16) against the CPU
# (fp32): relative difference of the total at most this, twice the reading
# (2.3e-6) of the first run on an H100 80GB HBM3 (seeded inputs).
SCORE_REF_TOL = 5e-6


def run_scoring(dev, llm, codes: str):
    """The LM reward score: `calculate_reward_score` with the 4B planner of
    phase 6 on a thinking request's own codes (finite outputs;
    `pmi_normalized`, `topk_recall` and `reward` in [0, 1]; its wall), its
    launches the `scoring` path; then, outside that path, the narrow
    planner of `run_small_thinking_reference` (head_dim 128) on the card in
    bf16 against the CPU in fp32: `sequence_log_prob` of 600 tokens after the
    codes prompt, within SCORE_REF_TOL."""
    import math

    from acestep_tpu_torch.config import Qwen3Config
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.scoring.lm_score import calculate_reward_score, sequence_log_prob

    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    got = calculate_reward_score(llm, CAPTION, LYRICS, codes)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _path_launches("scoring path", ("flash_attention",))
    ok = (all(math.isfinite(v) for v in got.values())
          and all(0.0 <= got[k] <= 1.0 for k in ("pmi_normalized", "topk_recall", "reward")))
    print(json.dumps(dict(phase="LM reward score, 4B planner, a thinking request's codes", ok=ok, wall_s=wall,
                          **got)), flush=True)
    if not ok:
        raise SystemExit(f"LM reward score out of range: {got}")

    cfg = Qwen3Config(vocab_size=1024, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1, head_dim=128)
    card = LLMHandler(cfg, device=dev)
    card.initialize(random_init=True, seed=9)
    cpu = LLMHandler(cfg, dtype=torch.float32, device="cpu")
    cpu.initialize(random_init=True, seed=9)
    cpu.params = _tree_to(card.params, "cpu", torch.float32)
    prompt = card.build_formatted_prompt(CAPTION, LYRICS, generation_phase="codes")
    cont = [int(x) for x in np.random.default_rng(3).integers(0, 256, 600)]
    a, b = sequence_log_prob(card, prompt, cont), sequence_log_prob(cpu, prompt, cont)
    err = abs(a[0] - b[0]) / abs(b[0])
    ok = err <= SCORE_REF_TOL
    print(json.dumps(dict(phase="narrow sequence_log_prob, card bf16 vs CPU fp32", ok=ok, card=a, cpu=b,
                          rel_err=err, tol=SCORE_REF_TOL)), flush=True)
    if not ok:
        raise SystemExit(f"narrow sequence_log_prob: {a} against {b}")
    return launches


# The planner's tensor parallelism on the card (`run_planner_tensor_parallel`):
# two ranks (dp1 x sp1 x tp2) share the one H100, so the phase proves the
# path, not a speed-up. Each rank holds half of the 4B planner's q/k/v/gate/up
# columns and o/down rows; each rowwise product's fp32 partials are summed
# over the two ranks before the one rounding to bf16, as one card's GEMM
# rounds its fp32 accumulators once, so the bf16 activations differ from the
# whole planner's only where the order of an fp32 sum moves a rounding. The
# prefill logits' relative L2 against the whole planner (the script's own, the
# same seed) may be at most this: a bf16 rounding is 2^-9 of a value, and such
# flips compound over 36 layers and their two sums each. Written before the
# first call.
PLANNER_TP_LOGITS_TOL = 5e-2
PLANNER_TP_SEED = 91  # the thinking request's seed
PLANNER_TP_SECONDS = 10.0


def _prefill_logits(llm, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The planner's prefill logits (fp32, on the host) of a right-padded
    prompt batch; a split planner runs it through `LLMHandler.on_line`."""
    from acestep_tpu_torch.models import qwen3

    cache = qwen3.KVCache.create(llm.config, ids.shape[0], ids.shape[1], llm.dtype, llm.device,
                                 qwen3.kv_heads(llm.params, llm.config))
    with torch.inference_mode():
        logits, _ = qwen3.prefill(llm.params, llm.config, llm._tensor(ids), llm._tensor(mask), cache, llm._tp_sum)
    return logits.float().cpu().numpy()


def _planner_prompt(llm):
    """The thinking request's CoT prompts with their CFG row: ids and mask."""
    prompts = [llm.build_formatted_prompt(CAPTION, LYRICS, generation_phase="cot"),
               llm.build_formatted_prompt(CAPTION, LYRICS, is_negative_prompt=True, generation_phase="cot")]
    ids, mask, _ = llm._encode_prompts(prompts, budget=350)
    return ids, mask


def _planner_4b(dev):
    """The 4B planner of `run_thinking_requests` (seed 0), its code range
    pointed at the top 64 000 ids."""
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.params import LM_CONFIGS

    llm = LLMHandler(LM_CONFIGS["4B"], device=dev)
    llm.initialize(random_init=True, seed=0)
    llm.fsm.num_code_tokens = 64_000
    llm.fsm.code_token_start = llm.config.vocab_size - 64_000
    return llm


def _planner_tp_request(h, llm) -> dict:
    """The phase's calls on the planner `llm` (split or whole) and the DiT
    `h` that the whole planner repeats: the CoT prompt's prefill logits, a
    1 x 10 s thinking request through the service and its codes' sequence
    log-prob; with each call's wall."""
    from acestep_tpu_torch.lm.constrained import _encode
    from acestep_tpu_torch.scoring.lm_score import sequence_log_prob
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    out, walls = {}, {}
    ids, mask = _planner_prompt(llm)
    t0 = time.time()
    out["logits"] = llm.on_line(_prefill_logits, ids, mask)
    walls["prefill_s"] = time.time() - t0
    t0 = time.time()
    r = generate_music(h, llm, GenerationParams(caption=CAPTION, lyrics=LYRICS, duration=PLANNER_TP_SECONDS,
                                                seed=PLANNER_TP_SEED, thinking=True),
                       GenerationConfig(batch_size=1, use_random_seed=False, seeds=[PLANNER_TP_SEED]),
                       save_audio=False)
    torch.cuda.synchronize()
    walls["thinking_request_s"] = time.time() - t0
    if not r.success:
        raise RuntimeError(f"thinking request failed: {r.error}")
    out["pcm"] = r.audios[0]["audio"]
    out["cot_text"], out["codes"] = r.extra_outputs.get("cot_text", ""), r.extra_outputs["audio_codes"]
    out["time_costs"] = r.extra_outputs["time_costs"]
    prompt = llm.build_formatted_prompt(CAPTION, LYRICS, generation_phase="codes")
    t0 = time.time()
    out["log_prob"] = sequence_log_prob(llm, prompt, _encode(llm.tokenizer, out["codes"])[:1024])
    walls["log_prob_s"] = time.time() - t0
    out["walls"] = walls
    return out


def _planner_tp_rank():
    """One of the two ranks of `run_planner_tensor_parallel`, spawned by the
    port's launcher: the full-width DiT (seed 0, bf16) at dp1 x sp1 x tp2,
    then the 4B planner split over the same mesh (its digest check and the
    tp plan timed); rank 0 runs `_planner_tp_request` while rank 1 follows.
    Every rank hashes the token ids its planner drew (`LLMHandler._note`) and
    reads its slice shapes, launch counters, collectives, peak memory and
    device; rank 0 returns them with the results."""
    import hashlib

    from acestep_tpu_torch.parallel.mesh import rank_device
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    torch.backends.cuda.matmul.allow_tf32 = False  # as the script's own process
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device()
    t0 = time.time()
    h = AceStepHandler(device=dev)
    h.initialize_service(random_init=True, seed=0)
    h.enable_mesh(dp=1, sp=1, tp=2)
    dit_s = time.time() - t0
    t0 = time.time()
    llm = _planner_4b(dev)
    init_s = time.time() - t0
    t0 = time.time()
    llm.enable_tensor_parallel(h.mesh)
    split_s = time.time() - t0
    drawn = hashlib.sha256()
    counts = {"sequences": 0, "tokens": 0}
    note = llm._note

    def hashed(rows):
        for row in rows:
            row = np.asarray(row, np.int64).reshape(-1)
            drawn.update(row.tobytes() + b"|")
            counts["sequences"] += 1
            counts["tokens"] += int(row.size)
        note(rows)

    llm._note = hashed
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counters()
    h.mesh.collective_s, h.mesh.collectives = 0.0, 0
    out = {}
    if h.mesh.is_leader:
        try:
            out = _planner_tp_request(h, llm)
            before = (h.mesh.collectives, h.mesh.collective_s)
            t0 = time.time()
            draft = llm.create_sample_from_query("a melancholic piano ballad about the sea", temperature=0.85,
                                                 max_new_tokens=64, seed=11)
            # Its prefill and decode steps alone: 2 sums a layer each.
            out["draft"] = dict({k: draft[k] for k in ("text", "route", "tokens")}, seconds=time.time() - t0,
                                collectives=h.mesh.collectives - before[0],
                                collective_s=h.mesh.collective_s - before[1])
        finally:
            h.stop_followers()
    else:
        h.serve_followers()
    counters = _counters()
    layer = llm.params["layers"][0]
    mine = dict(device=str(dev), coord=h.mesh.coord, backend=h.mesh.backend, dit_init_and_mesh_s=dit_s,
                planner_init_s=init_s, enable_tensor_parallel_s=split_s,
                q_proj=list(layer["self_attn"]["q_proj"]["kernel"].shape),
                down_proj=list(layer["mlp"]["down_proj"]["kernel"].shape),
                drawn_sha256=drawn.hexdigest(), drawn=counts,
                collectives=h.mesh.collectives, collective_s=h.mesh.collective_s,
                launches={k: fn.launches for k, fn in counters.items()},
                narrow_launches={k: counters[k].narrow_launches for k in _OOBLECK},
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    mine["launches"]["flash_attention_f32"] = counters["flash_attention"].f32_launches
    out["ranks"] = h.mesh.gather(mine)
    return out


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def run_planner_tensor_parallel(dit, llm, smi: str):
    """The planner's tensor parallelism on the card: two ranks spawned
    through the port's launcher, both on the one H100, each with the
    full-width DiT and the 4B planner split over dp1 x sp1 x tp2
    (`_planner_tp_rank`); rank 0 runs `_planner_tp_request` (a 1 x 10 s
    thinking request through the service, a sequence log-prob) and a
    64-token draft as mesh ops on the planner's line. Beside the ranks, to
    keep the script inside its time, run `cli generate --tp 2 --thinking` in
    a subprocess (`_mesh_cli`) and the whole planner's requests on a thread
    of this process: every wall of the phase includes their share of the
    card and the host. Held: each rank's q_proj and down_proj
    at half width, kernel 1 launched on both ranks, kernels 2 and 3 on rank 0
    only, no narrow-route call, the collectives above 0, and the token ids
    the two ranks drew equal (their hashes); the prefill logits within
    PLANNER_TP_LOGITS_TOL of the script's whole 4B planner `llm` (the same
    seed), whose own `_planner_tp_request` on the script's DiT `dit` gives
    the common prefix of the CoT and of the codes and the log-prob
    difference (reported, not held). Returns the two ranks' launches
    summed."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from acestep_tpu_torch.parallel.mesh import launch

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_planner_tp_")
    try:
        with ThreadPoolExecutor(2) as pool:
            cli_run = pool.submit(_mesh_cli, tmp, ["--tp", "2", "--thinking"], 2, 10)
            whole_run = pool.submit(_planner_tp_request, dit, llm)
            t0 = time.time()
            got = launch(_planner_tp_rank, 2, deadline_s=600.0)
            launch_s = time.time() - t0
            whole, cli = whole_run.result(), cli_run.result()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = got["ranks"]
    cfg = llm.config
    half_q = [cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim // 2]
    half_down = [cfg.intermediate_size // 2, cfg.hidden_size]
    ranks_ok = (len(ranks) == 2 and all(r["device"] == "cuda:0" for r in ranks)
                and all(r["q_proj"] == half_q and r["down_proj"] == half_down for r in ranks)
                and all(r["launches"]["flash_attention"] > 0 and r["collectives"] > 0 for r in ranks)
                and all((r["launches"][k] > 0) == (i == 0) for i, r in enumerate(ranks)
                        for k in ("decoder_block", "res_units"))
                and all(not any(r["narrow_launches"].values()) for r in ranks))
    same_tokens = ranks[0]["drawn"]["tokens"] > 0 and len({(r["drawn_sha256"], r["drawn"]["tokens"])
                                                           for r in ranks}) == 1

    a, b = got["logits"].astype(np.float64), whole["logits"].astype(np.float64)
    rel = [float(np.linalg.norm(a[i] - b[i]) / np.linalg.norm(b[i])) for i in range(len(b))]
    logits_ok = bool(np.isfinite(a).all()) and a.shape == b.shape and max(rel) <= PLANNER_TP_LOGITS_TOL
    code_ids = [dit.parse_audio_codes(c) for c in (got["codes"], whole["codes"])]
    pcm = got["pcm"]
    pcm_ok = pcm.shape == (2, int(PLANNER_TP_SECONDS * 48000)) and int(np.abs(pcm.astype(np.int32)).max()) > 0
    lp = (got["log_prob"][0], whole["log_prob"][0])
    lp_ok = all(np.isfinite(x) for x in lp)
    cli_ok = (cli["generate_exit_code"] == 0 and cli["generate_files_ok"] and cli["generate_ranks"] == 2
              and not cli["generate_ranks_left"]
              and sum(ln.startswith("planner mesh") for ln in cli["generate_log"]) == 1)
    ok = ranks_ok and same_tokens and logits_ok and pcm_ok and lp_ok and cli_ok
    collectives_per_token = 2 * cfg.num_hidden_layers
    print(json.dumps(dict(
        phase="planner tensor parallel dp1 x sp1 x tp2, the 4B planner split over two ranks on one card (proves "
              "the path, not a speed-up)", ok=ok, card=smi, launch_wall_s=launch_s, ranks=ranks,
        same_token_ids=same_tokens, collectives_per_decode_step=collectives_per_token,
        prefill_logits_rel_l2=rel, tol=PLANNER_TP_LOGITS_TOL,
        cot_common_prefix_chars=_common_prefix(got["cot_text"], whole["cot_text"]),
        cot_chars=[len(got["cot_text"]), len(whole["cot_text"])],
        codes_common_prefix=_common_prefix(*code_ids), codes=[len(c) for c in code_ids],
        log_prob_tp_whole=lp, log_prob_rel_diff=abs(lp[0] - lp[1]) / abs(lp[1]) if lp[1] else None,
        draft=got["draft"], rank0_walls=got["walls"], whole_walls=whole["walls"],
        rank0_time_costs=got["time_costs"], whole_time_costs=whole["time_costs"], cli=cli)), flush=True)
    if not ok:
        raise SystemExit(f"planner tensor parallel: ranks {ranks_ok}, same tokens {same_tokens}, logits {logits_ok} "
                         f"({rel}), pcm {pcm_ok}, log-prob {lp_ok}, cli {cli_ok}")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def _encode_kind(name: str) -> str:
    if any(t in name for t in ("conv", "cudnn", "gemm", "xmma", "nvjet", "cutlass", "sm90_", "implicit")):
        return "conv (cuDNN / GEMM)"
    return "other (elementwise: Snakes, bias adds, pads, copies)"


def _vae_encode_profile(h, seconds: int = 20, reps: int = 3) -> dict:
    """One `tiled_encode` chunk at full width (20 s, 960 000 samples, fp32,
    TF32 off as served): host-clock ms per chunk around synchronised calls,
    device ms by kernel kind, kernels per chunk and the device's idle share
    from `torch.profiler`, peak memory of one chunk; then the same chunk
    with cuDNN's TF32 allowed: its time and the relative L2 of its latents
    against the served fp32 ones (a measurement, not the served path)."""
    from acestep_tpu_torch.models import vae

    x = torch.as_tensor(np.ascontiguousarray(_signal(seconds, 34, h.vae_config.sampling_rate).T[None]),
                        device=h.device)
    chunk = lambda: vae.encode_mean(h.vae_params, h.vae_config, x)
    with torch.inference_mode():
        ref = chunk()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(h.device)
        base = torch.cuda.memory_allocated(h.device)
        chunk()
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated(h.device) - base) / 1e9
        t0 = time.time()
        for _ in range(reps):
            chunk()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / reps
        events = kernel_events(chunk, reps)
        # The encoder's body under the script's own flags, TF32 on (encode_raw
        # itself always runs it in strict fp32).
        tf32_chunk = lambda: vae._encode_raw(h.vae_params, h.vae_config, x).chunk(2, dim=-1)[0]
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = tf32_chunk()
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(reps):
                tf32_chunk()
            torch.cuda.synchronize()
            tf32_ms = (time.time() - t0) * 1e3 / reps
        finally:
            torch.backends.cudnn.allow_tf32 = False
        tf32_rel = float((tf32 - ref).norm() / ref.norm())
    dev_ms, n_kernels, kinds, top = _device_summary(events, reps, _encode_kind)
    return dict(samples=x.shape[1], latent_frames=ref.shape[1], wall_ms_per_chunk=wall_ms,
                device_ms_per_chunk=dev_ms, kernels_per_chunk=n_kernels,
                device_idle_share=max(0.0, 1.0 - dev_ms / wall_ms), peak_activation_gb=peak_gb, by_kind=kinds,
                top_kernels=top, tf32_wall_ms_per_chunk=tf32_ms, tf32_latents_rel_l2=tf32_rel)


def _kernel_kind(name: str) -> str:
    if "attention_sm90" in name:
        return "flash"
    if any(t in name for t in ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "wgmma")):
        return "gemm"
    return "other"


def _dit_step_profile(dit_forward, step_args: dict, steps: int = 3) -> dict:
    """One DiT step (`dit_forward`, 24 layers) of the 1 x 600 s request
    (7 500 tokens), replayed on its own arguments: host-clock ms per step
    around synchronised steps, and from `torch.profiler` the device time per
    kernel name and per kind (flash kernel, GEMMs, other: elementwise,
    norms, copies), kernels per step and the device's idle share."""
    if not step_args:
        raise SystemExit("the 600 s request never reached dit_forward at 7 500 tokens")
    run = lambda: dit_forward(*step_args["a"], **step_args["kw"])
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
        events = kernel_events(run, steps, {"attention_sm90": 48})  # 24 layers, self and cross
    dev_ms, n_kernels, kinds, top = _device_summary(events, steps, _kernel_kind)
    return dict(tokens=7500, wall_ms_per_step=wall_ms, device_ms_per_step=dev_ms,
                kernels_per_step=n_kernels, device_idle_share=max(0.0, 1.0 - dev_ms / wall_ms),
                by_kind=kinds, top_kernels=top)


def _device_summary(events: list, reps: int, kind) -> tuple:
    """Device-kernel time per repetition of a profiler window's kernel
    events: total ms, kernels, ms and kernels by `kind(name)`, and the 8
    longest kernels."""
    by_name: dict = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / reps, n + 1)
    kinds: dict = {}
    for name, (ms, n) in by_name.items():
        k = kinds.setdefault(kind(name), dict(ms=0.0, kernels=0.0))
        k["ms"] += ms
        k["kernels"] += n / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return (sum(ms for ms, _ in by_name.values()), sum(n for _, n in by_name.values()) / reps, kinds,
            [dict(name=n[:90], ms=ms, per_rep=c / reps) for n, (ms, c) in top])


def _decode_kind(name: str) -> str:
    if "oobleck_conv_sm90" in name:
        # The stream-K instance <256, false, true> (mangled ...Lb1EE) runs
        # kernel 3's k7 and k1 launches and nothing else.
        if ", true>" in name or "Lb1EE" in name:
            return "kernel3_oobleck_conv_sm90 (stream-K instance: k7 and k1 of block 0's chain)"
        return "kernel2_oobleck_conv_sm90"
    if "snake_kernel" in name:
        return "snake_kernel (input of kernel 2's blocks, unit 1 of kernel 3)"
    if any(t in name for t in ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "conv", "cudnn")):
        return "gemm_conv (plain conv_t of block 0, conv_in, conv_out)"
    return "other (elementwise: plain Snakes, bias adds, casts, _to_pcm)"


def _vae_decode_profile(h, frames: int = 544, reps: int = 3) -> dict:
    """One decode chunk of the 240 s and 600 s requests (544 latent frames:
    core 512 + 2 x 16) through the full-width decoder, as `vae.decode` runs
    it, then `_to_pcm`: device ms per part from CUDA events between the
    parts (conv_in, decoder blocks 0-4, final Snake + conv, `_to_pcm`; block 0
    is Snake + the plain conv_t + kernel 3, blocks 1-4 are kernel 2), the
    whole chunk on the host clock around synchronised calls, and from
    `torch.profiler` the device time by kernel kind, kernels per chunk and
    the device's idle share. A 600 s request decodes 30 such chunks."""
    from acestep_tpu_torch.models import vae
    from acestep_tpu_torch.ops.conv import conv1d

    cfg, d = h.vae_config, h.vae_params["decoder"]
    gen = torch.Generator(device=h.device).manual_seed(5)
    z = torch.randn((1, frames, d["conv1"]["kernel"].shape[1]), generator=gen, device=h.device).to(h.dtype)
    strides = tuple(reversed(cfg.downsampling_ratios))
    names = (["conv_in"] + [f"block{i}" + (" (snake + plain conv_t + kernel 3)" if i == 0 else " (kernel 2)")
                            for i in range(len(strides))] + ["final snake + conv", "_to_pcm"])

    def chunk(marks=None):
        def mark():
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

        mark()
        x = conv1d(z, d["conv1"]["kernel"], d["conv1"].get("bias"), padding=3)
        mark()
        for i, s in enumerate(strides):
            x = vae.decoder_block(d["block"][i], x, s)
            mark()
        x = conv1d(vae.snake(d["snake1"], x), d["conv2"]["kernel"], d["conv2"].get("bias"), padding=3)
        mark()
        h._to_pcm([x], -1.0)
        mark()

    with torch.inference_mode():
        chunk()
        torch.cuda.synchronize()
        parts = [0.0] * len(names)
        for _ in range(reps):
            marks: list = []
            chunk(marks)
            torch.cuda.synchronize()
            for k in range(len(names)):
                parts[k] += marks[k].elapsed_time(marks[k + 1]) / reps
        t0 = time.time()
        for _ in range(reps):
            chunk()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / reps
        # Kernel 3: a Snake and 6 convs; kernel 2: a Snake and 7 convs at 512
        # channels (block 1), a Snake and 4 at 256 and 128 (blocks 2-4).
        events = kernel_events(chunk, reps, {"oobleck_conv_sm90": 25, "snake_kernel": 5})
    dev_ms, n_kernels, kinds, top = _device_summary(events, reps, _decode_kind)
    return dict(frames=frames, wall_ms_per_chunk=wall_ms, parts_ms=dict(zip(names, parts)),
                device_ms_per_chunk=dev_ms, kernels_per_chunk=n_kernels,
                device_idle_share=max(0.0, 1.0 - dev_ms / wall_ms), by_kind=kinds, top_kernels=top)


THINKING_CAPTION = "a lo-fi hip hop beat with dusty vinyl crackle"  # warm-up only


def _decode_profile(llm, rows: int, max_len: int, steps: int = 10) -> dict:
    """The planner's decode step at `rows` batch rows over a `max_len` cache:
    host-clock ms per token around synchronised steps, and from
    `torch.profiler` the device-kernel time and kernel count per token."""
    from acestep_tpu_torch.models import qwen3

    dev = llm.device
    cache = qwen3.KVCache.create(llm.config, rows, max_len, llm.dtype, dev)
    tok = torch.full((rows,), 1000, dtype=torch.int64, device=dev)
    pos = torch.full((rows,), max_len - 64, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for _ in range(3):
            qwen3.decode_step(llm.params, llm.config, tok, pos, cache)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(steps):
            qwen3.decode_step(llm.params, llm.config, tok, pos, cache)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
        events = kernel_events(lambda: qwen3.decode_step(llm.params, llm.config, tok, pos, cache), steps)
    n_kernels = len(events)
    dev_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / steps
    del cache
    return dict(rows=rows, cache_len=max_len, wall_ms_per_token=wall_ms, device_ms_per_token=dev_ms,
                kernels_per_token=n_kernels / steps, device_idle_share=max(0.0, 1.0 - dev_ms / wall_ms))


def run_thinking_requests(dev, dit):
    """Text2music with thinking on at the service defaults (temperature 0.85,
    lm_cfg_scale 2.0, top_p 0.9) and the 4B planner. The byte tokenizer has no
    code tokens, so the FSM's code range is pointed at the top 64 000 ids."""
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.params import LM_CONFIGS
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    counters = _counters()
    llm = LLMHandler(LM_CONFIGS["4B"], device=dev)
    t0 = time.time()
    msg = llm.initialize(random_init=True, seed=0)
    print(json.dumps(dict(phase="LLMHandler 4B initialize", seconds=time.time() - t0, msg=msg)), flush=True)
    llm.fsm.num_code_tokens = 64_000
    llm.fsm.code_token_start = llm.config.vocab_size - 64_000

    # Count the flash launches inside the LM phases.
    lm_flash = {"n": 0}
    orig = llm.generate_with_stop_condition

    def counted_lm(*a, **kw):
        before = counters["flash_attention"].launches
        out = orig(*a, **kw)
        lm_flash["n"] += counters["flash_attention"].launches - before
        return out

    llm.generate_with_stop_condition = counted_lm

    def request(caption, b, seed, seconds=60.0):
        params = GenerationParams(caption=caption, lyrics=LYRICS, duration=seconds, seed=seed, thinking=True)
        cfg = GenerationConfig(batch_size=b, allow_lm_batch=True, use_random_seed=False,
                               seeds=[seed + j for j in range(b)])
        torch.cuda.synchronize()
        t = time.time()
        r = generate_music(dit, llm, params, cfg, save_audio=False)
        torch.cuda.synchronize()
        return r, time.time() - t

    # A 10 s warm-up: the same steps as the timed requests, fewer codes.
    r, wall = request(THINKING_CAPTION, 1, 7, seconds=10.0)
    if not r.success:
        raise SystemExit(f"thinking warm-up failed: {r.error}")
    print(json.dumps(dict(phase="warm-up thinking request b1x10s, other caption (untimed below)",
                          seconds=wall)), flush=True)

    _reset_counters()
    codes = None
    for b, seed in ((1, 200), (2, 300)):
        before = {k: fn.launches for k, fn in counters.items()}
        lm_before = lm_flash["n"]
        r, wall = request(CAPTION, b, seed)
        if not r.success:
            raise SystemExit(f"thinking request b{b}x60s failed: {r.error}")
        codes = codes or r.extra_outputs["audio_codes"]
        pcm = np.stack([a["audio"] for a in r.audios])
        tc = r.extra_outputs["time_costs"]
        n_codes = [len(dit.parse_audio_codes(c or "")) for c in r.extra_outputs["batch_audio_codes"]]
        peak = int(np.abs(pcm.astype(np.int32)).max())
        want = (b, 2, 60 * 48000)
        ok = pcm.dtype == np.int16 and pcm.shape == want and peak > 0 and n_codes == [300] * b
        line = dict(
            phase=f"thinking request b{b}x60s (4B planner)", ok=ok, wall_s=wall, audio_s_per_s=b * 60.0 / wall,
            lm_cot_time_cost=tc.get("lm_cot_time_cost"), lm_codes_time_cost=tc.get("lm_codes_time_cost"),
            codes_ms_per_token=1e3 * tc.get("lm_codes_time_cost", 0.0) / 300,
            n_codes=n_codes, shape=list(pcm.shape), dtype=str(pcm.dtype), peak=peak,
            cot_text=r.extra_outputs.get("cot_text", "")[:400], time_costs=tc,
            lm_flash_launches=lm_flash["n"] - lm_before,
            launches={k: fn.launches - before[k] for k, fn in counters.items()},
        )
        print(json.dumps(line), flush=True)
        if not ok:
            raise SystemExit(f"thinking request b{b}x60s: bad output {pcm.dtype} {pcm.shape} peak {peak} codes {n_codes}")
    launches = _path_launches("thinking path", ("flash_attention", "decoder_block", "res_units"))
    print(json.dumps(dict(phase="thinking path LM-phase flash launches", launches=lm_flash["n"])), flush=True)
    if lm_flash["n"] <= 0:
        raise SystemExit("the planner's prefill never reached the flash kernel")
    llm.generate_with_stop_condition = orig
    for rows in (2, 4):  # CFG rows of a 1 x 60 s and a 2 x 60 s request
        print(json.dumps(dict(phase="4B decode step profile", **_decode_profile(llm, rows, 2048 + 308))),
              flush=True)
        _logits_route(llm, rows)
    return launches, llm, codes


def run_free_form(dit, llm, codes: str):
    """The planner's free-form APIs on the 4B planner of
    `run_thinking_requests`: create_sample, format_sample and understand (on
    the codes of a thinking request) with max_new_tokens=128, then a
    `sample_mode` request (drafted, then a 1 x 30 s turbo request) and an
    `analysis_only` request through the service. The three API calls must
    take the understand grammar's route, their metadata must parse (bpm and
    duration as integers), and the planner's prefill must reach the flash
    kernel."""
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    _reset_counters()
    failed = []
    calls = [
        ("create_sample", lambda: llm.create_sample_from_query(
            "a melancholic piano ballad about the sea", temperature=0.85, max_new_tokens=128, seed=11)),
        ("format_sample", lambda: llm.format_sample_from_input(
            CAPTION + "\n\n# Lyrics\n" + LYRICS, temperature=0.85, max_new_tokens=128, seed=12)),
        ("understand", lambda: llm.understand_audio_from_codes(codes, temperature=0.3, max_new_tokens=128, seed=13)),
    ]
    for name, call in calls:
        torch.cuda.synchronize()
        t0 = time.time()
        out = call()
        torch.cuda.synchronize()
        sec = time.time() - t0
        md, tokens = out["metadata"], out["tokens"]
        ok = isinstance(md.get("bpm"), int) and isinstance(md.get("duration"), int) and out["route"] == "grammar"
        print(json.dumps(dict(phase=f"free-form {name} (4B planner, max_new_tokens 128)", ok=ok, seconds=sec,
                              tokens=tokens, tokens_per_s=tokens / sec, route=out["route"],
                              metadata_keys=sorted(md), text=out["text"][:300])), flush=True)
        if not ok:
            failed.append(name)
    requests = [
        ("sample_mode b1x30s", dict(caption="", sample_mode=True, duration=30.0, thinking=False)),
        ("analysis_only", dict(caption=CAPTION, lyrics=LYRICS, analysis_only=True)),
    ]
    for name, fields in requests:
        torch.cuda.synchronize()
        t0 = time.time()
        r = generate_music(dit, llm, GenerationParams(seed=21, **fields), GenerationConfig(batch_size=1),
                           save_audio=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        md = r.extra_outputs.get("lm_draft" if fields.get("sample_mode") else "lm_metadata") or {}
        tc = r.extra_outputs.get("time_costs", {})
        want_audio = 0 if fields.get("analysis_only") else 1
        ok = r.success and len(r.audios) == want_audio and isinstance(md.get("bpm"), int)
        if want_audio and ok:
            pcm = r.audios[0]["audio"]
            ok = pcm.shape == (2, 30 * 48000) and int(np.abs(pcm.astype(np.int32)).max()) > 0
        print(json.dumps(dict(phase=f"free-form service request {name}", ok=ok, wall_s=wall, error=r.error,
                              lm_draft_time_cost=tc.get("lm_draft_time_cost"),
                              analysis_time_cost=tc.get("analysis_time_cost"),
                              fields=sorted(md), time_costs=tc)), flush=True)
        if not ok:
            failed.append(name)
    launches = _path_launches("free-form path", ("flash_attention",))
    if failed:
        raise SystemExit(f"free-form APIs failed: {failed}")
    return launches


def _logits_route(llm, rows: int) -> None:
    """The fp32 logits product of bf16 operands per decode step (tied
    151 936 x 2 560 table): the port's route (`torch.mm(..., out_dtype=
    torch.float32)`) against upcasting both operands."""
    from acestep_tpu_torch.models import qwen3

    h = torch.randn((rows, 1, llm.config.hidden_size), device=llm.device).to(llm.dtype)
    w = llm.params["embed_tokens"]["weight"]
    with torch.inference_mode():
        got = qwen3.logits_from_hidden(llm.params, llm.config, h)
        ref = h.float() @ w.float().t()
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        port_ms = time_ms(lambda: qwen3.logits_from_hidden(llm.params, llm.config, h), 20)
        upcast_ms = time_ms(lambda: h.float() @ w.float().t(), 20)
    print(json.dumps(dict(phase="4B logits product per token", rows=rows, out_dtype_ms=port_ms,
                          upcast_ms=upcast_ms, rel_err_vs_upcast=err)), flush=True)
    if not err <= 1e-4:  # summation order only; bf16 rounding would be ~4e-3
        raise SystemExit(f"fp32 logits route disagrees with the upcast product: {err}")


# ---------------------------------------------------------------------------
# Training (phase 8)
# ---------------------------------------------------------------------------

# The fp32 route against its plain version (fp32, TF32 off) at the training
# shapes: max abs error at most this, twice the largest reading of the
# route's first, SIMT fp32 kernel (1.55e-6, the full-width cross case at 768
# tokens) on an H100 80GB HBM3 at 700 W; the 3xTF32 kernel is held to the
# same. Both sides sum fp32-accurate products in other orders, and the
# kernel's online softmax rescales its partial sums. The inputs come from the
# script's seeded generator in a fixed order, so a run repeats the reading.
F32_ROUTE_TOL = 3.1e-6
# The narrow config's LoRA loss and gradients, card (fp32 activations, the
# fp32 route, the recompute backward) against the CPU (fp32, plain): relative
# error of the loss, and each gradient's max abs error over its largest entry.
# Twice the first run's largest reading (7.2e-6, a cross-attention v_proj
# gradient; the losses were equal); the inputs are seeded, so a run repeats it.
TRAIN_GRAD_TOL = 1.5e-5
TRAIN_T, TRAIN_L, TRAIN_L_VALID = 1500, 512, 480  # a 60 s sample: latent frames, encoder rows, valid rows


def f32_attention_cases(dev, gen):
    """The training path's attention in fp32. Full width, 16 q / 8 kv heads
    of 128: a 60 s sample is 750 patched tokens, which `PreprocessedDataset`
    pads to 768 (1500 latent frames to 1536) with the tail masked; each of
    sliding w = 128, full, and cross onto 512 encoder rows (480 valid) at 750
    tokens and at the padded 768 the run feeds the kernel. The narrow config
    of `run_train_grads` (1024 frames: 512 tokens, 2 / 1 heads; cross onto
    300 keys), batch 2 with the second row padded."""

    def qkv(b, lq, lk, nq, nkv):
        mk = lambda l, n: torch.randn((b, l, n, 128), generator=gen, device=dev)
        return mk(lq, nq), mk(lk, nkv), mk(lk, nkv)

    def prefix(l, *valid):
        m = torch.zeros((len(valid), l), dtype=torch.int32, device=dev)
        for i, n in enumerate(valid):
            m[i, :n] = 1
        return m

    enc = prefix(TRAIN_L, TRAIN_L_VALID)
    full_width = []
    for l, lat in ((750, prefix(750, 750)), (768, prefix(768, 750))):
        full_width += [
            (f"dit_self_sliding_60s_train_{l}", qkv(1, l, l, 16, 8), dict(kv_mask=lat, window=128)),
            (f"dit_self_full_60s_train_{l}", qkv(1, l, l, 16, 8), dict(kv_mask=lat)),
            (f"dit_cross_60s_train_{l}", qkv(1, l, TRAIN_L, 16, 8), dict(kv_mask=enc)),
        ]
    return full_width + [
        ("narrow_self_sliding_train", qkv(2, 512, 512, 2, 1), dict(kv_mask=prefix(512, 512, 500), window=128)),
        ("narrow_self_full_train", qkv(2, 512, 512, 2, 1), dict(kv_mask=prefix(512, 512, 500))),
        ("narrow_cross_train", qkv(2, 512, 300, 2, 1), dict(kv_mask=prefix(300, 300, 260))),
    ]


def run_f32_attention_phase(dev, gen, results):
    """Kernel 1's fp32 route against its plain version at the training
    shapes: error, CUDA-event and profiler times, the plain version's time,
    SDPA on the same fp32 inputs and boolean mask, and two bounds against
    the bytes at 3.35 TB/s: `bound_ms` with the fp32 operations at 67 TFLOP/s
    (SIMT), `bound_3xtf32_ms` at 495 / 3 TFLOP/s (three TF32 products a
    product, as the kernel computes), with `share_of_3xtf32_bound` (the
    bound over `kernel_ms`). The kernels line sums the 3xTF32 bound. The
    kernel's CTAs an SM are read first (its design asks for 2)."""
    import torch.nn.functional as F

    from acestep_tpu_torch.ops.attention import make_attention_bias
    from acestep_tpu_torch.ops.flash_attention import f32_ctas_per_sm, flash_attention, flash_attention_plain

    ctas = f32_ctas_per_sm()
    print(json.dumps(dict(phase="flash_attention_f32 occupancy", ctas_per_sm=ctas,
                          sms=torch.cuda.get_device_properties(dev).multi_processor_count)), flush=True)

    for name, (q, k, v), kw in f32_attention_cases(dev, gen):
        run = lambda: flash_attention(q, k, v, kw["kv_mask"], window=kw.get("window"))
        before = flash_attention.f32_launches
        out = run()
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, kw["kv_mask"], window=kw.get("window"))
        err = (out - ref).abs().max().item()
        ok = bool(err <= F32_ROUTE_TOL) and bool(torch.isfinite(out).all()) and out.dtype == torch.float32 \
            and flash_attention.f32_launches == before + 1
        mask = make_attention_bias(q.shape[1], k.shape[1], kv_mask=kw["kv_mask"], window=kw.get("window"), device=dev)
        pairs = mask.expand(q.shape[0], 1, q.shape[1], k.shape[1]).sum().item()
        flops = 4.0 * pairs * q.shape[2] * q.shape[3]
        moved = nbytes(q, k, v, out) + kw["kv_mask"].numel() * 4
        b_ms, b_by = bound_ms(flops, moved, PEAK_F32_FLOPS)
        b3_ms, b3_by = bound_ms(flops, moved, PEAK_TF32_FLOPS / 3)
        k_ms = time_ms(run, 20)
        d_ms = device_ms(run, 10, {"flash_f32_kernel": 1})
        p_ms = time_ms(lambda: flash_attention_plain(q, k, v, kw["kv_mask"], window=kw.get("window")), 3)
        # Yardstick only: SDPA on the same fp32 inputs (the port never calls it).
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = q.shape[2] // k.shape[2]
        kt, vt = kt.repeat_interleave(reps, 1), vt.repeat_interleave(reps, 1)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 20)
        del qt, kt, vt
        line = dict(phase=f"kernel flash_attention_f32 {name}", ok=ok, max_abs_err=err, tol=F32_ROUTE_TOL,
                    kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                    bound_3xtf32_ms=b3_ms, bound_3xtf32_by=b3_by, share_of_3xtf32_bound=b3_ms / k_ms,
                    tflops=flops / (d_ms * 1e9), ctas_per_sm=ctas, shapes=dict(q=list(q.shape), k=list(k.shape)))
        print(json.dumps(line), flush=True)
        results.setdefault("flash_attention_f32", []).append(line)
        if not ok:
            raise SystemExit(f"flash_attention_f32 {name}: max_abs_err {err} > {F32_ROUTE_TOL}")


def _backward_vs_plain(dev, dtype, lq, lk, kw) -> float:
    """Max |difference| of q, k, v gradients: `FlashAttention` (the kernel's
    forward, the recompute backward) against the plain path under autograd,
    with a loss linear in the output (so the two backwards see the same
    cotangent). 0 when they agree bit for bit."""
    from acestep_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev).manual_seed(lq + lk)
    base = [torch.randn((1, l, n, 128), generator=g, device=dev).to(dtype) for l, n in ((lq, 16), (lk, 8), (lk, 8))]
    w = torch.randn((1, lq, 16, 128), generator=g, device=dev)
    grads = []
    for flash in (True, False):
        attn.set_flash_enabled(flash)
        try:
            leaves = [x.clone().requires_grad_(True) for x in base]
            (attn.attention(*leaves, **kw).float() * w).sum().backward()
            grads.append([x.grad.float() for x in leaves])
        finally:
            attn.set_flash_enabled(None)
    return max((a - b).abs().max().item() for a, b in zip(*grads))


def run_train_grads(dev):
    """The LoRA loss and gradients at the narrow config (head_dim 128, so
    kernel 1 fires): 2 x 1024 latent frames (512 patched tokens, the second
    row 1000 valid), 300 encoder rows (260 valid in the second row), rank 8
    over every target with nonzero B, fp32 weights, the same draws. Card
    against the CPU; then `FlashAttention`'s backward against the plain
    path's autograd on the card, bf16 and fp32, at the full-width training
    shapes."""
    from acestep_tpu_torch.ops.flash_attention import flash_attention
    from acestep_tpu_torch.params import init_acestep_params
    from acestep_tpu_torch.training.lora import init_lora_params
    from acestep_tpu_torch.training.train_step import sample_draws, value_and_grad
    from acestep_tpu_torch.training.trainer import LoRAConfig, TrainingConfig, decoder_flow_matching_loss, to_device_batch
    from acestep_tpu_torch.utils.precision import strict_fp32

    cfg = _small_cfgs()[0]
    params = init_acestep_params(cfg, seed=7, device=dev, dtype=torch.float32)
    lora = init_lora_params(8, params["decoder"], rank=8)
    gen = torch.Generator().manual_seed(9)
    for ab in lora.values():
        ab["b"] = (torch.randn(ab["b"].shape, generator=gen) * 0.05).to(dev)
    rng = np.random.default_rng(10)
    b, t, l = 2, 1024, 300
    batch = {
        "target_latents": rng.standard_normal((b, t, 64)).astype(np.float32),
        "context_latents": rng.standard_normal((b, t, 128)).astype(np.float32),
        "attention_mask": np.ones((b, t), np.int32),
        "encoder_hidden_states": rng.standard_normal((b, l, cfg.hidden_size)).astype(np.float32),
        "encoder_attention_mask": np.ones((b, l), np.int32),
    }
    batch["attention_mask"][1, 1000:] = 0
    batch["encoder_attention_mask"][1, 260:] = 0
    draws = sample_draws(torch.Generator().manual_seed(11), (b, t, 64))
    lcfg, tcfg = LoRAConfig(rank=8, alpha=8.0), TrainingConfig(cfg_ratio=float(draws["u"].mean()))

    def loss_and_grads(p, factors, device):
        tb = to_device_batch(batch, device)
        fn = lambda fac: decoder_flow_matching_loss(fac, p["decoder"], p["null_condition_emb"], cfg, lcfg, tcfg, tb,
                                                    draws=draws)
        with strict_fp32():
            return value_and_grad(fn, factors)

    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    loss_c, g_c = loss_and_grads(params, lora, dev)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    f32 = flash_attention.f32_launches
    loss_h, g_h = loss_and_grads(_tree_to(params, "cpu", torch.float32), _tree_to(lora, "cpu", torch.float32), "cpu")
    loss_err = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    grad_errs = {p: max((g_c[p][f].cpu() - g_h[p][f]).abs().max().item() / max(g_h[p][f].abs().max().item(), 1e-30)
                        for f in g_h[p]) for p in g_h}
    worst = max(grad_errs, key=grad_errs.get)
    expected = 2 * cfg.num_hidden_layers  # one self and one cross launch a layer, none in the backward
    bwd = {f"{dt}_{name}": _backward_vs_plain(dev, getattr(torch, dt), 768, lk, kw)
           for dt in ("bfloat16", "float32")
           for name, lk, kw in (("sliding", 768, dict(window=128)), ("cross", TRAIN_L, {}))}
    ok = (loss_err <= TRAIN_GRAD_TOL and grad_errs[worst] <= TRAIN_GRAD_TOL and f32 == expected
          and all(v == 0.0 for v in bwd.values()) and bool(torch.isfinite(loss_c)))
    print(json.dumps(dict(phase="training grads narrow card vs CPU fp32 (LoRA rank 8)", ok=ok, loss_card=float(loss_c),
                          loss_cpu=float(loss_h), loss_rel_err=loss_err, max_grad_rel_err=grad_errs[worst],
                          worst_leaf=worst, median_grad_rel_err=float(np.median(list(grad_errs.values()))),
                          tol=TRAIN_GRAD_TOL, f32_launches=f32, f32_launches_expected=expected, card_s=card_s,
                          flash_backward_vs_plain_max_abs=bwd)), flush=True)
    if not ok:
        raise SystemExit("training gradients: the card disagrees with the CPU or the plain backward")


def _write_samples(out_dir: str, hidden: int, n: int = 4, seed: int = 21) -> None:
    """`n` synthetic fp32 training samples of 60 s through `save_sample` and
    `write_manifest`: unit-gaussian latents and encoder rows, context
    latents of gaussian source latents and a chunk mask of ones."""
    from acestep_tpu_torch.training.dataset import save_sample, write_manifest

    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        enc_mask = np.zeros((TRAIN_L,), np.int32)
        enc_mask[:TRAIN_L_VALID] = 1
        sample = {
            "target_latents": rng.standard_normal((TRAIN_T, 64)).astype(np.float32),
            "encoder_hidden_states": rng.standard_normal((TRAIN_L, hidden)).astype(np.float32),
            "encoder_attention_mask": enc_mask,
            "context_latents": np.concatenate([rng.standard_normal((TRAIN_T, 64)), np.ones((TRAIN_T, 64))],
                                              axis=1).astype(np.float32),
            "attention_mask": np.ones((TRAIN_T,), np.int32),
        }
        save_sample(os.path.join(out_dir, f"sample_{i}.npz"), sample)
        entries.append({"file": f"sample_{i}.npz"})
    write_manifest(out_dir, entries)


def _timed_steps(trainer, batches) -> tuple:
    """Run `trainer.train(batches)`: (seconds of each step, losses)."""
    times, losses = [], []
    torch.cuda.synchronize()
    t0 = time.time()
    for _, loss, _ in trainer.train(batches):
        torch.cuda.synchronize()  # the step has read its loss back; this is for the clock's sake
        now = time.time()
        times.append(now - t0)
        losses.append(loss)
        t0 = now
    return times, losses


def run_lora_training(h, smi: str):
    """A full-width LoRA run through `LoRATrainer.train` on the handler's
    random bf16 turbo decoder, rank 32, alpha 32, fp32 batches of 60 s
    samples: 6 steps at batch 1 (warmup 2); then MultiSteps over 2 x 2
    micro-batches at batch 2; then one step with a NaN in target_latents,
    which must keep the factors, count in `nonfinite_steps` and log null.
    Then the adapter.npz the run wrote is served: a 1 x 30 s request with it
    loaded must equal, bit for bit, the same request on the decoder with the
    adapter merged in (`merge_lora`). Returns the training path's launches
    and the serving path's."""
    import shutil
    import tempfile

    from acestep_tpu_torch.ops.flash_attention import flash_attention
    from acestep_tpu_torch.training.dataset import PreprocessedDataset
    from acestep_tpu_torch.training.lora import merge_lora
    from acestep_tpu_torch.training.trainer import LoRAConfig, LoRATrainer, TrainingConfig, load_adapter

    tmp = tempfile.mkdtemp(prefix="acestep_train_")
    base = h.params
    try:
        t0 = time.time()
        _write_samples(tmp, h.config.hidden_size)
        write_s = time.time() - t0
        ds = PreprocessedDataset(tmp)
        run_dir = os.path.join(tmp, "run")
        lcfg = LoRAConfig(rank=32, alpha=32.0)
        tcfg = TrainingConfig(learning_rate=1e-4, warmup_steps=2, max_steps=6, checkpoint_every=1000, log_every=1,
                              output_dir=run_dir)
        _reset_counters()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = LoRATrainer(base, h.config, lcfg, tcfg)
        times, losses = _timed_steps(trainer, ds.batches(1, seed=0))
        peak_b1 = torch.cuda.max_memory_allocated()
        f32_run1 = flash_attention.f32_launches

        acc_cfg = TrainingConfig(learning_rate=1e-4, warmup_steps=1, max_steps=4, checkpoint_every=1000, log_every=1,
                                 gradient_accumulation_steps=2, output_dir=os.path.join(tmp, "accum"))
        torch.cuda.reset_peak_memory_stats()
        acc = LoRATrainer(base, h.config, lcfg, acc_cfg)
        acc_times, acc_losses = _timed_steps(acc, ds.batches(2, seed=1))
        peak_b2 = torch.cuda.max_memory_allocated()
        del acc_times
        acc_state = (int(acc.opt_state["gradient_step"]), int(acc.opt_state["mini_step"]))
        del acc

        before = {p: {k: v.clone() for k, v in ab.items()} for p, ab in trainer.lora.items()}
        nan_batch = next(ds.batches(1, shuffle=False))
        nan_batch["target_latents"][0, 10, 3] = np.nan
        trainer.tcfg.max_steps = 7
        _, nan_losses = _timed_steps(trainer, iter([nan_batch]))
        kept = all(torch.equal(v, before[p][k]) for p, ab in trainer.lora.items() for k, v in ab.items())
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        forwards = len(times) + len(acc_losses) + len(nan_losses)
        launches = _path_launches("training path", ("flash_attention_f32",))
        adapter = os.path.join(run_dir, "adapter.npz")
        adapter_bytes = os.path.getsize(adapter)
        ckpt_bytes = os.path.getsize(os.path.join(run_dir, "checkpoints", "step_7.pt"))
        finite = all(x is not None and np.isfinite(x) for x in losses + acc_losses)
        step_ms = float(np.median(times[1:])) * 1e3
        ok = (finite and len(losses) == 6 and len(acc_losses) == 4 and acc_state == (2, 0)
              and nan_losses == [None] and trainer.nonfinite_steps == 1 and kept
              and rows[-1]["loss"] is None and rows[-1]["nonfinite_steps"] == 1
              and launches["flash_attention_f32"] == 48 * forwards and f32_run1 == 48 * 6
              and launches["flash_attention"] == 0)
        print(json.dumps(dict(
            phase="lora training full width (turbo decoder bf16, rank 32, fp32 60 s samples)", ok=ok, card=smi,
            step_ms_median_2_6=step_ms, step_s=times, losses=losses, accum_losses=acc_losses,
            accum_gradient_step_mini_step=list(acc_state), nan_step_losses=nan_losses,
            nonfinite_steps=trainer.nonfinite_steps, factors_kept_on_nan=kept, metrics_last=rows[-1],
            resident_before_gib=resident / 2**30, peak_allocated_b1_gib=peak_b1 / 2**30,
            peak_allocated_b2_gib=peak_b2 / 2**30, forwards=forwards, f32_launches=launches["flash_attention_f32"],
            f32_launches_expected=48 * forwards, samples_write_s=write_s, adapter_file_bytes=adapter_bytes,
            checkpoint_file_bytes=ckpt_bytes, tokens=768, tokens_valid=750)), flush=True)
        if not ok:
            raise SystemExit("lora training: a check failed")

        # Serve the adapter the run wrote.
        _reset_counters()
        kw = dict(audio_duration=30.0, seeds=[LORA_SEED], use_random_seed=False)
        h.load_lora("trained", adapter)
        try:
            on = h.generate_music(CAPTION, LYRICS, **kw)["latents"]
        finally:
            h.unload_lora("trained")
            h.lora.invalidate_cache()
        served = _path_launches("trained adapter path", ("flash_attention", "decoder_block", "res_units"))
        off = h.generate_music(CAPTION, LYRICS, **kw)["latents"]
        factors, meta = load_adapter(adapter, device=h.device)
        h.params = {**base, "decoder": merge_lora(base["decoder"], factors, alpha=meta["alpha"], rank=meta["rank"])}
        merged = h.generate_music(CAPTION, LYRICS, **kw)["latents"]
    finally:
        h.params = base
        shutil.rmtree(tmp, ignore_errors=True)
    rel = float(np.linalg.norm(on - off) / max(np.linalg.norm(off), 1e-12))
    ok = (bool(np.array_equal(on, merged)) and not np.array_equal(on, off) and bool(np.isfinite(on).all())
          and meta["step"] == 7)
    print(json.dumps(dict(phase="trained adapter served b1x30s", ok=ok, on_equals_merged=bool(np.array_equal(on, merged)),
                          rel_l2_on_base=rel, meta=meta)), flush=True)
    if not ok:
        raise SystemExit("trained adapter: the served request differs from the merged decoder's")
    return launches, served


# The REST training phase: the run's steps (enough that it spans the two jobs
# served beside it) and the served requests' seeds.
REST_TRAIN_STEPS = 30
REST_T2M_SEED, REST_COVER_SEED = 11, 12
REST_LABEL_TOKENS = 128
# The largest job the memory policy lets the server take on an 80 GB card
# (batch 8, 600 s), served beside a rank-32 run.
REST_BIG_BATCH, REST_BIG_S = 8, 600


def _timed(cls, name: str, took: list) -> None:
    """Wrap `cls.name` so that each call appends its seconds to `took` (the
    caller puts the original back)."""
    real = getattr(cls, name)

    def timed(*a, **kw):
        t0 = time.time()
        try:
            return real(*a, **kw)
        finally:
            took.append(time.time() - t0)

    setattr(cls, name, timed)


def _json_call(port: int, method: str, path: str, body=None) -> dict:
    status, out, _ = _http(port, method, path, body)
    if status != 200:
        raise SystemExit(f"rest training: {method} {path} answered {status}: {out[:300]}")
    return json.loads(out)


def _poll_json(port: int, method: str, path: str, body, done, what: str, deadline_s: float = 300.0) -> dict:
    t_end = time.time() + deadline_s
    while True:
        out = _json_call(port, method, path, body)
        if done(out):
            return out
        if time.time() > t_end:
            raise SystemExit(f"rest training: {what} not done after {deadline_s} s: {str(out)[:300]}")
        time.sleep(0.05)


def _cli(*args) -> subprocess.Popen:
    """`python -m acestep_tpu_torch.cli ARGS` from the checkout's root, output captured."""
    return subprocess.Popen([sys.executable, "-m", "acestep_tpu_torch.cli", *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=os.path.dirname(os.path.abspath(__file__)))


def run_rest_training(h, llm, smi: str):
    """The dataset builder and a LoRA run through the REST server, beside
    serving, on the full-width bf16 handler and the 4B planner `llm` (random
    weights), with cuDNN's TF32 at PyTorch's default (on) for the phase.

      songs: three 60 s stereo 48 kHz WAVs: one with .caption.txt and
        .lyrics.txt, one with a .json, one with nothing; the server serves a
        1 x 30 s text2music job and a 1 x 30 s cover job of the first song
        (WAV files), and their latents and PCM are the reference;
      build: `/v1/train/build_dataset` with `label_with_lm`: every song
        labelled by the planner (understand on its codes, at most
        REST_LABEL_TOKENS tokens) and preprocessed, each sample under the
        server's model_lock; seconds per sample of each, the manifest,
        kernel 1's bf16 launches on this path; the text2music job again,
        submitted while the first sample's label holds model_lock: it must
        end before the build does (it waits for one sample, not the
        dataset) and equal the reference bit for bit; its wall;
      train: `/v1/train/start` (rank 32, REST_TRAIN_STEPS steps, fp32 on the
        bf16 decoder, no model_lock); while it is `running` (before the first
        job is submitted and after the second ends) the two jobs again: their
        latents and PCM must equal the reference bit for bit. Step times
        under the server (metrics.jsonl), the peak max_memory_allocated, the
        fp32 launches (48 a step);
      then status to completed, `/v1/train/export`, `/v1/lora/load`, one
        1 x 30 s job with the adapter (finite, not the base's latents), the
        `/v1/dataset/{scan,samples,sample/0 (PUT),preprocess_async,
        preprocess_status}` round; a second rank-32 run, and while it is
        `running` the largest job the memory policy lets the server take
        (batch REST_BIG_BATCH x REST_BIG_S s, thinking off, the 4B planner
        resident): its wall and the peak max_memory_allocated over the run
        and the job, beside the card's memory and the KV cache a thinking
        job of that size would add in its planner phase (computed from the
        4B config); then `stop` on that run;
      cli: `profile` (1 x 30 s, 8 steps), `profile --lm` (batches 1 and 2, 64
        tokens), `build-dataset` on the songs and `verify-checkpoint` on
        tests/goldens/checkpoint_tiny, as four subprocesses at once: each
        exits 0 (verify-checkpoint's code is the CPU test's), rows with the
        JAX command's keys.

    Returns the launches of the build path, the training path (the run and
    the jobs served beside it), the adapter's job and the explorer round."""
    import shutil
    import tempfile
    import threading

    from acestep_tpu_torch.ops.flash_attention import flash_attention
    from acestep_tpu_torch.service.api_server import serve
    from acestep_tpu_torch.training.dataset_builder import DatasetBuilder
    from acestep_tpu_torch.utils.audio import save_wav

    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the guard, not the script, keeps fp32 strict
    tmp = tempfile.mkdtemp(prefix="acestep_rest_train_")
    songs = os.path.join(tmp, "songs")
    os.makedirs(songs)
    for i, name in enumerate(("captioned", "described", "bare")):
        save_wav(os.path.join(songs, f"{name}.wav"), _signal(60.0, 40 + i, h.vae_config.sampling_rate))
    with open(os.path.join(songs, "captioned.caption.txt"), "w") as f:
        f.write(CAPTION)
    with open(os.path.join(songs, "captioned.lyrics.txt"), "w") as f:
        f.write(LYRICS)
    with open(os.path.join(songs, "described.json"), "w") as f:
        json.dump({"caption": "a slow piano ballad", "bpm": 72, "keyscale": "E minor", "language": "en"}, f)
    # Random weights rarely stop before the API's 512-token budget, at ≈ 48 ms
    # a token (host-bound); a label takes REST_LABEL_TOKENS at most here.
    understand = llm.understand_audio_from_codes
    llm.understand_audio_from_codes = lambda codes, **kw: understand(
        codes, **{**kw, "max_new_tokens": REST_LABEL_TOKENS})
    server = serve(h, llm, "127.0.0.1", 0, output_dir=os.path.join(tmp, "out"))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    latents = []
    real_generate = h.generate_music

    def generate_spy(*a, **kw):
        out = real_generate(*a, **kw)
        latents.append(out["latents"])
        return out

    def serve_pair():
        """The text2music job, then the cover job: (latents, WAV bytes, walls)."""
        got, walls = [], []
        for fields in (dict(seed=REST_T2M_SEED),
                       dict(seed=REST_COVER_SEED, task_type="cover",
                            src_audio=os.path.join(songs, "captioned.wav"))):
            t0 = time.time()
            tid = _release(port, duration=30.0, audio_format="wav", **fields)
            res = _wait_jobs(port, [tid])[tid]
            walls.append(time.time() - t0)
            with open(res["result"]["audio_paths"][0], "rb") as f:
                got.append((latents[-1], f.read()))
        return got, walls

    real_label, real_pre = DatasetBuilder.label_all, DatasetBuilder.preprocess_to_tensors
    real_convert = h.convert_audio_to_codes
    label_s, pre_s = [], []
    h.generate_music = generate_spy
    try:
        ref, ref_walls = serve_pair()

        # ---- the dataset builder under the server ----
        ds = os.path.join(tmp, "tensors")
        _timed(DatasetBuilder, "label_all", label_s)
        _timed(DatasetBuilder, "preprocess_to_tensors", pre_s)
        labelling = threading.Event()

        def convert_audio_to_codes(*a, **kw):  # inside the builder's hold of model_lock
            labelling.set()
            return real_convert(*a, **kw)

        h.convert_audio_to_codes = convert_audio_to_codes
        _reset_counters()
        t0 = time.time()
        build = {}
        builder = threading.Thread(target=lambda: build.update(out=_json_call(
            port, "POST", "/v1/train/build_dataset", {"audio_dir": songs, "output_dir": ds, "label_with_lm": True})))
        builder.start()
        if not labelling.wait(300):
            raise SystemExit("rest dataset build: no label began")
        t1 = time.time()
        tid = _release(port, duration=30.0, seed=REST_T2M_SEED, audio_format="wav")
        _wait_jobs(port, [tid])
        job_wall_during_build = time.time() - t1
        job_before_build = builder.is_alive()
        with open(_wait_jobs(port, [tid])[tid]["result"]["audio_paths"][0], "rb") as f:
            job_same = bool(np.array_equal(latents[-1], ref[0][0])) and f.read() == ref[0][1]
        builder.join(600)
        build_s = time.time() - t0
        built = build["out"]
        DatasetBuilder.label_all, DatasetBuilder.preprocess_to_tensors = real_label, real_pre
        del h.convert_audio_to_codes
        build_launches = _path_launches("dataset build path (and the job served during it)",
                                        ("flash_attention",))
        with open(os.path.join(ds, "manifest.json")) as f:
            manifest = json.load(f)["samples"]
        with open(os.path.join(songs, "labels.json")) as f:
            labels = json.load(f)
        by = {row["filename"]: row for row in labels}
        ok = (built["samples"] == 3 and [m["file"] for m in manifest] == ["bare.npz", "captioned.npz",
                                                                            "described.npz"]
              and all(row["label_source"] == "lm" and row["labeled"] for row in labels)
              and by["captioned.wav"]["caption"] == CAPTION and by["described.wav"]["bpm"] == 72
              and len(label_s) == len(pre_s) == 1 and job_before_build and job_same)
        print(json.dumps(dict(
            phase="rest dataset build (3 x 60 s, label_with_lm on the 4B planner)", ok=ok, card=smi,
            label_tokens_max=REST_LABEL_TOKENS, build_s=build_s,
            job_wall_during_build_s=job_wall_during_build, job_wall_alone_s=ref_walls[0],
            job_ended_before_build=job_before_build, job_equal_reference_bit_for_bit=job_same,
            label_s_per_sample=label_s[0] / 3 if label_s else None,
            preprocess_s_per_sample=pre_s[0] / 3 if pre_s else None, manifest=manifest,
            labels=[{k: row[k] for k in ("filename", "caption", "bpm", "keyscale", "language", "label_source")}
                    for row in labels],
            label_log=built["label_log"], flash_bf16_launches=build_launches["flash_attention"])), flush=True)
        if not ok:
            raise SystemExit(f"rest dataset build: {built}")
        with np.load(os.path.join(ds, "captioned.npz")) as z:
            sample = {k: z[k] for k in z.files}
        if sample["target_latents"].shape != (1500, 64) or not all(np.isfinite(v).all() for v in sample.values()):
            raise SystemExit(f"rest dataset build: bad tensors {[(k, v.shape) for k, v in sample.items()]}")

        # ---- a training run beside serving ----
        run_dir = os.path.join(tmp, "run")
        _reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_id = _json_call(port, "POST", "/v1/train/start", {
            "dataset_dir": ds, "rank": 32, "alpha": 32.0, "max_steps": REST_TRAIN_STEPS, "seed": 0,
            "checkpoint_every": 1000, "output_dir": run_dir})["run_id"]
        status = lambda: _json_call(port, "POST", "/v1/train/status", {"run_id": run_id})
        st = _poll_json(port, "POST", "/v1/train/status", {"run_id": run_id},
                        lambda st: st["status"] != "starting" and st["step"] >= 1, "the first step")
        running_before, step_before = st["status"] == "running", st["step"]
        during, during_walls = serve_pair()
        st = status()
        running_after, step_after = st["status"] == "running", st["step"]
        st = _poll_json(port, "POST", "/v1/train/status", {"run_id": run_id},
                        lambda st: st["status"] != "running", "the run")
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        train_launches = _path_launches("rest training path (the run and the jobs beside it)",
                                        ("flash_attention", "flash_attention_f32", "decoder_block", "res_units"))
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        step_ms = [(b["time"] - a["time"]) * 1e3 / (b["step"] - a["step"]) for a, b in zip(rows, rows[1:])]
        same = [bool(np.array_equal(g[0], r[0])) and g[1] == r[1] for g, r in zip(during, ref)]
        ok = (running_before and running_after and all(same) and st["status"] == "completed"
              and st["step"] == REST_TRAIN_STEPS and flash_attention.f32_launches == 48 * REST_TRAIN_STEPS
              and all(np.isfinite(row["loss"]) for row in rows))
        print(json.dumps(dict(
            phase="rest training beside serving (rank 32, fp32 on the bf16 decoder, TF32 on by default)", ok=ok,
            card=smi, running_before_first_job=running_before, step_before=step_before,
            running_after_second_job=running_after, step_after=step_after, final=st["status"], steps=st["step"],
            jobs_equal_reference_bit_for_bit=dict(text2music=same[0], cover=same[1]),
            reference_job_walls_s=ref_walls, job_walls_beside_training_s=during_walls,
            step_ms_under_server=step_ms, metrics=rows, peak_allocated_gib=peak_gib,
            f32_launches=flash_attention.f32_launches, f32_launches_expected=48 * REST_TRAIN_STEPS,
            tf32_flags_after=[torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32])),
            flush=True)
        if not ok:
            raise SystemExit(f"rest training: a check failed ({st.get('error')})")

        # ---- export, load, serve with the adapter ----
        exported = _json_call(port, "POST", "/v1/train/export", {"run_id": run_id,
                                                                 "target_dir": os.path.join(tmp, "adapters")})
        loaded = _json_call(port, "POST", "/v1/lora/load", {"name": "rest", "path": exported["adapter_path"]})
        _reset_counters()
        tid = _release(port, duration=30.0, seed=REST_T2M_SEED, audio_format="wav")
        _wait_jobs(port, [tid])
        adapted = latents[-1]
        adapter_launches = _path_launches("rest adapter job", ("flash_attention", "decoder_block", "res_units"))
        unloaded = _json_call(port, "POST", "/v1/lora/unload", {"name": "rest"})["success"]
        base = ref[0][0]
        rel = float(np.linalg.norm(adapted - base) / max(np.linalg.norm(base), 1e-12))

        # ---- the dataset explorer ----
        _reset_counters()
        scanned = _json_call(port, "POST", "/v1/dataset/scan", {"directory": songs})
        listed = _json_call(port, "GET", "/v1/dataset/samples")
        edited = _json_call(port, "PUT", "/v1/dataset/sample/0", {"caption": "an edited caption", "bpm": "90"})
        task = _json_call(port, "POST", "/v1/dataset/preprocess_async", {"output_dir": os.path.join(tmp, "t2")})
        done = _poll_json(port, "GET", f"/v1/dataset/preprocess_status/{task['task_id']}", None,
                          lambda t: t["status"] != "running", "preprocess_async")
        explorer_launches = _path_launches("rest dataset explorer", ("flash_attention",))

        # ---- the largest job beside a second run, then stop that run ----
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run2 = _json_call(port, "POST", "/v1/train/start", {
            "dataset_dir": ds, "rank": 32, "max_steps": 100000, "output_dir": os.path.join(tmp, "run2")})["run_id"]
        _poll_json(port, "POST", "/v1/train/status", {"run_id": run2}, lambda st: st["step"] >= 1, "run 2")
        policy = server.service.memory_policy
        t0 = time.time()
        tid = _release(port, duration=float(REST_BIG_S), batch_size=REST_BIG_BATCH, seed=REST_T2M_SEED,
                       audio_format="wav")
        big = _wait_jobs(port, [tid])[tid]
        big_wall = time.time() - t0
        st = _json_call(port, "POST", "/v1/train/status", {"run_id": run2})
        big_running_after, big_step_after = st["status"] == "running", st["step"]
        torch.cuda.synchronize()
        big_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        big_ok = (len(big["result"]["audio_paths"]) == REST_BIG_BATCH and big_running_after
                  and bool(np.isfinite(latents[-1]).all()) and latents[-1].shape[0] == REST_BIG_BATCH
                  and policy.max_batch_size >= REST_BIG_BATCH and policy.max_duration_s >= REST_BIG_S)
        c = llm.config
        # A thinking job's planner phase: the code pass's KV cache, rows doubled
        # for the planner's CFG, its prompt bucket taken as 1024 positions.
        kv_gib = (2 * c.num_hidden_layers * 2 * REST_BIG_BATCH * (1024 + REST_BIG_S * 5 + 8)
                  * c.num_key_value_heads * c.head_dim * 2) / 2**30
        total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
        print(json.dumps(dict(
            phase=f"rest largest job beside a run ({REST_BIG_BATCH} x {REST_BIG_S} s, thinking off, the 4B "
                  "planner resident, rank 32)", ok=big_ok, card=smi,
            policy=dict(max_batch_size=policy.max_batch_size, max_duration_s=policy.max_duration_s,
                        lm_size=policy.lm_size), latent_shape=list(latents[-1].shape), job_wall_s=big_wall,
            run_step_after=big_step_after,
            run_running_after=big_running_after, peak_allocated_gib=big_peak_gib,
            planner_resident_gib=nbytes(*_leaves(llm.params)) / 2**30,
            thinking_kv_cache_gib_computed=kv_gib, card_total_gib=total_gib,
            headroom_gib=total_gib - big_peak_gib - kv_gib)), flush=True)
        if not big_ok:
            raise SystemExit(f"rest largest job: {big}")
        stopped = _json_call(port, "POST", "/v1/train/stop", {"run_id": run2})
        st2 = _poll_json(port, "POST", "/v1/train/status", {"run_id": run2},
                         lambda st: st["status"] not in ("starting", "running"), "run 2's stop")
        runs = _json_call(port, "POST", "/v1/train/list", {})
        ok = (exported["success"] and exported["step"] == REST_TRAIN_STEPS and loaded["success"]
              and loaded["meta"]["rank"] == 32 and unloaded and bool(np.isfinite(adapted).all())
              and not np.array_equal(adapted, base)
              and scanned["total_samples"] == listed["total_samples"] == 3
              and edited["sample"]["caption"] == "an edited caption" and edited["sample"]["bpm"] == 90
              and done["status"] == "completed" and done["result"]["written"] == 3
              and stopped["stopped"] and st2["status"] == "stopped" and os.path.exists(st2["adapter_path"])
              and {runs[run_id]["status"], runs[run2]["status"]} == {"completed", "stopped"})
        print(json.dumps(dict(
            phase="rest export, adapter job, dataset explorer, stop", ok=ok, card=smi,
            exported_step=exported["step"], adapter_meta=loaded["meta"], rel_l2_adapted_base=rel,
            explorer=dict(scanned=scanned["total_samples"], edited=edited["sample"]["caption"],
                          preprocess=done["status"], written=done["result"]["written"]),
            stopped_at_step=st2["step"], runs={k: v["status"] for k, v in runs.items()})), flush=True)
        if not ok:
            raise SystemExit("rest training: export / adapter / explorer / stop checks failed")
    finally:
        DatasetBuilder.label_all, DatasetBuilder.preprocess_to_tensors = real_label, real_pre
        h.generate_music = real_generate
        h.__dict__.pop("convert_audio_to_codes", None)
        del llm.understand_audio_from_codes
        server.shutdown()
        server.server_close()
        torch.backends.cudnn.allow_tf32 = saved_tf32
    torch.cuda.empty_cache()

    # ---- the command line, four subprocesses at once ----
    try:
        jobs = {
            "profile": _cli("profile", "--random-init", "--durations", "30", "--batches", "1", "--think", "0",
                            "--steps", "8", "--json-out", os.path.join(tmp, "profile.json")),
            "profile_lm": _cli("profile", "--lm", "--random-init", "--batches", "1,2", "--lm-tokens", "64",
                               "--json-out", os.path.join(tmp, "profile_lm.json")),
            "build_dataset": _cli("build-dataset", "--random-init", "--audio-dir", songs, "--output-dir",
                                  os.path.join(tmp, "cli_tensors")),
            "verify_checkpoint": _cli("verify-checkpoint", CKPT_TINY),
        }
        t0 = time.time()
        outs = {k: p.communicate(timeout=600)[0] for k, p in jobs.items()}
        cli_s = time.time() - t0
        rcs = {k: p.returncode for k, p in jobs.items()}
        with open(os.path.join(tmp, "profile.json")) as f:
            profile_rows = json.load(f)
        with open(os.path.join(tmp, "profile_lm.json")) as f:
            lm_rows = json.load(f)
        written = sorted(os.listdir(os.path.join(tmp, "cli_tensors")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ["batch", "dit", "duration", "lm", "steps", "think", "throughput", "throughput_device", "transfer",
            "vae", "wall"]
    ok = (rcs == dict.fromkeys(jobs, 0) and [sorted(r) for r in profile_rows] == [keys]
          and [sorted(r) for r in lm_rows] == [["batch", "decode_s", "prefill_s", "tok_s"]] * 2
          and written == ["bare.npz", "captioned.npz", "described.npz", "manifest.json"])
    print(json.dumps(dict(phase="cli profile, profile --lm, build-dataset, verify-checkpoint (at once)", ok=ok,
                          card=smi, exit_codes=rcs, wall_s=cli_s, profile_rows=profile_rows, lm_rows=lm_rows,
                          build_dataset_files=written, tails={k: v[-600:] for k, v in outs.items() if rcs[k]})),
          flush=True)
    if not ok:
        raise SystemExit(f"cli subprocesses: {rcs}")
    return build_launches, train_launches, adapter_launches, explorer_launches


def run_probe_entry():
    """The probe's own entry point, as a developer runs it, at the probe's
    default seq and at 7 500 (every mode and K layout)."""
    from acestep_tpu_torch.tools import probe_kernel_parts

    modes = ",".join(m + t for m in PROBE_MODES for t in ("", "T"))
    _reset_counters()
    for seq in ("3840", "7500"):
        print(f"probe_kernel_parts --seq {seq}", flush=True)
        probe_kernel_parts.main(["--seq", seq, "--loop", "4", "--modes", modes])
    return _path_launches("probe entry point", ("attention_probe",))


def _timed_phase(seconds: dict, name: str, fn, *args):
    """fn(*args), its wall added to `seconds[name]`."""
    t0 = time.time()
    out = fn(*args)
    seconds[name] = seconds.get(name, 0.0) + time.time() - t0
    return out


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "acestep_tpu_torch")):
        print("chip_smoke: acestep_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    try:
        import transformers

        hf = transformers.__version__
    except ImportError:
        hf = None
    print(json.dumps(dict(phase="versions", python=sys.version.split()[0], torch=torch.__version__,
                          cuda=torch.version.cuda, transformers=hf)), flush=True)

    from acestep_tpu_torch.ops import cuda_lib

    t0 = time.time()
    took = cuda_lib.build()
    print(json.dumps(dict(phase="build", ok=True, seconds=time.time() - t0, per_source=took)), flush=True)
    for name in cuda_lib.SOURCES:
        log = (cuda_lib.BUILD_DIR / f"{name}.log").read_text() if (cuda_lib.BUILD_DIR / f"{name}.log").exists() else ""
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(1234)
    results: dict = {}
    seconds: dict = {}  # each top-level phase's wall, for the script's time budget
    _timed_phase(seconds, "run_attention_phase", run_attention_phase, dev, gen, results)
    # The training path's kernel check runs here with the other kernels': at
    # the end of the script 4 of its 6 first profiler windows came back empty.
    _timed_phase(seconds, "run_f32_attention_phase", run_f32_attention_phase, dev, gen, results)
    _timed_phase(seconds, "run_vae_phase", run_vae_phase, dev, gen, results)
    _timed_phase(seconds, "run_narrow_phase", run_narrow_phase, dev, gen, results)
    fp32_decode = _timed_phase(seconds, "run_fp32_decode", run_fp32_decode, dev, gen, smi)
    _timed_phase(seconds, "run_probe_phase", run_probe_phase, dev, gen, results)
    _timed_phase(seconds, "run_small_reference", run_small_reference, dev)
    _timed_phase(seconds, "run_small_thinking_reference", run_small_thinking_reference, dev)
    _timed_phase(seconds, "run_small_base_reference", run_small_base_reference, dev)
    checkpoint = _timed_phase(seconds, "run_checkpoint_tiny", run_checkpoint_tiny, dev)
    dit, text2music = _timed_phase(seconds, "run_requests", run_requests, dev)
    audio = _timed_phase(seconds, "run_audio_requests", run_audio_requests, dit)
    base = _timed_phase(seconds, "run_base_requests", run_base_requests, dit)
    serving, serving_direct = _timed_phase(seconds, "run_serving", run_serving, dit, smi)
    lora = _timed_phase(seconds, "run_lora", run_lora, dit)
    lrc = _timed_phase(seconds, "run_lrc", run_lrc, dit)
    data_parallel = _timed_phase(seconds, "run_data_parallel", run_data_parallel, dit, smi)
    sp_tp = _timed_phase(seconds, "run_sequence_tensor_parallel", run_sequence_tensor_parallel, dit, smi)
    thinking, llm, codes = _timed_phase(seconds, "run_thinking_requests", run_thinking_requests, dev, dit)
    free_form = _timed_phase(seconds, "run_free_form", run_free_form, dit, llm, codes)
    scoring = _timed_phase(seconds, "run_scoring", run_scoring, dev, llm, codes)
    planner_tp = _timed_phase(seconds, "run_planner_tensor_parallel", run_planner_tensor_parallel, dit, llm, smi)
    rest = _timed_phase(seconds, "run_rest_training", run_rest_training, dit, llm, smi)
    del llm
    torch.cuda.empty_cache()
    probe = _timed_phase(seconds, "run_probe_entry", run_probe_entry)
    _timed_phase(seconds, "run_train_grads", run_train_grads, dev)
    training, trained = _timed_phase(seconds, "run_lora_training", run_lora_training, dit, smi)
    del dit
    torch.cuda.empty_cache()
    paths = (text2music, audio, base, serving, serving_direct, lora, lrc, data_parallel, sp_tp, thinking, free_form,
             scoring, planner_tp, probe, checkpoint, fp32_decode, training, trained, *rest)
    launches = {k: sum(p[k] for p in paths) for k in text2music}

    narrow_src = "acestep_tpu_torch/csrc/oobleck_generic.cu"
    replaces = {
        "flash_attention": ("acestep_tpu_torch/csrc/flash_attention.cu",
                            "acestep_tpu/ops/pallas_attention.py:130"),
        "flash_attention_f32": ("acestep_tpu_torch/csrc/flash_attention_f32.cu",
                                "acestep_tpu/ops/pallas_attention.py:130"),
        "decoder_block": ("acestep_tpu_torch/csrc/oobleck_sm90.cu", "acestep_tpu/ops/pallas_vae.py:202"),
        "res_units": ("acestep_tpu_torch/csrc/oobleck_sm90.cu", "acestep_tpu/ops/pallas_vae.py:89"),
        "attention_probe": ("acestep_tpu_torch/csrc/attention_probe.cu", "tools/probe_kernel_parts.py:47"),
    }
    kernels = []
    for name, lines in results.items():
        src, rep = replaces[name]
        # Each row's bound at its route's own arithmetic: 3xTF32 for fp32 work on the tensor cores.
        bound = lambda l: "bound_3xtf32" if "bound_3xtf32_ms" in l else "bound"
        lib = [l["library_ms"] for l in lines if l["library_ms"] is not None]
        narrow = {}
        if name in _OOBLECK:  # the narrow route's source and its launches (the checkpoint_tiny and fp32 decode paths)
            narrow = dict(narrow_source=narrow_src, narrow_launches=checkpoint[name] + fp32_decode[name])
        kernels.append(dict(
            name=name, route="cuda", source=src, **narrow, replaces=rep, launches=launches[name],
            max_abs_err=max(l["max_abs_err"] for l in lines),
            ms=sum(l["kernel_ms"] for l in lines), plain_ms=sum(l["plain_ms"] for l in lines),
            bound_ms=sum(l[bound(l) + "_ms"] for l in lines),
            bound_by=(lambda l: l[bound(l) + "_by"])(max(lines, key=lambda l: l[bound(l) + "_ms"])),
            library_ms=sum(lib) if lib else None,
            shapes=[l["phase"].split()[-1] for l in lines],
        ))
    print(json.dumps(dict(phase="seconds by phase", total=time.time() - t_start, **seconds)), flush=True)
    leads = [lead for _, lead in WINDOWS if lead is not None]
    print(json.dumps(dict(phase="profiler windows", taken=len(WINDOWS), rejected=sum(not ok for ok, _ in WINDOWS),
                          guard_s=WINDOW_GUARD_S, least_launch_to_start_us=min(leads) if leads else None,
                          rejected_leads_us=[lead for ok, lead in WINDOWS if not ok])), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
