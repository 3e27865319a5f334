#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`acestep_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from `acestep_tpu_torch/csrc` (nvcc, in parallel);
  3. each kernel at main-path shapes against its plain PyTorch version in fp32 on
     the same bf16 inputs: max error and tolerance, kernel / plain / library
     times from CUDA events, and the bound (bf16 tensor-core peak 989 TFLOP/s,
     HBM 3.35 TB/s, the H100 SXM data-sheet rates);
  4. the whole pipeline at a narrow config on the card (bf16, kernels) against
     the same weights and noise on the CPU (fp32, plain versions);
  5. `AceStepHandler.initialize_service(random_init=True)` at full width, one
     untimed warm-up request, then text2music requests (1 x 30 s, 2 x 60 s,
     1 x 240 s, 1 x 600 s: the longest bucket, 7 500 DiT tokens) with every
     launch counter set to 0 just before and read just after;
  6. a `{"kernels": [...]}` JSON line, then the `{"ok": true, ...}` line last.
     In it a kernel's `ms`, `plain_ms`, `library_ms` and `bound_ms` are sums
     over its phase-3 shapes and `max_abs_err` their maximum.

Imports nothing of JAX. Exits non-zero without a result line when no CUDA
device is present or the port's package is not beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_cases(dev, gen):
    """Main-path attention shapes: DiT at 60 s batch 2 (750 patched tokens,
    16 q / 8 kv heads of 128), cross-attention onto a packed condition of
    lyric 512 + timbre 1 + text 256 with a padded tail, and the Qwen3 text
    encoder's causal 256-token bucket."""

    def qkv(b, lq, lk):
        mk = lambda l, n: torch.randn((b, l, n, 128), generator=gen, device=dev).to(torch.bfloat16)
        return mk(lq, 16), mk(lk, 8), mk(lk, 8)

    enc_mask = torch.ones((2, 769), dtype=torch.int32, device=dev)
    enc_mask[0, 700:] = 0
    enc_mask[1, 600:] = 0
    lat_mask = torch.ones((2, 750), dtype=torch.int32, device=dev)
    return [
        ("dit_self_sliding_60s_b2", qkv(2, 750, 750), dict(kv_mask=lat_mask, window=128)),
        ("dit_self_full_60s_b2", qkv(2, 750, 750), dict(kv_mask=lat_mask)),
        ("dit_cross_60s_b2", qkv(2, 750, 769), dict(kv_mask=enc_mask)),
        ("text_encoder_causal_256_b2", qkv(2, 256, 256), dict(causal=True)),
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
        k_ms = time_ms(lambda: flash_attention(q, k, v, kw.get("kv_mask"), window=kw.get("window"),
                                               causal=kw.get("causal", False)), 20)
        p_ms = time_ms(lambda: flash_attention_plain(q, k, v, kw.get("kv_mask"), window=kw.get("window"),
                                                     causal=kw.get("causal", False)), 3)
        # Yardstick only: SDPA on the same bf16 inputs (the port never calls it).
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = q.shape[2] // k.shape[2]
        kt, vt = kt.repeat_interleave(reps, 1), vt.repeat_interleave(reps, 1)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 20)
        line = dict(phase=f"kernel flash_attention {name}", ok=ok, max_abs_err=err, tol=tol,
                    kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                    shapes=dict(q=list(q.shape), k=list(k.shape)))
        print(json.dumps(line), flush=True)
        results.setdefault("flash_attention", []).append(line)
        if not ok:
            raise SystemExit(f"flash_attention {name}: max_abs_err {err} > {tol}")


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
    chunk = 224  # decode chunk of a 1 x 30 s request: core 192 + 2 x 16 overlap
    strides = tuple(reversed(cfg.downsampling_ratios))
    l_in = chunk
    cases = []
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
        p_ms = time_ms(lambda: plain(x), 2)
        line = dict(phase=f"kernel {kname} {label}", ok=ok, max_abs_err=err, tol=tol,
                    kernel_ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                    shapes=dict(x=list(shape), out=list(out.shape)))
        print(json.dumps(line), flush=True)
        results.setdefault(kname, []).append(line)
        if not ok:
            raise SystemExit(f"{kname} {label}: max_abs_err {err} > {tol}")


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


def run_small_reference(dev):
    """The whole pipeline on the card (bf16, kernels) against the same weights
    and noise on the CPU (fp32, plain versions), at a narrow config whose
    shapes every kernel takes: head_dim 128, 30 s (375 DiT tokens), VAE
    channels 1024 -> 128 with hop 32."""
    from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    cfgs = (
        AceStepConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=128, text_hidden_dim=256,
                      num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=2,
                      num_attention_pooler_hidden_layers=1, fsq_dim=256),
        OobleckConfig(downsampling_ratios=(2, 4, 4), channel_multiples=(1, 8, 8), decoder_channels=128),
        Qwen3Config(vocab_size=300, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=2, num_key_value_heads=1, head_dim=128),
    )
    gpu = AceStepHandler(*cfgs, device=dev)
    gpu.initialize_service(random_init=True, seed=5)
    cpu = AceStepHandler(*cfgs, dtype=torch.float32, device="cpu")
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


def run_requests(dev):
    from acestep_tpu_torch.ops.flash_attention import flash_attention
    from acestep_tpu_torch.ops.oobleck_kernels import decoder_block_kernel, res_units_kernel
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    counted = {"flash_attention": flash_attention, "decoder_block": decoder_block_kernel,
               "res_units": res_units_kernel}
    h = AceStepHandler(device=dev)
    t0 = time.time()
    msg = h.initialize_service(random_init=True, seed=0)
    print(json.dumps(dict(phase="initialize_service", seconds=time.time() - t0, msg=msg)), flush=True)
    t0 = time.time()
    h.generate_music(CAPTION, LYRICS, audio_duration=30.0, seeds=[1], use_random_seed=False)
    print(json.dumps(dict(phase="warm-up request b1x30s (untimed below)", seconds=time.time() - t0)), flush=True)
    requests = [(1, 30.0), (2, 60.0), (1, 240.0), (1, 600.0)]
    for fn in counted.values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, fn in counted.items()}
    print(json.dumps(dict(phase="main path launches", launches=launches)), flush=True)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")
    return launches


def main() -> int:
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
    print(json.dumps(dict(phase="versions", python=sys.version.split()[0], torch=torch.__version__,
                          cuda=torch.version.cuda)), flush=True)

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
    run_attention_phase(dev, gen, results)
    run_vae_phase(dev, gen, results)
    run_small_reference(dev)
    launches = run_requests(dev)

    replaces = {
        "flash_attention": ("acestep_tpu_torch/csrc/flash_attention.cu",
                            "acestep_tpu/ops/pallas_attention.py:130"),
        "decoder_block": ("acestep_tpu_torch/csrc/oobleck.cu", "acestep_tpu/ops/pallas_vae.py:202"),
        "res_units": ("acestep_tpu_torch/csrc/oobleck.cu", "acestep_tpu/ops/pallas_vae.py:89"),
    }
    kernels = []
    for name, lines in results.items():
        src, rep = replaces[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
            max_abs_err=max(l["max_abs_err"] for l in lines),
            ms=sum(l["kernel_ms"] for l in lines), plain_ms=sum(l["plain_ms"] for l in lines),
            bound_ms=sum(l["bound_ms"] for l in lines),
            bound_by=max(lines, key=lambda l: l["bound_ms"])["bound_by"],
            library_ms=(None if lines[0]["library_ms"] is None else sum(l["library_ms"] for l in lines)),
            shapes=[l["phase"].split()[-1] for l in lines],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
