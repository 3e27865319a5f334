"""Rank functions of `tests/test_torch_mesh.py`, in a module without JAX.

The ranks that `acestep_tpu_torch.parallel.mesh.launch` spawns import this
module to find their function, so it imports torch and the port only. The
handlers take the narrow configs of `tests/test_multichip.py` (the VAE's
encoder at 128 channels, so a reference encodes to the DiT's 64 latent
channels), fp32 on the CPU, with the weights that the test saved as numpy
(`params.from_jax_params`), and noise drawn per seed with numpy
(`seed_noise`, patched into `dit.prepare_noise` in the ranks and in the test).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.pipeline.handler as TH
from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params_dp

DIT = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=1,
    num_attention_pooler_hidden_layers=1, fsq_dim=64, timbre_fix_frame=8,
)
VAE = dict(
    encoder_hidden_size=128, downsampling_ratios=(2, 4, 4), channel_multiples=(1, 2, 4),
    decoder_channels=16, decoder_input_channels=64, audio_channels=2, sampling_rate=800,
)
TEXT = dict(
    vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
)
BUCKETS = dict(LATENT_BUCKETS=(64, 128, 256), TEXT_BUCKETS=(32, 64), LYRIC_BUCKETS=(32, 64))
TIMEOUT_S = 60.0
FAULT_SHIFT = 1.25  # a request at this shift raises on rank 1 (`_fault_on_rank_1`)


def seed_noise(shape, seeds):
    """(B, T, D) float32: row i drawn from numpy's generator at seeds[i]."""
    return np.stack([np.random.default_rng(int(s)).standard_normal(shape[1:]) for s in seeds]).astype(np.float32)


def prepare_noise(shape, seeds, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """`dit.prepare_noise` on `seed_noise`."""
    return torch.tensor(seed_noise(shape, seeds), dtype=dtype, device=device)


class StepNoise:
    """Injected SDE noise as `dit.generate_audio` reads it, by index only
    (no length, no iteration): step i's (B, T, 64) draw at seed + i."""

    def __init__(self, shape, seed: int):
        self.shape, self.seed = tuple(shape), seed

    def __getitem__(self, i: int) -> torch.Tensor:
        return torch.from_numpy(np.random.default_rng(self.seed + i).standard_normal(self.shape).astype(np.float32))


def _signal(seconds: float, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).standard_normal((2, int(800 * seconds)))).astype(np.float32)


_BASE = dict(lyrics=["[Instrumental]", "[Verse]\nhello world"], audio_duration=2.0, use_random_seed=False,
             normalize_db=-1.0)
REQUESTS = {
    "text2music": dict(_BASE, captions=["an energetic synthwave track", "slow piano ballad", "warm lofi beat",
                                        "dark ambient drone"], batch_size=4, seeds=[0, 1, 2, 3]),
    "batch3": dict(_BASE, captions=["warm lofi beat"], batch_size=3, seeds=[7, 8, 9]),
    "sde": dict(_BASE, captions=["warm lofi beat"], batch_size=4, seeds=[4, 5, 6, 7], infer_method="sde"),
    "sde_injected": dict(_BASE, captions=["warm lofi beat"], batch_size=4, seeds=[4, 5, 6, 7], infer_method="sde",
                         sde_noise=StepNoise((4, 64, 64), 40)),
    "condition": dict(_BASE, captions=["warm lofi beat", "slow piano ballad"], batch_size=2, seeds=[8, 9],
                      lyrics=["[Verse]\nla la", "[Chorus]\nhello world again"], return_condition=True),
    "apg": dict(_BASE, captions=["warm lofi beat", "slow piano ballad"], batch_size=2, seeds=[3, 4],
                inference_steps=10, guidance_scale=4.0),
    "adg": dict(_BASE, captions=["warm lofi beat", "slow piano ballad"], batch_size=2, seeds=[3, 4],
                inference_steps=10, guidance_scale=4.0, use_adg=True),
    "references": dict(_BASE, captions=["warm lofi beat"], batch_size=4, seeds=[10, 11, 12, 13],
                       reference_audios=[None, _signal(1.0, 1), None, [_signal(1.5, 2), _signal(0.5, 3)]]),
    "lora": dict(_BASE, captions=["warm lofi beat", "slow piano ballad"], batch_size=2, seeds=[5, 6]),
    "stream": dict(_BASE, captions=["warm lofi beat", "slow piano ballad"], batch_size=2, seeds=[5, 6],
                   return_int16=True),
}


def tiny_handler(weights_path: str) -> TH.AceStepHandler:
    """A CPU fp32 handler on the saved weights, with the small buckets."""
    for name, val in BUCKETS.items():
        setattr(TH, name, val)
    h = TH.AceStepHandler(AceStepConfig(**DIT), OobleckConfig(**VAE), Qwen3Config(**TEXT), dtype=torch.float32,
                          device="cpu")
    h.initialize_service(random_init=True)
    with open(weights_path, "rb") as f:
        weights = pickle.load(f)
    h.params = from_jax_params(weights["params"], h.config)
    h.vae_params = from_jax_params(weights["vae_params"], h.vae_config)
    h.text_params = from_jax_params(weights["text_params"], h.text_config)
    return h


def _fault_on_rank_1(h: TH.AceStepHandler) -> None:
    """Rank 1 raises in a request at FAULT_SHIFT and in loading an adapter named "broken"."""
    generate_audio, load = tdit.generate_audio, h.lora.load

    def faulty(*args, **kwargs):
        if kwargs.get("shift") == FAULT_SHIFT:
            raise RuntimeError("injected fault on rank 1")
        return generate_audio(*args, **kwargs)

    def faulty_load(name, path):
        if name == "broken":
            raise RuntimeError("injected load fault on rank 1")
        return load(name, path)

    tdit.generate_audio, h.lora.load = faulty, faulty_load


def _planner_refusal() -> str:
    """`enable_tensor_parallel()` on every rank for a planner with one KV
    head: the default mesh's tp = 2 does not divide it."""
    from acestep_tpu_torch.lm.handler import LLMHandler

    llm = LLMHandler(Qwen3Config(**{**TEXT, "num_key_value_heads": 1}), dtype=torch.float32, device="cpu")
    llm.initialize(random_init=True)
    try:
        llm.enable_tensor_parallel()
    except ValueError as e:
        return str(e)
    return "not refused"


def dp2_cases(weights_path: str, adapter_path: str):
    """Rank 0 runs every request of REQUESTS at dp = 2 (the LoRA one with the
    adapter on, then toggled off), a streamed one, one that fails on rank 1
    and one after it, the mesh shapes refused before a mesh is built (a tp
    that does not divide the DiT's heads, an sp that splits no latent
    bucket), a reload of every rank, then an adapter that fails to load on
    rank 1 alone and the request after it; returns them with each rank's pid,
    device and refusal of a planner's tp that does not divide."""
    torch.set_num_threads(1)
    tdit.prepare_noise = prepare_noise
    h = tiny_handler(weights_path)
    h.enable_mesh(dp=2, timeout=TIMEOUT_S)
    planner_refused = _planner_refusal()
    out = {}
    if h.mesh.rank == 1:
        _fault_on_rank_1(h)
        h.serve_followers()
    else:
        try:
            for name, kw in REQUESTS.items():
                if name == "lora":
                    h.load_lora("style", adapter_path)
                    out["lora_on"] = h.generate_music(**kw)
                    h.toggle_lora("style", False)
                    out["lora_off"] = h.generate_music(**kw)
                elif name == "stream":
                    calls = []
                    out["stream"] = h.generate_music(**kw, chunk_sink=lambda pos, pcm, total: calls.append(
                        (pos, pcm.copy(), total)))
                    out["stream_calls"] = calls
                else:
                    out[name] = h.generate_music(**kw)
            try:
                h.generate_music(**REQUESTS["lora"], shift=FAULT_SHIFT)
            except RuntimeError as e:
                out["fault"] = str(e)
            out["after_fault"] = h.generate_music(**REQUESTS["lora"])
            mesh = h.mesh
            for kw in (dict(dp=1, tp=3), dict(dp=1, sp=3)):
                try:
                    h.enable_mesh(**kw)
                except ValueError as e:
                    out.setdefault("refused", []).append(str(e))
            h.enable_mesh()
            out["unchanged_at_1x1x1"] = h.mesh is mesh
            out["reload"] = h.initialize_service(random_init=True, seed=3)
            out["after_reload"] = h.generate_music(**REQUESTS["lora"])
            for key, call in (("broken_load", lambda: h.load_lora("broken", adapter_path)),
                              ("out_of_step", lambda: h.generate_music(**REQUESTS["lora"]))):
                try:
                    call()
                except RuntimeError as e:
                    out[key] = str(e)
        finally:
            h.stop_followers()
    out["ranks"] = h.mesh.gather(dict(pid=os.getpid(), device=str(h.device), planner_refused=planner_refused))
    return out


def mesh_cases():
    """make_mesh's shapes and refusal, shard_batch's rows and
    shard_params_dp's check (one leaf perturbed on the last rank), as every
    rank sees them."""
    torch.set_num_threads(1)
    n = dist.get_world_size()
    out = {}
    if n == 8:
        meshes = [make_mesh(dp=4, tp=2), make_mesh(dp=2, sp=2, tp=2), make_mesh(tp=1)]
    else:
        meshes = [make_mesh(dp=2), make_mesh()]
    out["shapes"] = [m.shape for m in meshes]
    try:
        make_mesh(dp=3)
    except ValueError as e:
        out["mismatch"] = str(e)
    mesh = meshes[0]
    tree = {"x": np.arange(8 * 3).reshape(8, 3), "t": torch.arange(16.0).reshape(8, 2), "scalar": np.float32(2.0),
            "odd": [np.arange(3)], "meta": "text"}
    out["coord"] = mesh.coord
    out["rows"] = shard_batch(mesh, tree)
    params = {"a": torch.linspace(0, 1, 6, dtype=torch.bfloat16), "b": [torch.ones(2, 3), np.zeros(4, np.float32)]}
    out["same"] = shard_params_dp(mesh, params) is params
    if mesh.rank == n - 1:
        params["b"][0][1, 2] = 1.0 + 2 ** -20
    try:
        shard_params_dp(mesh, params)
    except ValueError as e:
        out["perturbed"] = str(e)
    return mesh.gather(out)


def die_on_rank_1():
    """Rank 1 exits at once; rank 0 waits for it in a gather."""
    mesh = make_mesh(dp=2, timeout=TIMEOUT_S)
    if mesh.rank == 1:
        os._exit(3)
    mesh.gather(None)
