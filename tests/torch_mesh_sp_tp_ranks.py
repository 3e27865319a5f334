"""Rank functions of `tests/test_torch_mesh_sp_tp.py`, in a module without JAX.

The ranks import this module to find their function, so it imports torch
and the port only. The handlers are those of `tests/torch_mesh_ranks.py`
(the narrow configs of `tests/test_multichip.py`, fp32 on the CPU, the JAX
handler's weights, numpy noise per seed), with latent buckets that give
every way a request meets sequence parallelism at sp = 2 (patch size 2,
sliding window 8): 64 frames split into 16 patched rows a rank, 66 do not
split (66 is no multiple of sp · patch_size), and 16 split into 4 rows a
rank, fewer than the window, so the halo reaches past the neighbour.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.pipeline.handler as TH
from tests import torch_mesh_ranks as R

BUCKETS = dict(LATENT_BUCKETS=(16, 64, 66, 128), TEXT_BUCKETS=(32, 64), LYRIC_BUCKETS=(32, 64))
TIMEOUT_S = R.TIMEOUT_S
CAPTURE_LAYERS = {0: [0, 1, 2, 3], 1: [1, 3]}  # every head of layer 0: all of both tp ranks' heads
LYRICS = ["[Verse]\nhello world\nsing it loud", "[Chorus]\nla la la\nonce more"]

_BASE = dict(captions=["warm lofi beat", "slow piano ballad"], lyrics=["[Instrumental]", "[Verse]\nhello world"],
             batch_size=2, audio_duration=2.0, use_random_seed=False, normalize_db=-1.0)
_SOURCE = np.random.default_rng(5).standard_normal((50, 64)).astype(np.float32)
_CODES = "".join(f"<|audio_code_{c}|>" for c in np.random.default_rng(6).integers(0, 1000, 10))
# Base requests take 4 guided steps: every collective a request makes is a
# round trip between processes, the slowest part of a loaded test machine.
REQUESTS = {
    "text2music": dict(_BASE, seeds=[0, 1], lyrics=LYRICS, vocal_languages=["en", "en"], return_condition=True),
    "odd_length": dict(_BASE, seeds=[2, 3], audio_duration=2.6),
    "short": dict(_BASE, seeds=[4, 5], audio_duration=0.6),
    "apg": dict(_BASE, seeds=[3, 4], inference_steps=4, guidance_scale=4.0),
    "adg": dict(_BASE, seeds=[3, 4], inference_steps=4, guidance_scale=4.0, use_adg=True),
    "sde": dict(_BASE, seeds=[6, 7], infer_method="sde"),
    "sde_injected": dict(_BASE, seeds=[6, 7], infer_method="sde", sde_noise=R.StepNoise((2, 64, 64), 40)),
    "cover": dict(_BASE, seeds=[8, 9], task_type="cover", target_latents=_SOURCE, audio_code_strings=[_CODES, None],
                  cover_noise_strength=0.3, audio_cover_strength=0.5),
    "lora": dict(_BASE, seeds=[5, 6]),
}
# dp = 2: a batch of 4 (JAX's `test_enable_mesh_serving_path_dp_sp_tp`) and one of 3, which does not divide.
REQUESTS_DP2 = {
    "batch4": dict(_BASE, captions="mesh serve test", lyrics="[Instrumental]", batch_size=4, seeds=[0, 1, 2, 3]),
    "batch3": dict(_BASE, captions="warm lofi beat", lyrics="[Instrumental]", batch_size=3, seeds=[7, 8, 9]),
}


def tiny_handler(weights_path: str) -> TH.AceStepHandler:
    """`torch_mesh_ranks.tiny_handler` with this module's buckets."""
    h = R.tiny_handler(weights_path)
    for name, val in BUCKETS.items():
        setattr(TH, name, val)
    return h


def capture(h: TH.AceStepHandler, cond: dict) -> list:
    """Both rows' lyric capture on `cond` (a `return_condition` result)."""
    return [h.capture_lyric_attention(cond["latents"], cond["condition"], cond["lyric_token_ids"],
                                      vocal_language="en", custom_layers_config=CAPTURE_LAYERS, sample_idx=i,
                                      lyric_mask=cond["lyric_mask"])
            for i in range(2)]


def run_requests(h: TH.AceStepHandler, requests: dict, adapter_path: str) -> dict:
    """Every request (the "lora" one with the adapter loaded) and the lyric
    capture of the text2music one."""
    out = {}
    for name, kw in requests.items():
        if name == "lora":
            h.load_lora("style", adapter_path)
            out[name] = h.generate_music(**kw)
            h.unload_lora("style")
        else:
            out[name] = h.generate_music(**kw)
    if "condition" in out.get("text2music", {}):
        out["capture"] = capture(h, out["text2music"])
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _rank_report(h: TH.AceStepHandler) -> dict:
    return dict(pid=os.getpid(), device=str(h.device), coord=h.mesh.coord, backend=h.mesh.backend,
                collectives=h.mesh.collectives,
                q_proj=tuple(h.params["decoder"]["layers"][0]["self_attn"]["q_proj"]["kernel"].shape),
                down_proj=tuple(h.params["decoder"]["layers"][0]["mlp"]["down_proj"]["kernel"].shape),
                encoder_q_proj=tuple(h.params["encoder"]["lyric_encoder"]["layers"][0]["self_attn"]["q_proj"]
                                     ["kernel"].shape))


def mesh_cases(weights_path: str, adapter_path: str, dp: int):
    """dp x 2 x 2 ranks: rank 0 runs REQUESTS (dp = 1) or REQUESTS_DP2 (dp =
    2) while the others follow, then gathers the decoder whole for a trainer
    (`training_decoder_whole`: the leaves that differ from the saved weights,
    or are missing or extra); returns them with each rank's report."""
    torch.set_num_threads(1)
    tdit.prepare_noise = R.prepare_noise
    h = tiny_handler(weights_path)
    h.enable_mesh(dp=dp, sp=2, tp=2, timeout=TIMEOUT_S)
    out = {}
    if h.mesh.is_leader:
        try:
            out = run_requests(h, REQUESTS if dp == 1 else REQUESTS_DP2, adapter_path)
            want = dict(_leaves(tiny_handler(weights_path).params["decoder"]))
            got = dict(_leaves(h.training_params()["decoder"]))
            out["training_decoder_whole"] = sorted(p for p in want.keys() | got.keys() if p not in want or p not in got
                                                   or not torch.equal(want[p], got[p]))
        finally:
            h.stop_followers()
    else:
        h.serve_followers()
    out["ranks"] = h.mesh.gather(_rank_report(h))
    return out
