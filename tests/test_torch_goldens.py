"""The port against activations recorded from the reference implementation.

`tests/goldens/{dit,vae}_tiny.npz` hold a state dict of the reference torch
models (seeded random weights at tiny configs), inputs and per-module
outputs (see tests/test_golden_parity.py, which holds the JAX package to the
same files). Here the state dicts go through the port's own converters
(`params.convert_torch_state_dict`, `models/vae.convert_torch_vae_state`) and
the port's modules must reproduce the recorded outputs on the CPU in fp32, at
the tolerances of the JAX package's golden tests: so the port is held to the
original system, not only to the JAX package.
"""

import os

import numpy as np
import pytest
import torch

from acestep_tpu_torch.config import AceStepConfig, OobleckConfig
from acestep_tpu_torch.models import dit, vae
from acestep_tpu_torch.ops.fsq import residual_fsq_decode_indices
from acestep_tpu_torch.params import convert_torch_state_dict

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

TINY = AceStepConfig(
    hidden_size=64, intermediate_size=128, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=8,
    text_hidden_dim=32, num_lyric_encoder_hidden_layers=2,
    num_timbre_encoder_hidden_layers=2, num_attention_pooler_hidden_layers=1,
    fsq_dim=64, timbre_fix_frame=10,
)

TOL = 5e-6  # fp32 round-off headroom, as in tests/test_golden_parity.py


def _assert_close(name, got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    err = float(np.abs(got - want).max())
    assert err < tol, f"{name}: max abs err {err:.3e} >= {tol}"


@pytest.fixture(scope="module")
def dit_golden():
    z = np.load(os.path.join(GOLDEN_DIR, "dit_tiny.npz"))
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    inp = {k[3:]: torch.tensor(z[k]) for k in z.files if k.startswith("in/")}
    out = {k[4:]: z[k] for k in z.files if k.startswith("out/")}
    return convert_torch_state_dict(sd, TINY, torch.float32), inp, out


def test_lyric_and_timbre_encoders_golden(dit_golden):
    params, IN, OUT = dit_golden
    got = dit.lyric_encoder(params["encoder"]["lyric_encoder"], TINY, IN["lyric_h"], IN["lyric_m"])
    _assert_close("lyric_encoder", got, OUT["lyric_out"])
    tu, tm = dit.timbre_encoder(params["encoder"]["timbre_encoder"], TINY, IN["refer_packed"],
                                IN["refer_order"].to(torch.int32), 2, 2)
    _assert_close("timbre_encoder", tu, OUT["timbre_unpack"])
    np.testing.assert_array_equal(tm.numpy(), OUT["timbre_mask"])


def test_attention_pooler_golden(dit_golden):
    params, IN, OUT = dit_golden
    got = dit.attention_pooler(params["tokenizer"]["attention_pooler"], TINY, IN["pooler_x"])
    _assert_close("attention_pooler", got, OUT["pooler_out"])


def test_audio_tokenize_golden(dit_golden):
    params, IN, OUT = dit_golden
    q, idx = dit.audio_tokenize(params["tokenizer"], TINY, IN["src_latents"])
    _assert_close("audio_tokenize.quantized", q, OUT["tok_quantized"], tol=1e-5)
    ref_idx = OUT["tok_indices"]
    if ref_idx.ndim == 3:  # ResidualFSQ stacks a trailing quantizer axis
        ref_idx = ref_idx[..., 0]
    np.testing.assert_array_equal(idx.numpy(), ref_idx)


def test_detokenizer_and_fsq_decode_golden(dit_golden):
    params, IN, OUT = dit_golden
    got = dit.detokenizer(params["detokenizer"], TINY, torch.tensor(OUT["tok_quantized"]))
    _assert_close("detokenizer", got, OUT["detok_out"])
    got = residual_fsq_decode_indices(params["tokenizer"]["quantizer"], IN["audio_codes"], TINY.fsq_levels,
                                      torch.float32)
    _assert_close("fsq.get_output_from_indices", got, OUT["fsq_from_indices"], tol=1e-6)


def test_prepare_condition_golden(dit_golden):
    """No hints and no codes: the cover rows take theirs from the source
    latents through the audio tokenizer chain."""
    params, IN, OUT = dit_golden
    enc, enc_m, ctx = dit.prepare_condition(
        params, TINY,
        text_hidden_states=IN["text_h"], text_attention_mask=IN["text_m"],
        lyric_hidden_states=IN["lyric_h"], lyric_attention_mask=IN["lyric_m"],
        refer_packed=IN["refer_packed"], refer_order_mask=IN["refer_order"].to(torch.int32),
        src_latents=IN["src_latents"], chunk_masks=IN["chunk_masks"],
        is_covers=IN["is_covers"], silence_latent=IN["silence_latent"], max_refs=2,
    )
    _assert_close("prepare_condition.encoder_hidden", enc, OUT["prep_enc_h"])
    np.testing.assert_array_equal(enc_m.numpy(), OUT["prep_enc_m"])
    _assert_close("prepare_condition.context_latents", ctx, OUT["prep_ctx"])


def test_denoise_trajectory_golden(dit_golden):
    """The 8-step ODE loop against the reference's eager loop, shifts 3 and 2
    (masks None: the reference drops the decoder's masks)."""
    params, IN, OUT = dit_golden
    kvs = dit.precompute_cross_kv(params["decoder"], TINY, torch.tensor(OUT["prep_enc_h"]))
    for shift in (3, 2):
        xt = dit.denoise(params["decoder"], TINY, IN["noise"], dit.build_t_schedule(shift=float(shift)),
                         torch.tensor(OUT["prep_ctx"]), kvs, None, None)
        _assert_close(f"denoise@shift{shift}", xt, OUT[f"gen_latents_shift{shift}"])


@pytest.mark.parametrize("case", ["cover_plain", "cover_noise", "cover_switch"])
def test_cover_noise_and_switch_trajectories_golden(dit_golden, case):
    """The cover-noise schedule entry (renoised from the source partway down
    the schedule) and the non-cover switch at audio_cover_strength 0.5,
    against the reference loop. As in the JAX package's test, all-ones
    masks leave one deviation by design: the packed-timbre sequence's one pad
    slot, which this build masks out of cross-attention and the reference
    attends (~2e-4 over 8 steps); 1e-3 bounds it, where a wrong truncation,
    entry or switch would be O(1)."""
    params, IN, OUT = dit_golden
    common = dict(
        text_hidden_states=IN["text_h"],
        text_attention_mask=torch.ones_like(IN["text_m"]),
        lyric_hidden_states=IN["lyric_h"],
        lyric_attention_mask=torch.ones_like(IN["lyric_m"]),
        refer_packed=IN["refer_packed"],
        refer_order_mask=IN["refer_order"].to(torch.int32),
        src_latents=IN["src_latents"], chunk_masks=IN["chunk_masks"],
        is_covers=torch.ones_like(IN["is_covers"]),
        silence_latent=IN["silence_latent"],
        attention_mask=torch.ones_like(IN["attn_mask"]),
        infer_method="ode", max_refs=2, noise=IN["noise"], shift=3.0,
    )
    extra = {
        "cover_plain": {},
        "cover_noise": dict(cover_noise_strength=0.6),
        "cover_switch": dict(audio_cover_strength=0.5, non_cover_text_hidden_states=IN["text_h"] * 0.5,
                             non_cover_text_attention_mask=torch.ones_like(IN["text_m"])),
    }[case]
    g = dit.generate_audio(params, TINY, **common, **extra)
    _assert_close(f"generate_audio@{case}", g["target_latents"], OUT[f"gen_{case}"], tol=1e-3)


@pytest.fixture(scope="module")
def vae_golden():
    z = np.load(os.path.join(GOLDEN_DIR, "vae_tiny.npz"))
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    cfg = OobleckConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4), channel_multiples=(2, 4),
                        decoder_channels=8, decoder_input_channels=4, audio_channels=2)
    return vae.convert_torch_vae_state(sd, cfg, torch.float32), cfg, z


def test_vae_encode_raw_golden(vae_golden):
    params, cfg, z = vae_golden
    got = vae.encode_raw(params, cfg, torch.tensor(z["in/audio"]).transpose(1, 2))  # NCL -> NLC
    _assert_close("vae.encode_raw", got.transpose(1, 2), z["out/enc_raw"], tol=1e-5)


def test_vae_decode_golden(vae_golden):
    """Through the decoder-block wrappers' plain versions (the CPU route)."""
    params, cfg, z = vae_golden
    got = vae.decode(params, cfg, torch.tensor(z["in/latents"]).transpose(1, 2))
    _assert_close("vae.decode", got.transpose(1, 2), z["out/dec"], tol=1e-5)
