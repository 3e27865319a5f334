"""PyTorch port models vs the JAX package on the CPU at tiny configs (fp32).

The same JAX init goes into both packages through `from_jax_params`; the
inputs are numpy arrays made from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import AceStepConfig as JAceStepConfig
from acestep_tpu.config import Qwen3Config as JQwen3Config
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen3 as jqwen3
from acestep_tpu.params import init_acestep_params
from acestep_tpu_torch.config import AceStepConfig, Qwen3Config
from acestep_tpu_torch.models import dit as tdit
from acestep_tpu_torch.models import qwen3 as tqwen3
from acestep_tpu_torch.params import from_jax_params

_DIT = dict(
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=4,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=16,
    sliding_window=8,
    text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=2,
    num_timbre_encoder_hidden_layers=1,
    num_attention_pooler_hidden_layers=1,
    fsq_dim=64,
    timbre_fix_frame=10,
)
_TEXT = dict(
    vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
)
J_DIT, T_DIT = JAceStepConfig(**_DIT), AceStepConfig(**_DIT)

# fp32 on both sides; a few layers deep, so allow summation-order drift.
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def dit_params():
    jp = init_acestep_params(jax.random.PRNGKey(0), J_DIT, jnp.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), T_DIT)


def _inputs(b=2, t=20, text_len=7, lyric_len=9):
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    text_mask = np.ones((b, text_len), np.int32)
    text_mask[1, 5:] = 0
    lyric_mask = np.ones((b, lyric_len), np.int32)
    lyric_mask[0, 6:] = 0
    return dict(
        text_hidden_states=f32(b, text_len, J_DIT.text_hidden_dim),
        text_attention_mask=text_mask,
        lyric_hidden_states=f32(b, lyric_len, J_DIT.text_hidden_dim),
        lyric_attention_mask=lyric_mask,
        refer_packed=f32(3, J_DIT.timbre_fix_frame, J_DIT.timbre_hidden_dim),
        refer_order_mask=np.asarray([0, 0, 1], np.int32),
        src_latents=f32(b, t, J_DIT.audio_acoustic_hidden_dim),
        chunk_masks=np.ones((b, t), np.float32),
        is_covers=np.asarray([0, 1], np.int32),
        silence_latent=f32(1, t, J_DIT.audio_acoustic_hidden_dim),
        precomputed_lm_hints_25hz=f32(b, t - 3, J_DIT.audio_acoustic_hidden_dim),
    )


def _both(inp):
    return ({k: jnp.asarray(v) for k, v in inp.items()}, {k: torch.tensor(v) for k, v in inp.items()})


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_qwen3_forward_hidden_and_embed():
    jcfg, tcfg = JQwen3Config(**_TEXT), Qwen3Config(**_TEXT)
    jp = jqwen3.init_qwen3_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    ids = np.random.default_rng(1).integers(0, 300, (2, 12)).astype(np.int32)
    _close(tqwen3.forward_hidden(tp, tcfg, torch.tensor(ids)), jqwen3.forward_hidden(jp, jcfg, jnp.asarray(ids)))
    _close(tqwen3.embed_tokens(tp, torch.tensor(ids)), jqwen3.embed_tokens(jp, jnp.asarray(ids)))


def test_prepare_condition(dit_params):
    jp, tp = dit_params
    ji, ti = _both(_inputs())
    want = jdit.prepare_condition(jp, J_DIT, max_refs=2, **ji)
    got = tdit.prepare_condition(tp, T_DIT, max_refs=2, **ti)
    for g, w in zip(got, want):
        _close(g, w)


def test_prepare_condition_without_hints_is_not_ported(dit_params):
    """Without hints or codes the cover row's hints come from its source
    latents through the audio tokenizer chain (ported since this test only
    checked that it raised): T = 20 is padded with silence to a multiple of
    the pool window first, as in the JAX package."""
    jp, tp = dit_params
    inp = _inputs()
    inp.pop("precomputed_lm_hints_25hz")
    inp["src_latents"] = inp["src_latents"][:, :18]
    inp["chunk_masks"] = inp["chunk_masks"][:, :18]
    ji, ti = _both(inp)
    want = jdit.prepare_condition(jp, J_DIT, max_refs=2, **ji)
    got = tdit.prepare_condition(tp, T_DIT, max_refs=2, **ti)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_dit_forward_one_step(dit_params, layout):
    """One velocity step; the stacked {"sliding", "full"} JAX layout converts
    to the same per-layer list."""
    jp, tp = dit_params
    if layout == "stacked":
        jp = jdit.stack_acestep_params(jp, J_DIT)
        assert isinstance(jp["decoder"]["layers"], dict)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), T_DIT)
    ji, ti = _both(_inputs())
    enc_j, mask_j, ctx_j = jdit.prepare_condition(jp, J_DIT, max_refs=2, **ji)
    enc_t, mask_t, ctx_t = tdit.prepare_condition(tp, T_DIT, max_refs=2, **ti)
    rng = np.random.default_rng(3)
    xt = rng.standard_normal((2, 20, 64)).astype(np.float32)
    lat = np.ones((2, 20), np.int32)
    lat[1, 15:] = 0
    t = np.asarray([0.9, 0.9], np.float32)
    want = jdit.dit_forward(
        jp["decoder"], J_DIT, jnp.asarray(xt), jnp.asarray(t), jnp.asarray(t), ctx_j,
        jdit.precompute_cross_kv(jp["decoder"], J_DIT, enc_j), encoder_mask=mask_j, latent_mask=jnp.asarray(lat),
    )
    got = tdit.dit_forward(
        tp["decoder"], T_DIT, torch.tensor(xt), torch.tensor(t), torch.tensor(t), ctx_t,
        tdit.precompute_cross_kv(tp["decoder"], T_DIT, enc_t), encoder_mask=mask_t, latent_mask=torch.tensor(lat),
    )
    _close(got, want)


def test_generate_audio_with_injected_noise(dit_params):
    jp, tp = dit_params
    inp = _inputs()
    inp["is_covers"] = np.zeros(2, np.int32)
    lat = np.ones((2, 20), np.int32)
    lat[0, 17:] = 0
    noise = np.random.default_rng(4).standard_normal((2, 20, 64)).astype(np.float32)
    ji, ti = _both(inp)
    want = jdit.generate_audio(jp, J_DIT, attention_mask=jnp.asarray(lat), noise=jnp.asarray(noise),
                               max_refs=2, shift=3.0, **ji)
    got = tdit.generate_audio(tp, T_DIT, attention_mask=torch.tensor(lat), noise=torch.tensor(noise),
                              max_refs=2, shift=3.0, **ti)
    assert got["num_steps"] == want["num_steps"] == 8
    _close(got["target_latents"], want["target_latents"])


def test_schedules_match_jax():
    for shift in (1.0, 2.0, 3.0, 2.6):
        assert tdit.build_t_schedule(shift) == jdit.build_t_schedule(shift)
    assert tdit.build_t_schedule(3.0, [0.97, 0.51, 0.0]) == jdit.build_t_schedule(3.0, [0.97, 0.51, 0.0])
    assert tdit.build_linspace_schedule(12, 2.0) == jdit.build_linspace_schedule(12, 2.0)
