"""Whole text2music slice: the port's AceStepHandler vs the JAX handler (CPU, fp32).

Both handlers run the tiny configs of tests/test_pipeline.py with one set of
weights (the JAX random init, carried over with `from_jax_params`) and the
same injected numpy noise: `prepare_noise` is patched in both packages for
this test only, because `jax.random` and `torch.Generator` give different
numbers for one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.pipeline.handler as TH
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu_torch.config import AceStepConfig as TA, OobleckConfig as TO, Qwen3Config as TQ
from acestep_tpu_torch.params import from_jax_params

_DIT = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=1,
    num_attention_pooler_hidden_layers=1, fsq_dim=64, timbre_fix_frame=10,
)
_VAE = dict(
    encoder_hidden_size=128, downsampling_ratios=(2, 4, 4), channel_multiples=(1, 1, 1),
    decoder_channels=16, decoder_input_channels=64, audio_channels=2, sampling_rate=800,
)
_TEXT = dict(
    vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
)
BUCKETS = dict(LATENT_BUCKETS=(64, 128, 256), TEXT_BUCKETS=(32, 64), LYRIC_BUCKETS=(32, 64))

# Latents: fp32 on both sides through 8 DiT steps. Audio: both sides quantise
# to int16 and divide by 32767, so allow two PCM steps plus fp32 drift.
LATENT_TOL = dict(rtol=1e-4, atol=1e-4)
AUDIO_ATOL = 2.5 / 32767


def _noise(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


@pytest.fixture
def handlers(monkeypatch):
    for mod in (JH, TH):
        for name, val in BUCKETS.items():
            monkeypatch.setattr(mod, name, val)
    monkeypatch.setattr(jdit, "prepare_noise", lambda shape, seeds, dtype=jnp.bfloat16: jnp.asarray(_noise(shape), dtype))
    monkeypatch.setattr(
        tdit, "prepare_noise",
        lambda shape, seeds, dtype=torch.bfloat16, device=None: torch.tensor(_noise(shape), dtype=dtype, device=device),
    )
    jh = JH.AceStepHandler(JA(**_DIT), JO(**_VAE), JQ(**_TEXT), dtype=jnp.float32)
    jh.initialize_service(random_init=True)
    th = TH.AceStepHandler(TA(**_DIT), TO(**_VAE), TQ(**_TEXT), dtype=torch.float32, device="cpu")
    th.initialize_service(random_init=True)
    th.params = from_jax_params(jax.tree.map(np.asarray, jh.params), th.config)
    th.vae_params = from_jax_params(jax.tree.map(np.asarray, jh.vae_params), th.vae_config)
    th.text_params = from_jax_params(jax.tree.map(np.asarray, jh.text_params), th.text_config)
    return jh, th


@pytest.mark.parametrize("duration", [2.0, 8.0])  # one decode chunk; two chunks with overlap
def test_generate_music_text2music_matches_jax(handlers, duration):
    jh, th = handlers
    kw = dict(
        captions=["an energetic synthwave track", "slow piano ballad"],
        lyrics=["[Instrumental]", "[Verse]\nhello world"],
        batch_size=2, audio_duration=duration, seeds=[3, 4], use_random_seed=False, shift=3.0,
        normalize_db=-1.0,
    )
    want = jh.generate_music(**kw)
    got = th.generate_music(**kw)
    t_exact = int(duration * 25)
    assert got["latents"].shape == want["latents"].shape == (2, t_exact, 64)
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    assert got["audios"].shape == want["audios"].shape == (2, 2, t_exact * 32)
    assert np.abs(got["audios"]).max() > 0
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=AUDIO_ATOL)
    assert got["num_steps"] == 8


def test_unported_requests_raise(handlers):
    """Requests that once raised now run: a cover request (the tokenizer chain
    on the silence source), guidance (APG, ADG) and SDE each give finite
    latents of the request's shape; so do a deferred finish and a streaming
    sink, equal to the synchronous request. A checkpoint directory that does
    not exist still raises FileNotFoundError."""
    _, th = handlers
    out = th.generate_music("x", "y", task_type="cover", audio_duration=2.0, seeds=[1], use_random_seed=False)
    assert out["latents"].shape == (1, 50, 64) and np.isfinite(out["latents"]).all()
    for kw in (dict(guidance_scale=3.0), dict(guidance_scale=3.0, use_adg=True, inference_steps=10),
               dict(infer_method="sde")):
        out = th.generate_music("x", "y", audio_duration=2.0, seeds=[1], use_random_seed=False, **kw)
        assert out["latents"].shape == (1, 50, 64) and np.isfinite(out["latents"]).all(), kw
        assert out["audios"].shape == (1, 2, 50 * 32) and np.isfinite(out["audios"]).all(), kw
    kw = dict(audio_duration=2.0, seeds=[1], use_random_seed=False, return_int16=True)
    ref = th.generate_music("x", "y", **kw)["audios"]
    chunks = []
    out = th.generate_music("x", "y", async_finish=True, chunk_sink=lambda pos, pcm, total: chunks.append(pcm.copy()),
                            **kw)
    assert "audios" not in out
    np.testing.assert_array_equal(out["finish"](), ref)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=-1), ref)
    with pytest.raises(FileNotFoundError):
        th.initialize_service("/nonexistent", random_init=False)


@pytest.mark.parametrize("kw", [
    dict(inference_steps=12, guidance_scale=7.0),
    dict(inference_steps=10, guidance_scale=4.0, use_adg=True),
    dict(inference_steps=10, guidance_scale=5.0, cfg_interval_start=0.3, cfg_interval_end=0.8),
], ids=["apg", "adg", "interval"])
def test_generate_music_base_guidance_matches_jax(handlers, kw):
    """A base request (linspace schedule, CFG on the null condition) through
    both handlers: the guidance parameters reach the DiT the same way."""
    jh, th = handlers
    args = dict(captions=["warm lofi beat", "slow piano ballad"], lyrics=["[Instrumental]", "[Verse]\nhello"],
                batch_size=2, audio_duration=2.0, seeds=[3, 4], use_random_seed=False, shift=3.0,
                normalize_db=-1.0, **kw)
    want, got = jh.generate_music(**args), th.generate_music(**args)
    assert got["num_steps"] == want["num_steps"] == kw["inference_steps"]
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=AUDIO_ATOL)


def test_generate_music_sde_injected_noise_matches_jax(handlers):
    """A turbo SDE request through both handlers, the port's handed the
    per-step noise JAX's keys draw (`sde_noise`, at the padded length of
    64 frames): the same latents."""
    jh, th = handlers
    args = dict(captions=["warm lofi beat", "slow piano ballad"], lyrics=["[Instrumental]", "[Verse]\nhello"],
                batch_size=2, audio_duration=2.0, seeds=[3, 4], use_random_seed=False, infer_method="sde",
                decode_audio=False)
    want = jh.generate_music(**args)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0), want["num_steps"])
    noise = [torch.tensor(np.asarray(jax.random.normal(k, (2, 64, 64), dtype=jnp.float32))) for k in keys]
    got = th.generate_music(**args, sde_noise=noise)
    assert got["num_steps"] == want["num_steps"] == 8
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    seeded = th.generate_music(**args)["latents"]
    assert float(np.abs(seeded - got["latents"]).max()) > 1e-2  # the hook replaced the seeded draw
