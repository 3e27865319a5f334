"""The lyric post-pass of the port against the JAX package (CPU, fp32).

`models/dit.dit_cross_attention_capture`, `AceStepHandler.get_lyric_timestamps`
(batch 2 with two lyric lengths, so each row is cut by its own `lyric_mask`),
`generate_music(return_condition=True)`'s lyric ids and mask, and the
service's `auto_lrc` / `auto_score` entries, deferred finish included. Both
handlers share weights and noise (the `handlers` fixture of
`test_torch_pipeline.py`). The tiny DiT has 2 layers of 4 heads, so the
alignment reads a head map of its own (`LAYERS`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
import acestep_tpu.service.inference as JS
import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.service.inference as TS
from acestep_tpu.config import AceStepConfig as JA
from acestep_tpu.params import init_acestep_params as j_init
from acestep_tpu.service.params import GenerationConfig as JGC, GenerationParams as JGP
from acestep_tpu_torch.config import AceStepConfig as TA
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.service.params import GenerationConfig as TGC, GenerationParams as TGP
from test_torch_pipeline import _DIT, LATENT_TOL, handlers  # noqa: F401 — the fixture

CAPTURE_TOL = 1e-5
LAYERS = {0: [1, 3], 1: [0, 2]}
LYRICS = ["[Verse]\nhello world\nsing it loud", "[Chorus]\nla la la la\nonce more with feeling\nand again"]


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture
def lrc_handlers(handlers, monkeypatch):  # noqa: F811
    """The pipeline tests' handlers with lyric buckets wide enough for
    `LYRICS` (the tiny 32 / 64 buckets would cut them)."""
    import acestep_tpu.pipeline.handler as JH
    import acestep_tpu_torch.pipeline.handler as TH

    for mod in (JH, TH):
        monkeypatch.setattr(mod, "LYRIC_BUCKETS", (64, 128))
    return handlers


@pytest.mark.parametrize("t", [64, 75])  # a whole number of patches; one padded frame
def test_capture_matches_jax(t):
    cfg = JA(**_DIT)
    params = jdit.stack_acestep_params(j_init(jax.random.PRNGKey(1), cfg, jnp.float32), cfg)
    tdec = from_jax_params(jax.tree.map(np.asarray, params), TA(**_DIT))["decoder"]
    b, l_enc = 2, 23
    xt = _rng(1).standard_normal((b, t, 64)).astype(np.float32)
    ctx = _rng(2).standard_normal((b, t, 128)).astype(np.float32)
    enc = _rng(3).standard_normal((b, l_enc, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((b, l_enc), np.int32)
    mask[1, 15:] = 0
    ts = np.asarray([0.125, 0.5], np.float32)
    want = jdit.dit_cross_attention_capture(params["decoder"], cfg, jnp.asarray(xt), jnp.asarray(ts),
                                            jnp.asarray(ctx), jnp.asarray(enc), jnp.asarray(mask), [0, 1])
    got = tdit.dit_cross_attention_capture(tdec, TA(**_DIT), torch.from_numpy(xt), torch.from_numpy(ts),
                                           torch.from_numpy(ctx), torch.from_numpy(enc), torch.from_numpy(mask),
                                           [0, 1])
    assert sorted(got) == sorted(want) == [0, 1]
    for layer in got:
        g, w = got[layer].numpy(), np.asarray(want[layer])
        assert g.shape == w.shape == (b, cfg.num_attention_heads, l_enc, -(-t // cfg.patch_size))
        assert float(np.abs(g - w).max()) <= CAPTURE_TOL
        np.testing.assert_allclose(g.sum(axis=2), 1.0, rtol=1e-5)  # softmax over the text axis
        assert float(np.abs(g[1, :, 15:]).max()) == 0.0  # masked keys get no weight


def _generate(jh, th):
    kw = dict(captions=["warm lofi beat", "slow piano ballad"], lyrics=LYRICS, batch_size=2, audio_duration=2.0,
              seeds=[3, 4], use_random_seed=False, vocal_languages=["en", "en"], return_condition=True)
    return jh.generate_music(**kw), th.generate_music(**kw)


def test_return_condition_carries_lyric_ids_and_mask(lrc_handlers):
    """C.4: the port returns the (B, L) lyric ids and mask as JAX does, and the
    two rows' lyric lengths differ."""
    jh, th = lrc_handlers
    want, got = _generate(jh, th)
    np.testing.assert_array_equal(got["lyric_token_ids"], np.asarray(want["lyric_token_ids"]))
    np.testing.assert_array_equal(got["lyric_mask"], want["lyric_mask"])
    assert got["lyric_mask"].shape[0] == 2 and len(set(got["lyric_mask"].sum(axis=1))) == 2
    for k, v in got["condition"].items():
        np.testing.assert_allclose(v, want["condition"][k], **LATENT_TOL)


def test_get_lyric_timestamps_matches_jax(lrc_handlers):
    """Each row of a batch of 2 through both handlers, on JAX's latents and
    condition: equal LRC text, token and sentence stamps and lyric score;
    each row has one LRC line per non-empty lyric line."""
    jh, th = lrc_handlers
    out, _ = _generate(jh, th)
    for i in range(2):
        args = (out["latents"], out["condition"], out["lyric_token_ids"], LYRICS[i], 2.0)
        kw = dict(vocal_language="en", custom_layers_config=LAYERS, sample_idx=i, lyric_mask=out["lyric_mask"])
        want = jh.get_lyric_timestamps(*args, **kw)
        got = th.get_lyric_timestamps(*args, **kw)
        assert got["success"] and want["success"]
        assert sorted(got) == sorted(want)
        for key in ("lrc_text", "token_timestamps", "sentence_timestamps", "lyrics_score", "lyrics_score_detail"):
            assert got[key] == want[key], (i, key)
        lines = [ln for ln in LYRICS[i].split("\n") if ln.strip()]
        assert got["lrc_text"].count("\n") == len(lines) - 1
        starts = [s["start"] for s in got["sentence_timestamps"]]
        assert starts == sorted(starts) and all(0.0 <= s <= 2.0 for s in starts)
    none = th.get_lyric_timestamps(out["latents"], out["condition"], out["lyric_token_ids"], LYRICS[0], 2.0,
                                   custom_layers_config={1: [9]})
    assert none == {"success": False, "error": "no attention maps captured"}


@pytest.mark.parametrize("defer", [False, True], ids=["sync", "deferred"])
def test_service_auto_lrc_and_score_match_jax(lrc_handlers, defer):
    """`auto_lrc` and `auto_score` through both services at batch 2: each
    entry's `lrc`, `sentence_timestamps` and `lyrics_score` equal JAX's;
    with `defer_finish` they land at finish. A request with only
    `auto_score` gets no LRC."""
    jh, th = lrc_handlers
    params = dict(caption="warm lofi beat", lyrics=LYRICS[1], duration=10.0, seed=5, thinking=False,
                  vocal_language="en", auto_lrc=True, auto_score=True)
    cfg = dict(batch_size=2, use_random_seed=False, seeds=[5, 6])
    jh.custom_layers_config = th.custom_layers_config = LAYERS
    want = JS.generate_music(jh, None, JGP(**params), JGC(**cfg), save_audio=False, defer_finish=defer)
    got = TS.generate_music(th, None, TGP(**params), TGC(**cfg), save_audio=False, defer_finish=defer)
    assert got.success and want.success, got.error
    if defer:
        assert got.audios == [] and want.audios == []
        want.finish()
        got.finish()
    assert len(got.audios) == len(want.audios) == 2
    for g, w in zip(got.audios, want.audios):
        assert g["lrc"] == w["lrc"] and g["lrc"].count("\n") == 3
        assert g["sentence_timestamps"] == w["sentence_timestamps"]
        assert g["lyrics_score"] == w["lyrics_score"] and 0.0 <= g["lyrics_score"] <= 1.0
    only = TS.generate_music(th, None, TGP(**{**params, "auto_lrc": False}), TGC(**cfg), save_audio=False)
    assert only.success and all("lrc" not in a and "lyrics_score" in a for a in only.audios)
