"""The serving path's handler and service pieces: the port against the JAX package (CPU, fp32).

Streaming (`StreamCursor`, `decode_latents` with a chunk sink), the pipelined
finish (`async_finish`), the decode's retry ladder under an injected
out-of-memory (the port's `torch.OutOfMemoryError` at dispatch, JAX's
RESOURCE_EXHAUSTED), the saved FLAC and its sidecar, and the merged batch.
Both packages run the tiny configs of tests/test_torch_pipeline.py with one
set of weights (`from_jax_params`) and the same numpy noise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu.service.inference as JS
import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.models.vae as tvae
import acestep_tpu_torch.pipeline.handler as TH
import acestep_tpu_torch.service.inference as TS
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu.service.params import GenerationConfig as JGC, GenerationParams as JGP
from acestep_tpu.utils import native_audio as jnative
from acestep_tpu_torch.config import AceStepConfig as TA, OobleckConfig as TO, Qwen3Config as TQ
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.service.params import GenerationConfig as TGC, GenerationParams as TGP

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
HOP = 32  # the tiny VAE's samples per latent frame

# Both sides quantise to int16 from fp32 waveforms: two PCM steps (the
# AUDIO_ATOL of tests/test_torch_pipeline.py, in int16 units).
PCM_ATOL = 2


def _noise(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def handlers():
    """One pair for the module (JAX's compiled programs are reused)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JH, TH):
            for name, val in BUCKETS.items():
                mp.setattr(mod, name, val)
        mp.setattr(jdit, "prepare_noise", lambda shape, seeds, dtype=jnp.bfloat16: jnp.asarray(_noise(shape), dtype))
        mp.setattr(
            tdit, "prepare_noise",
            lambda shape, seeds, dtype=torch.bfloat16, device=None: torch.tensor(_noise(shape), dtype=dtype,
                                                                                 device=device),
        )
        jh = JH.AceStepHandler(JA(**_DIT), JO(**_VAE), JQ(**_TEXT), dtype=jnp.float32)
        jh.initialize_service(random_init=True)
        th = TH.AceStepHandler(TA(**_DIT), TO(**_VAE), TQ(**_TEXT), dtype=torch.float32, device="cpu")
        th.initialize_service(random_init=True)
        th.params = from_jax_params(jax.tree.map(np.asarray, jh.params), th.config)
        th.vae_params = from_jax_params(jax.tree.map(np.asarray, jh.vae_params), th.vae_config)
        th.text_params = from_jax_params(jax.tree.map(np.asarray, jh.text_params), th.text_config)
        yield jh, th


def _latents(b, t, seed=5):
    return np.random.default_rng(seed).standard_normal((b, t, 64)).astype(np.float32)


class _Sink:
    """Records what a chunk sink receives; checks every sample arrives once, in order."""

    def __init__(self):
        self.calls = []

    def __call__(self, pos, pcm, total):
        self.calls.append((pos, np.array(pcm), total))

    def joined(self, total):
        assert [p for p, _, _ in self.calls] == list(np.cumsum([0] + [c.shape[-1] for _, c, _ in self.calls])[:-1])
        assert all(t == total for _, _, t in self.calls)
        out = np.concatenate([c for _, c, _ in self.calls], axis=-1)
        assert out.shape[-1] == total
        return out


def test_stream_cursor_exactly_once():
    """A retried attempt re-covers emitted spans with other chunk bounds:
    each cursor forwards every sample once, cutting partly new chunks, and
    the two packages' cursors forward the same calls."""
    src = np.arange(100, dtype=np.int16).reshape(1, 1, 100)
    feeds = [(0, 0, 40), (0, 0, 30), (30, 30, 60), (60, 60, 100)]
    got = {}
    for name, cls in (("jax", JH.StreamCursor), ("port", TH.StreamCursor)):
        calls = []
        cursor = cls(lambda pos, pcm, total: calls.append((pos, pcm.copy())))
        for pos, a, b in feeds:
            cursor(pos, src[..., a:b], 100)
        assert cursor.emitted == 100 and cursor.chunks == 3
        got[name] = calls
    assert [p for p, _ in got["port"]] == [p for p, _ in got["jax"]] == [0, 40, 60]
    for (_, a), (_, b) in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate([c for _, c in got["port"]], -1)[0, 0], src[0, 0])


@pytest.mark.parametrize("b,normalize_db", [(1, -1.0), (2, None)])
def test_decode_latents_sink_matches_jax(handlers, monkeypatch, b, normalize_db):
    """The chunked decode with a sink, at 16-frame cores (4 chunks of 50
    frames): the same chunk positions and totals, each chunk's PCM within two
    steps of JAX's, the joined chunks equal to the returned PCM, and the
    decode's compute / transfer split in `timings`."""
    jh, th = handlers
    for cls in (JH.AceStepHandler, TH.AceStepHandler):
        monkeypatch.setattr(cls, "_decode_chunk_core", staticmethod(lambda t, bb: 16))
    z = _latents(b, 50)
    jsink, tsink, timings = _Sink(), _Sink(), {}
    want = jh.decode_latents(jnp.asarray(z), normalize_db=normalize_db, return_int16=True, chunk_sink=jsink)
    got = th.decode_latents(torch.tensor(z), normalize_db=normalize_db, return_int16=True, chunk_sink=tsink,
                            timings=timings)
    assert got.shape == want.shape == (b, 2, 50 * HOP) and got.dtype == np.int16
    assert [(p, c.shape, t) for p, c, t in tsink.calls] == [(p, c.shape, t) for p, c, t in jsink.calls]
    assert len(tsink.calls) == 4
    np.testing.assert_array_equal(tsink.joined(50 * HOP), got)
    np.testing.assert_allclose(got, want, rtol=0, atol=PCM_ATOL)
    assert np.abs(got).max() > 0
    assert {"compute_wait_s", "transfer_s"} <= set(timings) and "retries" not in timings


def test_async_finish_interleaved_matches_sync(handlers):
    """Two requests dispatched before either finishes give the synchronous
    results bit for bit (the pipelined worker's order), with the decode's
    split in the time costs."""
    _, th = handlers
    kw = dict(captions="pipelined", lyrics="[Instrumental]", audio_duration=2.0, batch_size=1,
              use_random_seed=False, return_int16=True)
    ref1, ref2 = th.generate_music(**kw, seeds=[11]), th.generate_music(**kw, seeds=[22])
    a = th.generate_music(**kw, seeds=[11], async_finish=True)
    assert "audios" not in a and callable(a["finish"])
    b = th.generate_music(**kw, seeds=[22], async_finish=True)
    np.testing.assert_array_equal(a["finish"](), ref1["audios"])
    np.testing.assert_array_equal(b["finish"](), ref2["audios"])
    for r in (a, b, ref1):
        tc = r["time_costs"]
        assert {"vae_decode_time_cost", "vae_decode_compute_wait_time_cost", "vae_decode_transfer_time_cost",
                "total_time_cost"} <= set(tc)
        assert "vae_decode_hbm_retries" not in tc


def _fail_once(real, at, exc):
    """`real` that raises `exc` on its call number `at` (0-based), once."""
    calls = {"n": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if calls["n"] == at + 1:
            raise exc
        return real(*a, **kw)

    return wrapped


@pytest.mark.parametrize("fail_at", [0, 1])  # the first chunk's decode, the second's
def test_decode_ladder_matches_jax(handlers, monkeypatch, fail_at):
    """An out-of-memory in one chunk's decode: both packages retry once at
    the halved core (250 frames: 2 chunks of 192, then 3 of 96), every
    sample reaches the sink once, and the PCM agrees within two steps."""
    jh, th = handlers
    real_jit = jh._vae_decode_jit
    monkeypatch.setitem(jh.__dict__, "_vae_decode_jit",
                        _fail_once(real_jit, fail_at, RuntimeError("RESOURCE_EXHAUSTED: out of HBM")))
    monkeypatch.setattr(tvae, "decode", _fail_once(tvae.decode, fail_at, torch.OutOfMemoryError("injected")))
    z = _latents(1, 250, seed=9)
    before = (th._decode_retries, jh._decode_retries)
    jsink, tsink, jt, tt = _Sink(), _Sink(), {}, {}
    want = jh.decode_latents(jnp.asarray(z), normalize_db=-1.0, return_int16=True, chunk_sink=jsink, timings=jt)
    got = th.decode_latents(torch.tensor(z), normalize_db=-1.0, return_int16=True, chunk_sink=tsink, timings=tt)
    assert tt["retries"] == jt["retries"] == 1
    assert (th._decode_retries - before[0], jh._decode_retries - before[1]) == (1, 1)
    assert len(tsink.calls) == len(jsink.calls) == 3
    np.testing.assert_array_equal(tsink.joined(250 * HOP), got)
    np.testing.assert_allclose(got, want, rtol=0, atol=PCM_ATOL)


def test_generate_music_ladder_matches_jax(handlers, monkeypatch):
    """generate_music's fallback after an out-of-memory: the port's dispatch
    raises (a CUDA OOM arises at allocation), JAX's finish raises
    RESOURCE_EXHAUSTED; both redo the decode at 128-frame chunks, count one
    retry in `vae_decode_hbm_retries`, stream each sample once, and agree."""
    jh, th = handlers
    real_finish = jh._decode_latents_finish
    monkeypatch.setattr(jh, "_decode_latents_finish",
                        _fail_once(real_finish, 0, RuntimeError("RESOURCE_EXHAUSTED: out of HBM")))
    monkeypatch.setattr(tvae, "decode", _fail_once(tvae.decode, 0, torch.OutOfMemoryError("injected")))
    kw = dict(captions="ladder", lyrics="[Instrumental]", audio_duration=10.0, seeds=[3], use_random_seed=False,
              normalize_db=-1.0, return_int16=True)
    jsink, tsink = _Sink(), _Sink()
    want = jh.generate_music(**kw, chunk_sink=jsink)
    got = th.generate_music(**kw, chunk_sink=tsink)
    assert got["time_costs"]["vae_decode_hbm_retries"] == want["time_costs"]["vae_decode_hbm_retries"] == 1
    assert [p for p, _, _ in tsink.calls] == [p for p, _, _ in jsink.calls]
    np.testing.assert_array_equal(tsink.joined(250 * HOP), got["audios"])
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=PCM_ATOL)


def test_ladder_stops_at_64_frames(handlers, monkeypatch):
    """An out-of-memory at every size is raised once the core is 64 frames,
    after the retries down to it; any other error is not retried."""
    _, th = handlers

    def oom(*a, **kw):
        raise torch.OutOfMemoryError("injected")

    monkeypatch.setattr(tvae, "decode", oom)
    timings = {}
    with pytest.raises(torch.OutOfMemoryError):
        th.decode_latents(torch.tensor(_latents(1, 250)), timings=timings)  # cores 192, 96, 64
    assert timings["retries"] == 2
    monkeypatch.setattr(tvae, "decode", lambda *a, **kw: (_ for _ in ()).throw(ValueError("not memory")))
    with pytest.raises(ValueError):
        th.decode_latents(torch.tensor(_latents(1, 250)), timings=timings)
    assert timings["retries"] == 2


def test_saved_flac_and_sidecar_match_jax(handlers, tmp_path):
    """`save_audio=True` writes FLAC: its bytes are JAX's native encoder's
    for the same PCM (the port's own unsaved request), and its params
    sidecar has the JAX sidecar's keys and values but for the paths."""
    jh, th = handlers
    params = dict(caption="saved song", lyrics="[Instrumental]", duration=2.0, seed=4, thinking=False)
    cfg = dict(batch_size=1, use_random_seed=False)
    pcm = TS.generate_music(th, None, TGP(**params), TGC(**cfg), save_audio=False).audios[0]["audio"]
    got = TS.generate_music(th, None, TGP(**params), TGC(**cfg, output_dir=str(tmp_path / "port")))
    want = JS.generate_music(jh, None, JGP(**params), JGC(**cfg, output_dir=str(tmp_path / "jax")))
    assert got.success and want.success, (got.error, want.error)
    g, w = got.audios[0], want.audios[0]
    assert g["path"].endswith(".flac") and w["path"].endswith(".flac")
    assert g["key"] == w["key"] and set(g) == set(w)
    with open(g["path"], "rb") as f:
        assert f.read() == jnative.flac_encode(np.ascontiguousarray(pcm.T), 800)
    with open(g["params_path"]) as f, open(w["params_path"]) as f2:
        gs, ws = json.load(f), json.load(f2)
    assert gs == ws


def test_generate_music_merged_matches_jax(handlers, tmp_path):
    """Two single-sample requests merged into one batch: per-request keys,
    seeds, metas and files as JAX's; the audio within two steps; one merged
    share each. With defer_finish the two results share one finish."""
    jh, th = handlers
    reqs = [dict(caption="merged alpha", duration=2.0, seed=100, thinking=False),
            dict(caption="merged beta", lyrics="[Verse]\nhi", duration=2.0, seed=101, thinking=False)]
    cfg = dict(batch_size=1, audio_format="wav")
    want = JS.generate_music_merged(jh, [(JGP(**r), JGC(**cfg, output_dir=str(tmp_path / "jax"))) for r in reqs])
    got = TS.generate_music_merged(th, [(TGP(**r), TGC(**cfg)) for r in reqs], save_audio=False)
    saved = TS.generate_music_merged(th, [(TGP(**r), TGC(**cfg, output_dir=str(tmp_path / "port"))) for r in reqs],
                                     defer_finish=True)
    assert all(r.audios == [] for r in saved)
    for g, s, w in zip(got, saved, want):
        s.finish()
        assert g.success and s.success and w.success
        assert g.extra_outputs["merged_batch"] == w.extra_outputs["merged_batch"] == 2
        assert g.extra_outputs["time_costs"]["merged_share"] == 0.5
        ga, sa, wa = g.audios[0], s.audios[0], w.audios[0]
        assert ga["key"] == sa["key"] == wa["key"] and ga["seed"] == wa["seed"] and ga["metas"] == wa["metas"]
        assert sa["path"].endswith(".wav")
        _, wav = wavfile.read(sa["path"])
        np.testing.assert_array_equal(wav.T, ga["audio"])
        np.testing.assert_allclose(ga["audio"], wavfile.read(wa["path"])[1].T, rtol=0, atol=PCM_ATOL)
