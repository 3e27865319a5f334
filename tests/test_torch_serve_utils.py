"""The serving path's host-side pieces: the port against the JAX package (CPU).

The native audio library (FLAC, peak, int16 conversion, resampling),
`save_audio` and the WAV stream header, the memory policy, the chat API's
parsing and routing, the merge keys of dynamic batching, and the local
checkpoint catalog. Inputs are numpy arrays and request dicts made from a
seed; every comparison is exact.
"""

import base64
import dataclasses
import itertools
import os

import numpy as np
import pytest

import acestep_tpu.service.inference as JS
import acestep_tpu.service.openrouter as JOR
import acestep_tpu_torch.service.inference as TS
import acestep_tpu_torch.service.openrouter as TOR
from acestep_tpu.service.params import GenerationConfig as JGC, GenerationParams as JGP
from acestep_tpu.utils import audio as jaudio, downloader as jdl, memory_config as jmem, native_audio as jnative
from acestep_tpu_torch.service.params import GenerationConfig as TGC, GenerationParams as TGP
from acestep_tpu_torch.utils import audio as taudio, downloader as tdl, memory_config as tmem
from acestep_tpu_torch.utils import native_audio as tnative

CKPT = os.path.join(os.path.dirname(__file__), "goldens", "checkpoint_tiny")


def _pcm(n, ch=2, seed=0):
    """int16 (n, ch): a loud tone plus noise, the kind of PCM a decode gives."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48_000.0
    tone = 12000 * np.sin(2 * np.pi * 220 * t)[:, None] + rng.normal(0, 2000, (n, ch))
    return np.clip(tone, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    if not jnative.available():
        pytest.fail("the JAX package's native audio library did not build (g++ and native/Makefile)")


@pytest.mark.parametrize("n,ch", [(48_000, 2), (4097, 1), (10, 2)])
def test_flac_encode_and_decode_match_jax(n, ch):
    pcm = _pcm(n, ch, seed=n)
    got, want = tnative.flac_encode(pcm, 48_000), jnative.flac_encode(pcm, 48_000)
    assert got == want
    dec, sr, bps = tnative.flac_decode(got)
    jdec = jnative.flac_decode(want)
    assert (sr, bps) == jdec[1:] == (48_000, 16)
    np.testing.assert_array_equal(dec, jdec[0])
    np.testing.assert_array_equal(dec.T, pcm)
    assert tnative.flac_decode(b"not flac") is None and jnative.flac_decode(b"not flac") is None


def test_peak_and_int16_conversions_match_jax():
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((2, 9001)) * 0.7).astype(np.float32)
    assert tnative.peak(audio) == jnative.peak(audio)
    for gain in (-1.0, 0.891, 2.0):
        np.testing.assert_array_equal(tnative.f32_to_i16(audio, gain), jnative.f32_to_i16(audio, gain))
    pcm = _pcm(777, seed=4)
    np.testing.assert_array_equal(tnative.i16_to_f32(pcm), jnative.i16_to_f32(pcm))


@pytest.mark.parametrize("sr_in,sr_out", [(44_100, 48_000), (24_000, 48_000), (48_000, 16_000)])
def test_resample_matches_jax(sr_in, sr_out):
    """Channel 0 bit for bit against the JAX package's stereo call, and every
    channel bit for bit against its mono call of that channel. (JAX's stereo
    rows are allocated longer than the C code's stride, so there channel 1
    comes back shifted; the port allocates the stride: ROADMAP C.)"""
    audio = (np.random.default_rng(sr_in).standard_normal((2, 5000)) * 0.3).astype(np.float32)
    got, want = tnative.resample(audio, sr_in, sr_out), jnative.resample(audio, sr_in, sr_out)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[0], want[0])
    for c in range(audio.shape[0]):
        np.testing.assert_array_equal(got[c], jnative.resample(audio[c : c + 1], sr_in, sr_out)[0])
    assert not np.array_equal(got[1], want[1])  # the JAX stereo call's shift, which the port does not have


@pytest.mark.parametrize("fmt", ["flac", "wav", "wav16", "wav32"])
@pytest.mark.parametrize("kind", ["int16", "float"])
def test_save_audio_matches_jax(tmp_path, fmt, kind):
    """Each format the port saves natively writes the JAX package's bytes,
    under the same extension."""
    pcm = _pcm(4800, seed=7).T
    audio = pcm if kind == "int16" else pcm.astype(np.float32) / 32768.0
    got = taudio.save_audio(str(tmp_path / "port"), audio, 48_000, fmt=fmt)
    want = jaudio.save_audio(str(tmp_path / "jax"), audio, 48_000, fmt=fmt)
    assert os.path.splitext(got)[1] == os.path.splitext(want)[1] == (".flac" if fmt == "flac" else ".wav")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_save_audio_without_ffmpeg_falls_back_to_wav(tmp_path, monkeypatch):
    monkeypatch.setattr(taudio, "_ffmpeg", lambda: None)
    assert taudio.save_audio(str(tmp_path / "a"), _pcm(100).T, 48_000, fmt="mp3").endswith("a.wav")


@pytest.mark.parametrize("frames,channels,sr", [(0, 2, 48_000), (12345, 2, 48_000), (7, 1, 800)])
def test_wav_header_matches_jax(frames, channels, sr):
    assert taudio.wav_header(frames, channels, sr) == jaudio.wav_header(frames, channels, sr)


@pytest.mark.parametrize("hbm_gb", [8, 16, 24, 40, 80, 95])
def test_runtime_memory_config_matches_jax(hbm_gb):
    assert dataclasses.asdict(tmem.get_runtime_memory_config(hbm_gb)) == dataclasses.asdict(
        jmem.get_runtime_memory_config(hbm_gb))


def test_detect_hbm_gb_override(monkeypatch):
    monkeypatch.setenv("ACESTEP_MAX_HBM_GB", "24")
    assert tmem.detect_hbm_gb() == jmem.detect_hbm_gb() == 24.0
    assert tmem.get_runtime_memory_config() == tmem.get_runtime_memory_config(24.0)


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


# The chat messages of tests/test_service.py's parse and routing tests, and
# one of each input mode.
CHAT_MESSAGES = [
    [{"role": "user", "content": [
        {"type": "text", "text": "cover this, 2 seconds"},
        {"type": "input_audio", "input_audio": {"data": _b64(b"AAA"), "format": "wav"}},
        {"type": "input_audio", "input_audio": {"data": _b64(b"BBB"), "format": "wav"}},
    ]}],
    [{"role": "user", "content": "tiny test, 2 seconds"}],
    [{"role": "system", "content": "ignored"},
     {"role": "user", "content": "<prompt>dark techno, 128 bpm</prompt><lyrics>[verse]\nla la</lyrics>"}],
    [{"role": "user", "content": "[Verse]\nline one\nline two\n[Chorus]\nhey"}],
    [{"role": "user", "content": "warm jazz 30 seconds\n# Lyrics\nsoft words here"}],
    [{"role": "user", "content": "a\nb\nc\nd"}],
    [{"role": "user", "content": [{"type": "audio", "audio": _b64(b"CC")}, {"type": "text", "text": ""}]}],
]


@pytest.mark.parametrize("i", range(len(CHAT_MESSAGES)))
def test_parse_chat_messages_matches_jax(i):
    (gp, gparts), (wp, wparts) = TOR.parse_chat_messages(CHAT_MESSAGES[i]), JOR.parse_chat_messages(CHAT_MESSAGES[i])
    assert gparts == wparts
    assert gp.to_dict() == wp.to_dict()


def test_route_chat_audio_matches_jax():
    for task, n in itertools.product([None, "text2music", "cover", "repaint", "lego", "extract", "complete",
                                      "music_continuation"], range(3)):
        assert TOR.route_chat_audio(task, n) == JOR.route_chat_audio(task, n)
    assert TOR.route_chat_audio(None, 1) == ("music_continuation", None, 0)
    assert TOR.route_chat_audio("cover", 2) == ("cover", 0, 1)


CHAT_BODIES = [
    {"messages": CHAT_MESSAGES[1]},
    {"messages": CHAT_MESSAGES[1], "sample_mode": 1, "seed": "3,4", "batch_size": 2, "temperature": 0.5},
    {"messages": CHAT_MESSAGES[2], "lyrics": "[Instrumental]", "audio_config": {
        "duration": 20, "bpm": 90, "vocal_language": "en", "key_scale": "C major", "time_signature": "3",
        "instrumental": False, "format": "flac"}, "thinking": True, "top_k": 5, "lm_cfg_scale": 2.5},
    {"messages": CHAT_MESSAGES[0], "task_type": "cover", "guidance_scale": 4.0, "inference_steps": 12,
     "repainting_start": 1.0, "repainting_end": 2.0, "audio_cover_strength": 0.5, "use_cot_caption": False},
]


@pytest.mark.parametrize("llm", [False, True])
@pytest.mark.parametrize("i", range(len(CHAT_BODIES)))
def test_build_chat_request_matches_jax(i, llm):
    (gp, gcfg, gparts, groute) = TOR.build_chat_request(CHAT_BODIES[i], llm)
    (wp, wcfg, wparts, wroute) = JOR.build_chat_request(CHAT_BODIES[i], llm)
    assert (gp.to_dict(), gcfg, gparts, groute) == (wp.to_dict(), wcfg, wparts, wroute)
    assert TOR.chat_body_overrides(CHAT_BODIES[i]) == JOR.chat_body_overrides(CHAT_BODIES[i])
    assert TOR.lm_sampling_overrides(CHAT_BODIES[i]) == JOR.lm_sampling_overrides(CHAT_BODIES[i])


def test_models_response_matches_jax():
    assert TOR.models_response() == JOR.models_response()
    assert TOR.models_response(["a", "b"]) == JOR.models_response(["a", "b"])


_MERGE_GRID = [
    dict(),
    dict(thinking=False),
    dict(thinking=False, duration=60.0),
    dict(thinking=False, duration=59.9999),
    dict(thinking=False, task_type="cover"),
    dict(thinking=False, audio_codes="<|audio_code_3|>"),
    dict(thinking=False, sample_mode=True),
    dict(thinking=False, sample_query="  "),
    dict(thinking=False, sample_query="jazz"),
    dict(thinking=False, use_format=True),
    dict(thinking=False, analysis_only=True),
    dict(thinking=False, reference_audio="r.wav"),
    dict(thinking=False, src_audio="s.wav"),
    dict(thinking=False, auto_lrc=True),
    dict(thinking=False, timesteps=[0.9, 0.5]),
    dict(thinking=False, inference_steps=50, guidance_scale=4.0, use_adg=True),
    dict(thinking=False, normalization_db=-3.0, enable_normalization=False, shift=2.0, infer_method="sde"),
    dict(thinking=False, instruction="custom:"),
]


@pytest.mark.parametrize("fields", _MERGE_GRID)
def test_merge_keys_match_jax(fields):
    for cfg in (dict(), dict(batch_size=2), dict(audio_format="wav"), dict(seeds=[5])):
        assert TS.merge_eligible(TGP(**fields)) == JS.merge_eligible(JGP(**fields))
        assert TS.merge_group_key(TGP(**fields), TGC(**cfg)) == JS.merge_group_key(JGP(**fields), JGC(**cfg))


def test_checkpoint_catalog_matches_jax(tmp_path, monkeypatch):
    """verify_checkpoint on the repo's tiny checkpoint and on its planner
    directory, and the catalog of a root with a complete and a broken model."""
    for comps in ("DIT_CHECKPOINT_COMPONENTS", "LM_CHECKPOINT_COMPONENTS"):
        assert getattr(tdl, comps) == getattr(jdl, comps)
    for path in (CKPT, os.path.join(CKPT, "acestep-5Hz-lm-0.6B"), str(tmp_path)):
        for comps in (None, tdl.LM_CHECKPOINT_COMPONENTS):
            assert tdl.verify_checkpoint(path, comps) == jdl.verify_checkpoint(path, comps)
    os.symlink(CKPT, tmp_path / "acestep-v15-tiny")
    (tmp_path / "acestep-5Hz-lm-broken").mkdir()
    (tmp_path / "other").mkdir()
    assert tdl.list_available_models(str(tmp_path)) == jdl.list_available_models(str(tmp_path))
    assert [m["complete"] for m in tdl.list_available_models(str(tmp_path))] == [False, True]
    monkeypatch.setenv("ACESTEP_CHECKPOINT_ROOT", str(tmp_path / "missing"))
    assert tdl.list_available_models() == []
