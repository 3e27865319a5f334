"""The audio-input tasks: the port against the JAX package on the CPU (fp32).

The VAE encoder (`encode_mean`, `encode_sample`, `tiled_encode`), the source
audio through the audio tokenizer (`convert_audio_to_codes`), the repaint and
outpaint masks, and whole requests of every task (cover, repaint, extract,
lego, complete; reference audio for timbre) through the handler and through
the service layer with WAV files, plus the WAV and FLAC readers. Both
packages get one set of weights (the JAX random init, carried over with
`from_jax_params`) and the same numpy inputs and noise; `prepare_noise` is
patched in both, because `jax.random` and `torch.Generator` differ.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu.service.inference as JS
import acestep_tpu.utils.audio as jaudio
import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.pipeline.handler as TH
import acestep_tpu_torch.service.inference as TS
import acestep_tpu_torch.utils.audio as taudio
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu.models import vae as jvae
from acestep_tpu.service.params import GenerationConfig as JGC, GenerationParams as JGP
from acestep_tpu_torch.config import AceStepConfig as TA, OobleckConfig as TO, Qwen3Config as TQ
from acestep_tpu_torch.models import vae as tvae
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.service.params import GenerationConfig as TGC, GenerationParams as TGP
from acestep_tpu_torch.utils.constants import TASK_INSTRUCTIONS

# The tiny configs of tests/test_torch_pipeline.py: 64-dim latents need an
# encoder of 128 channels (its last conv writes mean and scale); hop 32 at
# 800 Hz keeps 25 latent frames a second.
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
SR = _VAE["sampling_rate"]

# fp32 on both sides: the encoder's convs sum in other orders (1e-5); latents
# and audio at the tolerances of the text2music check in
# tests/test_torch_pipeline.py.
ENC_TOL = dict(rtol=1e-5, atol=1e-5)
LATENT_TOL = dict(rtol=1e-4, atol=1e-4)
AUDIO_ATOL = 2.5 / 32767


def _noise(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


def _audio(seconds, seed, channels=2):
    """A seeded stereo signal in [-1, 1]: two tones and some noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tones = [0.4 * np.sin(2 * np.pi * (37 + 11 * c) * t + c) for c in range(channels)]
    return (np.stack(tones) + 0.1 * rng.standard_normal((channels, t.size))).astype(np.float32)


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
    # A silence latent that is not all zeros, so that padding with it shows.
    sil = np.random.default_rng(9).standard_normal((1, 60, 64)).astype(np.float32) * 0.1
    jh.silence_latent = th.silence_latent = sil
    return jh, th


@pytest.fixture(scope="module")
def vae_weights():
    """Random Snake logs and biases on the tiny VAE, so every channel differs."""
    rng = np.random.default_rng(0)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                        if k in ("alpha", "beta", "bias") else perturb(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        return tree

    jp = perturb(jvae.init_oobleck_params(jax.random.PRNGKey(0), JO(**_VAE), jnp.float32))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TO(**_VAE))


def test_encode_mean_and_tiled_encode_match_jax(vae_weights):
    """One chunk, then 10 s in chunks of 4 s with 1 s of context each side
    (four chunks, the last one padded)."""
    jp, tp = vae_weights
    jcfg, tcfg = JO(**_VAE), TO(**_VAE)
    x = _audio(10.0, 1).T[None]
    want = np.asarray(jvae.encode_mean(jp, jcfg, jnp.asarray(x[:, :1600])))
    got = tvae.encode_mean(tp, tcfg, torch.tensor(x[:, :1600])).numpy()
    assert got.shape == (1, 50, 64)
    np.testing.assert_allclose(got, want, **ENC_TOL)
    want = np.asarray(jvae.tiled_encode(jp, jcfg, jnp.asarray(x), chunk_seconds=4, overlap_seconds=1))
    got = tvae.tiled_encode(tp, tcfg, torch.tensor(x), chunk_seconds=4, overlap_seconds=1).numpy()
    assert got.shape == want.shape == (1, 250, 64)
    np.testing.assert_allclose(got, want, **ENC_TOL)


def test_encode_sample_with_injected_noise(vae_weights):
    """The JAX package's draw handed to the port: mean + (softplus(scale) +
    1e-4) * noise agrees; without noise the port draws from its generator."""
    jp, tp = vae_weights
    jcfg, tcfg = JO(**_VAE), TO(**_VAE)
    x = _audio(2.0, 2).T[None]
    key = jax.random.PRNGKey(5)
    want = np.asarray(jvae.encode_sample(jp, jcfg, jnp.asarray(x), key))
    noise = np.asarray(jax.random.normal(key, want.shape, dtype=jnp.float32))
    got = tvae.encode_sample(tp, tcfg, torch.tensor(x), noise=torch.tensor(noise)).numpy()
    np.testing.assert_allclose(got, want, **ENC_TOL)
    a = tvae.encode_sample(tp, tcfg, torch.tensor(x), torch.Generator().manual_seed(3))
    b = tvae.encode_sample(tp, tcfg, torch.tensor(x), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not np.allclose(a.numpy(), got)


def test_convert_audio_to_codes_matches_jax(handlers):
    """3.9 s of audio: 97 latent frames, padded with silence to 100 (a
    pool-window multiple), 20 codes, each the same as the JAX package's."""
    jh, th = handlers
    audio = _audio(3.9, 3)
    want, got = jh.convert_audio_to_codes(audio), th.convert_audio_to_codes(audio)
    assert got == want and len(th.parse_audio_codes(got)) == 20
    np.testing.assert_allclose(th.encode_reference_audio(audio), jh.encode_reference_audio(audio), **ENC_TOL)


@pytest.mark.parametrize("starts,ends", [
    ([0.5, None], [1.5, None]),  # one repaint row, one full row
    ([-0.6, 1.0], [1.2, 3.0]),  # outpainting before t = 0, and a span to the end
    ([None, 0.0], [None, 5.0]),  # a span past the last frame
])
@pytest.mark.parametrize("codes", [(False, False), (True, False)])
def test_build_chunk_masks_and_src_latents_match_jax(handlers, starts, ends, codes):
    jh, th = handlers
    t_latent = 64
    sil = jh._silence_tiled(t_latent)
    target = np.random.default_rng(4).standard_normal((2, t_latent, 64)).astype(np.float32)
    instr = ["Generate audio semantic tokens based on the given conditions:", "Fill the audio:"]
    args = (2, t_latent, instr, list(codes), target, [True, True], starts, ends, sil)
    for w, g in zip(jh.build_chunk_masks_and_src_latents(*args), th.build_chunk_masks_and_src_latents(*args)):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


_TASKS = {
    "cover": dict(task_type="cover"),
    "cover_strength_noise": dict(task_type="cover", audio_cover_strength=0.5, cover_noise_strength=0.4),
    "repaint": dict(task_type="repaint", repainting_start=[0.5, 0.2], repainting_end=[1.5, 2.5]),
    "outpaint": dict(task_type="repaint", repainting_start=[-0.5, -0.5], repainting_end=[1.0, 1.0]),
    "extract": dict(task_type="extract"),
    "lego": dict(task_type="lego", instructions=[TASK_INSTRUCTIONS["lego"].format(TRACK_NAME="DRUMS")] * 2,
                 repainting_start=[0.4, 0.4], repainting_end=[1.6, 1.6]),
    "complete": dict(task_type="complete"),
    "reference": dict(task_type="text2music", reference=True),
}


@pytest.mark.parametrize("task", sorted(_TASKS))
def test_generate_music_tasks_match_jax(handlers, task):
    """Source latents (2.6 s of encoded audio for a 2 s request: cut to the
    bucket) and, for `reference`, one shared reference clip per row plus a
    second on row 0 (two packed refs, max_refs 2)."""
    jh, th = handlers
    kw = dict(_TASKS[task])
    src = jh.encode_reference_audio(_audio(2.6, 5))
    if kw.pop("reference", False):
        r1, r2 = _audio(1.0, 6), _audio(0.3, 7)
        kw["reference_audios"] = [[r1, r2], [r1]]
    else:
        kw["target_latents"] = src
    common = dict(captions=["an energetic synthwave track", "slow piano ballad"],
                  lyrics=["[Instrumental]", "[Verse]\nhello world"], batch_size=2, audio_duration=2.0,
                  seeds=[3, 4], use_random_seed=False, shift=3.0, normalize_db=-1.0)
    want = jh.generate_music(**common, **kw)
    got = th.generate_music(**common, **kw)
    assert got["spans"] == want["spans"]
    assert got["latents"].shape == want["latents"].shape == (2, 50, 64)
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    assert got["audios"].shape == want["audios"].shape == (2, 2, 50 * 32)
    assert np.abs(got["audios"]).max() > 0
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=AUDIO_ATOL)


@pytest.mark.parametrize("task,extra", [
    ("cover", {}),
    ("repaint", dict(repainting_start=0.5, repainting_end=-1)),  # a negative end repaints to the end
    ("text2music", dict(src_audio=None, reference_audio="ref")),
])
def test_service_generate_music_with_audio_files(handlers, tmp_path, monkeypatch, task, extra):
    """`src_audio` and `reference_audio` as WAV files written with each
    package's save_wav, read back at the tiny VAE's rate (the service reads
    at its default 48 kHz, which would resample this 800 Hz VAE's input)."""
    jh, th = handlers
    for mod in (jaudio, taudio):
        load = mod.load_audio
        monkeypatch.setattr(mod, "load_audio", lambda path, target_sr=SR, _load=load: _load(path, target_sr))
    src = str(tmp_path / "src.wav")
    ref = str(tmp_path / "ref.wav")
    taudio.save_wav(src, _audio(2.4, 8), SR)
    taudio.save_wav(ref, _audio(0.8, 9), SR)
    fields = dict(caption="warm lofi beat", lyrics="[Instrumental]", duration=2.0, seed=7, thinking=False,
                  task_type=task, src_audio=src)
    fields.update(extra)
    if fields.get("reference_audio") == "ref":
        fields["reference_audio"] = ref
    want = JS.generate_music(jh, None, JGP(**fields), JGC(batch_size=1, use_random_seed=False), save_audio=False)
    got = TS.generate_music(th, None, TGP(**fields), TGC(batch_size=1, use_random_seed=False), save_audio=False)
    assert want.success, want.error
    assert got.success, got.error
    g, w = got.audios[0]["audio"], want.audios[0]["audio"]
    assert g.dtype == w.dtype == np.int16 and g.shape == w.shape == (2, 250 * 32)  # clamped up to 10 s
    assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 2
    tc = got.extra_outputs["time_costs"]
    assert ("vae_encode_time_cost" in tc) == bool(fields.get("src_audio") or fields.get("reference_audio"))


def _flac_verbatim(pcm: np.ndarray, sr: int) -> bytes:
    """A FLAC stream of int16 (L, C) PCM in VERBATIM subframes: STREAMINFO,
    then frames of 4096 samples with their CRC-8 and CRC-16."""

    def crc(data, poly, bits):
        top, mask, c = 1 << (bits - 1), (1 << bits) - 1, 0
        for byte in data:
            c ^= byte << (bits - 8)
            for _ in range(8):
                c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        return c

    n, ch = pcm.shape
    bits = (sr << 44) | ((ch - 1) << 41) | (15 << 36) | n  # rate, channels, 16 bps, samples
    info = struct.pack(">HH", 4096, 4096) + b"\0" * 6 + bits.to_bytes(8, "big") + b"\0" * 16
    out = bytearray(b"fLaC" + bytes([0x80, 0, 0, 34]) + info)
    for fi, start in enumerate(range(0, n, 4096)):
        block = pcm[start : start + 4096]
        bs = block.shape[0]
        hdr = bytearray([0xFF, 0xF8, (7 << 4) | 0, ((ch - 1) << 4) | (4 << 1)])
        assert fi < 128
        hdr += bytes([fi]) + struct.pack(">H", bs - 1)
        hdr.append(crc(hdr, 0x07, 8))
        body = bytearray()
        for c in range(ch):
            body.append(0b00000010)  # subframe header: VERBATIM, no wasted bits
            body += block[:, c].astype(">i2").tobytes()
        frame = hdr + body
        frame += struct.pack(">H", crc(frame, 0x8005, 16))
        out += frame
    return bytes(out)


@pytest.mark.parametrize("form", ["wav_stereo", "wav_mono", "flac", "wav_resampled"])
def test_load_audio_matches_jax(tmp_path, monkeypatch, form):
    """WAV through scipy (stereo and mono, at the target rate), FLAC without
    ffmpeg through the decoders, and a 24 kHz WAV resampled to 48 kHz: both
    packages through their native resampler, channel 0 bit for bit, and
    channel 1 bit for bit against JAX's mono call of that channel (JAX's
    stereo call shifts it: ROADMAP C)."""
    import acestep_tpu.utils.native_audio as jnative

    rng = np.random.default_rng(10)
    pcm = rng.integers(-20000, 20000, (3000, 1 if form == "wav_mono" else 2)).astype(np.int16)
    sr = 24_000 if form == "wav_resampled" else 48_000
    path = str(tmp_path / ("a.flac" if form == "flac" else "a.wav"))
    if form == "flac":
        with open(path, "wb") as f:
            f.write(_flac_verbatim(pcm, sr))
        monkeypatch.setattr(taudio, "_ffmpeg", lambda: None)
        monkeypatch.setattr(jaudio, "_ffmpeg", lambda: None)
    else:
        taudio.save_wav(path, pcm.T, sr)
    want, got = jaudio.load_audio(path), taudio.load_audio(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (2, 6000 if form == "wav_resampled" else 3000)
    if form == "wav_resampled":
        assert jnative.available()
        np.testing.assert_array_equal(got[0], want[0])
        mono = jnative.resample((pcm[:, 1:2].T / 32768.0).astype(np.float32), sr, 48_000)[0]
        np.testing.assert_array_equal(got[1], mono)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0], pcm[:, 0] / 32768.0)


def test_load_flac_goes_through_the_native_decoder(tmp_path, monkeypatch):
    """Without ffmpeg a FLAC file is read by the native decoder (a stream
    the port's own encoder wrote), and the pure-Python decoder is not
    called; a stream the native decoder refuses goes to the pure-Python one."""
    from acestep_tpu_torch.utils import flac as tflac, native_audio as tnative

    rng = np.random.default_rng(12)
    pcm = rng.integers(-20000, 20000, (4000, 2)).astype(np.int16)
    path = str(tmp_path / "n.flac")
    with open(path, "wb") as f:
        f.write(tnative.flac_encode(pcm, 48_000))
    monkeypatch.setattr(taudio, "_ffmpeg", lambda: None)
    calls = []
    real = tnative.flac_decode
    monkeypatch.setattr(tnative, "flac_decode", lambda blob: calls.append("native") or real(blob))
    monkeypatch.setattr(tflac, "decode", lambda blob: pytest.fail("the pure-Python decoder ran"))
    got = taudio.load_audio(path)
    assert calls == ["native"]
    np.testing.assert_array_equal(got, pcm.T / 32768.0)

    monkeypatch.setattr(tnative, "flac_decode", lambda blob: None)
    monkeypatch.setattr(tflac, "decode", lambda blob: (pcm.T.astype(np.int32), 48_000, 16))
    np.testing.assert_array_equal(taudio.load_audio(path), pcm.T / 32768.0)


def test_save_wav_matches_jax(tmp_path):
    audio = np.clip(_audio(0.5, 11), -1, 1)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    taudio.save_wav(a, audio, SR)
    jaudio.save_wav(b, audio, SR)
    assert open(a, "rb").read() == open(b, "rb").read()
