"""The port's checkpoint loading against the JAX package's, on the CPU (fp32).

The twin of tests/test_checkpoint_load.py: `tests/goldens/checkpoint_tiny/`
is a reference-layout checkpoint written by the reference torch models (the
DiT's config.json and model.safetensors, silence_latent.pt, vae/,
Qwen3-Embedding-0.6B/ and an LM directory with genres_vocab.txt). Both
packages load it; the port's trees must equal `from_jax_params` of the JAX
load exactly, and one request from disk must match. The port reads
safetensors without the `safetensors` package; here that package writes the
files its reader is held to.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.pipeline.handler as TH
from acestep_tpu.lm.handler import LLMHandler as JLLMHandler
from acestep_tpu_torch.lm.handler import LLMHandler as TLLMHandler
from acestep_tpu_torch.params import from_jax_params, load_safetensors_state
from acestep_tpu_torch.utils.tokenizer import ByteFallbackTokenizer, load_tokenizer

CKPT = os.path.join(os.path.dirname(__file__), "goldens", "checkpoint_tiny")
LM_DIR = os.path.join(CKPT, "acestep-5Hz-lm-0.6B")
BUCKETS = dict(LATENT_BUCKETS=(64, 128, 256), TEXT_BUCKETS=(32, 64), LYRIC_BUCKETS=(32, 64))

# The tolerances of tests/test_torch_pipeline.py's text2music check: fp32
# latents through 8 DiT steps, and audio quantised to int16 on both sides.
LATENT_TOL = dict(rtol=1e-4, atol=1e-4)
AUDIO_ATOL = 2.5 / 32767


@pytest.fixture(scope="module")
def loaded():
    saved = {(m, k): getattr(m, k) for m in (JH, TH) for k in BUCKETS}
    for m in (JH, TH):
        for k, v in BUCKETS.items():
            setattr(m, k, v)
    jh = JH.AceStepHandler(dtype=jnp.float32)
    jh.initialize_service(CKPT)
    th = TH.AceStepHandler(dtype=torch.float32, device="cpu")
    th.initialize_service(CKPT)
    yield jh, th
    for (m, k), v in saved.items():
        setattr(m, k, v)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_config_json_parsed(loaded):
    """The values the reference AceStepConfig.to_dict() wrote, with the
    fsq_input_levels -> fsq_levels rename."""
    jh, th = loaded
    assert th.config == TH.AceStepConfig(**{f: getattr(jh.config, f) for f in jh.config.__dataclass_fields__})
    assert th.config.audio_acoustic_hidden_dim == 16 and th.config.in_channels == 48
    assert th.config.text_hidden_dim == 64 and tuple(th.config.fsq_levels) == (8, 8, 8, 5, 5, 5)
    assert th.vae_config.decoder_input_channels == 16 and th.vae_config.hop_length == 32
    assert th.text_config.hidden_size == 64 and th.text_config == TH.Qwen3Config(
        **{f: getattr(jh.text_config, f) for f in jh.text_config.__dataclass_fields__})


def test_loaded_params_equal_the_jax_load(loaded):
    """Each tree from disk equals the JAX package's load of the same files,
    carried over with `from_jax_params` (stacked DiT layers unstacked), bit
    for bit at fp32: the VAE's weight norm is folded in numpy float32 as
    the JAX package folds it."""
    jh, th = loaded
    for got, want, cfg in ((th.params, jh.params, th.config), (th.vae_params, jh.vae_params, th.vae_config),
                           (th.text_params, jh.text_params, th.text_config)):
        _assert_trees_equal(got, from_jax_params(jax.tree.map(np.asarray, want), cfg))
    assert _flat(th.vae_params)["/decoder/block/0/conv_t1/kernel"].dtype == torch.float32


@pytest.mark.parametrize("form", ["pt", "npy"])
def test_silence_latent_from_pt_and_npy(tmp_path, form):
    want = torch.load(os.path.join(CKPT, "silence_latent.pt"), map_location="cpu", weights_only=True).numpy()
    ckpt = CKPT
    if form == "npy":
        ckpt = _copy_without(tmp_path, "silence_latent.pt")
        np.save(os.path.join(ckpt, "silence_latent.npy"), want[0])  # 2-D: the loader adds the batch axis
    th = TH.AceStepHandler(dtype=torch.float32, device="cpu")
    th.initialize_service(ckpt)
    assert th.silence_latent.shape == (1, 25, 16) and th.silence_latent.dtype == np.float32
    assert np.abs(th.silence_latent).sum() > 0
    np.testing.assert_array_equal(th.silence_latent, want)


def test_generate_music_from_disk_matches_jax(loaded, monkeypatch):
    """One text2music request on weights loaded from disk by each package,
    with the same injected noise: latents and audio agree."""
    jh, th = loaded
    rng_noise = lambda shape: np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(jdit, "prepare_noise", lambda shape, seeds, dtype=jnp.bfloat16: jnp.asarray(rng_noise(shape), dtype))
    monkeypatch.setattr(tdit, "prepare_noise", lambda shape, seeds, dtype=torch.bfloat16, device=None:
                        torch.tensor(rng_noise(shape), dtype=dtype, device=device))
    kw = dict(captions="an energetic synthwave track", lyrics="[Instrumental]", audio_duration=2.0,
              batch_size=1, seeds=[3], use_random_seed=False, shift=3.0, normalize_db=-1.0)
    want, got = jh.generate_music(**kw), th.generate_music(**kw)
    assert got["latents"].shape == want["latents"].shape == (1, 50, 16)
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    assert got["audios"].shape == want["audios"].shape == (1, 2, 50 * 32)
    assert np.abs(got["audios"]).max() > 0
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=AUDIO_ATOL)


def _copy_without(tmp_path, *remove):
    dst = os.path.join(str(tmp_path), "ckpt")
    shutil.copytree(CKPT, dst, ignore=shutil.ignore_patterns("acestep-5Hz-lm-0.6B"))
    for rel in remove:
        p = os.path.join(dst, rel)
        if os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.remove(p)
    return dst


@pytest.mark.parametrize(
    "remove,needle",
    [
        (("silence_latent.pt",), "silence_latent"),
        (("vae",), "VAE"),
        (("Qwen3-Embedding-0.6B",), "text encoder"),
        (("model.safetensors",), "safetensors"),
    ],
)
def test_missing_component_hard_fails(tmp_path, remove, needle):
    """A partial checkpoint fails at load with the component named, and the
    handler keeps nothing."""
    dst = _copy_without(tmp_path, *remove)
    th = TH.AceStepHandler(dtype=torch.float32, device="cpu")
    with pytest.raises(FileNotFoundError, match=needle):
        th.initialize_service(dst)
    assert not th.initialized and th.params is None and th.vae_params is None


def test_lm_checkpoint_load_with_genres_vocab():
    jl = JLLMHandler(dtype=jnp.float32)
    jl.initialize(LM_DIR)
    tl = TLLMHandler(dtype=torch.float32, device="cpu")
    tl.initialize(LM_DIR)
    assert tl.initialized and tl.config.hidden_size == 64 and tl.config.vocab_size == 512
    assert tl.genres_vocab == jl.genres_vocab == ["synthwave", "ambient", "rock"]
    assert "genres" in tl.fsm._tries  # the FSM constrains the CoT's genres to the vocabulary
    _assert_trees_equal(tl.params, from_jax_params(jax.tree.map(np.asarray, jl.params), tl.config))
    out = tl.generate_with_stop_condition("energetic synthwave", "[Instrumental]", temperature=0.8,
                                          stop_at_reasoning=True, seed=0)
    md = out["metadata"]
    assert isinstance(md.get("bpm"), int) and 30 <= md["bpm"] <= 300
    assert isinstance(md.get("duration"), int) and 10 <= md["duration"] <= 600


def test_lm_missing_weights_hard_fails(tmp_path):
    d = tmp_path / "lm"
    d.mkdir()
    shutil.copy(os.path.join(LM_DIR, "config.json"), d)
    tl = TLLMHandler(dtype=torch.float32, device="cpu")
    with pytest.raises(FileNotFoundError, match="safetensors"):
        tl.initialize(str(d))
    assert not tl.initialized


def test_tokenizer_falls_back_to_bytes_without_tokenizer_files():
    """checkpoint_tiny has no tokenizer files: the AutoTokenizer branch
    falls back to the byte tokenizer, as the JAX package's does."""
    from acestep_tpu.utils.tokenizer import load_tokenizer as jload

    te = os.path.join(CKPT, "Qwen3-Embedding-0.6B")
    tok = load_tokenizer(te)
    assert isinstance(tok, ByteFallbackTokenizer)
    assert type(jload(te)).__name__ == type(tok).__name__
    assert tok.encode("ab") == jload(te).encode("ab") == [100, 101]


_DTYPES = {
    "F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16, "I64": torch.int64, "I32": torch.int32,
}


@pytest.mark.parametrize("name", sorted(_DTYPES))
def test_safetensors_reader_matches_safe_open(tmp_path, name):
    """Each dtype the reader takes, against the `safetensors` package's own
    reader, with shapes of odd byte sizes (the later tensors start unaligned
    to their element size in some files) and an empty tensor."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    dtype = _DTYPES[name]
    g = torch.Generator().manual_seed(len(name))
    make = (lambda *s: torch.randn(s, generator=g).to(dtype)) if dtype.is_floating_point else (
        lambda *s: torch.randint(-2**31, 2**31 - 1, s, generator=g, dtype=torch.int64).to(dtype))
    tensors = {"a": make(3, 5), "b.weight": make(7), "c": make(2, 1, 3), "empty": make(0, 4),
               "tail": torch.arange(3, dtype=torch.uint8).to(dtype)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path)
    got = load_safetensors_state(path)
    with safe_open(path, framework="pt") as f:
        want = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype == dtype and got[k].shape == want[k].shape, k
        assert got[k].device.type == "cpu"
        assert torch.equal(got[k], want[k]), k


def test_safetensors_reader_reads_a_directory_in_sorted_order_and_refuses_other_dtypes(tmp_path):
    from safetensors.torch import save_file

    save_file({"x": torch.ones(2), "y": torch.zeros(1)}, str(tmp_path / "b.safetensors"))
    save_file({"x": torch.full((3,), 2.0)}, str(tmp_path / "a.safetensors"))
    got = load_safetensors_state(str(tmp_path))
    assert got["x"].tolist() == [1.0, 1.0] and got["y"].tolist() == [0.0]  # b.* read last wins
    bad = tmp_path / "bad"
    bad.mkdir()
    save_file({"u": torch.ones(4, dtype=torch.float64)}, str(bad / "m.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        load_safetensors_state(str(bad))
