"""The dataset builder and `preprocess_audio_to_sample`: the port against the
JAX package on the CPU (fp32, tiny configs).

The scan (sidecar text, JSON and CSV files in the JAX package's order of
precedence, a nested directory), the CSV delimiters, the planner's labels
(greedy, through the same audio codes), label files both ways, and
preprocess-to-tensors: equal manifests and progress calls, each array within
`ENC_TOL`; the same through both packages' `cli build-dataset`. One set of weights and one silence latent in both packages (the
DiT's from the port's init, the planner's from the JAX package's); the JAX
builder runs once for the module and each test compares a part of the
port's run with it.
"""

import functools
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu.training.dataset as jdataset
import acestep_tpu.training.dataset_builder as jbuilder
import acestep_tpu_torch.pipeline.handler as TH
import acestep_tpu_torch.training.dataset as tdataset
import acestep_tpu_torch.training.dataset_builder as tbuilder
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu.lm.handler import LLMHandler as JLLM
from acestep_tpu.utils.tokenizer import load_tokenizer
from acestep_tpu_torch.config import AceStepConfig as TA, OobleckConfig as TO, Qwen3Config as TQ
from acestep_tpu_torch.lm.handler import LLMHandler as TLLM
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
# fp32 on both sides; the tolerance of the VAE encoder's check in
# tests/test_torch_audio_inputs.py (convolutions and products summed in
# other orders).
ENC_TOL = dict(rtol=1e-5, atol=1e-5)
# The planner labels with the understand API at this budget (the API's
# default is 512 tokens), greedy in both packages.
LABEL_TOKENS = 40
SECONDS = 0.3  # 14 400 samples at 48 kHz: 450 latent frames of the tiny VAE, 90 codes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny shapes the suite's parallel workers
    contending for the cores cost far more than a thread pool saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_wav(path, seed, seconds=SECONDS):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(int(2 * 48_000 * seconds)) * 2000).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48_000)
        w.writeframes(pcm.tobytes())


def _write(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def _rich_dir(d):
    """a: caption and lyrics sidecars; b: a JSON; c: a ';' CSV row; d:
    nothing; sub/e: a legacy .txt lyrics file and a JSON whose bpm the CSV
    row overrides."""
    os.makedirs(os.path.join(d, "sub"))
    for i, name in enumerate(("a", "b", "c", "d", "sub/e")):
        _write_wav(os.path.join(d, name + ".wav"), seed=i + 1)
    _write(os.path.join(d, "a.caption.txt"), "a dreamy synth piece\n")
    _write(os.path.join(d, "a.lyrics.txt"), "[Verse]\nla la la\n")
    _write(os.path.join(d, "b.json"), json.dumps({"bpm": 100, "keyscale": "C major", "caption": "jazz trio",
                                                  "language": "en"}))
    _write(os.path.join(d, "meta.csv"), "file;bpm;key;caption\nc.wav;128;A minor;csv caption\ne.wav;77.0;;\n")
    _write(os.path.join(d, "sub", "e.txt"), "old style lyrics")
    _write(os.path.join(d, "sub", "e.json"), json.dumps({"bpm": 90, "timesignature": "3"}))
    return d


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """The songs that are labelled and preprocessed: a with caption and
    lyrics sidecars, b with a JSON, c with a CSV row (bpm and key) and no
    caption, so that the planner writes it."""
    d = str(tmp_path_factory.mktemp("songs"))
    for i, name in enumerate(("a", "b", "c")):
        _write_wav(os.path.join(d, name + ".wav"), seed=i + 1)
    _write(os.path.join(d, "a.caption.txt"), "a dreamy synth piece")
    _write(os.path.join(d, "a.lyrics.txt"), "[Verse]\nla la la")
    _write(os.path.join(d, "b.json"), json.dumps({"bpm": 100, "keyscale": "C major", "caption": "jazz trio"}))
    _write(os.path.join(d, "meta.csv"), "file,bpm,key\nc.wav,128,A minor\n")
    return d


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return None if tree is None else jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def pairs():
    """Both packages' DiT handlers and planners on one set of weights. The
    DiT side's weights are the port's random init carried into the JAX
    handler (its serving layout through `stack_acestep_params`): the JAX
    init compiles op by op for most of a minute on the CPU. The VAE's Snake
    logs and biases are randomised, so that the latents are O(1)."""
    td = TH.AceStepHandler(TA(**_DIT), TO(**_VAE), TQ(**_TEXT), dtype=torch.float32, device="cpu")
    td.initialize_service(random_init=True)
    jd = JH.AceStepHandler(JA(**_DIT), JO(**_VAE), JQ(**_TEXT), dtype=jnp.float32)
    gen = torch.Generator().manual_seed(0)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: torch.randn(v.shape, generator=gen) * 0.3 if k in ("alpha", "beta", "bias") else perturb(v)
                    for k, v in tree.items()}
        return [perturb(v) for v in tree] if isinstance(tree, list) else tree

    td.vae_params = perturb(td.vae_params)
    jd.params = jdit.stack_acestep_params(_to_jax(td.params), jd.config)
    jd.vae_params, jd.text_params = _to_jax(td.vae_params), _to_jax(td.text_params)
    jd.text_tokenizer, jd.initialized = load_tokenizer(None), True
    sil = np.random.default_rng(9).standard_normal((1, 60, 64)).astype(np.float32) * 0.1
    jd.silence_latent = td.silence_latent = sil

    jcfg, tcfg = JQ(**_TEXT, tie_word_embeddings=False), TQ(**_TEXT, tie_word_embeddings=False)
    jl = JLLM(jcfg, dtype=jnp.float32)
    jl.initialize(random_init=True, seed=3)
    tl = TLLM(tcfg, dtype=torch.float32, device="cpu")
    tl.initialize(random_init=True)
    tl.params = from_jax_params(jax.tree.map(np.asarray, jl.params), tcfg)
    for llm in (jl, tl):
        for api in ("understand_audio_from_codes", "format_sample_from_input"):
            setattr(llm, api, functools.partial(getattr(llm, api), max_new_tokens=LABEL_TOKENS))
    return (jd, jl), (td, tl)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_run(pairs, audio_dir, tmp_path_factory):
    """The JAX package's builder, once: its tensors, then its labels."""
    (jd, jl), _ = pairs
    b = jbuilder.DatasetBuilder(jd, jl)
    b.scan_directory(audio_dir)
    out = str(tmp_path_factory.mktemp("jax_tensors"))
    calls = []
    written, msg = b.preprocess_to_tensors(out, progress_cb=lambda i, s, st: calls.append((i, s.filename, st)))
    tensors = {w: _npz(os.path.join(out, w)) for w in written}
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    label_msgs = b.label_all(temperature=0.0)
    labels_path = b.save_labels(str(tmp_path_factory.mktemp("jax_labels") / "labels.json"))
    return dict(written=written, msg=msg.replace(out, "OUT"), calls=calls, tensors=tensors, manifest=manifest,
                label_msgs=label_msgs, labels=[s.to_dict() for s in b.samples], labels_path=labels_path)


def test_scan_matches_jax(pairs, tmp_path):
    """Both packages' scans of one directory: equal samples and messages, each
    field from the source that wins."""
    _, (td, tl) = pairs
    d = _rich_dir(str(tmp_path / "songs"))
    jsamples, jmsg = jbuilder.DatasetBuilder(None).scan_directory(d)
    b = tbuilder.DatasetBuilder(td, tl)
    samples, msg = b.scan_directory(d)
    assert [s.to_dict() for s in samples] == [s.to_dict() for s in jsamples]
    assert msg == jmsg == "5 audio files (1 captions, 2 lyrics, 2 csv rows)"
    by = {s.filename: s for s in samples}
    assert (by["a.wav"].caption, by["a.wav"].lyrics, by["a.wav"].label_source) == (
        "a dreamy synth piece", "[Verse]\nla la la", "sidecar")
    assert (by["b.wav"].bpm, by["b.wav"].keyscale, by["b.wav"].language) == (100, "C major", "en")
    assert (by["c.wav"].bpm, by["c.wav"].keyscale, by["c.wav"].caption) == (128, "A minor", "csv caption")
    assert (by["e.wav"].bpm, by["e.wav"].timesignature, by["e.wav"].lyrics) == (77, "3", "old style lyrics")
    assert not by["d.wav"].labeled
    assert tbuilder.DatasetBuilder(td).scan_directory(os.path.join(d, "none")) == (
        jbuilder.DatasetBuilder(None).scan_directory(os.path.join(d, "none")))


@pytest.mark.parametrize("text,want", [
    ("File,BPM,Caption\ns.wav,90.0,hello\n", {"s.wav": {"bpm": 90, "caption": "hello"}}),
    ("file;bpm;keyscale;language\ns.wav;120;D minor;de\nt.wav;x;;\n",
     {"s.wav": {"bpm": 120, "keyscale": "D minor", "language": "de"}}),
    ("FILE\tKey\tTimeSignature\ns.wav\tE major\t6\n", {"s.wav": {"keyscale": "E major", "timesignature": "6"}}),
    ("name,bpm\ns.wav,90\n", {}),
])
def test_csv_delimiters_match_jax(tmp_path, text, want):
    """',', ';' and tab are sniffed, headers match in any case, a bad bpm is
    dropped, a CSV without a `file` column is skipped."""
    _write(str(tmp_path / "x.csv"), text)
    got = tbuilder.load_csv_metadata(str(tmp_path))
    assert got == jbuilder.load_csv_metadata(str(tmp_path)) == want


def test_lm_labels_match_jax(pairs, audio_dir, jax_run, tmp_path):
    """label_all on greedy planners: the same messages and labels as JAX's;
    sidecar and CSV fields win over the planner's; a sample whose audio
    cannot be read fails alone. Label files go both ways."""
    _, (td, tl) = pairs
    b = tbuilder.DatasetBuilder(td, tl)
    b.scan_directory(audio_dir)
    assert b.label_all(temperature=0.0) == jax_run["label_msgs"] == [
        f"labeled {n}.wav via lm" for n in "abc"]
    labels = [s.to_dict() for s in b.samples]
    assert labels == jax_run["labels"]
    by = {s["filename"]: s for s in labels}
    assert (by["a.wav"]["caption"], by["b.wav"]["bpm"], by["c.wav"]["bpm"]) == ("a dreamy synth piece", 100, 128)
    assert all(s["labeled"] and s["duration"] == pytest.approx(SECONDS) for s in labels)

    back = tbuilder.DatasetBuilder(td)
    assert back.load_labels(jax_run["labels_path"]) == 3
    assert [s.to_dict() for s in back.samples] == labels
    path = b.save_labels(str(tmp_path / "labels.json"))
    jb = jbuilder.DatasetBuilder(None)
    jb.load_labels(path)
    assert [s.to_dict() for s in jb.samples] == labels

    b.samples[1].audio_path = str(tmp_path / "missing.wav")
    msgs = b.label_all(temperature=0.0)
    assert msgs[1].startswith("label failed for b.wav:") and msgs[0] == msgs[2].replace("c.wav", "a.wav")
    assert b.label_sample(9) == (None, "invalid sample index 9")
    assert tbuilder.DatasetBuilder(td).label_sample(0) == (None, "invalid sample index 0")


def test_preprocess_to_tensors_matches_jax(pairs, audio_dir, jax_run, tmp_path):
    """Equal manifests, file names and progress calls; every array within
    ENC_TOL, integer masks equal. The port's tensors read back through its
    PreprocessedDataset; a sample that fails is left out alone."""
    _, (td, _) = pairs
    b = tbuilder.DatasetBuilder(td)
    b.scan_directory(audio_dir)
    out = str(tmp_path / "tensors")
    calls = []
    written, msg = b.preprocess_to_tensors(out, progress_cb=lambda i, s, st: calls.append((i, s.filename, st)))
    assert written == jax_run["written"] and calls == jax_run["calls"]
    assert msg.replace(out, "OUT") == jax_run["msg"] == "wrote 3/3 samples to OUT"
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == jax_run["manifest"]
    for name in written:
        got, want = _npz(os.path.join(out, name)), jax_run["tensors"][name]
        assert sorted(got) == sorted(want) == sorted(tdataset.PreprocessedDataset.REQUIRED)
        assert got["target_latents"].shape == (450, 64) and got["context_latents"].shape == (450, 128)
        assert np.abs(want["target_latents"]).max() > 0.1
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if want[k].dtype == np.int32:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], **ENC_TOL, err_msg=k)
    assert len(tdataset.PreprocessedDataset(out)) == 3

    b.samples[0].audio_path = str(tmp_path / "missing.wav")
    written, msg = b.preprocess_to_tensors(str(tmp_path / "again"), max_duration=0.1)
    assert written == ["b.npz", "c.npz"] and "(1 failed: ['a.wav']...)" in msg
    assert _npz(str(tmp_path / "again" / "b.npz"))["target_latents"].shape == (150, 64)


@pytest.mark.parametrize("metas", [None, {"bpm": 96, "keyscale": "G major", "duration": 12}])
def test_preprocess_audio_to_sample_matches_jax(pairs, metas):
    """One song straight through both packages' `preprocess_audio_to_sample`,
    with the default metadata and with a dict (`parse_metas`)."""
    (jd, _), (td, _) = pairs
    rng = np.random.default_rng(4)
    audio = (0.3 * rng.standard_normal((2, int(48_000 * SECONDS)))).astype(np.float32)
    kw = dict(metas=metas, vocal_language="en")
    want = jdataset.preprocess_audio_to_sample(jd, audio, "a dreamy synth piece", "[Verse]\nla la la", **kw)
    got = tdataset.preprocess_audio_to_sample(td, audio, "a dreamy synth piece", "[Verse]\nla la la", **kw)
    assert sorted(got) == sorted(want)
    assert got["context_latents"].shape == (450, 128)
    np.testing.assert_array_equal(got["context_latents"][:, :64], jd._silence_tiled(450))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], **ENC_TOL, err_msg=k)


def test_build_dataset_command_matches_jax(pairs, audio_dir, tmp_path, monkeypatch, capsys):
    """`cli build-dataset` (scan and preprocess) in both packages on the
    paired handlers: equal exit codes and output, equal manifests, each
    array within ENC_TOL."""
    import acestep_tpu.cli as jcli
    import acestep_tpu_torch.cli as tcli

    (jd, _), (td, _) = pairs
    monkeypatch.setattr(jcli, "_compile_cache", lambda: None)
    outs = {}
    for name, main, mod, h in (("jax", jcli.main, JH, jd), ("torch", tcli.main, TH, td)):
        monkeypatch.setattr(h, "initialize_service", lambda *a, **k: "initialized")  # keeps the paired weights
        monkeypatch.setattr(mod, "AceStepHandler", lambda *a, _h=h, **k: _h)
        out = str(tmp_path / name)
        argv = ["build-dataset", "--random-init", "--audio-dir", audio_dir, "--output-dir", out]
        rc = main(argv + (["--device", "cpu"] if name == "torch" else []))
        outs[name] = (rc, capsys.readouterr().out.replace(out, "OUT"), out)
    assert outs["torch"][:2] == outs["jax"][:2] == (0, "initialized\nscan: 3 audio files (1 captions, 1 lyrics, "
                                                       "1 csv rows)\nwrote 3/3 samples to OUT\n")
    (_, _, jout), (_, _, tout) = outs["jax"], outs["torch"]
    with open(os.path.join(jout, "manifest.json")) as f, open(os.path.join(tout, "manifest.json")) as g:
        assert json.load(g) == json.load(f)
    for name in ("a.npz", "b.npz", "c.npz"):
        got, want = _npz(os.path.join(tout, name)), _npz(os.path.join(jout, name))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **ENC_TOL, err_msg=k)
