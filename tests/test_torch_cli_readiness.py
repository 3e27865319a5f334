"""The port's `cli download`, `verify-checkpoint`, `profile` and
`build-dataset` against the JAX package's commands on the CPU.

`verify-checkpoint` on a complete directory, an incomplete one and the LM
layout; `download` with the network patched (no source, the Hub, ModelScope:
`_reachable` and `snapshot_download` are replaced in both packages, and no
test opens a socket): equal exit codes and output. `profile`: the JAX
command and the port's drive one tiny port handler, so the rows' keys and
their non-timing values must be equal; `--trace-dir` writes a Chrome trace;
`--lm` rows on a tiny planner in each package (`build-dataset` against the
JAX command: `tests/test_torch_dataset_builder.py`).
The utilities of the same slice: `utils/debug` (the `ACESTEP_TPU_DEBUG`
domains) and `utils/audio`'s level helpers against the JAX package's.
"""

import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import acestep_tpu.cli as jcli
import acestep_tpu.pipeline.handler as JH
import acestep_tpu.utils.downloader as jdl
import acestep_tpu_torch.cli as tcli
import acestep_tpu_torch.lm.handler as TLM
import acestep_tpu_torch.pipeline.handler as TH
import acestep_tpu_torch.utils.downloader as tdl
from acestep_tpu_torch.config import Qwen3Config
from tests.test_torch_serve import BUCKETS, TINY_TEXT, _handler

CKPT = os.path.join(os.path.dirname(__file__), "goldens", "checkpoint_tiny")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny shapes the suite's parallel workers
    contending for the cores cost far more than a thread pool saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(capsys, argv):
    """(exit code, stdout) of the JAX command and of the port's."""
    out = []
    for main in (jcli.main, tcli.main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_verify_checkpoint_matches_jax(tmp_path, capsys):
    """Complete, incomplete, and the LM layout (by name, then by --lm),
    before and after its tokenizer files exist."""
    broken = tmp_path / "acestep-broken"
    broken.mkdir()
    (broken / "config.json").write_text("{}")
    lmdir = tmp_path / "acestep-5Hz-lm-0.6B"
    shutil.copytree(os.path.join(CKPT, "acestep-5Hz-lm-0.6B"), lmdir)
    plain = tmp_path / "plain"
    shutil.copytree(lmdir, plain)
    cases = [([CKPT], 0), ([str(broken)], 1), ([str(lmdir)], 1), ([str(plain), "--lm"], 1)]
    for args, rc in cases:
        want, got = _both(capsys, ["verify-checkpoint", *args])
        assert got == want and got[0] == rc, args
    assert "complete" in _both(capsys, ["verify-checkpoint", CKPT])[1][1]
    for d in (lmdir, plain):
        (d / "tokenizer.json").write_text("{}")
        (d / "tokenizer_config.json").write_text("{}")
    for args in ([str(lmdir)], [str(plain), "--lm"]):
        want, got = _both(capsys, ["verify-checkpoint", *args])
        assert got == want and got[0] == 0 and "tokenizer: ok" in got[1]


def _fake_snapshot(calls):
    def snapshot_download(repo, local_dir):
        calls.append((repo, local_dir))
        shutil.copytree(CKPT, local_dir)
        return local_dir

    return snapshot_download


@pytest.mark.parametrize("hosts", ["none", "hf", "modelscope"])
def test_download_matches_jax_with_the_network_patched(tmp_path, capsys, monkeypatch, hosts):
    """A complete cached model is certified without a source; a missing one
    fails with its components named when nothing answers, and is fetched
    from the host that answers (a fake `snapshot_download` copies
    checkpoint_tiny into place)."""
    reachable = {"none": set(), "hf": {"huggingface.co"}, "modelscope": {"www.modelscope.cn"}}[hosts]
    calls = []
    for mod in (jdl, tdl):
        monkeypatch.setattr(mod, "_reachable", lambda host, *a, **k: host in reachable)
    for name in ("huggingface_hub", "modelscope"):
        monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(snapshot_download=_fake_snapshot(calls)))

    shutil.copytree(CKPT, tmp_path / "jax" / "acestep-v15-turbo")
    shutil.copytree(CKPT, tmp_path / "torch" / "acestep-v15-turbo")
    outs = []
    for main, cache in ((jcli.main, "jax"), (tcli.main, "torch")):
        for model in ("acestep-v15-turbo", "acestep-v15-base"):
            rc = main(["download", "--models", model, "--cache-dir", str(tmp_path / cache)])
            outs.append((rc, capsys.readouterr().out.replace(str(tmp_path / cache), "CACHE")))
    assert outs[:2] == outs[2:]
    assert outs[0] == (0, "acestep-v15-turbo: CACHE/acestep-v15-turbo — complete\n")
    if hosts == "none":
        assert outs[1][0] == 1 and "(no source reachable) — MISSING: config, weights" in outs[1][1] and not calls
    else:
        assert outs[1] == (0, "acestep-v15-base: CACHE/acestep-v15-base — complete  [downloaded]\n")
        assert [c[0] for c in calls] == ["ACE-Step/ACE-Step-v1.5-base"] * 2
    assert tdl.pick_source() == jdl.pick_source() == {"none": None, "hf": "hf", "modelscope": "modelscope"}[hosts]


@pytest.fixture(scope="module")
def dit():
    with pytest.MonkeyPatch.context() as mp:
        for name, val in BUCKETS.items():
            mp.setattr(TH, name, val)
        yield _handler()


def _serve_handler(monkeypatch, mod, h):
    class Fake:
        def __new__(cls, *a, **k):
            return h

    monkeypatch.setattr(mod, "AceStepHandler", Fake)


# The profiler's trace export, slowed down in the test: a cell's wall must
# not include it (nor the profiler's start and stop).
EXPORT_DELAY_S = 3.0


def test_profile_rows_match_jax(dit, tmp_path, monkeypatch, capsys):
    """Both commands time one tiny port handler over a 2 s x (1, 2) matrix:
    the same table columns, rows with the same keys and the same non-timing
    values; the port's --trace-dir writes one trace a cell, and its walls
    stay near those of the port's run without traces however long the
    export takes."""
    import time

    monkeypatch.setattr(jcli, "_compile_cache", lambda: None)
    for mod in (JH, TH):
        _serve_handler(monkeypatch, mod, dit)
    for name, val in BUCKETS.items():
        monkeypatch.setattr(TH, name, val)
    real_export = torch.profiler.profile.export_chrome_trace

    def slow_export(self, path):
        time.sleep(EXPORT_DELAY_S)
        return real_export(self, path)

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", slow_export)
    rows = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main), ("traced", tcli.main)):
        argv = ["profile", "--random-init", "--durations", "2", "--batches", "1,2", "--steps", "8",
                "--json-out", str(tmp_path / f"{name}.json")]
        if name != "jax":
            argv += ["--device", "cpu"]
        if name == "traced":
            argv += ["--trace-dir", str(tmp_path / "traces")]
        assert main(argv) == 0
        text = capsys.readouterr().out
        assert "Xfer(s)" in text and "audio_s/s" in text
        with open(tmp_path / f"{name}.json") as f:
            rows[name] = json.load(f)
    timing = ("wall", "lm", "dit", "vae", "transfer", "throughput", "throughput_device")
    assert [sorted(r) for r in rows["torch"]] == [sorted(r) for r in rows["traced"]] == [
        sorted(r) for r in rows["jax"]]
    assert [{k: v for k, v in r.items() if k not in timing} for r in rows["traced"]] == [
        {k: v for k, v in r.items() if k not in timing} for r in rows["jax"]] == [
        {"duration": 2, "batch": b, "think": False, "steps": 8} for b in (1, 2)]
    for r, plain in zip(rows["traced"], rows["torch"]):
        assert r["throughput"] > 0 and r["throughput_device"] >= r["throughput"] and r["lm"] == 0.0
        assert r["wall"] < min(EXPORT_DELAY_S, 2 * plain["wall"] + 1.0), (r["wall"], plain["wall"])
    traces = sorted(os.listdir(tmp_path / "traces"))
    assert traces == [f"profile_d2_b{b}_think0_s8.json" for b in (1, 2)]
    with open(tmp_path / "traces" / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_profile_lm_rows_match_jax(tmp_path, monkeypatch, capsys):
    """`profile --lm` on a tiny planner in each package: equal exit codes,
    table headers and rows with the same keys and batches, a positive
    rate."""
    import acestep_tpu.lm.handler as JLM
    import jax.numpy as jnp
    from acestep_tpu.config import Qwen3Config as JQ

    handlers = {"jax": JLM.LLMHandler(JQ(**TINY_TEXT), dtype=jnp.float32),
                "torch": TLM.LLMHandler(Qwen3Config(**TINY_TEXT), dtype=torch.float32, device="cpu")}
    for name, mod in (("jax", JLM), ("torch", TLM)):
        monkeypatch.setattr(mod, "LLMHandler", lambda *a, _h=handlers[name], **k: _h)
    rows, heads = {}, {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        out = tmp_path / f"{name}.json"
        argv = ["profile", "--lm", "--random-init", "--batches", "1,2", "--lm-tokens", "8", "--json-out", str(out)]
        assert main(argv + (["--device", "cpu"] if name == "torch" else [])) == 0
        lines = capsys.readouterr().out.splitlines()
        heads[name] = [ln for ln in lines if "tok/s" in ln]
        rows[name] = json.loads(out.read_text())
    assert heads["torch"] == heads["jax"] and len(heads["jax"]) == 1
    assert [sorted(r) for r in rows["torch"]] == [sorted(r) for r in rows["jax"]] == [
        ["batch", "decode_s", "prefill_s", "tok_s"]] * 2
    assert [r["batch"] for r in rows["torch"]] == [r["batch"] for r in rows["jax"]] == [1, 2]
    assert all(r["tok_s"] > 0 for r in rows["torch"])


@pytest.mark.parametrize("env", ["", "1", "all", "lm,vae", " generation , io,", "nope"])
def test_debug_domains_match_jax(monkeypatch, capsys, env):
    """`ACESTEP_TPU_DEBUG` switches the same domains in both packages, and
    `log` / `span` write the same lines to stderr (the span's time aside)."""
    import re

    import acestep_tpu.utils.debug as jdebug
    import acestep_tpu_torch.utils.debug as tdebug

    monkeypatch.setenv("ACESTEP_TPU_DEBUG", env)
    assert tdebug.DOMAINS == jdebug.DOMAINS
    assert [tdebug.enabled(d) for d in tdebug.DOMAINS] == [jdebug.enabled(d) for d in jdebug.DOMAINS]
    err = []
    for mod in (jdebug, tdebug):
        for d in mod.DOMAINS:
            mod.log(d, f"message {d}")
            with mod.span(d, "work"):
                pass
        err.append(re.sub(r"took [0-9.]+s", "took Ts", capsys.readouterr().err))
    assert err[0] == err[1]
    assert ("[debug:lm] message lm" in err[1]) == (env in ("1", "all", "lm,vae"))


@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.7, 3.0])
def test_audio_levels_match_jax(scale):
    """`peak_normalize`, `clip_guard` and `is_silence` give the JAX package's
    arrays bit for bit and its answers, silence and clipping included."""
    import acestep_tpu.utils.audio as jaudio
    import acestep_tpu_torch.utils.audio as taudio

    x = (np.random.default_rng(1).standard_normal((2, 480)) * scale).astype(np.float32)
    for db in (-1.0, -6.0):
        np.testing.assert_array_equal(taudio.peak_normalize(x, db), jaudio.peak_normalize(x, db))
    np.testing.assert_array_equal(taudio.clip_guard(x), jaudio.clip_guard(x))
    for th in (-60.0, -20.0):
        assert taudio.is_silence(x, th) == jaudio.is_silence(x, th)
    assert taudio.is_silence(np.zeros((2, 0), np.float32)) and taudio.is_silence(x) == (scale < 1e-3)
