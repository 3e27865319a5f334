"""The PyTorch port stands alone: no JAX, no `acestep_tpu`, no silent CPU run."""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, importlib.util, pkgutil, sys
import acestep_tpu_torch
names = [m.name for m in pkgutil.walk_packages(acestep_tpu_torch.__path__, "acestep_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "acestep_tpu.")) or m == "acestep_tpu")
# Imports inside functions too: every import statement of every module and of chip_smoke.py.
import ast, glob
def jaxy(m):
    return m in ("jax", "jaxlib", "acestep_tpu") or m.startswith(("jax.", "jaxlib.", "acestep_tpu."))
for path in glob.glob("acestep_tpu_torch/**/*.py", recursive=True) + ["chip_smoke.py"]:
    for node in ast.walk(ast.parse(open(path).read())):
        mods = [a.name for a in node.names] if isinstance(node, ast.Import) else (
            [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        bad += [f"{path}: {m}" for m in mods if jaxy(m)]
print(len(names), bad)
need = {"acestep_tpu_torch.lm.handler", "acestep_tpu_torch.lm.sampling", "acestep_tpu_torch.lm.prefix_cache",
        "acestep_tpu_torch.lm.dfa", "acestep_tpu_torch.lm.constrained", "acestep_tpu_torch.service.inference",
        "acestep_tpu_torch.service.params", "acestep_tpu_torch.tools.probe_kernel_parts",
        "acestep_tpu_torch.ops.attention_probe", "acestep_tpu_torch.ops.fsq",
        "acestep_tpu_torch.service.api_server", "acestep_tpu_torch.service.openrouter",
        "acestep_tpu_torch.service.webui", "acestep_tpu_torch.utils.native_audio",
        "acestep_tpu_torch.utils.memory_config", "acestep_tpu_torch.utils.progress",
        "acestep_tpu_torch.utils.logbuffer", "acestep_tpu_torch.utils.local_cache",
        "acestep_tpu_torch.utils.env", "acestep_tpu_torch.utils.downloader",
        "acestep_tpu_torch.training", "acestep_tpu_torch.training.lora", "acestep_tpu_torch.training.trainer",
        "acestep_tpu_torch.training.train_step", "acestep_tpu_torch.training.optim",
        "acestep_tpu_torch.training.dataset", "acestep_tpu_torch.training.estimate",
        "acestep_tpu_torch.training.presets", "acestep_tpu_torch.ops.attention",
        "acestep_tpu_torch.ops.flash_attention", "acestep_tpu_torch.cli",
        "acestep_tpu_torch.pipeline.lora_manager", "acestep_tpu_torch.scoring",
        "acestep_tpu_torch.scoring.alignment", "acestep_tpu_torch.scoring.lyric_score",
        "acestep_tpu_torch.scoring.lm_score", "acestep_tpu_torch.training.dataset_builder",
        "acestep_tpu_torch.service.train_api", "acestep_tpu_torch.utils.debug",
        "acestep_tpu_torch.utils.precision", "acestep_tpu_torch.parallel", "acestep_tpu_torch.parallel.mesh"}
missing = sorted(need - set(names))
print(missing)
sys.exit(1 if bad or missing or len(names) < 25 else 0)
"""


def test_port_imports_no_jax_and_no_acestep_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_package_data_covers_csrc_and_presets():
    """Every file under `csrc/` and `training/presets/` that is not a Python
    module matches a `package-data` pattern of pyproject.toml, so a wheel
    carries what the port builds at first use (the FLAC writer's
    `acestep_audio.cpp` included) and the presets it loads; and every module
    of the port (the dataset builder, the training REST service, the debug
    and precision utilities among them) lies in a package that the
    `packages.find` settings include."""
    import fnmatch
    import tomllib

    import setuptools

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        settings = tomllib.load(f)["tool"]["setuptools"]
    patterns = settings["package-data"]["acestep_tpu_torch"]
    packages = set(setuptools.find_packages(where=REPO, include=settings["packages"]["find"]["include"]))
    pkg = os.path.join(REPO, "acestep_tpu_torch")
    modules = [os.path.relpath(os.path.join(d, name), REPO) for d, _, names in os.walk(pkg)
               for name in names if name.endswith(".py")]
    assert {"acestep_tpu_torch/training/dataset_builder.py", "acestep_tpu_torch/service/train_api.py",
            "acestep_tpu_torch/utils/debug.py", "acestep_tpu_torch/utils/precision.py"} <= set(modules)
    outside = [m for m in modules if os.path.dirname(m).replace(os.sep, ".") not in packages]
    assert not outside, outside
    files = [os.path.join(d, name) for d in ("csrc", os.path.join("training", "presets"))
             for name in sorted(os.listdir(os.path.join(pkg, d)))
             if os.path.isfile(os.path.join(pkg, d, name)) and not name.endswith(".py")]
    assert any(f.endswith(".cpp") for f in files) and any(f.endswith(".json") for f in files)
    missing = [f for f in files if not any(fnmatch.fnmatch(f, p) for p in patterns)]
    assert not missing, missing


def test_entry_points_refuse_a_silent_cpu_run(monkeypatch):
    from acestep_tpu_torch.cli import main as cli_main
    from acestep_tpu_torch.device import resolve_device
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.service.api_server import main as api_main
    from acestep_tpu_torch.tools.probe_kernel_parts import main as probe_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AceStepHandler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMHandler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["generate", "--random-init", "--thinking", "--caption", "x"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_main(["--seq", "128"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["serve", "--random-init", "--port", "0"])
    for cmd in ("train", "estimate"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_main([cmd, "--random-init", "--dataset-dir", "."])
    for argv in (["build-dataset", "--random-init", "--audio-dir", "."], ["profile", "--random-init"],
                 ["profile", "--lm", "--random-init"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api_main(["--port", "0"])
    assert resolve_device("cpu").type == "cpu"


def test_cli_writes_stereo_int16_wav(tmp_path):
    """`generate --format wav` saves through `save_audio`: 16-bit stereo."""
    from acestep_tpu_torch.utils.audio import save_audio

    pcm = (np.arange(2 * 480, dtype=np.int64).reshape(2, 480) % 200 - 100).astype(np.int16)
    path = save_audio(str(tmp_path / "a"), pcm, 48000, fmt="wav")
    assert path == str(tmp_path / "a.wav")
    with wave.open(path, "rb") as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()) == (2, 2, 48000, 480)
        back = np.frombuffer(f.readframes(480), "<i2").reshape(480, 2).T
    np.testing.assert_array_equal(back, pcm)
