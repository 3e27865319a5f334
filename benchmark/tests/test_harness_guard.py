"""The import guard: whole top-level names, and a reference free of the program."""

import os
import subprocess
import sys

from harness import guard
from harness.spec import BENCH_DIR


def test_forbidden_modules_compare_whole_top_level_names():
    assert guard.forbidden_modules(["acestep_tpu_torch", "acestep_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(["acestep_tpu.models.dit", "numpy"]) == ["acestep_tpu"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_a_run_imports_no_jax():
    """What a run imports (the harness, the reference, the port's service
    path) loads no forbidden module, in a process of its own."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness.runner, reference.model, control; "
            "import acestep_tpu_torch.service.inference, acestep_tpu_torch.pipeline.handler; "
            "from harness import guard; print(guard.forbidden_modules())") % (BENCH_DIR, os.path.dirname(BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_imports(os.path.join(BENCH_DIR, "reference")) == []


def test_reference_scan_finds_a_program_import(tmp_path):
    (tmp_path / "a.py").write_text("import numpy\nfrom acestep_tpu_torch.models import dit\n")
    (tmp_path / "b.py").write_text("import acestep_tpu_torchlike\nimport jax.numpy as jnp\n")
    bad = guard.reference_imports(str(tmp_path))
    assert len(bad) == 2 and "acestep_tpu_torch.models" in bad[0] and "jax.numpy" in bad[1]
