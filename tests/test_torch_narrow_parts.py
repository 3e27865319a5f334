"""`tools/narrow_parts.py` on the CPU: every switch its builds set is one the
narrow route's source tests, and without a card the tool refuses to run."""

import re

import pytest
import torch

from acestep_tpu_torch.ops import cuda_lib
from acestep_tpu_torch.tools import narrow_parts


@pytest.mark.parametrize("build", sorted(narrow_parts.BUILDS))
def test_every_build_switch_is_in_the_source(build):
    src = (cuda_lib.SRC_DIR / "oobleck_generic.cu").read_text()
    for flag in narrow_parts.BUILDS[build]:
        macro = flag[2:].split("=")[0]
        assert re.search(rf"^#ifn?def {macro}$", src, re.M), flag


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        narrow_parts.main([])
