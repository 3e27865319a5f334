"""Checks that need the card (marked `cuda`; they skip without one):

    python -m pytest benchmark/tests -m cuda

The seeded weights repeat bit for bit on the card, and a tiny run of each
cell through the port's kernels in bf16 is correct.
"""

import io
import time

import pytest
import torch

from harness import runner, spec, weights
from tiny_cells import tiny_cell

CELLS = [w["name"] for w in spec.bench_spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for v in items for t in _flat(v)]


@pytest.mark.cuda
def test_weights_repeat_by_seed_on_the_card(card):
    cell = tiny_cell(CELLS[0])
    a = _flat(weights.make_weights(cell.config, 2**31 + 5, card))
    b = _flat(weights.make_weights(cell.config, 2**31 + 5, card))
    c = _flat(weights.make_weights(cell.config, 2**31 + 6, card))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_bf16_run_on_the_card_is_correct(card, name):
    cell = tiny_cell(name, steps=10 if cell_is_base(name) else None)
    out = runner.run_cell(cell, 2**31 + 11, 1.0, False, card, time.time())
    assert out["result"]["correct"], out["notes"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_fails_the_limits_at_the_cells_size(card, name):
    """The program passes and the fp8 control fails the cell's limits, on
    the first request of one seed at the cell's own size."""
    from harness import correct
    from control import readings

    cell = spec.load_cell(name)
    row = readings(cell, [2**31 + 21], [2**31 + 21], "fp8", card, torch.bfloat16, out=io.StringIO())[0]
    assert correct.verdict([row["program"]], cell.limits, 0)["correct"]
    assert not correct.verdict([row["control"]], cell.limits, 0)["correct"]


def cell_is_base(name):
    return spec.load_cell(name).config["sampler"]["inference_steps"] > 8
