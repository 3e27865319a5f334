"""A run of each cell at tiny widths on the CPU, through the port's plain
versions: it passes as it stands, and `correct` comes out false when the
path under the window is broken, and when the fp8 control stands in for the
program.

The harness's look for a chip is skipped (`runner.run_cell` on the CPU, the
program in fp32); the limits are each cell's own.
"""

import time

import pytest
import torch

from harness import correct, runner, spec
from tiny_cells import tiny_cell

CELLS = [w["name"] for w in spec.bench_spec()["workloads"]]
STEPS = {"base.apg-4x60": 10}


def run(name, seconds=0.5, trace=False):
    cell = tiny_cell(name, steps=STEPS.get(name))
    return runner.run_cell(cell, 2**31 + 99, seconds, trace, "cpu", time.time(), dtype=torch.float32)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct(name):
    out = run(name)
    r = out["result"]
    assert r["correct"], out["notes"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    assert set(r["compared"]) == {"latent_rel_l2", "pcm_rel_l2"}
    assert {m["name"] for m in spec.load_cell(name).end_to_end} == set(r["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run_reports_its_per_layer_metrics(name):
    out = run(name, trace=True)
    r = out["result"]
    assert r["correct"]
    names = {m["name"] for m in spec.load_cell(name).per_layer}
    assert set(r["metrics"]) <= names
    # Read from the untraced window; the CPU has no device trace for the rest.
    assert {"mfu.batch", "dit_share.batch"} <= set(r["metrics"])
    assert out["notes"]["traced_requests"] >= 1 and out["notes"]["requests"] >= 1
    assert r["attempted"] == out["notes"]["traced_requests"] + out["notes"]["requests"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _denoise_leaves_state(monkeypatch):
    """Every DiT forward returns a zero velocity: each step returns its state unchanged."""
    from acestep_tpu_torch.models import dit

    orig = dit.dit_forward
    monkeypatch.setattr(dit, "dit_forward", lambda *a, **kw: torch.zeros_like(orig(*a, **kw)))


def _rows_left_out(monkeypatch):
    """Only the first half of the batch is denoised; the rest copy it."""
    from acestep_tpu_torch.models import dit

    orig = dit.generate_audio

    def half(*a, **kw):
        out = orig(*a, **kw)
        x = out["target_latents"]
        keep = max(1, x.shape[0] // 2)
        out["target_latents"] = torch.cat([x[:keep]] * (-(-x.shape[0] // keep)))[: x.shape[0]]
        return out

    monkeypatch.setattr(dit, "generate_audio", half)


def _answer_altered(monkeypatch):
    """The decode's second half of each chunk is lost where it is produced."""
    from acestep_tpu_torch.models import vae

    orig = vae.decode

    def decode(p, cfg, z):
        w = orig(p, cfg, z)
        w[:, w.shape[1] // 2:] = 0
        return w

    monkeypatch.setattr(vae, "decode", decode)


FAULTS = {"denoise_unchanged": _denoise_leaves_state, "rows_left_out": _rows_left_out,
          "answer_altered": _answer_altered}


# A batch of one row has no half to leave out.
CASES = [(name, fault) for name in CELLS for fault in sorted(FAULTS)
         if fault != "rows_left_out" or spec.load_cell(name).traffic["batch"] > 1]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(name)
    assert not out["result"]["correct"], out["result"]["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_stands_far_from_the_reference(name):
    """At tiny widths the fp8 control (the reference in fp8 in the program's
    place) reads hundreds of times farther from the fp32 reference than the
    program in fp32 does. That it fails the cell's limits holds at the
    cell's own size: `test_harness_card.py` and `control.py` on the card."""
    from harness import weights
    from reference import model as reference

    cell = tiny_cell(name, steps=STEPS.get(name))
    w = weights.make_weights(cell.config, 7, "cpu", torch.float32)
    material = runner.traffic.prompts(cell.traffic)
    req = runner.traffic.request(cell.traffic, material, 7, 0)
    want = reference.generate(w, cell.config, req, "cpu")
    low = correct.distances(reference.generate(w, cell.config, req, "cpu", precision="fp8"), want)
    out = run(name)
    high = out["notes"]["readings"][0]
    assert low["latent_rel_l2"] > 100 * high["latent_rel_l2"]
    assert low["pcm_rel_l2"] > 100 * high["pcm_rel_l2"]


def test_idle_share_and_mfu_read_the_untraced_window():
    """The idle share is the untraced window's: the device's busy time for a
    second of audio (the traced window's) times its audio, over its length;
    `mfu` is that window's operations over its length."""
    from harness import readers, trace

    cell = tiny_cell("base.apg-4x60")
    run = runner.Run(cell, 0)
    req = runner.traffic.request(cell.traffic, runner.traffic.prompts(cell.traffic), 0, 0)
    run.records = [dict(ok=True, audio_s=240.0, request=req)] * 4
    run.window_s = 20.0
    run.traced_records = [dict(ok=True, audio_s=240.0, request=req)] * 2
    run.trace = trace.Trace(window_s=30.0, busy_s=8.0, spans={}, device_ops=[], idle_gaps=[], kernels=0,
                            unattributed=0, least_lead_us=None)
    assert readers.device_idle_share(run) == pytest.approx(20.0)  # 1 - 8 / 480 * 960 / 20
    flops = run.request_flops(req)["total"]
    assert readers.mfu(run) == pytest.approx(100 * 4 * flops / (20.0 * readers.measure.PEAK_BF16_FLOPS))
    run.trace = None
    assert readers.device_idle_share(run) is None
