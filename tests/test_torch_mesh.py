"""Data parallelism of the port (`acestep_tpu_torch.parallel`, the handler's
mesh methods) on the CPU, in gloo groups of spawned ranks.

`make_mesh`, `shard_batch` and `shard_params_dp` run in groups of 8 and 2
ranks (`test_mesh_shapes` of `tests/test_multichip.py` is the model). One
group of 2 ranks runs every dp = 2 request of `tests/torch_mesh_ranks.py`
once, on handlers that load the JAX handler's weights saved as numpy (the
ranks import no JAX). Its results are held against JAX's dp = 2 mesh path on
2 of the 8 simulated CPU devices, and against the port's dp = 1 in this
process, with the tolerances of `tests/test_torch_pipeline.py`. Both packages
draw noise per seed with numpy (`prepare_noise` patched), because
`jax.random` and `torch.Generator` differ. Every group runs under a deadline
and a 60 s group timeout, and the tests check that no rank is left.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessExitedException

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu_torch.models.dit as tdit
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu.parallel.mesh import make_mesh as jax_make_mesh
from acestep_tpu_torch.parallel.mesh import launch
from acestep_tpu_torch.training.lora import init_lora_params
from tests import torch_mesh_ranks as R

LATENT_TOL = dict(rtol=1e-4, atol=1e-4)
AUDIO_ATOL = 2.5 / 32767
DEADLINE_S = 240.0


def _ranks_of_this_process() -> list:
    """Pids of the spawned ranks (`spawn_main`) whose parent is this process."""
    pids = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and b"spawn_main" in cmd:
            pids.append(int(d))
    return pids


@pytest.fixture(scope="module")
def jax_handler():
    with pytest.MonkeyPatch.context() as mp:
        for name, val in R.BUCKETS.items():
            mp.setattr(JH, name, val)
        mp.setattr(jdit, "prepare_noise",
                   lambda shape, seeds, dtype=jnp.bfloat16: jnp.asarray(R.seed_noise(shape, seeds), dtype))
        jh = JH.AceStepHandler(JA(**R.DIT), JO(**R.VAE), JQ(**R.TEXT), dtype=jnp.float32)
        jh.initialize_service(random_init=True)
        yield jh


@pytest.fixture(scope="module")
def files(jax_handler, tmp_path_factory):
    """The JAX handler's weights as numpy, and a rank-4 LoRA adapter over
    every target of the port's decoder (B drawn, so it changes the output)."""
    d = tmp_path_factory.mktemp("mesh")
    weights = str(d / "weights.pkl")
    with open(weights, "wb") as f:
        pickle.dump({k: jax.tree.map(np.asarray, getattr(jax_handler, k))
                     for k in ("params", "vae_params", "text_params")}, f)
    rng = np.random.default_rng(0)
    factors = init_lora_params(0, R.tiny_handler(weights).params["decoder"], rank=4)
    adapter = str(d / "adapter.npz")
    np.savez(adapter, **{f"{p}|{k}": (rng.standard_normal(tuple(v.shape)) * 0.2).astype(np.float32)
                         for p, ab in factors.items() for k, v in ab.items()},
             __meta__=np.asarray('{"rank": 4, "alpha": 8.0, "adapter_type": "lora"}'))
    return weights, adapter


@pytest.fixture(scope="module")
def dp2(files):
    """Every dp = 2 case, from one group of 2 spawned ranks."""
    return launch(R.dp2_cases, 2, *files, timeout=R.TIMEOUT_S, deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def dp1(files):
    """The same requests on one port handler in this process (dp = 1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdit, "prepare_noise", R.prepare_noise)
        h = R.tiny_handler(files[0])
        out = {}
        for name, kw in R.REQUESTS.items():
            if name == "lora":
                h.load_lora("style", files[1])
                out["lora_on"] = h.generate_music(**kw)
                h.toggle_lora("style", False)
                out["lora_off"] = h.generate_music(**kw)
            else:
                out[name] = h.generate_music(**kw)
        yield out


@pytest.mark.parametrize("nprocs", [2, 8])
def test_mesh_shapes_rows_and_replication(nprocs):
    """make_mesh's (dp, sp, tp) shapes, dp defaulting to the world size and
    a product that does not match raising; each rank's rows of a tree, with
    0-d, non-array and non-divisible leaves whole; the replication check
    passing, then naming the leaf that one rank perturbed, on every rank."""
    every = launch(R.mesh_cases, nprocs, timeout=R.TIMEOUT_S, deadline_s=DEADLINE_S)
    assert len(every) == nprocs
    x = np.arange(8 * 3).reshape(8, 3)
    for rank, out in enumerate(every):
        if nprocs == 8:
            assert out["shapes"] == [{"dp": 4, "sp": 1, "tp": 2}, {"dp": 2, "sp": 2, "tp": 2},
                                     {"dp": 8, "sp": 1, "tp": 1}]
        else:
            assert out["shapes"] == [{"dp": 2, "sp": 1, "tp": 1}] * 2
        assert out["mismatch"] == f"dp(3) * sp(1) * tp(1) != devices({nprocs})"
        dp = out["shapes"][0]["dp"]
        i = out["coord"]["dp"]
        assert out["coord"] == dict(zip(("dp", "sp", "tp"), np.unravel_index(rank, (dp, 1, nprocs // dp))))
        k = 8 // dp
        rows = out["rows"]
        np.testing.assert_array_equal(rows["x"], x[i * k:(i + 1) * k])
        torch.testing.assert_close(rows["t"], torch.arange(16.0).reshape(8, 2)[i * k:(i + 1) * k])
        assert rows["scalar"] == np.float32(2.0) and rows["meta"] == "text"
        np.testing.assert_array_equal(rows["odd"][0], np.arange(3))
        assert out["same"]
        assert out["perturbed"] == f"weights differ across ranks: leaf '/b/0' of rank {nprocs - 1} is not rank 0's"


def test_dp2_text2music_matches_jax_mesh(jax_handler, dp2, dp1):
    """Batch 4 at dp = 2 against JAX's dp = 2 mesh (2 of the 8 simulated
    devices), and against the port's dp = 1."""
    jax_handler.enable_data_parallel(jax_make_mesh(dp=2, devices=jax.devices()[:2]))
    want = jax_handler.generate_music(**R.REQUESTS["text2music"])
    got = dp2["text2music"]
    assert got["latents"].shape == want["latents"].shape == (4, 50, 64)
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    assert got["audios"].shape == want["audios"].shape == (4, 2, 50 * 32)
    assert np.abs(got["audios"]).max() > 0
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=AUDIO_ATOL)
    np.testing.assert_allclose(got["latents"], dp1["text2music"]["latents"], **LATENT_TOL)
    np.testing.assert_allclose(got["audios"], dp1["text2music"]["audios"], rtol=0, atol=AUDIO_ATOL)
    assert got["seeds"] == [0, 1, 2, 3] and set(got["time_costs"]) >= {"diffusion_time_cost", "total_time_cost"}


@pytest.mark.parametrize("case", ["batch3", "sde", "sde_injected", "apg", "adg", "references", "lora_on",
                                  "lora_off", "condition"])
def test_dp2_matches_dp1(dp2, dp1, case):
    """A batch that does not divide by dp (rank 0 alone); SDE, whose step
    noise is the whole batch's, drawn or injected (read by index only);
    APG and ADG, whose statistics stay per row; references on rows 1 and 3
    (two on row 3), renumbered on each rank; a LoRA adapter loaded on rank
    0, then toggled off; `return_condition`'s arrays gathered in row order."""
    got, want = dp2[case], dp1[case]
    assert got["latents"].shape == want["latents"].shape
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=AUDIO_ATOL)
    if case == "condition":
        assert set(got["condition"]) == set(want["condition"]) == {
            "encoder_hidden_states", "encoder_attention_mask", "context_latents"}
        for k, v in want["condition"].items():
            np.testing.assert_allclose(got["condition"][k], v, **LATENT_TOL)
        np.testing.assert_array_equal(got["lyric_token_ids"], want["lyric_token_ids"])
        np.testing.assert_array_equal(got["lyric_mask"], want["lyric_mask"])
    if case == "sde_injected":
        assert np.abs(got["latents"] - dp2["sde"]["latents"]).max() > 1e-2  # the injected noise took effect
    if case == "lora_on":
        assert np.abs(got["latents"] - dp2["lora_off"]["latents"]).max() > 1e-2  # the adapter took effect


def test_dp2_stream_delivers_once(dp2):
    """A streamed request under dp = 2: one chunk_sink call with the whole PCM."""
    (pos, pcm, total), = dp2["stream_calls"]
    audio = dp2["stream"]["audios"]
    assert pos == 0 and total == audio.shape[-1] and audio.dtype == np.int16
    np.testing.assert_array_equal(pcm, audio)


def test_dp2_errors_and_refusals(dp2):
    """A rank that raises makes rank 0's call raise with its message, and
    the next request runs; the refusals: a tp that does not divide the DiT's
    heads, an sp that splits no latent bucket, and on every rank the
    planner's tensor parallelism at a tp (the default mesh's, 2) that does
    not divide its KV heads; 1 x 1 x 1 changes nothing; every rank ran on
    the CPU and is gone."""
    assert "rank 1 failed in generate_music" in dp2["fault"] and "injected fault on rank 1" in dp2["fault"]
    assert dp2["after_fault"]["latents"].shape == (2, 50, 64)
    tp3, sp3 = dp2["refused"]
    assert "tp=3 does not divide the DiT's num_attention_heads (4)" in tp3
    assert "sp=3: no latent bucket of (64, 128, 256) divides by sp * patch_size (6)" in sp3
    assert [r["planner_refused"] for r in dp2["ranks"]] == [
        "tp=2 does not divide the planner's num_key_value_heads (1)"] * 2
    assert dp2["unchanged_at_1x1x1"]
    assert [r["device"] for r in dp2["ranks"]] == ["cpu", "cpu"]
    assert not {r["pid"] for r in dp2["ranks"]} & set(_ranks_of_this_process())


def test_dp2_reload_and_a_change_out_of_step(dp2):
    """A reload reaches every rank (the digest check passes, and the rows
    change with the weights); an adapter that loads on rank 0 and fails on
    rank 1 raises with rank 1's message and leaves the ranks out of step, so
    the next request raises instead of running on different models."""
    assert dp2["reload"].startswith("initialized in")
    assert np.abs(dp2["after_reload"]["latents"] - dp2["lora_off"]["latents"]).max() > 1e-2
    assert "rank 1 failed in load_lora" in dp2["broken_load"] and "injected load fault" in dp2["broken_load"]
    assert "load_lora failed on ranks [1]" in dp2["out_of_step"]


def test_dead_rank_fails_the_launch():
    """A rank that exits makes launch raise, and no rank is left."""
    with pytest.raises(ProcessExitedException, match="exit code 3"):
        launch(R.die_on_rank_1, 2, timeout=R.TIMEOUT_S, deadline_s=DEADLINE_S)
    assert _ranks_of_this_process() == []
