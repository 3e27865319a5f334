"""Sequence and tensor parallelism of the port's DiT on the CPU: the tp plan,
the sliding layers' halo, and the handler's mesh in gloo groups of spawned
ranks.

The tp plan (`_tp_spec_for`, `shard_params_tp`) is held leaf by leaf against
JAX's on both of its layouts (`test_tp_plan_shards_kernels` of
`tests/test_multichip.py` is the model). The halo functions run in one
process: each simulated sp rank's sliding-window attention on its halo'd
rows, kept rows concatenated, against JAX's `attention` on the whole
sequence, at slices longer and shorter than the window.

One group of 4 ranks (dp1 x sp2 x tp2) runs every request of
`tests/torch_mesh_sp_tp_ranks.py` once, and one group of 8 (dp2 x sp2 x tp2)
the batch of 4 of JAX's `test_enable_mesh_serving_path_dp_sp_tp` and a batch
of 3. The handlers load the JAX handler's weights (the ranks import no JAX);
their latents are held against the port's 1 x 1 x 1 in this process at
fp32 within `LATENT_TOL` and the PCM within 2.5 steps, and text2music and
APG (JAX's `enable_sequence_parallel` at dp1 x sp2 x tp2) and the batch of 4
(JAX's `enable_mesh` at dp2 x sp2 x tp2) against JAX's own mesh paths on the
simulated CPU devices within JAX's 2e-3.
Noise is numpy's per seed in both packages. Both groups start at once, on
threads of this process, while it computes the references; every group
runs under a deadline and a 60 s group timeout, and no rank is left.
"""

import os
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu_torch.models.dit as tdit
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu.ops.attention import attention as jax_attention
from acestep_tpu.ops.rope import apply_rope as jax_rope, rope_cos_sin as jax_cos_sin
from acestep_tpu.params import init_acestep_params as j_init
from acestep_tpu.parallel.mesh import _tp_spec_for as jax_spec_for, make_mesh as jax_make_mesh
import acestep_tpu_torch.pipeline.handler as TH
from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config
from acestep_tpu_torch.ops.attention import attention
from acestep_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from acestep_tpu_torch.params import init_acestep_params
from acestep_tpu_torch.parallel.mesh import _tp_spec_for, device_backend, launch, shard_params_tp
from acestep_tpu_torch.parallel.tensor import halo_edges, halo_extend, halo_mask, halo_rows
from acestep_tpu_torch.training.lora import init_lora_params
from tests import torch_mesh_ranks as R
from tests import torch_mesh_sp_tp_ranks as S

LATENT_TOL = dict(rtol=1e-4, atol=1e-4)
JAX_TOL = dict(rtol=2e-3, atol=2e-3)
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


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}/{i}")
    else:
        yield path, tree


def test_tp_plan_shards_kernels():
    """Every leaf's spec equals JAX's, in the per-layer layout and the
    stacked one (3-D kernels: the plan one axis right); colwise kernels and
    their biases split their output features, rowwise kernels their input
    rows, everything else stays whole; `shard_params_tp` keeps this rank's
    part as a tensor of its own."""
    cfg = dict(R.DIT, attention_bias=True)
    def both():  # shapes only (eval_shape): no weight is computed
        params = j_init(jax.random.PRNGKey(0), JA(**cfg), jnp.float32)
        return params, dict(params, decoder=dict(params["decoder"], layers=jdit.stack_layers_by_parity(
            params["decoder"]["layers"])))

    jparams, stacked = jax.eval_shape(both)
    split = 0
    for tree in (jparams, stacked):
        for path, leaf in _paths(tree):
            want = tuple(jax_spec_for(path, leaf.ndim))
            assert _tp_spec_for(path, leaf.ndim) == want, path
            split += "tp" in want
    assert split > 0
    assert _tp_spec_for("/decoder/layers/0/self_attn/q_proj/kernel", 2) == (None, "tp")
    assert _tp_spec_for("/decoder/layers/0/self_attn/q_proj/bias", 1) == ("tp",)
    assert _tp_spec_for("/decoder/layers/0/self_attn/o_proj/kernel", 2) == ("tp", None)
    assert _tp_spec_for("/decoder/layers/0/self_attn/o_proj/bias", 1) == ()
    assert _tp_spec_for("/decoder/layers/sliding/mlp/down_proj/kernel", 3) == (None, "tp", None)
    assert _tp_spec_for("/decoder/layers/sliding/mlp/up_proj/kernel", 3) == (None, None, "tp")
    assert _tp_spec_for("/decoder/norm_out/weight", 1) == ()

    dec = init_acestep_params(AceStepConfig(**cfg), seed=0, device="cpu", dtype=torch.float32)["decoder"]
    mine = shard_params_tp(types.SimpleNamespace(coord={"tp": 1}, shape={"tp": 2}), dec)
    attn, mine_attn = dec["layers"][0]["self_attn"], mine["layers"][0]["self_attn"]
    torch.testing.assert_close(mine_attn["q_proj"]["kernel"], attn["q_proj"]["kernel"][:, 32:], rtol=0, atol=0)
    torch.testing.assert_close(mine_attn["q_proj"]["bias"], attn["q_proj"]["bias"][32:], rtol=0, atol=0)
    torch.testing.assert_close(mine_attn["k_proj"]["kernel"], attn["k_proj"]["kernel"][:, 16:], rtol=0, atol=0)
    torch.testing.assert_close(mine_attn["o_proj"]["kernel"], attn["o_proj"]["kernel"][32:], rtol=0, atol=0)
    assert mine_attn["o_proj"]["bias"] is attn["o_proj"]["bias"]
    assert mine_attn["q_norm"]["weight"] is attn["q_norm"]["weight"]  # per head: whole
    mlp = mine["layers"][1]["mlp"]
    assert mlp["gate_proj"]["kernel"].shape == (64, 64) and mlp["down_proj"]["kernel"].shape == (64, 64)
    assert mine["condition_embedder"]["kernel"] is dec["condition_embedder"]["kernel"]
    assert mine_attn["o_proj"]["kernel"].untyped_storage().nbytes() == 32 * 64 * 4  # not a view of the whole


@pytest.mark.parametrize("places,backend", [
    ([("h", "cpu")] * 4, "gloo"),
    ([("h", "cuda:0")] * 4, "gloo"),  # ranks that share a card: NCCL refuses them
    ([("h", "cuda:0"), ("h", "cuda:1"), ("h", "cuda:0"), ("h", "cuda:1")], "gloo"),
    ([("h", "cuda:0"), ("h", "cuda:1"), ("g", "cuda:0"), ("g", "cuda:1")], "nccl"),
    ([("h", "cuda:0"), ("h", "cpu")], "gloo"),
])
def test_device_backend_rule(monkeypatch, places, backend):
    """The device groups' backend from every rank's (host, device): NCCL
    only when each rank has a card of its own."""
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    assert device_backend(places) == backend


@pytest.mark.parametrize("sp,total,window", [(2, 32, 8), (2, 8, 8), (4, 12, 5)])
def test_halo_matches_whole_sequence_attention(sp, total, window):
    """Each of `sp` ranks extends its rows by `window` rows of the others
    (`halo_extend` of every rank's `halo_edges`, zeros past the ends), takes
    rope at the global positions (`halo_rows`) and the whole mask's keys
    (`halo_mask`), runs the band and keeps its own rows: the concatenation
    equals JAX's attention over the whole sequence, with a key mask that
    hides its tail. Slices at, above and below the window (the last ones
    reach past the neighbour)."""
    rng = np.random.default_rng(sp * 100 + total + window)
    b, n, hd = 2, 2, 16
    x = rng.standard_normal((b, total, n * hd)).astype(np.float32)
    proj = [rng.standard_normal((n * hd, n * hd)).astype(np.float32) / 8 for _ in range(3)]
    mask = np.ones((b, total), np.int32)
    mask[1, total - 3:] = 0

    jcos, jsin = jax_cos_sin(total, hd)
    q, k, v = (jnp.asarray(x @ p).reshape(b, total, n, hd) for p in proj)
    want = jax_attention(jax_rope(q, jcos, jsin), jax_rope(k, jcos, jsin), v, kv_mask=jnp.asarray(mask),
                         window=window, scale=hd**-0.5)

    xt, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    cos, sin = rope_cos_sin(total, hd)
    l = total // sp
    edges = [halo_edges(xt[:, j * l:(j + 1) * l], window) for j in range(sp)]
    got = []
    for r in range(sp):
        xe = halo_extend(xt[:, r * l:(r + 1) * l], edges, r, window)
        assert xe.shape == (b, l + 2 * window, n * hd)
        rows, inside = halo_rows(r * l, l, window, total)
        qe, ke, ve = (torch.from_numpy(xe.numpy() @ p).reshape(b, -1, n, hd) for p in proj)
        out = attention(apply_rope(qe, cos[rows], sin[rows]), apply_rope(ke, cos[rows], sin[rows]), ve,
                        kv_mask=halo_mask(tmask, inside, r * l, window, b), window=window, scale=hd**-0.5)
        got.append(out[:, window:window + l])
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def jax_handler():
    """The JAX handler on the port's random init (its serving layout through
    `stack_acestep_params`): JAX's own init compiles op by op for 16 s on
    the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        for name, val in S.BUCKETS.items():
            mp.setattr(JH, name, val)
        mp.setattr(jdit, "prepare_noise",
                   lambda shape, seeds, dtype=jnp.bfloat16: jnp.asarray(R.seed_noise(shape, seeds), dtype))
        th = TH.AceStepHandler(AceStepConfig(**R.DIT), OobleckConfig(**R.VAE), Qwen3Config(**R.TEXT),
                               dtype=torch.float32, device="cpu")
        th.initialize_service(random_init=True)
        jh = JH.AceStepHandler(JA(**R.DIT), JO(**R.VAE), JQ(**R.TEXT), dtype=jnp.float32)
        jh.params = jdit.stack_acestep_params(_to_jax(th.params), jh.config)
        jh.vae_params, jh.text_params = _to_jax(th.vae_params), _to_jax(th.text_params)
        jh.silence_latent, jh.text_tokenizer, jh.initialized = th.silence_latent, th.text_tokenizer, True
        yield jh


@pytest.fixture(scope="module")
def files(jax_handler, tmp_path_factory):
    """The JAX handler's weights as numpy, and a rank-4 LoRA adapter over
    every target of the port's decoder (B drawn, so it changes the output)."""
    d = tmp_path_factory.mktemp("mesh_sp_tp")
    weights = str(d / "weights.pkl")
    with open(weights, "wb") as f:
        pickle.dump({k: jax.tree.map(np.asarray, getattr(jax_handler, k))
                     for k in ("params", "vae_params", "text_params")}, f)
    rng = np.random.default_rng(0)
    factors = init_lora_params(0, S.tiny_handler(weights).params["decoder"], rank=4)
    adapter = str(d / "adapter.npz")
    np.savez(adapter, **{f"{p}|{k}": (rng.standard_normal(tuple(v.shape)) * 0.2).astype(np.float32)
                         for p, ab in factors.items() for k, v in ab.items()},
             __meta__=np.asarray('{"rank": 4, "alpha": 8.0, "adapter_type": "lora"}'))
    return weights, adapter


@pytest.fixture(scope="module")
def meshes(files):
    """Both groups, one after the other on a thread while this process
    computes its references: {1: dp1 x sp2 x tp2 on 4 ranks (every request),
    2: dp2 x sp2 x tp2 on 8 (the dp = 2 requests)}, as futures. One at a
    time, because each collective waits for every rank of its line."""
    with ThreadPoolExecutor(1) as pool:
        yield {dp: pool.submit(launch, S.mesh_cases, 4 * dp, *files, dp, timeout=S.TIMEOUT_S, deadline_s=DEADLINE_S)
               for dp in (1, 2)}


@pytest.fixture(scope="module")
def mesh4(meshes, one):
    return meshes[1].result()


@pytest.fixture(scope="module")
def one(files):
    """Every request on one port handler in this process (1 x 1 x 1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdit, "prepare_noise", R.prepare_noise)
        h = S.tiny_handler(files[0])
        out = S.run_requests(h, {**S.REQUESTS, **S.REQUESTS_DP2}, files[1])
        out["lora_off"] = h.generate_music(**S.REQUESTS["lora"])  # the adapter unloaded
        yield out


def _same(got, want):
    assert got["latents"].shape == want["latents"].shape
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    assert got["audios"].shape == want["audios"].shape and np.abs(got["audios"]).max() > 0
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=AUDIO_ATOL)


def test_sp_tp_text2music_and_apg_match_jax_mesh(jax_handler, meshes, one):
    """text2music and base APG (its norms over time cross the sp ranks) at
    dp1 x sp2 x tp2 against JAX's `enable_sequence_parallel` on a
    dp1 x sp2 x tp2 mesh of 4 of the simulated devices, and against the
    port's 1 x 1 x 1 (JAX's `enable_mesh` is held in the dp = 2 test)."""
    jax_handler.enable_sequence_parallel(jax_make_mesh(dp=1, sp=2, tp=2, devices=jax.devices()[:4]))
    want = {name: jax_handler.generate_music(**S.REQUESTS[name]) for name in ("text2music", "apg")}
    mesh4 = meshes[1].result()
    for name in ("text2music", "apg"):
        np.testing.assert_allclose(mesh4[name]["latents"], want[name]["latents"], **JAX_TOL)
        _same(mesh4[name], one[name])


@pytest.mark.parametrize("case", ["odd_length", "short", "adg", "sde", "sde_injected", "cover", "lora",
                                  "condition"])
def test_sp_tp_matches_one_device(mesh4, one, case):
    """A length that does not divide by sp · patch_size (every sp rank
    computes it whole), slices shorter than the window, ADG, SDE drawn and
    injected (the whole sequence's noise, sliced), a cover with source
    latents, LM hints, cover noise and a non-cover segment, an adapter
    under tp (its factors cut by the plan), and text2music's
    `return_condition` arrays."""
    if case == "condition":
        for k, v in one["text2music"]["condition"].items():
            np.testing.assert_allclose(mesh4["text2music"]["condition"][k], v, **LATENT_TOL)
        np.testing.assert_array_equal(mesh4["text2music"]["lyric_mask"], one["text2music"]["lyric_mask"])
        return
    _same(mesh4[case], one[case])
    if case == "lora":
        assert np.abs(mesh4["lora"]["latents"] - one["lora_off"]["latents"]).max() > 1e-2
    if case == "sde_injected":
        assert np.abs(mesh4["sde_injected"]["latents"] - mesh4["sde"]["latents"]).max() > 1e-2


def test_sp_tp_lyric_capture_matches_one_device(mesh4, one):
    """The lyric capture under tp: each tp rank's heads gathered into the
    global order (every head of layer 0, two of layer 1), both rows."""
    for got, want in zip(mesh4["capture"], one["capture"]):
        assert got["ids"] == want["ids"] and got["attn"].shape == want["attn"].shape
        assert got["attn"].shape[0] == 6
        np.testing.assert_allclose(got["attn"], want["attn"], rtol=1e-5, atol=1e-6)


def test_sp_tp_ranks(mesh4):
    """Four ranks at their (dp, sp, tp) coordinates on the CPU, the device
    collectives on gloo and as many on the ranks of a tp line; the
    decoder's kernels cut by the plan, the encoders whole; a trainer's
    decoder gathered whole from the tp ranks equals the saved weights;
    every rank is gone."""
    assert mesh4["training_decoder_whole"] == []
    ranks = mesh4["ranks"]
    assert [r["coord"] for r in ranks] == [dict(dp=0, sp=s, tp=t) for s in range(2) for t in range(2)]
    assert {r["device"] for r in ranks} == {"cpu"} and {r["backend"] for r in ranks} == {"gloo"}
    assert all(r["q_proj"] == (64, 32) and r["down_proj"] == (64, 64) and r["encoder_q_proj"] == (64, 64)
               for r in ranks)
    # The lyric capture runs on the first tp line (sp = 0) alone.
    counts = [r["collectives"] for r in ranks]
    assert counts[0] == counts[1] > counts[2] == counts[3] > 0
    assert not {r["pid"] for r in ranks} & set(_ranks_of_this_process())


def test_dp2_sp2_tp2_matches_jax_mesh_and_one_device(jax_handler, meshes, one):
    """JAX's `test_enable_mesh_serving_path_dp_sp_tp` on the port: batch 4 at
    dp2 x sp2 x tp2 against JAX's `enable_mesh(dp=2, sp=2, tp=2)` on the 8
    simulated devices and the port's 1 x 1 x 1; a
    batch of 3 (dp group 0 alone) against 1 x 1 x 1; each dp group's
    representative answered."""
    jax_handler.enable_mesh(dp=2, sp=2, tp=2)
    want = jax_handler.generate_music(**S.REQUESTS_DP2["batch4"])
    mesh8 = meshes[2].result()
    np.testing.assert_allclose(mesh8["batch4"]["latents"], want["latents"], **JAX_TOL)
    for case in ("batch4", "batch3"):
        _same(mesh8[case], one[case])
    assert [r["coord"]["dp"] for r in mesh8["ranks"]] == [0] * 4 + [1] * 4
    assert not {r["pid"] for r in mesh8["ranks"]} & set(_ranks_of_this_process())
