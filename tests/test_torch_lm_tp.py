"""The planner's tensor parallelism in the port (`LLMHandler.enable_tensor_parallel`)
on the CPU, in one gloo group of four spawned ranks at dp2 x tp2.

The tiny planner of `tests/test_torch_lm.py` (JAX's init, untied head, fp32)
is split over the group by the tp plan; its calls run as mesh ops on the
planner's line, ranks 0 and 1 (`tests/torch_lm_tp_ranks.py`). The prefill
and decode logits are held against JAX's `qwen3.prefill` / `decode_step` on
params sharded over `make_mesh(dp=4, tp=2)` (8 simulated CPU devices) and
against the port's whole planner in this process, with the tolerances of
JAX's `test_lm_tensor_parallel_matches_single_device`; a greedy CFG
generation, a free-form call and a sequence log-prob against both packages'
one-process calls. The group starts on a thread while this process computes
the references, runs under a deadline and a 60 s group timeout, and no rank
is left.
"""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from acestep_tpu.config import Qwen3Config as JQ
from acestep_tpu.lm.handler import LLMHandler as JLLM
from acestep_tpu.models import qwen3 as jqwen3
from acestep_tpu.parallel.mesh import make_mesh as jax_make_mesh
from acestep_tpu_torch.parallel.mesh import launch
from acestep_tpu_torch.scoring.lm_score import sequence_log_prob
from tests import torch_lm_tp_ranks as L

STEP_TOL = dict(rtol=2e-4, atol=2e-4)  # prefill and one decode step (JAX's tolerance)
STEPS_TOL = dict(rtol=5e-4, atol=5e-4)  # four successive decode steps
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
def jax_planner():
    jh = JLLM(JQ(**L.LM), dtype=jnp.float32)
    jh.initialize(random_init=True, seed=3)
    jh.fsm.code_token_start, jh.fsm.num_code_tokens = L.CODE_START, L.N_CODES
    return jh


@pytest.fixture(scope="module")
def weights(jax_planner, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_tp") / "planner.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jax_planner.params), f)
    return path


@pytest.fixture(scope="module")
def group(weights):
    """The dp2 x tp2 group's results, as a future."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch, L.lm_tp_cases, 4, weights, timeout=L.TIMEOUT_S, deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def one(weights, group):
    """The same calls on the port's whole planner in this process."""
    h = L.planner(weights)
    ids, mask, total = L.prompt_ids(h)
    prompt = h.build_formatted_prompt("calm piano", "[Verse]\nla la", generation_phase="codes")
    return dict(forwards=L.prefill_and_steps(h, ids, mask, total),
                generate=h.generate_with_stop_condition("calm piano", "[Verse]\nla la", **L.GREEDY),
                free=h.create_sample_from_query("rainy jazz", **L.FREE),
                log_prob=sequence_log_prob(h, prompt, L.SCORED))


@pytest.fixture(scope="module")
def jax_ref(jax_planner, one):
    """JAX's greedy generation (whole planner), then its prefill and decode
    steps on params sharded over make_mesh(dp=4, tp=2)."""
    jh = jax_planner
    out = {"generate": jh.generate_with_stop_condition("calm piano", "[Verse]\nla la", **L.GREEDY)}
    jh.enable_tensor_parallel(jax_make_mesh(dp=4, tp=2))
    assert "tp" in str(jh.params["layers"][0]["self_attn"]["q_proj"]["kernel"].sharding.spec)
    ids, mask, bucket = jh._encode_prompts([jh.build_formatted_prompt("ambient pads", "")], budget=8)
    cache = jqwen3.KVCache.create(jh.config, 1, bucket + 8, jnp.float32)
    logits, cache = jqwen3.prefill(jh.params, jh.config, jnp.asarray(ids), jnp.asarray(mask), cache)
    out["prefill"] = np.asarray(logits)
    pos = int(mask[0].sum())
    step, cache = jqwen3.decode_step(jh.params, jh.config, jnp.asarray([L.PROMPT_TOKENS], jnp.int32),
                                     jnp.asarray([pos], jnp.int32), cache)
    out["step"] = np.asarray(step)
    steps = []
    for i, tok in enumerate(L.STEP_TOKENS):
        step, cache = jqwen3.decode_step(jh.params, jh.config, jnp.asarray([tok], jnp.int32),
                                         jnp.asarray([pos + 1 + i], jnp.int32), cache)
        steps.append(np.asarray(step))
    out["steps"] = np.stack(steps)
    return out


@pytest.fixture(scope="module")
def tp(group, jax_ref):
    return group.result()


@pytest.mark.parametrize("key,tol", [("prefill", STEP_TOL), ("step", STEP_TOL), ("steps", STEPS_TOL)])
def test_tp2_logits_match_jax_mesh_and_one_process(tp, jax_ref, one, key, tol):
    """(a) The prefill logits and the first decode step within 2e-4, four
    more decode steps within 5e-4, of JAX's tp-sharded mesh and of the
    port's whole planner; the line's ranks computed them bit for bit alike
    (`on_line` raises otherwise)."""
    got = tp["forwards"][key]
    assert got.shape == jax_ref[key].shape == one["forwards"][key].shape
    np.testing.assert_allclose(got, jax_ref[key], **tol)
    np.testing.assert_allclose(got, one["forwards"][key], **tol)


def test_tp2_greedy_cfg_generation_equals_jax_and_one_process(tp, jax_ref, one):
    """(b) Greedy CFG two-phase generation on the mesh: the codes, the CoT
    and the metadata equal JAX's and the port's one-process call."""
    got, want, whole = tp["generate"], jax_ref["generate"], one["generate"]
    assert "<think>" in got["cot_text"]
    assert got["batch_codes"] == want["batch_codes"] == whole["batch_codes"]
    assert len(got["codes"]) == 15
    assert got["cot_text"] == want["cot_text"] and got["batch_cot_texts"] == whole["batch_cot_texts"]
    assert got["metadata"] == want["metadata"] == whole["metadata"]


def test_tp2_free_form_and_log_prob_equal_one_process(tp, one):
    """(c) create_sample_from_query and the LM score's sequence log-prob run
    on the mesh and equal the whole planner's (the log-prob within 2e-4)."""
    for key in ("text", "metadata", "route", "tokens"):
        assert tp["free"][key] == one["free"][key], key
    assert tp["free"]["tokens"] > 0
    np.testing.assert_allclose(tp["log_prob"], one["log_prob"], **STEP_TOL)


def test_tp2_line_ranks_agree_and_the_others_return_none(tp):
    """(d) One op through the mesh: ranks 0 and 1 (the line) return the same
    logits, each after 2 x layers collectives a forward (one prefill, five
    decode steps), ranks 2 and 3 None; each line rank holds half of q_proj's
    columns and of down_proj's rows, the other dp group drops its slice; a
    rank that draws other tokens makes rank 0 raise naming it and the first
    step, and the next call runs; a forward outside a mesh op is refused;
    no rank is left."""
    every = tp["every_rank"]
    assert every[2] is None and every[3] is None
    (logits0, n0), tokens0 = every[0]
    (logits1, n1), tokens1 = every[1]
    assert tokens0 == tokens1 == []
    np.testing.assert_array_equal(logits0, logits1)
    assert n0 == n1 == 2 * L.LM["num_hidden_layers"] * 6
    ranks = tp["ranks"]
    assert [r["coord"] for r in ranks] == [dict(dp=d, sp=0, tp=t) for d in range(2) for t in range(2)]
    assert [r["q_proj"] for r in ranks] == [(32, 16), (32, 16), None, None]
    assert [r["down_proj"] for r in ranks] == [(32, 32), (32, 32), None, None]
    assert tp["fault"].startswith("the planner's tp rank 1 is out of step with rank 0 in create_sample_from_query: "
                                  "sequence 0, step 13: "), tp["fault"]
    assert tp["after_fault"]["text"] == tp["free"]["text"]
    assert "its forwards run only in a public call on rank 0" in tp["outside_an_op"]
    assert not {r["pid"] for r in ranks} & set(_ranks_of_this_process())


def test_tp_that_does_not_divide_is_refused_on_every_rank(tp):
    """(e) The default mesh (tp = 4 over the four ranks) does not divide the
    planner's 2 KV heads, and tp = 2 does not divide a planner with 1: both
    raise ValueError on every rank, before any group call."""
    for r in tp["ranks"]:
        assert r["refused"] == ["tp=4 does not divide the planner's num_key_value_heads (2)",
                                "tp=2 does not divide the planner's num_key_value_heads (1)"]
