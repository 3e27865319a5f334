"""Rank functions of `tests/test_torch_lm_tp.py`, in a module without JAX.

The ranks import this module to find their function, so it imports torch and
the port only. Each rank builds the tiny planner of `tests/test_torch_lm.py`
(untied head, fp32 on the CPU) on the JAX planner's weights that the test
saved as numpy, with the code range pointed at byte ids, and splits it over
a dp2 x tp2 mesh: ranks 0 and 1 are the planner's line, ranks 2 and 3 the
other dp group.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

import acestep_tpu_torch.models.qwen3 as tqwen3
from acestep_tpu_torch.config import Qwen3Config
from acestep_tpu_torch.lm.handler import LLMHandler
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.parallel.mesh import make_mesh
from acestep_tpu_torch.scoring.lm_score import sequence_log_prob

LM = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=8, tie_word_embeddings=False)
CODE_START, N_CODES = 100, 64
TIMEOUT_S = 60.0
GREEDY = dict(temperature=0.0, cfg_scale=2.0, top_k=0, top_p=0.9, target_duration=3.0, seed=4, batch_size=2)
FREE = dict(temperature=0.0, max_new_tokens=24, seed=5)
# A free-form call at this seed draws other tokens on rank 1 from step 13 (`_fault_on_rank_1`).
# It takes 16 new tokens: the loop asks whether every row has finished only every 8 steps, and no
# row of this grammar has by step 8, so both ranks run the same steps and collectives.
FAULT = dict(FREE, seed=99, max_new_tokens=16)
PROMPT_TOKENS, STEP_TOKENS = 7, (11, 12, 13, 14)
SCORED = [int(x) for x in np.random.default_rng(3).integers(0, 256, 40)]


def planner(weights_path: str) -> LLMHandler:
    """The tiny planner on the saved weights (whole)."""
    h = LLMHandler(Qwen3Config(**LM), dtype=torch.float32, device="cpu")
    h.initialize(random_init=True)
    with open(weights_path, "rb") as f:
        h.params = from_jax_params(pickle.load(f), h.config)
    h.fsm.code_token_start, h.fsm.num_code_tokens = CODE_START, N_CODES
    return h


def prompt_ids(h: LLMHandler):
    """The prompt of JAX's `test_lm_tensor_parallel_matches_single_device`:
    ids, mask and the cache length."""
    ids, mask, bucket = h._encode_prompts([h.build_formatted_prompt("ambient pads", "")], budget=8)
    return ids, mask, bucket + 8


def prefill_and_steps(llm: LLMHandler, ids: np.ndarray, mask: np.ndarray, total: int) -> dict:
    """The prefill logits, the first decode step's (token 7 at the prompt's
    length) and four more steps' (tokens 11-14), each as numpy; run through
    `LLMHandler.on_line`, so a split planner sums over its line."""
    cfg, tp_sum = llm.config, llm._tp_sum
    cache = tqwen3.KVCache.create(cfg, 1, total, torch.float32, kv_heads=tqwen3.kv_heads(llm.params, cfg))
    with torch.inference_mode():
        logits, cache = tqwen3.prefill(llm.params, cfg, torch.as_tensor(ids), torch.as_tensor(mask), cache, tp_sum)
        out = {"prefill": logits.numpy().copy()}
        pos = int(mask[0].sum())
        step, cache = tqwen3.decode_step(llm.params, cfg, torch.tensor([PROMPT_TOKENS]), torch.tensor([pos]),
                                         cache, tp_sum)
        out["step"] = step.numpy().copy()
        steps = []
        for i, tok in enumerate(STEP_TOKENS):
            step, cache = tqwen3.decode_step(llm.params, cfg, torch.tensor([tok]), torch.tensor([pos + 1 + i]),
                                             cache, tp_sum)
            steps.append(step.numpy().copy())
    out["steps"] = np.stack(steps)
    return out


def forward_collectives(llm: LLMHandler, ids: np.ndarray, mask: np.ndarray, total: int) -> tuple:
    """The last decode step's logits of `prefill_and_steps` and how many
    device collectives one prefill and five decode steps took on this rank."""
    before = llm.mesh.collectives if llm.mesh is not None else 0
    out = prefill_and_steps(llm, ids, mask, total)["steps"][-1]
    return out, (llm.mesh.collectives if llm.mesh is not None else 0) - before


def _fault_on_rank_1(h: LLMHandler) -> None:
    """Rank 1's create_sample_from_query at FAULT's seed reads logits rolled by
    one token, so it draws other tokens than rank 0."""
    real = h.create_sample_from_query

    def faulty(*args, **kwargs):
        if kwargs.get("seed") != FAULT["seed"]:
            return real(*args, **kwargs)
        logits = tqwen3.logits_from_hidden
        tqwen3.logits_from_hidden = lambda *a: logits(*a).roll(1, dims=-1)
        try:
            return real(*args, **kwargs)
        finally:
            tqwen3.logits_from_hidden = logits

    h.create_sample_from_query = faulty


def _refusals(mesh) -> list:
    """enable_tensor_parallel's refusals on this rank: the default mesh (tp
    = 4, every rank) does not divide the planner's 2 KV heads, and `mesh`'s
    tp = 2 does not divide a planner with 1."""
    out = []
    for cfg, m in ((Qwen3Config(**LM), None), (Qwen3Config(**{**LM, "num_key_value_heads": 1}), mesh)):
        h = LLMHandler(cfg, dtype=torch.float32, device="cpu")
        h.initialize(random_init=True)
        try:
            h.enable_tensor_parallel(m)
        except ValueError as e:
            out.append(str(e))
    return out


def lm_tp_cases(weights_path: str) -> dict:
    """dp2 x tp2 ranks with the planner split over them. Rank 0 runs the
    forwards of `prefill_and_steps`, a greedy CFG generation, a free-form
    call and a sequence log-prob as mesh ops, one op sent straight through
    the mesh to see every rank's value, a call that rank 1 breaks and one
    after it; returns them with each rank's report."""
    torch.set_num_threads(1)
    mesh = make_mesh(dp=2, tp=2, timeout=TIMEOUT_S)
    out = {"refused": _refusals(mesh)}
    h = planner(weights_path)
    h.enable_tensor_parallel(mesh)
    ids, mask, total = prompt_ids(h)
    if mesh.rank == 1:
        _fault_on_rank_1(h)
    if mesh.is_leader:
        try:
            out["forwards"] = h.on_line(prefill_and_steps, ids, mask, total)
            out["generate"] = h.generate_with_stop_condition("calm piano", "[Verse]\nla la", **GREEDY)
            out["free"] = h.create_sample_from_query("rainy jazz", **FREE)
            prompt = h.build_formatted_prompt("calm piano", "[Verse]\nla la", generation_phase="codes")
            out["log_prob"] = sequence_log_prob(h, prompt, SCORED)
            switches = {"device_fsm": True, "prefix_cache": True}
            out["every_rank"] = mesh.lead("planner", "on_line", dict(
                args=(forward_collectives, ids, mask, total), kwargs={}, switches=switches))
            try:
                h.create_sample_from_query("rainy jazz", **FAULT)
            except RuntimeError as e:
                out["fault"] = str(e)
            out["after_fault"] = h.create_sample_from_query("rainy jazz", **FREE)
            try:
                tqwen3.prefill(h.params, h.config, torch.as_tensor(ids), torch.as_tensor(mask),
                               tqwen3.KVCache.create(h.config, 1, total, torch.float32), h._tp_sum)
            except RuntimeError as e:
                out["outside_an_op"] = str(e)
        finally:
            mesh.stop_followers()
    else:
        mesh.serve()
    attn = h.params["layers"][0] if h.params is not None else None
    out["ranks"] = mesh.gather(dict(
        pid=os.getpid(), coord=mesh.coord, refused=out["refused"],
        q_proj=None if attn is None else tuple(attn["self_attn"]["q_proj"]["kernel"].shape),
        down_proj=None if attn is None else tuple(attn["mlp"]["down_proj"]["kernel"].shape)))
    return out
