"""Device-side sampling for the 5 Hz planner LM.

Port of `acestep_tpu/lm/sampling.py`:

- `cfg_combine`: uncond + scale * (cond - uncond) in float32;
- `sample`: temperature / top-k / top-p, with the K = 512 nucleus prefilter
  for big vocabularies (normalised by the full-vocab logsumexp);
- `sample_allow` / `sample_block` / `sample_prob_end`: FSM-constrained
  sampling, the device side of the FSM's StepSpecs;
- `generate_cot_dfa`: the whole constrained CoT phase as one device loop over
  the DFA tables of `lm/dfa.py`;
- `generate_codes_scan`: the whole audio-code phase, with no read-back to the
  host until the caller reads the returned tokens;
- `generate_free`: unconstrained decoding until EOS (the understand /
  create_sample / format_sample APIs when their grammar does not compile).

Randomness comes from an explicit `torch.Generator` on the logits' device and
is drawn as a Gumbel-max, the way `jax.random.categorical` draws it; the
numbers differ from JAX's for one seed (a recorded deviation). With
temperature <= 0 every sampler is greedy and draws nothing.

The loops take `tp_sum` for a planner split over tp ranks and hand it to
every `qwen3.decode_step` (see `models/qwen3.py`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from acestep_tpu_torch.config import Qwen3Config
from acestep_tpu_torch.models import qwen3

NEG = torch.finfo(torch.float32).min
_TINY = torch.finfo(torch.float32).tiny

# Nucleus sampling over a big vocab: prefilter to the top-K candidates
# (`torch.topk` returns them sorted), so top-p needs no full sort.
_NUCLEUS_PREFILTER_K = 512

# The CoT and free loops ask the device whether every row has finished once
# every this many steps; steps past the end write EOS and do not change the
# result.
COT_CHECK_EVERY = 8


def cfg_combine(cond: torch.Tensor, uncond: torch.Tensor, scale: float) -> torch.Tensor:
    return uncond.float() + scale * (cond.float() - uncond.float())


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gumbel-max draw over the last axis (the form of `jax.random.categorical`)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_(min=_TINY)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until the cumulative prob exceeds top_p (always the top one)
    min_keep = (cum - probs < top_p).sum(dim=-1, keepdim=True).clamp(min=1)
    threshold = torch.gather(sorted_logits, -1, min_keep - 1)
    return torch.where(logits < threshold, torch.full_like(logits, NEG), logits)


def nucleus_keep(vals: torch.Tensor, lse: Optional[torch.Tensor], top_p: float) -> torch.Tensor:
    """Keep-mask over descending candidate logits: the exact full-vocab nucleus
    when `lse` is the full row's logsumexp, else renormalised inside `vals`."""
    probs = torch.exp(vals - lse) if lse is not None else torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p
    keep[..., 0] = True
    return keep


def sample(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,
    temperature: float = 1.0,
    *,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(float(temperature), 1e-6)
    v = scaled.shape[-1]
    k_eff = top_k if top_k > 0 else (_NUCLEUS_PREFILTER_K if (top_p < 1.0 and v > 2048) else 0)
    if k_eff and k_eff < v:
        vals, idx = torch.topk(scaled, k_eff, dim=-1)  # sorted descending
        if top_p < 1.0:
            # user top-k: renormalise inside the k set (HF warper order);
            # perf-only prefilter: the cutoff must match the full-vocab nucleus
            lse = None if top_k > 0 else torch.logsumexp(scaled, dim=-1, keepdim=True)
            vals = torch.where(nucleus_keep(vals, lse, top_p), vals, torch.full_like(vals, NEG))
        choice = categorical(vals, generator)
        return torch.gather(idx, -1, choice[..., None])[..., 0]
    return categorical(_filter_top_p(scaled, top_p), generator)


def sample_allow(
    logits: torch.Tensor,  # (B, V)
    allow_ids: torch.Tensor,  # (B, A) padded with -1
    generator: torch.Generator,
    temperature: float = 1.0,
    *,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Sample among a small allowed set: gather -> sample -> map back."""
    safe_ids = allow_ids.clamp(min=0).long()
    sub = torch.gather(logits.float(), -1, safe_ids)
    sub = torch.where(allow_ids >= 0, sub, torch.full_like(sub, NEG))
    idx = sample(sub, generator, temperature, top_k=top_k, top_p=top_p)
    return torch.gather(safe_ids, -1, idx[:, None])[:, 0]


def sample_block(
    logits: torch.Tensor,  # (B, V)
    block_ids: torch.Tensor,  # (B, A) padded with -1
    generator: torch.Generator,
    temperature: float = 1.0,
    *,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    logits = logits.float()
    v = logits.shape[1]
    safe_ids = torch.where(block_ids >= 0, block_ids, v - 1).long()
    penalty = torch.where(block_ids >= 0, NEG, 0.0).float()
    row = torch.zeros_like(logits).scatter_add_(1, safe_ids, penalty)
    return sample(logits + row, generator, temperature, top_k=top_k, top_p=top_p)


def _newline_wins(lg: torch.Tensor, newline_token: int) -> torch.Tensor:
    """P(newline) > max P(other) on the unconstrained logits (ref
    `_should_end_text_field`)."""
    probs = torch.softmax(lg, dim=-1)
    nl_p = probs[:, newline_token]
    other = probs.clone()
    other[:, newline_token] = 0.0
    return nl_p > other.amax(dim=-1)


def sample_prob_end(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,
    temperature: float,
    *,
    newline_token: int,
    eos_token: int,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Free-text sampling with probability-gated newline ending: newline when
    P(newline) > max P(other), else sample with EOS excluded."""
    lg = logits.float()
    force = _newline_wins(lg, newline_token)
    lg = lg.clone()
    lg[:, eos_token] = NEG
    tok = sample(lg, generator, temperature, top_k=top_k, top_p=top_p)
    return torch.where(force, newline_token, tok)


def _apply_repetition_penalty(lg: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor over the seen ids."""
    return torch.where(seen, torch.where(lg > 0, lg / penalty, lg * penalty), lg)


def generate_cot_dfa(
    params,
    cfg: Qwen3Config,
    logits0: torch.Tensor,  # (R, V) from prefill (R = B, or 2B with CFG)
    positions: torch.Tensor,  # (R,)
    cache: qwen3.KVCache,
    generator: torch.Generator,
    tables: dict,  # device tensors of lm/dfa.CotDFA: trans, alpha_allow, ...
    start_states: torch.Tensor,  # (B,)
    temperature: float,
    seen0: Optional[torch.Tensor] = None,  # (B, V) bool: prompt tokens
    *,
    max_steps: int,
    eos_token: int,
    newline_token: int = -1,
    top_k: int = 0,
    top_p: float = 1.0,
    cfg_scale: float = 1.0,
    repetition_penalty: float = 1.0,
    tp_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, int]:
    """The whole constrained CoT phase as one device loop.

    Per step the state rows gather an allow-mask, the biased logits are
    sampled, and `trans[state, sym(token)]` advances. Returns (tokens
    (B, max_steps) EOS-padded, steps run). The host asks whether every row is
    finished only every `COT_CHECK_EVERY` steps.
    """
    r, v = logits0.shape
    use_cfg = cfg_scale > 1.0
    b = r // 2 if use_cfg else r
    use_rp = repetition_penalty != 1.0
    dev = logits0.device
    trans, alpha_allow = tables["trans"], tables["alpha_allow"]
    allow_other, finished = tables["allow_other"], tables["finished"]
    prob_end, alpha_tokens = tables["prob_end"], tables["alpha_tokens"].long()
    vocab_to_sym = tables["vocab_to_sym"]

    out = torch.full((b, max_steps), eos_token, dtype=torch.int32, device=dev)
    states = start_states.long().clone()
    pos = positions.clone()
    logits = logits0
    seen = None
    if use_rp:
        seen = seen0.clone() if seen0 is not None else torch.zeros((b, v), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    zero = torch.zeros((), device=dev)
    neg = torch.full((), NEG, device=dev)

    step = 0
    while step < max_steps:
        if step % COT_CHECK_EVERY == 0 and bool(finished[states].all()):
            break
        lg = logits.float()
        if use_cfg:
            lg = cfg_combine(lg[:b], lg[b:], cfg_scale)
        if use_rp:
            lg = _apply_repetition_penalty(lg, seen, repetition_penalty)
        done = finished[states]
        bias = torch.where(allow_other[states][:, None], zero, neg).expand(b, v).clone()
        bias[:, alpha_tokens] = torch.where(alpha_allow[states], zero, neg)
        tok = sample(lg + bias, generator, temperature, top_k=top_k, top_p=top_p)
        if newline_token >= 0:
            tok = torch.where(prob_end[states] & _newline_wins(lg, newline_token), newline_token, tok)
        tok = torch.where(done, eos_token, tok)
        states = torch.where(done, states, trans[states, vocab_to_sym[tok]].long())
        out[:, step] = tok.to(torch.int32)
        if use_rp:
            seen[rows, tok] = True
        feed = torch.cat([tok, tok]) if use_cfg else tok
        logits, cache = qwen3.decode_step(params, cfg, feed, pos, cache, tp_sum)
        pos = pos + 1
        step += 1
    return out, step


def generate_free(
    params,
    cfg: Qwen3Config,
    logits0: torch.Tensor,  # (B, V) from prefill
    positions: torch.Tensor,  # (B,)
    cache: qwen3.KVCache,
    generator: torch.Generator,
    temperature: float,
    *,
    max_steps: int,
    eos_token: int,
    top_k: int = 0,
    top_p: float = 1.0,
    tp_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, int]:
    """Unconstrained decoding until every row has sampled EOS, as one device
    loop. Returns (tokens (B, max_steps) EOS-padded, steps run). A row that
    is done writes EOS; the host asks whether every row is done only every
    `COT_CHECK_EVERY` steps, so there is no read-back per token."""
    b = logits0.shape[0]
    dev = logits0.device
    out = torch.full((b, max_steps), eos_token, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    pos = positions.clone()
    logits = logits0
    step = 0
    while step < max_steps:
        if step % COT_CHECK_EVERY == 0 and step > 0 and bool(done.all()):
            break
        tok = sample(logits.float(), generator, temperature, top_k=top_k, top_p=top_p)
        tok = torch.where(done, eos_token, tok)
        done = done | (tok == eos_token)
        out[:, step] = tok.to(torch.int32)
        logits, cache = qwen3.decode_step(params, cfg, tok, pos, cache, tp_sum)
        pos = pos + 1
        step += 1
    return out, step


def generate_codes_scan(
    params,
    cfg: Qwen3Config,
    first_tokens: torch.Tensor,  # (R,) tokens to feed first (R = B, or 2B with CFG)
    positions: torch.Tensor,  # (R,) their positions
    cache: qwen3.KVCache,
    generator: torch.Generator,
    seen0: Optional[torch.Tensor] = None,  # (B, n_codes) bool: codes already in the prompt
    *,
    n_steps: int,
    code_start: int,
    n_codes: int,
    temperature: float = 0.85,
    top_k: int = 0,
    top_p: float = 0.9,
    cfg_scale: float = 1.0,
    repetition_penalty: float = 1.0,
    tp_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, qwen3.KVCache]:
    """Generate `n_steps` audio-code tokens on the device; returns (token ids
    (B, n_steps) on the device, cache). Nothing is read back to the host.

    With cfg_scale > 1 the rows are [cond(B), uncond(B)] in one decode batch
    and each sampled token feeds both halves. repetition_penalty != 1 applies
    HF semantics over the code sub-vocabulary.
    """
    r = first_tokens.shape[0]
    use_cfg = cfg_scale > 1.0
    b = r // 2 if use_cfg else r
    use_rp = repetition_penalty != 1.0
    dev = first_tokens.device
    seen = None
    if use_rp:
        seen = seen0.clone() if seen0 is not None else torch.zeros((b, n_codes), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    out = torch.empty((b, n_steps), dtype=torch.int64, device=dev)
    toks, pos = first_tokens.long(), positions.clone()
    for i in range(n_steps):
        logits, cache = qwen3.decode_step(params, cfg, toks, pos, cache, tp_sum)
        code_logits = logits[:, code_start : code_start + n_codes]
        if use_cfg:
            code_logits = cfg_combine(code_logits[:b], code_logits[b:], cfg_scale)
        if use_rp:
            code_logits = _apply_repetition_penalty(code_logits.float(), seen, repetition_penalty)
        idx = sample(code_logits, generator, temperature, top_k=top_k, top_p=top_p)
        if use_rp:
            seen[rows, idx] = True
        out[:, i] = idx + code_start
        toks = torch.cat([idx, idx]) + code_start if use_cfg else idx + code_start
        pos = pos + 1
    return out, cache
