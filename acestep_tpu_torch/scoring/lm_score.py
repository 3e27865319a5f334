"""PMI and top-k reward scoring of generated audio codes through the planner.

Port of `acestep_tpu/scoring/lm_score.py` on the port's `LLMHandler`:
PMI(codes; condition) = log P(codes | condition) - log P(codes), squashed
through tanh; the composite reward mixes the PMI, the share of code tokens in
the planner's top k, and the metadata recall. The log-probabilities come from
one teacher-forced forward over prompt + codes (`qwen3.forward_hidden`, so
the flash kernel on the card once the sequence reaches 256 tokens), fp32
logits and `log_softmax`, with no per-token loop. Each score's forward runs
as one planner call (`LLMHandler.on_line`), so a planner split over a mesh
computes it on its tp line.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from acestep_tpu_torch.lm.constrained import _encode
from acestep_tpu_torch.models import qwen3


def pmi_score(log_prob_conditional: float, log_prob_unconditional: float) -> float:
    """Pointwise mutual information."""
    return log_prob_conditional - log_prob_unconditional


def pmi_to_normalized_score(pmi: float, scale: float = 0.1) -> float:
    """PMI mapped to (0, 1) through tanh."""
    return 0.5 * (math.tanh(scale * pmi) + 1.0)


@torch.inference_mode()
def _token_log_probs(params, cfg, input_ids: torch.Tensor, target_mask: torch.Tensor, tp_sum=None):
    """Per-token log P(token | prefix), the mask of the scored positions and
    the logits that predict them (logits at position i predict token i+1)."""
    hidden = qwen3.forward_hidden(params, cfg, input_ids, tp_sum=tp_sum)
    logits = qwen3.logits_from_hidden(params, cfg, hidden).float()
    logp = torch.log_softmax(logits, dim=-1)
    targets = input_ids[:, 1:].long()
    token_logp = torch.gather(logp[:, :-1], -1, targets[..., None])[..., 0]
    mask = target_mask[:, 1:].float()
    return token_logp, mask, logits[:, :-1]


def _scored(llm_handler, prompt: str, continuation_ids: List[int]):
    prompt_ids = _encode(llm_handler.tokenizer, prompt)
    ids = np.asarray([prompt_ids + list(continuation_ids)], np.int32)
    mask = np.zeros_like(ids)
    mask[0, len(prompt_ids):] = 1
    out = _token_log_probs(llm_handler.params, llm_handler.config, llm_handler._tensor(ids),
                           llm_handler._tensor(mask), llm_handler._tp_sum)
    return ids, out


def sequence_log_prob(llm_handler, prompt: str, continuation_ids: List[int]) -> Tuple[float, float]:
    """(total log-prob, mean log-prob) of the continuation given the prompt."""
    return llm_handler.on_line(_sequence_log_prob, prompt, continuation_ids)


def _sequence_log_prob(llm_handler, prompt: str, continuation_ids: List[int]) -> Tuple[float, float]:
    _, (token_logp, m, _) = _scored(llm_handler, prompt, continuation_ids)
    total = float((token_logp * m).sum())
    n = float(m.sum())
    return total, total / max(n, 1.0)


def topk_recall(llm_handler, prompt: str, continuation_ids: List[int], k: int = 10) -> float:
    """Share of the continuation's tokens within the planner's top k."""
    return llm_handler.on_line(_topk_recall, prompt, continuation_ids, k)


def _topk_recall(llm_handler, prompt: str, continuation_ids: List[int], k: int) -> float:
    ids, (_, m, logits) = _scored(llm_handler, prompt, continuation_ids)
    kth = torch.topk(logits, k, dim=-1).values[..., -1]
    targets = torch.as_tensor(ids[0, 1:], device=logits.device).long()
    target_logits = torch.gather(logits[0], -1, targets[:, None])[:, 0]
    in_topk = (target_logits >= kth[0]) & (m[0] > 0)
    n = float(m[0].sum())
    return float(in_topk.sum()) / max(n, 1.0)


def metadata_recall(generated_meta: Dict[str, Any], reference_meta: Dict[str, Any]) -> float:
    """Share of the reference metadata fields the generation reproduced."""
    if not reference_meta:
        return 1.0
    hits, total = 0, 0
    for k, v in reference_meta.items():
        if v in (None, "", "N/A"):
            continue
        total += 1
        g = generated_meta.get(k)
        if g is None:
            continue
        if str(g).strip().lower() == str(v).strip().lower():
            hits += 1
        elif k in ("bpm", "duration"):
            try:
                if abs(float(g) - float(v)) / max(abs(float(v)), 1e-6) < 0.1:
                    hits += 1
            except (TypeError, ValueError):
                pass
    return hits / total if total else 1.0


def calculate_reward_score(
    llm_handler,
    caption: str,
    lyrics: str,
    audio_codes: str,
    *,
    generated_meta: Optional[Dict[str, Any]] = None,
    reference_meta: Optional[Dict[str, Any]] = None,
    pmi_weight: float = 0.5,
    recall_weight: float = 0.3,
    meta_weight: float = 0.2,
    topk: int = 10,
) -> Dict[str, float]:
    """Composite reward of `audio_codes` (at most their first 1024 tokens)
    for the caption and lyrics."""
    codes = llm_handler.parse_lm_output(audio_codes)[1] or audio_codes
    code_ids = _encode(llm_handler.tokenizer, codes)[:1024]
    if not code_ids:
        return {"reward": 0.0, "pmi": 0.0, "pmi_normalized": 0.0, "topk_recall": 0.0, "meta_recall": 0.0}

    cond_prompt = llm_handler.build_formatted_prompt(caption, lyrics, generation_phase="codes")
    uncond_prompt = llm_handler.build_formatted_prompt("", lyrics, is_negative_prompt=True, generation_phase="cot")
    lp_cond, _ = sequence_log_prob(llm_handler, cond_prompt, code_ids)
    lp_uncond, _ = sequence_log_prob(llm_handler, uncond_prompt, code_ids)
    pmi = pmi_score(lp_cond, lp_uncond) / max(len(code_ids), 1)
    pmi_n = pmi_to_normalized_score(pmi, scale=1.0)
    recall = topk_recall(llm_handler, cond_prompt, code_ids, k=topk)
    meta = metadata_recall(generated_meta or {}, reference_meta or {})
    reward = pmi_weight * pmi_n + recall_weight * recall + meta_weight * meta
    return {
        "reward": float(reward),
        "pmi": float(pmi),
        "pmi_normalized": float(pmi_n),
        "topk_recall": float(recall),
        "meta_recall": float(meta),
    }
