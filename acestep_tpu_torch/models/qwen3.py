"""Qwen3 text encoder (Qwen3-Embedding-0.6B), text-encoder half.

Port of the text-encoder role of `acestep_tpu/models/qwen3.py`:
`forward_hidden` (causal forward -> last hidden state; reference
`conditioning_embed.py:73-81`) and `embed_tokens` (the raw table lookup of the
lyric path). The planner LM half (prefill, decode, KV cache) is not ported yet.
Parameters are the JAX package's tree of tensors (see `params.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from acestep_tpu_torch.config import Qwen3Config
from acestep_tpu_torch.ops.attention import attention
from acestep_tpu_torch.ops.basic import linear, mlp_swiglu, rms_norm
from acestep_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Params = Dict[str, Any]


def _split_heads(x: torch.Tensor, n: int, h: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], n, h)


def _layer_forward(
    p: Params,
    cfg: Qwen3Config,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    h = rms_norm(p["input_layernorm"]["weight"], x, cfg.rms_norm_eps)
    a = p["self_attn"]
    q = _split_heads(linear(a["q_proj"], h), cfg.num_attention_heads, cfg.head_dim)
    q = rms_norm(a["q_norm"]["weight"], q, cfg.rms_norm_eps)
    k = _split_heads(linear(a["k_proj"], h), cfg.num_key_value_heads, cfg.head_dim)
    k = rms_norm(a["k_norm"]["weight"], k, cfg.rms_norm_eps)
    v = _split_heads(linear(a["v_proj"], h), cfg.num_key_value_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v, kv_mask=kv_mask, causal=True, scale=cfg.head_dim**-0.5)
    x = x + linear(a["o_proj"], o.reshape(x.shape[0], x.shape[1], -1))
    h = rms_norm(p["post_attention_layernorm"]["weight"], x, cfg.rms_norm_eps)
    return x + mlp_swiglu(p["mlp"], h)


def forward_hidden(
    params: Params,
    cfg: Qwen3Config,
    input_ids: torch.Tensor,  # (B, L)
    attention_mask: Optional[torch.Tensor] = None,  # (B, L) key padding
) -> torch.Tensor:
    """Full causal forward -> last_hidden_state (text-encoder role)."""
    x = embed_tokens(params, input_ids)
    cos, sin = rope_cos_sin(x.shape[1], cfg.head_dim, cfg.rope_theta, device=x.device)
    for lp in params["layers"]:
        x = _layer_forward(lp, cfg, x, cos, sin, attention_mask)
    return rms_norm(params["norm"]["weight"], x, cfg.rms_norm_eps)


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Raw embedding-table lookup (lyric path)."""
    return params["embed_tokens"]["weight"][input_ids.long()]
