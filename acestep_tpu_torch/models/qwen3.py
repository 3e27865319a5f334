"""Qwen3 transformer: text encoder and the 5 Hz planner LM.

Port of `acestep_tpu/models/qwen3.py` in its two roles:

1. Text encoder: `forward_hidden` (causal forward -> last hidden state;
   reference `conditioning_embed.py:73-81`) and `embed_tokens` (the raw table
   lookup of the lyric path).
2. Planner LM: `KVCache` (preallocated (layers, B, max_len, n_kv, head_dim)),
   `prefill`, `decode_step` with per-row positions, and `logits_from_hidden`
   (the fp32 product of the model-dtype operands, as JAX's
   ``preferred_element_type=float32``).

Unlike the JAX version, which returns a new cache, `prefill` and
`decode_step` write into the cache's tensors in place (one row per step and
layer) and return the same `KVCache`. Parameters are the JAX package's tree of
tensors (see `params.py`); `convert_torch_qwen3_state` builds it from an HF
Qwen3 state dict.

Under tensor parallelism (`parallel.mesh.shard_params_tp`: q/k/v/gate/up
hold this rank's output columns, o/down its input rows) the forwards take
`tp_sum`, the fp32 sum over the tp ranks: attention runs on the local heads
and the MLP on the local features, and each rowwise product's fp32 partial is
summed before its one rounding (`ops.basic.linear_rowwise`), two sums a
layer. Head counts come from the weights' widths, so the same code runs a
whole model or a rank's slice; the embeddings, the norms and the head stay
whole, so every rank of the line computes the same logits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from acestep_tpu_torch.config import Qwen3Config
from acestep_tpu_torch.ops.attention import attention, attention_xla
from acestep_tpu_torch.ops.basic import linear, linear_rowwise, matmul_f32, mlp_swiglu, rms_norm
from acestep_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from acestep_tpu_torch.params import leaf, np32

Params = Dict[str, Any]


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, L, n·h) -> (B, L, n, h): n is the heads the weights hold."""
    return x.reshape(x.shape[0], x.shape[1], -1, h)


def kv_heads(params: Params, cfg: Qwen3Config) -> int:
    """The key-value heads `params` hold: the config's, or a tp rank's share."""
    return params["layers"][0]["self_attn"]["k_proj"]["kernel"].shape[-1] // cfg.head_dim


@dataclass
class KVCache:
    """Per-layer stacked KV cache: k/v are (layers, B, max_len, n_kv, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # () int32: number of valid positions

    @staticmethod
    def create(cfg: Qwen3Config, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
               kv_heads: Optional[int] = None) -> "KVCache":
        """Zeros for `kv_heads` heads (the config's by default; a tp rank's
        share of them under tensor parallelism)."""
        n_kv = cfg.num_key_value_heads if kv_heads is None else kv_heads
        shape = (cfg.num_hidden_layers, batch, max_len, n_kv, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((), dtype=torch.int32, device=device),
        )


def _layer_forward(
    p: Params,
    cfg: Qwen3Config,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    tp_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One Qwen3 decoder layer. Returns (x, (k, v)): the new K/V for caching."""
    h = rms_norm(p["input_layernorm"]["weight"], x, cfg.rms_norm_eps)
    a = p["self_attn"]
    q = _split_heads(linear(a["q_proj"], h), cfg.head_dim)
    q = rms_norm(a["q_norm"]["weight"], q, cfg.rms_norm_eps)
    k = _split_heads(linear(a["k_proj"], h), cfg.head_dim)
    k = rms_norm(a["k_norm"]["weight"], k, cfg.rms_norm_eps)
    v = _split_heads(linear(a["v_proj"], h), cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v, kv_mask=kv_mask, causal=True, scale=cfg.head_dim**-0.5)
    x = x + linear_rowwise(a["o_proj"], o.reshape(x.shape[0], x.shape[1], -1), tp_sum)
    h = rms_norm(p["post_attention_layernorm"]["weight"], x, cfg.rms_norm_eps)
    return x + mlp_swiglu(p["mlp"], h, tp_sum), (k, v)


def forward_hidden(
    params: Params,
    cfg: Qwen3Config,
    input_ids: torch.Tensor,  # (B, L)
    attention_mask: Optional[torch.Tensor] = None,  # (B, L) key padding
    tp_sum: Optional[Callable] = None,
) -> torch.Tensor:
    """Full causal forward -> last_hidden_state (text-encoder role; the
    planner's teacher-forced scoring forward)."""
    x = embed_tokens(params, input_ids)
    cos, sin = rope_cos_sin(x.shape[1], cfg.head_dim, cfg.rope_theta, device=x.device)
    for lp in params["layers"]:
        x, _ = _layer_forward(lp, cfg, x, cos, sin, attention_mask, tp_sum)
    return rms_norm(params["norm"]["weight"], x, cfg.rms_norm_eps)


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Raw embedding-table lookup (lyric path)."""
    return params["embed_tokens"]["weight"][input_ids.long()]


def logits_from_hidden(params: Params, cfg: Qwen3Config, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits: the product of hidden and the head in hidden's dtype,
    accumulated and returned in fp32 (tied embeddings without `lm_head`)."""
    head = params.get("lm_head")
    if head is None:
        return matmul_f32(hidden, params["embed_tokens"]["weight"].t())
    return matmul_f32(hidden, head["kernel"])


# ---------------------------------------------------------------------------
# LM prefill / decode with KV cache
# ---------------------------------------------------------------------------


def prefill(
    params: Params,
    cfg: Qwen3Config,
    input_ids: torch.Tensor,  # (B, L) right-padded to a bucket
    prompt_mask: torch.Tensor,  # (B, L) 1 for real tokens
    cache: KVCache,
    tp_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Process the whole prompt; returns (logits at the last real token (B, V), cache).

    Writes the K/V of all L positions into cache[:, :, :L] in place.
    """
    l = input_ids.shape[1]
    x = embed_tokens(params, input_ids)
    cos, sin = rope_cos_sin(l, cfg.head_dim, cfg.rope_theta, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, (k, v) = _layer_forward(lp, cfg, x, cos, sin, prompt_mask, tp_sum)
        cache.k[i, :, :l] = k.to(cache.k.dtype)
        cache.v[i, :, :l] = v.to(cache.v.dtype)
    x = rms_norm(params["norm"]["weight"], x, cfg.rms_norm_eps)
    last_idx = prompt_mask.to(torch.int64).sum(dim=1) - 1  # (B,)
    last_hidden = x[torch.arange(x.shape[0], device=x.device), last_idx]
    logits = logits_from_hidden(params, cfg, last_hidden[:, None, :])[:, 0]
    cache.length = (last_idx.max() + 1).to(torch.int32)
    return logits, cache


def _rot_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def decode_step(
    params: Params,
    cfg: Qwen3Config,
    token_ids: torch.Tensor,  # (B,) current tokens
    positions: torch.Tensor,  # (B,) positions of these tokens
    cache: KVCache,
    tp_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step -> (logits (B, V) fp32, the updated cache).

    Each row's new K/V lands at its own position; a position at or past the
    cache's length is a no-op write. Row r attends to cache keys at positions
    <= positions[r].
    """
    b = token_ids.shape[0]
    max_len = cache.k.shape[2]
    dev = token_ids.device
    x = embed_tokens(params, token_ids)[:, None, :]  # (B, 1, D)

    # Rope from per-row positions, in fp32.
    inv_freq = 1.0 / (
        cfg.rope_theta ** (torch.arange(0, cfg.head_dim, 2, dtype=torch.float32, device=dev) / cfg.head_dim)
    )
    freqs = positions.float()[:, None] * inv_freq[None]  # (B, h/2)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, None, :]  # (B, 1, 1, h)
    cos, sin = torch.cos(emb), torch.sin(emb)

    kv_mask = (torch.arange(max_len, device=dev)[None, :] <= positions[:, None])[:, None, None, :]
    rows = torch.arange(b, device=dev)
    in_range = (positions < max_len)[:, None, None]
    slot = positions.clamp(max=max_len - 1).long()

    for i, lp in enumerate(params["layers"]):
        h = rms_norm(lp["input_layernorm"]["weight"], x, cfg.rms_norm_eps)
        a = lp["self_attn"]
        q = _split_heads(linear(a["q_proj"], h), cfg.head_dim)
        q = rms_norm(a["q_norm"]["weight"], q, cfg.rms_norm_eps)
        k = _split_heads(linear(a["k_proj"], h), cfg.head_dim)
        k = rms_norm(a["k_norm"]["weight"], k, cfg.rms_norm_eps)
        v = _split_heads(linear(a["v_proj"], h), cfg.head_dim)
        qf = (q.float() * cos + _rot_half(q.float()) * sin).to(q.dtype)
        kf = (k.float() * cos + _rot_half(k.float()) * sin).to(k.dtype)

        # In-place scatter of one row per sequence; out-of-range rows write
        # back what the last slot holds.
        ki, vi = cache.k[i], cache.v[i]
        ki[rows, slot] = torch.where(in_range, kf[:, 0].to(ki.dtype), ki[rows, slot])
        vi[rows, slot] = torch.where(in_range, v[:, 0].to(vi.dtype), vi[rows, slot])

        o = attention_xla(qf, ki, vi, mask=kv_mask, scale=cfg.head_dim**-0.5)
        x = x + linear_rowwise(a["o_proj"], o.reshape(b, 1, -1), tp_sum)
        h2 = rms_norm(lp["post_attention_layernorm"]["weight"], x, cfg.rms_norm_eps)
        x = x + mlp_swiglu(lp["mlp"], h2, tp_sum)

    x = rms_norm(params["norm"]["weight"], x, cfg.rms_norm_eps)
    logits = logits_from_hidden(params, cfg, x)[:, 0]
    cache.length = cache.length + 1
    return logits, cache


def convert_torch_qwen3_state(state: Dict[str, Any], cfg: Qwen3Config, dtype=torch.bfloat16, device="cpu") -> Params:
    """An HF Qwen3Model / Qwen3ForCausalLM state_dict -> the port's tree
    (names with or without the "model." prefix; `lm_head` kept when the
    state has one and the embeddings are untied)."""

    def get(name):
        for cand in (name, "model." + name):
            if cand in state:
                return np32(state[cand])
        raise KeyError(name)

    def lin(prefix):
        return {"kernel": leaf(get(prefix + ".weight").T, device, dtype)}

    def norm(prefix):
        return {"weight": leaf(get(prefix + ".weight"), device, dtype)}

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"layers.{i}"
        layers.append({
            "input_layernorm": norm(pre + ".input_layernorm"),
            "self_attn": {
                "q_proj": lin(pre + ".self_attn.q_proj"),
                "k_proj": lin(pre + ".self_attn.k_proj"),
                "v_proj": lin(pre + ".self_attn.v_proj"),
                "o_proj": lin(pre + ".self_attn.o_proj"),
                "q_norm": norm(pre + ".self_attn.q_norm"),
                "k_norm": norm(pre + ".self_attn.k_norm"),
            },
            "post_attention_layernorm": norm(pre + ".post_attention_layernorm"),
            "mlp": {
                "gate_proj": lin(pre + ".mlp.gate_proj"),
                "up_proj": lin(pre + ".mlp.up_proj"),
                "down_proj": lin(pre + ".mlp.down_proj"),
            },
        })
    params = {
        "embed_tokens": {"weight": leaf(get("embed_tokens.weight"), device, dtype)},
        "layers": layers,
        "norm": norm("norm"),
    }
    if "lm_head.weight" in state and not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": leaf(np32(state["lm_head.weight"]).T, device, dtype)}
    return params
