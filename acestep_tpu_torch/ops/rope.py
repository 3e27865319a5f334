"""Rotary position embeddings (Qwen3 duplicated-halves layout).

Port of `acestep_tpu/ops/rope.py`: float32 inverse frequencies, (L, head_dim)
cos/sin tables, rotate-half application computed in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    seq_len: int, head_dim: int, theta: float = 1e6, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each (seq_len, head_dim), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., L, heads, head_dim); cos/sin: (L, head_dim)."""
    cos = cos.float()[..., :, None, :]
    sin = sin.float()[..., :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
