"""Grouped-query attention with causal / sliding-window and padding masks.

Port of `acestep_tpu/ops/attention.py`. Two paths behind one interface, with
the JAX package's gate (`_flash_wanted`: `set_flash_enabled` first, then
`ACESTEP_TPU_NO_FLASH=1` off, then head_dim % 128 == 0 and min(Lq, Lk) >= 256)
on every device: the banded flash kernel (`ops/flash_attention`, a CUDA kernel
on the card, its plain version for a CPU tensor) through `FlashAttention`,
whose backward recomputes the einsum path as JAX's `_flash_diff` does;
anything else runs the einsum with an fp32 softmax, as the JAX package does
outside Pallas.

Mask semantics follow the reference's `create_4d_mask`: a boolean "allowed"
geometry (causal and/or |i-j| <= window) AND-ed with a key-padding mask.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

FLASH_MIN_LEN = 256
_flash_override: Optional[bool] = None


def set_flash_enabled(value: Optional[bool]) -> None:
    """Force the flash path on or off (None: the shape gate decides)."""
    global _flash_override
    _flash_override = value


def flash_wanted(lq: int, lk: int, head_dim: int) -> bool:
    if _flash_override is not None:
        return _flash_override
    if os.environ.get("ACESTEP_TPU_NO_FLASH", "0") == "1":
        return False
    return head_dim % 128 == 0 and min(lq, lk) >= FLASH_MIN_LEN


def make_attention_bias(
    q_len: int,
    kv_len: Optional[int] = None,
    *,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Lk) bool/0-1: valid keys
    window: Optional[int] = None,
    causal: bool = False,
    device=None,
) -> Optional[torch.Tensor]:
    """Boolean allowed-mask of shape (B or 1, 1, Lq, Lk), or None if all allowed."""
    kv_len = q_len if kv_len is None else kv_len
    if device is None and kv_mask is not None:
        device = kv_mask.device
    geom = None
    if causal or window is not None:
        qi = torch.arange(q_len, device=device)[:, None]
        kj = torch.arange(kv_len, device=device)[None, :]
        diff = qi - kj
        allowed = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
        if causal:
            allowed &= diff >= 0
            if window is not None:
                allowed &= diff <= window
        elif window is not None:
            allowed &= diff.abs() <= window
        geom = allowed[None, None]
    if kv_mask is not None:
        pad = kv_mask.to(torch.bool)[:, None, None, :]
        geom = pad if geom is None else (geom & pad)
    return geom


def attention_xla(
    q: torch.Tensor,  # (B, Lq, Nq, H)
    k: torch.Tensor,  # (B, Lk, Nkv, H)
    v: torch.Tensor,  # (B, Lk, Nkv, H)
    *,
    mask: Optional[torch.Tensor] = None,  # (B|1, 1, Lq, Lk) bool — True = attend
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention via einsum with fp32 scores and softmax; (B, Lq, Nq, H) in q.dtype.

    Masked scores take finfo(float32).min, so a fully masked row averages all
    keys uniformly (never NaN), as in the JAX version.
    """
    b, lq, nq, h = q.shape
    nkv = k.shape[2]
    groups = nq // nkv
    scale = h**-0.5 if scale is None else scale
    qg = q.reshape(b, lq, nkv, groups, h)
    scores = torch.einsum("bqngh,bsnh->bngqs", qg.float(), k.float()) * scale
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(~mask[:, :, None, :, :], neg)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqs,bsnh->bqngh", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, lq, nq, h).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of JAX's `_flash_diff`.

    Forward: `flash_attention` on whichever route the dtype takes (the bf16 or
    fp32 kernel on the card, the plain version on the CPU). The kernels are
    ctypes calls on raw pointers, so autograd cannot see through them; the
    backward recomputes `make_attention_bias` + `attention_xla` on detached
    copies of q, k, v and differentiates that, as `_flash_diff_bwd` does: no
    probabilities are stored, the O(L^2) recompute is in the backward only.
    The mask and the static arguments get no gradient.
    """

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, window, causal, scale):
        from acestep_tpu_torch.ops.flash_attention import flash_attention

        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.statics = (window, causal, scale)
        return flash_attention(q, k, v, kv_mask, scale=scale, window=window, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        window, causal, scale = ctx.statics
        with torch.enable_grad():
            qd, kd, vd = (x.detach().requires_grad_(True) for x in (q, k, v))
            mask = make_attention_bias(
                q.shape[1], k.shape[1], kv_mask=kv_mask, window=window, causal=causal, device=q.device
            )
            out = attention_xla(qd, kd, vd, mask=mask, scale=scale)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Lk) key padding
    window: Optional[int] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Structured-mask attention; dispatches to the flash kernel or the einsum."""
    lq, lk = q.shape[1], k.shape[1]
    if flash_wanted(lq, lk, q.shape[-1]):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return FlashAttention.apply(q, k, v, kv_mask, window, causal, scale)
    mask = None
    if kv_mask is not None or window is not None or causal:
        mask = make_attention_bias(
            lq, lk, kv_mask=kv_mask, window=window, causal=causal, device=q.device
        )
    return attention_xla(q, k, v, mask=mask, scale=scale)
