"""Banded flash attention: CUDA kernel wrapper and its plain PyTorch version.

Port of `acestep_tpu/ops/pallas_attention.py::flash_attention` (Pallas kernel
`_band_kernel`). The kernel is `csrc/flash_attention.cu` on the Hopper
mainloop of `csrc/attention_sm90.cuh`: one CTA per (128-row q tile, q head,
batch), TMA loads of 128-key K/V tiles into a ring fed by a producer thread,
wgmma products and an online softmax over only the key tiles inside the
band; its source note gives what bounds it on an H100.

`flash_attention` launches the kernel for a CUDA tensor (bf16, head_dim 128,
rows that TMA can read: see `_rows_ok`) and raises on anything it does not
take, without copying; a CPU tensor takes `flash_attention_plain`, the einsum
with an fp32 softmax. `.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from acestep_tpu_torch.ops import cuda_lib
from acestep_tpu_torch.ops.attention import attention_xla, make_attention_bias

HEAD_DIM = 128
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "acestep_flash_attention": (
        [_P] * 5 + [ctypes.c_int] * 5 + [_LL] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int,
    ),
}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    causal: bool = False,
) -> torch.Tensor:
    mask = make_attention_bias(
        q.shape[1], k.shape[1], kv_mask=kv_mask, window=window, causal=causal, device=q.device
    )
    return attention_xla(q, k, v, mask=mask, scale=scale)


def _rows_ok(x: torch.Tensor) -> bool:
    """(B, L, N, 128) readable by a TMA tensor map through its batch and row
    strides: heads packed, strides and base address multiples of 16 bytes."""
    return (
        x.stride(3) == 1
        and x.stride(2) == HEAD_DIM
        and x.stride(1) % 8 == 0
        and x.stride(0) % 8 == 0
        and x.data_ptr() % 16 == 0
    )


def flash_attention(
    q: torch.Tensor,  # (B, Lq, Nq, H)
    k: torch.Tensor,  # (B, Lk, Nkv, H)
    v: torch.Tensor,  # (B, Lk, Nkv, H)
    kv_mask: Optional[torch.Tensor] = None,  # (B, Lk), nonzero = valid key
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    causal: bool = False,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, scale=scale, window=window, causal=causal)
    b, lq, nq, h = q.shape
    _, lk, nkv, _ = k.shape
    if h != HEAD_DIM or k.shape[-1] != h or v.shape != k.shape or k.shape[0] != b:
        raise ValueError(f"flash_attention: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if nq % nkv:
        raise ValueError("flash_attention: q heads must be a multiple of kv heads")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention: the kernel takes bf16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _rows_ok(x):
            raise ValueError(
                f"flash_attention: {name} strides {tuple(x.stride())} are not TMA-readable "
                "(heads packed, 16-byte-aligned strides and base)"
            )
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, lq, nq, h), dtype=q.dtype, device=q.device)
    scale = h**-0.5 if scale is None else scale
    lib = cuda_lib.load("flash_attention", _SIGNATURES)
    rc = lib.acestep_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), b, lq, lk, nq, nkv,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1),
        float(scale), -1 if window is None else int(window), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
