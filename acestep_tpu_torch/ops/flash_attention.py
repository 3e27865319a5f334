"""Banded flash attention: CUDA kernel wrappers and their plain PyTorch version.

Port of `acestep_tpu/ops/pallas_attention.py::flash_attention` (Pallas kernel
`_band_kernel`), which keeps the storage dtype and accumulates in fp32. Two
routes by dtype:

- bf16 (serving): `csrc/flash_attention.cu` on the Hopper mainloop of
  `csrc/attention_sm90.cuh`: one CTA per (128-row q tile, q head, batch), TMA
  loads of 128-key K/V tiles into a ring fed by a producer thread, wgmma
  products and an online softmax over only the key tiles inside the band;
- fp32 (training, where the JAX package runs the DiT in fp32):
  `csrc/flash_attention_f32.cu`, 3xTF32 `mma.sync` on the tensor cores at
  fp32 accuracy (each operand split into two TF32 parts in registers, three
  products per product): one CTA per (64-row q tile, q head, batch), two an
  SM, 32-key K/V tiles through a two-stage cp.async ring, the same band,
  mask and online softmax.

Each source note gives what bounds it on an H100. `flash_attention` launches
a kernel for a CUDA tensor (head_dim 128, rows with 16-byte strides and base:
see `_rows_ok`) and raises on anything it does not take, any other dtype
included, without copying; a CPU tensor takes `flash_attention_plain`, the
einsum with an fp32 softmax. `.launches` counts the bf16 route's launches,
`.f32_launches` the fp32 route's. `f32_ctas_per_sm` reads the fp32 route's
occupancy on the current card.
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
_ARGS = [_P] * 5 + [ctypes.c_int] * 5 + [_LL] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
_ROUTES = {  # dtype -> (library, C entry point, launch counter)
    torch.bfloat16: ("flash_attention", "acestep_flash_attention", "launches"),
    torch.float32: ("flash_attention_f32", "acestep_flash_attention_f32", "f32_launches"),
}
_F32_CTAS = "acestep_flash_attention_f32_ctas_per_sm"


def _library(dtype: torch.dtype) -> ctypes.CDLL:
    lib_name, entry, _ = _ROUTES[dtype]
    signatures = {entry: (_ARGS, ctypes.c_int)}
    if dtype == torch.float32:
        signatures[_F32_CTAS] = ([], ctypes.c_int)
    return cuda_lib.load(lib_name, signatures)


def f32_ctas_per_sm() -> int:
    """CTAs of the fp32 route's kernel that one SM of the current card holds
    at once (its design asks for 2); raises on a CUDA error."""
    n = getattr(_library(torch.float32), _F32_CTAS)()
    if n < 0:
        cuda_lib.check(-n, "flash_attention_f32")
    return n


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
    """(B, L, N, 128) readable in 16-byte pieces (a TMA tensor map, or
    cp.async) through its batch and row strides: heads packed, strides and
    base address multiples of 16 bytes."""
    per16 = 16 // x.element_size()
    return (
        x.stride(3) == 1
        and x.stride(2) == HEAD_DIM
        and x.stride(1) % per16 == 0
        and x.stride(0) % per16 == 0
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
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ROUTES:
        raise ValueError(f"flash_attention: the kernels take bf16 or fp32, got {q.dtype}, {k.dtype}, {v.dtype}")
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
    lib_name, entry, counter = _ROUTES[q.dtype]
    rc = getattr(_library(q.dtype), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), b, lq, lk, nq, nkv,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1),
        float(scale), -1 if window is None else int(window), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(rc, lib_name)
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    return out


flash_attention.launches = 0
flash_attention.f32_launches = 0
