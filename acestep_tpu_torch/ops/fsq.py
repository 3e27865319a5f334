"""Finite Scalar Quantization (FSQ) and the single-quantizer ResidualFSQ wrapper.

Port of `acestep_tpu/ops/fsq.py` (the math of vector-quantize-pytorch's
FSQ/ResidualFSQ as the reference audio tokenizer uses it):

- levels L = (8, 8, 8, 5, 5, 5) -> codebook 64 000, code dim 6
- ``bound``: tanh(z + shift) scaled into [-(L-1)/2, (L-1)/2] with an offset
  of 0.5 for even levels (shift = atanh(offset / half_l), eps = 1e-3)
- quantize: round(bound(z)) / (L // 2) -> values in [-1, 1]
- index codec: mixed radix over ``basis = cumprod([1, *levels[:-1]])``

The index codec runs in float32 like the JAX version and is bit-exact with it.
ResidualFSQ with one quantizer is project_in (dim -> 6) -> FSQ -> project_out
(6 -> dim).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from acestep_tpu_torch.ops.basic import linear


def _levels_arrays(levels: Sequence[int], device=None):
    lv = np.asarray(levels, dtype=np.float32)
    basis = np.concatenate([[1.0], np.cumprod(lv[:-1])]).astype(np.float32)
    half_width = (np.asarray(levels, dtype=np.int32) // 2).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (lv, basis, half_width))


def fsq_bound(z: torch.Tensor, levels: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    lv, _, _ = _levels_arrays(levels, z.device)
    half_l = (lv - 1.0) * (1.0 + eps) / 2.0
    offset = torch.where(torch.as_tensor(levels, device=z.device) % 2 == 0, 0.5, 0.0).float()
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def fsq_quantize(z: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Quantize bounded z to normalized code values in [-1, 1] (float32)."""
    _, _, half_width = _levels_arrays(levels, z.device)
    return torch.round(fsq_bound(z.float(), levels)) / half_width


def fsq_codes_to_indices(codes: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Normalized codes (..., d) -> integer indices (...)."""
    _, basis, half_width = _levels_arrays(levels, codes.device)
    scaled = codes.float() * half_width + half_width
    return (scaled * basis).sum(dim=-1).to(torch.int32)


def fsq_indices_to_codes(indices: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Integer indices (...) -> normalized codes (..., d) in [-1, 1], float32."""
    lv, basis, half_width = _levels_arrays(levels, indices.device)
    idx = indices.float()[..., None]
    codes_non_centered = torch.remainder(torch.floor(idx / basis), lv)
    return (codes_non_centered - half_width) / half_width


def residual_fsq_forward(params, z: torch.Tensor, levels: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """project_in -> FSQ -> project_out. Returns (quantized_out, indices)."""
    zc = linear(params["project_in"], z).float()
    codes = fsq_quantize(zc, levels)
    indices = fsq_codes_to_indices(codes, levels)
    return linear(params["project_out"], codes.to(z.dtype)), indices


def residual_fsq_decode_indices(
    params, indices: torch.Tensor, levels: Sequence[int], dtype=torch.bfloat16
) -> torch.Tensor:
    """ResidualFSQ.get_output_from_indices for one quantizer.

    indices: (...) or (..., 1) int; the trailing quantizer axis is squeezed.
    Returns (..., dim).
    """
    if indices.dim() and indices.shape[-1] == 1:
        indices = indices[..., 0]
    codes = fsq_indices_to_codes(indices, levels)
    return linear(params["project_out"], codes.to(dtype))
