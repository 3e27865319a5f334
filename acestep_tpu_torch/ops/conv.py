"""1-D convolutions in NLC layout with (K, C_in, C_out) kernels.

Port of `acestep_tpu/ops/conv.py`. The public functions keep the JAX layout
(channels last, 'LIO' kernels) so the tests compare like with like; inside,
the general cases go through PyTorch's NCL convolutions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,  # (B, L, C_in)
    kernel: torch.Tensor,  # (K, C_in, C_out)
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
) -> torch.Tensor:
    w = kernel.to(x.dtype).permute(2, 1, 0)  # (C_out, C_in, K)
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=padding, dilation=dilation)
    y = y.transpose(1, 2)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.contiguous()


def conv_transpose1d(
    x: torch.Tensor,  # (B, L, C_in)
    kernel: torch.Tensor,  # (K, C_in, C_out)
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """torch ConvTranspose1d semantics: out_len = (L-1)*stride - 2*padding + K.

    Fast path (the Oobleck decoder's K = 2·stride, padding = stride/2, even
    stride): three dense products and an interleave. Output position
    p = t·s + r receives
      x[t]   · W[r + s/2]                       (always)
      x[t-1] · W[r + 3s/2]   for r <  s/2
      x[t+1] · W[r -  s/2]   for r >= s/2
    Each product is rounded to x.dtype, as in the JAX version.
    """
    k = kernel.shape[0]
    s = stride
    if s > 1 and s % 2 == 0 and k == 2 * s and padding == s // 2:
        b, l, _ = x.shape
        cout = kernel.shape[2]
        kf = kernel.to(x.dtype)
        half = s // 2
        a = torch.einsum("blc,rcd->blrd", x, kf[half : half + s])
        p_ = torch.einsum("blc,rcd->blrd", x, kf[3 * half :])
        n_ = torch.einsum("blc,rcd->blrd", x, kf[:half])
        p_shift = F.pad(p_[:, :-1], (0, 0, 0, 0, 1, 0))
        n_shift = F.pad(n_[:, 1:], (0, 0, 0, 0, 0, 1))
        zeros = torch.zeros_like(p_shift)
        y = a + torch.cat([p_shift, zeros], dim=2) + torch.cat([zeros, n_shift], dim=2)
        y = y.reshape(b, l * s, cout)
    else:
        w = kernel.to(x.dtype).permute(1, 2, 0)  # (C_in, C_out, K)
        y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride, padding=padding)
        y = y.transpose(1, 2)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.contiguous()
