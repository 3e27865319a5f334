"""Elementary neural-net ops: linear, RMSNorm, SwiGLU MLP, sin².

Port of `acestep_tpu/ops/basic.py`. A linear layer is a dict
``{"kernel": (in, out)[, "bias": (out,)]}`` applied as ``x @ kernel``, the
JAX package's layout. RMSNorm statistics are float32, the output is cast back
to the input dtype. Under tensor parallelism a rowwise layer (o_proj,
down_proj) holds this rank's input rows, and `linear_rowwise` sums its fp32
partials over the ranks before the one rounding.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 product x @ w of operands in x's dtype (JAX's
    ``preferred_element_type=float32``), without rounding to x's dtype.

    On the card a bf16 product goes through ``torch.mm(..., out_dtype=
    torch.float32)``: the GEMM's fp32 accumulators come out as they are. The
    CPU build has no such kernel, so there both operands are upcast; products
    of bf16 values are exact in fp32, so the two routes differ only in the
    order of the sums.
    """
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """Apply a linear layer in the dtype of x, with fp32 accumulation.

    As in the JAX version, a bias is added to the fp32 product and the sum is
    rounded once to x's dtype.
    """
    bias = params.get("bias")
    if bias is None:
        return torch.matmul(x, params["kernel"].to(x.dtype))
    return (matmul_f32(x, params["kernel"]) + bias.float()).to(x.dtype)


def linear_rowwise(params, x: torch.Tensor, tp_sum: Optional[Callable] = None) -> torch.Tensor:
    """`linear` of a rowwise tensor-parallel shard: the local product in
    fp32, summed in fp32 over the tp ranks by `tp_sum` (in place), the bias
    added once and the sum rounded once to x's dtype: the single device's
    one rounding point (bf16 partials are never summed). Without `tp_sum`,
    `linear`."""
    if tp_sum is None:
        return linear(params, x)
    y = tp_sum(matmul_f32(x, params["kernel"]))
    bias = params.get("bias")
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(weight: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics (Qwen3RMSNorm semantics)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (weight.float() * xf).to(x.dtype)


# cos(r) on [-π, π] as an even least-squares polynomial; the Oobleck kernels
# in csrc/oobleck.cu evaluate the same polynomial, so Snake matches the JAX
# package's `sin2_f32` and not `torch.sin`.
_COS_EVEN_COEF = (
    9.9999999980e-01,
    -4.9999999880e-01,
    4.1666664136e-02,
    -1.3888867452e-03,
    2.4800691382e-05,
    -2.7536992140e-07,
    2.0620751417e-09,
    -9.7751781371e-12,
)
_TWO_PI = 6.283185307179586
_INV_TWO_PI = 0.15915494309189535


def sin2_f32(u: torch.Tensor) -> torch.Tensor:
    """sin²(u) via ½ − ½·cos(2u) with a range-reduced even polynomial (fp32)."""
    v = 2.0 * u
    k = torch.round(v * _INV_TWO_PI)
    r = v - k * _TWO_PI
    r2 = r * r
    c = torch.full_like(r2, _COS_EVEN_COEF[-1])
    for coef in _COS_EVEN_COEF[-2::-1]:
        c = c * r2 + coef
    return 0.5 - 0.5 * c


def mlp_swiglu(params, x: torch.Tensor, tp_sum: Optional[Callable] = None) -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(x)) * up(x)) — Qwen3MLP semantics. Under
    tensor parallelism gate and up hold local features and `tp_sum` sums
    down's partials (`linear_rowwise`)."""
    g = linear(params["gate_proj"], x)
    u = linear(params["up_proj"], x)
    return linear_rowwise(params["down_proj"], F.silu(g) * u, tp_sum)
