"""Oobleck decoder kernels (CUDA) and their plain PyTorch versions.

Port of `acestep_tpu/ops/pallas_vae.py`:

- `decoder_block_kernel` replaces `decoder_block_pallas`: one Oobleck decoder
  block, Snake -> ConvTranspose1d (K = 2s, pad s/2) -> 3 residual units.
- `res_units_kernel` replaces `res_units_pallas`: the 3-residual-unit chain
  alone (decoder block 0, 1024 channels).

Both run `csrc/oobleck.cu` as a short fixed sequence of launches (Snake, then
conv-as-GEMM with fused bias/Snake/residual epilogues); the source note there
gives the design and what bounds it on an H100. Each wrapper counts its calls
that launch the kernels in `.launches`. A CPU tensor takes the plain version
beside it, which rounds to the input dtype at the same points as the kernels;
a CUDA tensor launches the kernels or raises.

Rows outside [0, L) read as zeros (torch zero padding), so the halo gates of
the TPU kernels (`TOTAL_HALO`, `_upsample_halo`) only keep the dispatch in
`models/vae.decoder_block` identical to the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from acestep_tpu_torch.ops import cuda_lib
from acestep_tpu_torch.ops.basic import sin2_f32
from acestep_tpu_torch.ops.conv import conv_transpose1d

DILATIONS = (1, 3, 9)
TOTAL_HALO = 40  # the TPU kernels' halo: 39 rows (3 * (1 + 3 + 9)) rounded to 8

_P = ctypes.c_void_p
_SIGNATURES = {
    "acestep_snake": ([_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P], ctypes.c_int),
    "acestep_conv_gemm": ([_P] * 7 + [ctypes.c_int] * 7 + [_P], ctypes.c_int),
}


def _upsample_halo(s: int) -> int:
    """Input halo rows per side of the TPU block kernel (kept for the gates)."""
    need = -(-TOTAL_HALO // s) + 1
    return -(-need // 8) * 8


def snake_consts(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exp(alpha), 1 / (exp(beta) + 1e-9)) in fp32; alpha/beta are stored as logs."""
    return torch.exp(p["alpha"].float()), 1.0 / (torch.exp(p["beta"].float()) + 1e-9)


def snake_f32(xf: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    a, inv_b = snake_consts(p)
    return xf + inv_b * sin2_f32(a * xf)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _conv_f32(x: torch.Tensor, kernel: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """fp32 'same' conv in NLC with a (K, Ci, Co) kernel."""
    k = kernel.shape[0]
    pad = (k - 1) * dilation // 2
    y = F.conv1d(x.transpose(1, 2), kernel.float().permute(2, 1, 0), padding=pad, dilation=dilation)
    return y.transpose(1, 2)


def res_unit_plain(h: torch.Tensor, p: Dict[str, Any], dilation: int) -> torch.Tensor:
    dtype = h.dtype
    a = snake_f32(h.float(), p["snake1"]).to(dtype)
    acc = _conv_f32(a.float(), p["conv1"]["kernel"], dilation) + p["conv1"]["bias"].float()
    z = snake_f32(acc, p["snake2"]).to(dtype)
    out = h.float() + _conv_f32(z.float(), p["conv2"]["kernel"]) + p["conv2"]["bias"].float()
    return out.to(dtype)


def res_units_plain(x: torch.Tensor, unit_params: Sequence[Dict[str, Any]]) -> torch.Tensor:
    for p, d in zip(unit_params, DILATIONS):
        x = res_unit_plain(x, p, d)
    return x


def decoder_block_plain(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    dtype = x.dtype
    a = snake_f32(x.float(), p["snake1"]).to(dtype)
    ct = p["conv_t1"]
    bias = ct.get("bias")
    y = conv_transpose1d(
        a.float(), ct["kernel"].float(), None if bias is None else bias.float(),
        stride=stride, padding=stride // 2,
    ).to(dtype)
    return res_units_plain(y, (p["res_unit1"], p["res_unit2"], p["res_unit3"]))


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _lib():
    return cuda_lib.load("oobleck", _SIGNATURES)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_act(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: expects a contiguous bf16 (B, L, C) tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[-1] % 128:
        raise ValueError(f"{what}: channel count {x.shape[-1]} is not a multiple of 128")


def _snake_cuda(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    ae, ib = (t.contiguous() for t in snake_consts(p))
    y = torch.empty_like(x)
    rc = _lib().acestep_snake(
        x.data_ptr(), ae.data_ptr(), ib.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1], _stream(x)
    )
    cuda_lib.check(rc, "oobleck snake")
    return y


def _conv_gemm(
    x: torch.Tensor,
    w: torch.Tensor,  # (KT, Ci, N)
    bias: Optional[torch.Tensor],
    snake2: Optional[Dict[str, torch.Tensor]],
    res: Optional[torch.Tensor],
    dilation: int,
    pad: int,
) -> torch.Tensor:
    b, l, ci = x.shape
    kt, _, n = w.shape
    w = w.to(torch.bfloat16).contiguous()
    bias = torch.zeros(n, device=x.device) if bias is None else bias.float().contiguous()
    ae2 = ib2 = None
    if snake2 is not None:
        ae2, ib2 = (t.contiguous() for t in snake_consts(snake2))
    y = torch.empty((b, l, n), dtype=torch.bfloat16, device=x.device)
    rc = _lib().acestep_conv_gemm(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if ae2 is None else ae2.data_ptr(),
        None if ib2 is None else ib2.data_ptr(),
        None if res is None else res.data_ptr(),
        y.data_ptr(), b, l, ci, n, kt, dilation, pad, _stream(x),
    )
    cuda_lib.check(rc, "oobleck conv_gemm")
    return y


def _res_unit_cuda(h: torch.Tensor, p: Dict[str, Any], dilation: int) -> torch.Tensor:
    a = _snake_cuda(h, p["snake1"])
    z = _conv_gemm(a, p["conv1"]["kernel"], p["conv1"]["bias"], p["snake2"], None, dilation, 3 * dilation)
    return _conv_gemm(z, p["conv2"]["kernel"], p["conv2"]["bias"], None, h, 1, 0)


def phase_weights(kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """(2s, Ci, Co) transposed-conv kernel -> (3, Ci, s*Co) taps on x[t-1],
    x[t], x[t+1], with output phase r in columns [r*Co, (r+1)*Co)."""
    s, half = stride, stride // 2
    _, ci, co = kernel.shape
    w = torch.zeros((3, ci, s, co), dtype=kernel.dtype, device=kernel.device)
    w[0, :, :half] = kernel[3 * half :].permute(1, 0, 2)  # x[t-1] -> phases r < s/2
    w[1] = kernel[half : half + s].permute(1, 0, 2)  # x[t] -> every phase
    w[2, :, half:] = kernel[:half].permute(1, 0, 2)  # x[t+1] -> phases r >= s/2
    return w.reshape(3, ci, s * co)


def res_units_kernel(x: torch.Tensor, unit_params: Sequence[Dict[str, Any]]) -> torch.Tensor:
    """3-residual-unit chain (dilations 1/3/9) on (B, L, C) NLC activations."""
    if x.device.type == "cpu":
        return res_units_plain(x, unit_params)
    _check_act(x, "res_units_kernel")
    for p, d in zip(unit_params, DILATIONS):
        x = _res_unit_cuda(x, p, d)
    res_units_kernel.launches += 1
    return x


res_units_kernel.launches = 0


def decoder_block_kernel(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    """One decoder block (B, L, Ci) -> (B, L*stride, Co); stride even."""
    if stride % 2:
        raise ValueError("Oobleck decoder strides are even")
    if x.device.type == "cpu":
        return decoder_block_plain(x, p, stride)
    _check_act(x, "decoder_block_kernel")
    b, l, _ = x.shape
    ct = p["conv_t1"]
    co = ct["kernel"].shape[2]
    if co % 128:
        raise ValueError(f"decoder_block_kernel: output channels {co} are not a multiple of 128")
    a = _snake_cuda(x, p["snake1"])
    bias = ct.get("bias")
    bias_tiled = None if bias is None else bias.float().repeat(stride)
    y = _conv_gemm(a, phase_weights(ct["kernel"], stride), bias_tiled, None, None, 1, 1)
    y = y.view(b, l * stride, co)
    for name, d in zip(("res_unit1", "res_unit2", "res_unit3"), DILATIONS):
        y = _res_unit_cuda(y, p[name], d)
    decoder_block_kernel.launches += 1
    return y


decoder_block_kernel.launches = 0
