"""Stage-cost probe of the attention kernel: CUDA wrapper and plain version.

Port of the Pallas kernel of `tools/probe_kernel_parts.py` (`make_kernel`,
launched by `run_mode`). Over all keys (no mask), S = Q K^T / sqrt(128) in
fp32, then P by mode (`MODES`): ``dots`` S * 1e-3, ``+max`` S - rowmax,
``+exp`` exp(S - rowmax), ``+expf`` the same with `exp_poly`, ``full``
softmax, ``fullf`` softmax with `exp_poly`; O = bf16(P) V. Tensors are
head-major, q (B, Nq, L, 128), k/v (B, Nkv, L, 128); with
``k_transposed`` k is (B, Nkv, 128, L).

`attention_probe` launches `csrc/attention_probe.cu` for a CUDA tensor (bf16,
L a multiple of ``block_q``) and raises on anything it does not take; a CPU
tensor takes `attention_probe_plain`, which follows the TPU kernel's rounding
(bf16(P) before P V). `.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from acestep_tpu_torch.ops import cuda_lib

HEAD_DIM = 128
SCALE = 0.08838834764831845  # 128 ** -0.5, as the TPU probe writes it
MODES = ("dots", "+max", "+exp", "+expf", "full", "fullf")
BLOCK_Q = (64, 128)
_EXP2_COEF = (9.99999769e-01, 6.93156779e-01, 2.40131684e-01,
              5.58765685e-02, 8.94057778e-03, 1.89437864e-03)
_P = ctypes.c_void_p
_SIGNATURES = {
    "acestep_attention_probe": ([_P] * 4 + [ctypes.c_int] * 7 + [_P], ctypes.c_int),
}


def exp_poly(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for x <= 0 by exponent-bit assembly and a degree-5 exp2
    polynomial (`_exp_softmax_fast` of the TPU probe), fp32."""
    y = torch.clamp(x, min=-87.0) * 1.4426950408889634
    yi = torch.floor(y)
    yf = y - yi
    p = torch.full_like(yf, _EXP2_COEF[-1])
    for c in _EXP2_COEF[-2::-1]:
        p = p * yf + c
    two_yi = ((yi.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * two_yi


def attention_probe_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str, *, k_transposed: bool = False
) -> torch.Tensor:
    if mode not in MODES:
        raise ValueError(f"attention_probe: unknown mode {mode!r}")
    kk = k.transpose(-1, -2) if k_transposed else k
    groups = q.shape[1] // kk.shape[1]
    kk = kk.repeat_interleave(groups, dim=1)
    vv = v.repeat_interleave(groups, dim=1)
    s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * SCALE
    if mode == "dots":
        p = s * 1e-3
    else:
        m = s.amax(dim=-1, keepdim=True)
        if mode == "+max":
            p = s - m
        elif mode in ("+exp", "full"):
            p = torch.exp(s - m)
        else:
            p = exp_poly(s - m)
        if mode in ("full", "fullf"):
            p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p.to(v.dtype).float(), vv.float()).to(q.dtype)


def attention_probe(
    q: torch.Tensor,  # (B, Nq, L, 128)
    k: torch.Tensor,  # (B, Nkv, L, 128), or (B, Nkv, 128, L) with k_transposed
    v: torch.Tensor,  # (B, Nkv, L, 128)
    mode: str,
    *,
    k_transposed: bool = False,
    block_q: int = 64,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_probe_plain(q, k, v, mode, k_transposed=k_transposed)
    if mode not in MODES:
        raise ValueError(f"attention_probe: unknown mode {mode!r}")
    b, nq, l, h = q.shape
    nkv = v.shape[1]
    k_shape = (b, nkv, h, l) if k_transposed else (b, nkv, l, h)
    if h != HEAD_DIM or tuple(v.shape) != (b, nkv, l, h) or tuple(k.shape) != k_shape or nq % nkv:
        raise ValueError(
            f"attention_probe: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
        )
    if block_q not in BLOCK_Q or l % block_q:
        raise ValueError(f"attention_probe: block_q must be one of {BLOCK_Q} and divide L={l}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"attention_probe: the kernel takes bf16, got {q.dtype}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)
    lib = cuda_lib.load("attention_probe", _SIGNATURES)
    rc = lib.acestep_attention_probe(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, nq, nkv,
        MODES.index(mode), int(bool(k_transposed)), int(block_q),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(rc, "attention_probe")
    attention_probe.launches += 1
    return out


attention_probe.launches = 0
