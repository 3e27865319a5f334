"""Oobleck decoder kernels (CUDA) and their plain PyTorch versions.

Port of `acestep_tpu/ops/pallas_vae.py`:

- `decoder_block_kernel` replaces `decoder_block_pallas`: one Oobleck decoder
  block, Snake -> ConvTranspose1d (K = 2s, pad s/2) -> 3 residual units, at
  C_out in {128, 256, 512}. After a Snake launch on its input (`csrc/oobleck.cu`)
  it runs the implicit-GEMM convolutions of `csrc/oobleck_sm90.cu` (TMA +
  wgmma): the upsampling conv with the first unit's Snake in its epilogue,
  then one fused launch per residual unit at C <= 256 (z stays in registers)
  or two at C = 512 (z through HBM).
- `res_units_kernel` replaces `res_units_pallas`: the 3-residual-unit chain
  alone (decoder block 0, 1024 channels), as a short fixed sequence of
  `csrc/oobleck.cu` launches (Snake, then conv-as-GEMM with fused
  bias/Snake/residual epilogues).

The source notes give each design and what bounds it on an H100. Each wrapper
counts its calls that launch the kernels in `.launches`. A CPU tensor takes
the plain version beside it, which rounds to the input dtype at the same
points as the kernels; a CUDA tensor launches the kernels or raises.

Rows outside [0, L) read as zeros (torch zero padding), so the halo gates of
the TPU kernels (`TOTAL_HALO`, `_upsample_halo`) only keep the dispatch in
`models/vae.decoder_block` identical to the JAX package's.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
_SM90_SIGNATURES = {
    "acestep_oob_upsample": ([_P] * 7 + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
    "acestep_oob_unit": ([_P] * 12 + [ctypes.c_int] * 4 + [_P], ctypes.c_int),
    "acestep_oob_k7": ([_P] * 6 + [ctypes.c_int] * 4 + [_P], ctypes.c_int),
    "acestep_oob_k1": ([_P] * 8 + [ctypes.c_int] * 3 + [_P], ctypes.c_int),
}
SM90_CHANNELS = (128, 256, 512)  # output channels the decoder-block kernels take


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
    return _snake_launch(x, *(t.contiguous() for t in snake_consts(p)))


def _snake_launch(x: torch.Tensor, ae: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
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


def pack_conv_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(K, C_in, N) conv kernel -> (K, N, C_in) bf16: each tap K-major, the
    B-operand layout of `csrc/oobleck_sm90.cu` (the wrappers keep one per
    weight tensor)."""
    return kernel.permute(0, 2, 1).to(torch.bfloat16).contiguous()


def _sm90():
    return cuda_lib.load("oobleck_sm90", _SM90_SIGNATURES)


# Kernel operands derived from weights (packed kernels, fp32 biases, Snake
# constants), kept per weight tensor so that a decode does not rebuild them
# on every call: an entry holds while its tensors live unchanged (same
# objects, same version counters) and is dropped when one is freed.
_DERIVED: Dict[tuple, Tuple[tuple, Any]] = {}


def _version(t: torch.Tensor) -> Optional[int]:
    try:
        return t._version
    except RuntimeError:  # inference tensors keep no version counter (nor change in place)
        return None


def _derived(tag: str, tensors: Tuple[torch.Tensor, ...], make: Callable[[], Any]) -> Any:
    key = (tag,) + tuple(id(t) for t in tensors)
    stamp = tuple(_version(t) for t in tensors)
    hit = _DERIVED.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)) and hit[1] == stamp:
        return hit[2]
    value = make()
    drop = lambda _ref, key=key: _DERIVED.pop(key, None)
    _DERIVED[key] = (tuple(weakref.ref(t, drop) for t in tensors), stamp, value)
    return value


def _f32(t: Optional[torch.Tensor], n: int, device: torch.device, repeat: int = 1) -> torch.Tensor:
    if t is None:
        return torch.zeros(n, device=device)
    return _derived(f"f32x{repeat}", (t,), lambda: t.float().repeat(repeat).contiguous())


def _packed(kernel: torch.Tensor, stride: Optional[int] = None) -> torch.Tensor:
    """pack_conv_weights of the kernel, or of its phase weights when `stride` is given."""
    if stride is None:
        return _derived("packed", (kernel,), lambda: pack_conv_weights(kernel))
    return _derived(f"phase{stride}", (kernel,), lambda: pack_conv_weights(phase_weights(kernel, stride)))


def _snake_consts(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    return _derived("snake", (p["alpha"], p["beta"]), lambda: snake_consts(p))


def _check_sm90(what: str, c: int, *ts: torch.Tensor) -> None:
    """What the TMA kernels take: CUDA bf16 (B, L, C) contiguous, 16-byte
    aligned bases (TMA reads nothing else), C in SM90_CHANNELS."""
    if c not in SM90_CHANNELS:
        raise ValueError(f"{what}: {c} channels; the kernels take {SM90_CHANNELS}")
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: expects contiguous bf16 (B, L, C) CUDA tensors, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: base address not 16-byte aligned; TMA cannot read it")


def upsample_sm90(
    a0: torch.Tensor, ct: Dict[str, torch.Tensor], stride: int, snake_next: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvTranspose1d (K = 2s, pad s/2) of a0 = bf16(Snake(x)), (B, L, C_in)
    -> y (B, L s, C_out) = bf16(conv_t + bias) and a1 = bf16(snake_next(y)),
    in one launch (CUDA tensors only)."""
    b, l, ci = a0.shape
    co = ct["kernel"].shape[2]
    _check_sm90("upsample_sm90", co, a0)
    n = stride * co
    w = _packed(ct["kernel"], stride)
    bias = _f32(ct.get("bias"), n, a0.device, repeat=stride)
    ae, ib = _snake_consts(snake_next)
    y = torch.empty((b, l, n), dtype=torch.bfloat16, device=a0.device)
    a1 = torch.empty_like(y)
    rc = _sm90().acestep_oob_upsample(
        a0.data_ptr(), w.data_ptr(), bias.data_ptr(), ae.data_ptr(), ib.data_ptr(),
        y.data_ptr(), a1.data_ptr(), b, l, ci, n, co, _stream(a0),
    )
    cuda_lib.check(rc, "oobleck_sm90 upsample")
    return y.view(b, l * stride, co), a1.view(b, l * stride, co)


def res_unit_sm90(
    h: torch.Tensor,
    a: torch.Tensor,
    p: Dict[str, Any],
    dilation: int,
    snake_next: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One residual unit from h and a = bf16(Snake1(h)) (CUDA tensors only):
    h' = bf16(h + conv_k1(z) + b2) with z = bf16(Snake2(conv_k7,d(a) + b1)),
    and a_next = bf16(snake_next(h')) when `snake_next` is given. One launch
    at C <= 256 (z in registers), two at C = 512 (z through HBM)."""
    b, l, c = h.shape
    _check_sm90("res_unit_sm90", c, h, a)
    if a.shape != h.shape:
        raise ValueError(f"res_unit_sm90: a {tuple(a.shape)} and h {tuple(h.shape)} differ")
    w1, w2 = _packed(p["conv1"]["kernel"]), _packed(p["conv2"]["kernel"])
    b1 = _f32(p["conv1"].get("bias"), c, h.device)
    b2 = _f32(p["conv2"].get("bias"), c, h.device)
    ae1, ib1 = _snake_consts(p["snake2"])
    out = torch.empty_like(h)
    a_next = aen = ibn = None
    if snake_next is not None:
        a_next = torch.empty_like(h)
        aen, ibn = _snake_consts(snake_next)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib, stream = _sm90(), _stream(h)
    if c <= 256:
        rc = lib.acestep_oob_unit(
            a.data_ptr(), h.data_ptr(), w1.data_ptr(), b1.data_ptr(), ae1.data_ptr(), ib1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), ptr(aen), ptr(ibn), out.data_ptr(), ptr(a_next),
            b, l, c, dilation, stream,
        )
        cuda_lib.check(rc, "oobleck_sm90 unit")
    else:
        z = torch.empty_like(h)
        rc = lib.acestep_oob_k7(
            a.data_ptr(), w1.data_ptr(), b1.data_ptr(), ae1.data_ptr(), ib1.data_ptr(), z.data_ptr(),
            b, l, c, dilation, stream,
        )
        cuda_lib.check(rc, "oobleck_sm90 k7")
        rc = lib.acestep_oob_k1(
            z.data_ptr(), h.data_ptr(), w2.data_ptr(), b2.data_ptr(), ptr(aen), ptr(ibn),
            out.data_ptr(), ptr(a_next), b, l, c, stream,
        )
        cuda_lib.check(rc, "oobleck_sm90 k1")
    return out, a_next


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
    """One decoder block (B, L, Ci) -> (B, L*stride, Co); stride even, Co in
    SM90_CHANNELS on the card."""
    if stride % 2:
        raise ValueError("Oobleck decoder strides are even")
    if x.device.type == "cpu":
        return decoder_block_plain(x, p, stride)
    _check_act(x, "decoder_block_kernel")
    units = (p["res_unit1"], p["res_unit2"], p["res_unit3"])
    _check_sm90("decoder_block_kernel", p["conv_t1"]["kernel"].shape[2], x)
    a = _snake_launch(x, *_snake_consts(p["snake1"]))
    y, a = upsample_sm90(a, p["conv_t1"], stride, units[0]["snake1"])
    for k, (u, d) in enumerate(zip(units, DILATIONS)):
        y, a = res_unit_sm90(y, a, u, d, units[k + 1]["snake1"] if k + 1 < len(units) else None)
    decoder_block_kernel.launches += 1
    return y


decoder_block_kernel.launches = 0
