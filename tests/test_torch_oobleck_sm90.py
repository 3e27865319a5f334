"""The decoder-block kernel's weight packing and launch sequence on the CPU.

`csrc/oobleck_sm90.cu` computes acc[t, n] = sum_j sum_ci a[t + j d - pad, ci]
W[j, n, ci] from weights that `ops/oobleck_kernels.pack_conv_weights` packs
K-major as (tap, n, ci), and the upsampling conv from `phase_weights`' phase
columns packed the same way. The CUDA kernel cannot run here, so these tests
hold its arithmetic as a plain emulation: the packed layouts against the
unpacked convolutions (fp32), and the launch sequence with the kernel's bf16
rounding points against `res_units_plain` / `decoder_block_plain` (bf16).
"""

import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acestep_tpu_torch.ops import oobleck_kernels
from acestep_tpu_torch.ops.conv import conv_transpose1d
from acestep_tpu_torch.ops.oobleck_kernels import (
    DILATIONS,
    _conv_f32,
    decoder_block_plain,
    pack_conv_weights,
    phase_weights,
    res_unit_plain,
    res_units_plain,
    snake_f32,
)


def _t(rng, shape, scale=1.0, dtype=torch.float32):
    """Random values that bf16 holds exactly, so packing loses nothing."""
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale)
    return x.to(torch.bfloat16).to(dtype)


def conv_packed(a: torch.Tensor, wp: torch.Tensor, dil: int, pad: int) -> torch.Tensor:
    """The kernel's implicit GEMM on (tap, n, ci) weights, rows outside [0, L) zero."""
    kt, l = wp.shape[0], a.shape[1]
    ap = F.pad(a.float(), (0, 0, pad, (kt - 1) * dil - pad))
    return sum(ap[:, j * dil : j * dil + l] @ wp[j].float().t() for j in range(kt))


def _unit(rng, c, dtype):
    snake = lambda: {"alpha": _t(rng, (c,), 0.3), "beta": _t(rng, (c,), 0.3)}
    return {
        "snake1": snake(),
        "conv1": {"kernel": _t(rng, (7, c, c), c**-0.5, dtype), "bias": _t(rng, (c,), 0.3)},
        "snake2": snake(),
        "conv2": {"kernel": _t(rng, (1, c, c), c**-0.5, dtype), "bias": _t(rng, (c,), 0.3)},
    }


def _block(rng, ci, co, stride, dtype):
    return {
        "snake1": {"alpha": _t(rng, (ci,), 0.3), "beta": _t(rng, (ci,), 0.3)},
        "conv_t1": {"kernel": _t(rng, (2 * stride, ci, co), ci**-0.5, dtype), "bias": _t(rng, (co,), 0.3)},
        **{f"res_unit{i}": _unit(rng, co, dtype) for i in (1, 2, 3)},
    }


# The launches of `decoder_block_kernel`, emulated with the kernel's rounding points.


def unit_launch(h, a, p, d, snake_next):
    """One residual-unit launch: (h', a_next) from h and a = bf16(Snake1(h))."""
    dt = h.dtype
    z = snake_f32(conv_packed(a, pack_conv_weights(p["conv1"]["kernel"]), d, 3 * d) + p["conv1"]["bias"], p["snake2"])
    z = z.to(dt)
    out = (conv_packed(z, pack_conv_weights(p["conv2"]["kernel"]), 1, 0) + p["conv2"]["bias"] + h.float()).to(dt)
    a_next = None if snake_next is None else snake_f32(out.float(), snake_next).to(dt)
    return out, a_next


def block_launches(x, p, stride):
    dt = x.dtype
    b, l, _ = x.shape
    co = p["conv_t1"]["kernel"].shape[2]
    units = (p["res_unit1"], p["res_unit2"], p["res_unit3"])
    a0 = snake_f32(x.float(), p["snake1"]).to(dt)
    y = conv_packed(a0, pack_conv_weights(phase_weights(p["conv_t1"]["kernel"], stride)), 1, 1)
    y = (y + p["conv_t1"]["bias"].repeat(stride)).to(dt).view(b, l * stride, co)
    a = snake_f32(y.float(), units[0]["snake1"]).to(dt)
    for k, (u, d) in enumerate(zip(units, DILATIONS)):
        y, a = unit_launch(y, a, u, d, units[k + 1]["snake1"] if k < 2 else None)
    return y


@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("taps", [7, 1])
def test_packed_conv_weights_match_the_conv(taps, d):
    rng = np.random.default_rng(taps * 10 + d)
    a, k = _t(rng, (2, 45, 64)), _t(rng, (taps, 64, 96))
    wp = pack_conv_weights(k)
    assert wp.shape == (taps, 96, 64) and wp.dtype == torch.bfloat16
    torch.testing.assert_close(conv_packed(a, wp, d, (taps - 1) * d // 2), _conv_f32(a, k, d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [2, 4, 6, 10])
def test_packed_phase_weights_match_conv_transpose(stride):
    rng = np.random.default_rng(stride)
    ci, co, l = 64, 32, 19
    a, k, bias = _t(rng, (2, l, ci)), _t(rng, (2 * stride, ci, co)), _t(rng, (co,))
    wp = pack_conv_weights(phase_weights(k, stride))
    assert wp.shape == (3, stride * co, ci)
    got = (conv_packed(a, wp, 1, 1) + bias.repeat(stride)).view(2, l * stride, co)
    want = conv_transpose1d(a, k, bias, stride=stride, padding=stride // 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# bf16 on both sides: the same rounding points, fp32 sums in another order, so
# a rounding step can flip and carry through the following units.
def _bf16_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("c", [128, 256])
def test_unit_launches_match_res_units_plain(c):
    rng = np.random.default_rng(c)
    units = [_unit(rng, c, torch.bfloat16) for _ in range(3)]
    h = _t(rng, (2, 150, c), dtype=torch.bfloat16)
    a = snake_f32(h.float(), units[0]["snake1"]).to(torch.bfloat16)
    y = h
    for k, (u, d) in enumerate(zip(units, DILATIONS)):
        nxt = units[k + 1]["snake1"] if k < 2 else None
        want = res_unit_plain(y, u, d)
        y, a = unit_launch(y, a, u, d, nxt)
        _bf16_close(y, want)
    _bf16_close(y, res_units_plain(h, units))


@pytest.mark.parametrize("c,stride", [(128, 2), (256, 4)])
def test_block_launches_match_decoder_block_plain(c, stride):
    rng = np.random.default_rng(c + stride)
    p = _block(rng, 2 * c, c, stride, torch.bfloat16)
    x = _t(rng, (2, 40, 2 * c), dtype=torch.bfloat16)
    got = block_launches(x, p, stride)
    want = decoder_block_plain(x, p, stride)
    assert got.shape == want.shape == (2, 40 * stride, c)
    _bf16_close(got, want)


def test_packed_operands_are_kept_per_weight_tensor():
    """The wrapper's packed weights are built once per weight tensor, rebuilt
    after an in-place edit, and dropped with the tensor."""
    k = torch.randn(7, 64, 32)
    first = oobleck_kernels._packed(k)
    assert oobleck_kernels._packed(k) is first
    torch.testing.assert_close(first, pack_conv_weights(k), rtol=0, atol=0)
    phase = oobleck_kernels._packed(k[:4].clone(), 2)
    assert phase.shape == (3, 64, 64)
    k.mul_(2.0)
    again = oobleck_kernels._packed(k)
    assert again is not first
    torch.testing.assert_close(again, pack_conv_weights(k), rtol=0, atol=0)
    key = ("packed", id(k))
    assert key in oobleck_kernels._DERIVED
    del k, first, again, phase
    gc.collect()
    assert key not in oobleck_kernels._DERIVED
