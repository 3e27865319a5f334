"""The Oobleck kernels' weight packing, schedules and launch sequences on the CPU.

`csrc/oobleck_sm90.cu` computes acc[t, n] = sum_j sum_ci a[t + j d - pad, ci]
W[j, n, ci] from weights that `ops/oobleck_kernels.pack_conv_weights` packs
K-major as (tap, n, ci), and the upsampling conv from `phase_weights`' phase
columns packed the same way. The CUDA kernels cannot run here, so these tests
hold their arithmetic as a plain emulation: the packed layouts against the
unpacked convolutions (fp32); the residual chain's stream-K schedule
(`streamk_schedule`, walked as the kernel walks it) for coverage and for its
fixed-order sum of partials; and the launch sequences with the kernels' bf16
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
    STEP_CHANNELS,
    TILE_COLS,
    TILE_ROWS,
    _conv_f32,
    conv_tiles,
    decoder_block_plain,
    pack_conv_weights,
    phase_weights,
    res_unit_plain,
    res_units_plain,
    snake_f32,
    streamk_schedule,
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


# 384: `res_units_kernel`'s k7 + k1 on whole 128-channel tiles, with the fused
# unit's rounding points.
@pytest.mark.parametrize("c", [128, 256, 384])
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


# The residual chain (kernel 3): k7 launches on the stream-K schedule.

H100_SMS = 132


def streamk_segments(sched, steps, cta):
    """CTA `cta`'s work in order, as `sk_segments` in csrc/oobleck_sm90.cu
    walks it: (tile, k0, k1), K steps k0 .. k1 - 1 of the tile; its whole
    tiles, then its run of split steps from the top down, cut at tile edges.
    A segment with k0 > 0 first adds the running sum that CTA `cta` - 1
    left for the tile's steps 0 .. k0 - 1; one with k1 < steps then leaves
    its running sum in the CTA's workspace slot, one with k1 == steps runs
    the epilogue."""
    grid, dp_tiles, sk_ctas, q, r = sched
    segs = [(t, 0, steps) for t in range(cta, dp_tiles, grid)]
    if cta < sk_ctas:
        begin = cta * q + min(cta, r)
        end = begin + q + (cta < r)
        while end > begin:
            t, base = (end - 1) // steps, (end - 1) // steps * steps
            k0 = max(begin - base, 0)
            segs.append((dp_tiles + t, k0, end - base))
            end = base + k0
    return segs


@pytest.mark.parametrize(
    "b,l,c,sms",
    [
        (1, 2240, 1024, H100_SMS),  # 224-frame chunk: 72 tiles, all split
        (1, 5440, 1024, H100_SMS),  # 544-frame chunk: 172 = one whole round + 40 split
        (2, 5440, 1024, H100_SMS),  # two whole rounds + 80 split
        (1, 4224, 1024, H100_SMS),  # 132 tiles: whole rounds only
        (2, 77, 1024, H100_SMS),  # ragged, below a tile: 8 tiles over 112 CTAs
        (1, 40, 256, H100_SMS),  # one tile, fewer steps than CTAs x STREAMK_MIN_STEPS
        (2, 300, 256, 4),  # ragged, a small card: whole rounds and a split round
    ],
)
def test_streamk_schedule_covers_every_step_once(b, l, c, sms):
    tiles, steps = conv_tiles(b, l, c), 7 * c // STEP_CHANNELS
    sched = streamk_schedule(tiles, steps, sms)
    grid, dp_tiles, sk_ctas, q, r = sched
    assert 1 <= grid <= sms and sk_ctas <= grid and dp_tiles % grid == 0
    assert sk_ctas * q + r == (tiles - dp_tiles) * steps
    seen, last, partial_of = {}, {}, {}
    for cta in range(grid):
        segs = streamk_segments(sched, steps, cta)
        n_whole = len(range(cta, dp_tiles, grid))
        for i, (t, k0, k1) in enumerate(segs):
            assert 0 <= t < tiles and 0 <= k0 < k1 <= steps
            for k in range(k0, k1):
                assert (t, k) not in seen
                seen[t, k] = cta
            if k1 == steps:  # one segment ends each tile and runs its epilogue
                assert t not in last
                last[t] = cta
            else:  # only the first split segment ends inside a tile: one slot per CTA
                assert i == n_whole and cta not in partial_of
                partial_of[cta] = (t, k1)
            if k0 > 0:  # only the last segment starts inside a tile
                assert i == len(segs) - 1
    assert len(seen) == tiles * steps and sorted(last) == list(range(tiles))
    for cta, segs in ((c, streamk_segments(sched, steps, c)) for c in range(grid)):
        for t, k0, k1 in segs:
            if k0 > 0:  # CTA - 1 holds the steps just below, its running sum ready in its slot
                assert partial_of[cta - 1] == (t, k0) and seen[t, k0 - 1] == cta - 1


def streamk_conv(a, wp, dil, pad, sms):
    """conv_packed as the stream-K k7 launch sums it: each segment sums its
    steps in the mainloop's order, then, if it starts inside the tile, adds
    the running sum that the CTA below left in its slot."""
    bsz, l, ci = a.shape
    kt, n = wp.shape[:2]
    n_ci, n_rt, n_nt = ci // STEP_CHANNELS, -(-l // TILE_ROWS), n // TILE_COLS
    tiles, steps = conv_tiles(bsz, l, n), kt * ci // STEP_CHANNELS
    ap = F.pad(a.float(), (0, 0, pad, (kt - 1) * dil - pad + TILE_ROWS))

    def tile_at(t):  # row tiles fastest, then output-channel tiles, then batch
        return (t % n_rt) * TILE_ROWS, (t // n_rt % n_nt) * TILE_COLS, t // n_rt // n_nt

    def steps_sum(t, k0, k1):
        t0, n0, bb = tile_at(t)
        acc = torch.zeros(TILE_ROWS, TILE_COLS)
        for k in range(k0, k1):
            j, c = divmod(k, n_ci)
            rows = ap[bb, t0 + j * dil : t0 + j * dil + TILE_ROWS, c * STEP_CHANNELS : (c + 1) * STEP_CHANNELS]
            acc += rows @ wp[j, n0 : n0 + TILE_COLS, c * STEP_CHANNELS : (c + 1) * STEP_CHANNELS].float().t()
        return acc

    sched = streamk_schedule(tiles, steps, sms)
    slot, done = {}, {}
    for cta in range(sched[0]):  # in CTA order: a CTA reads only the slot of the one below
        for t, k0, k1 in streamk_segments(sched, steps, cta):
            acc = steps_sum(t, k0, k1)
            if k0 > 0:
                acc = acc + slot[cta - 1]
            if k1 < steps:
                slot[cta] = acc
            else:
                done[t] = acc
    out = torch.zeros(bsz, n_rt * TILE_ROWS, n)
    for t, acc in done.items():
        t0, n0, bb = tile_at(t)
        out[bb, t0 : t0 + TILE_ROWS, n0 : n0 + TILE_COLS] = acc
    return out[:, :l]


@pytest.mark.parametrize("d", DILATIONS)
def test_streamk_partials_sum_to_the_conv(d):
    rng = np.random.default_rng(100 + d)
    a, k = _t(rng, (2, 300, 256)), _t(rng, (7, 256, 256), 256**-0.5)
    wp = pack_conv_weights(k)
    sched = streamk_schedule(conv_tiles(2, 300, 256), 28, 4)
    assert sched[2] > 0 and sched[1] > 0  # whole rounds and split tiles both
    got = streamk_conv(a, wp, d, 3 * d, sms=4)
    torch.testing.assert_close(got, conv_packed(a, wp, d, 3 * d), rtol=1e-5, atol=1e-5)


def chain_launches(h, units, sms):
    """`res_units_kernel`'s 7 launches with their rounding points: Snake1 of
    unit 1, then per unit the stream-K k7 (z = bf16(Snake2(. + b1))) and the
    k1 (h' = bf16(h + . + b2), a_next = bf16(Snake1_next(h')))."""
    dt = h.dtype
    a = snake_f32(h.float(), units[0]["snake1"]).to(dt)
    for k, (p, d) in enumerate(zip(units, DILATIONS)):
        z = streamk_conv(a, pack_conv_weights(p["conv1"]["kernel"]), d, 3 * d, sms) + p["conv1"]["bias"]
        z = snake_f32(z, p["snake2"]).to(dt)
        h = (conv_packed(z, pack_conv_weights(p["conv2"]["kernel"]), 1, 0) + p["conv2"]["bias"] + h.float()).to(dt)
        if k < 2:
            a = snake_f32(h.float(), units[k + 1]["snake1"]).to(dt)
    return h


def test_chain_launches_match_res_units_plain():
    rng = np.random.default_rng(7)
    units = [_unit(rng, 256, torch.bfloat16) for _ in range(3)]
    h = _t(rng, (2, 150, 256), dtype=torch.bfloat16)
    _bf16_close(chain_launches(h, units, sms=3), res_units_plain(h, units))

