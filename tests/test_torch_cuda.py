"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, not at import). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q

The plain versions run in fp32 (TF32 off) on the same bf16 inputs; the
tolerances cover the kernels' bf16 rounding of P (attention) and of the
intermediate activations (Oobleck), which the fp32 plain run does not do.
"""

import pytest
import torch

from acestep_tpu_torch.config import OobleckConfig
from acestep_tpu_torch.models import vae
from acestep_tpu_torch.ops import oobleck_kernels
from acestep_tpu_torch.ops.attention_probe import MODES, attention_probe, attention_probe_plain
from acestep_tpu_torch.ops.basic import matmul_f32
from acestep_tpu_torch.ops.conv import conv_transpose1d
from acestep_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from acestep_tpu_torch.ops.oobleck_kernels import (
    DILATIONS,
    decoder_block_kernel,
    decoder_block_plain,
    res_unit_plain,
    res_unit_sm90,
    res_units_kernel,
    res_units_plain,
    snake_f32,
    upsample_sm90,
)
from acestep_tpu_torch.params import init_oobleck_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def _scattered_mask(b, lk, dev):
    """Holes that are not a prefix: some 128-key tiles all valid (interior),
    others with a gap or every 7th key missing (edge)."""
    mask = torch.ones((b, lk), dtype=torch.int32, device=dev)
    mask[:, 300:340] = 0
    mask[:, 600:700:7] = 0
    mask[-1, lk - 50:] = 0
    return mask


@pytest.mark.parametrize(
    "b,lq,lk,nq,nkv,kw",
    [
        (2, 384, 384, 4, 2, {}),
        (2, 384, 384, 4, 2, dict(window=64)),
        (2, 384, 384, 4, 2, dict(causal=True)),
        (2, 384, 384, 4, 2, dict(causal=True, window=64)),
        (1, 200, 200, 4, 2, dict(pad=150)),
        (2, 256, 130, 4, 2, dict(pad=100)),
        (1, 130, 130, 4, 2, {}),  # one row and one key past a 128 tile
        (2, 130, 769, 4, 2, dict(pad=700)),
        (1, 1000, 1000, 4, 2, dict(window=127)),  # band edges inside and on tile edges
        (1, 1000, 1000, 4, 2, dict(window=128)),
        (1, 1000, 1000, 4, 2, dict(window=129)),
        (2, 1000, 1000, 4, 2, dict(scatter=True)),  # interior and edge tiles in one call
        (2, 1000, 1000, 4, 2, dict(scatter=True, window=200)),
        (1, 7500, 7500, 16, 8, dict(window=128)),  # DiT sliding layer at 600 s
        (1, 7500, 769, 16, 8, dict(pad=700)),  # DiT cross-attention at 600 s
        (1, 3000, 3000, 16, 8, {}),  # DiT full layer at 240 s
    ],
)
def test_flash_kernel_matches_plain(dev, b, lq, lk, nq, nkv, kw):
    kw = dict(kw)
    pad = kw.pop("pad", None)
    scatter = kw.pop("scatter", False)
    q, k, v = _randn((b, lq, nq, 128), 1, dev), _randn((b, lk, nkv, 128), 2, dev), _randn((b, lk, nkv, 128), 3, dev)
    mask = None
    if pad is not None:
        mask = torch.ones((b, lk), dtype=torch.int32, device=dev)
        mask[:, pad:] = 0
    if scatter:
        mask = _scattered_mask(b, lk, dev)
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q.float(), k.float(), v.float(), mask, **kw)
    assert torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() < 1e-2


def _lm_prefill_case(dev, lq: int, nq: int, nkv: int) -> None:
    """Causal attention with a right-padded prompt mask against the plain version."""
    q, k, v = _randn((2, lq, nq, 128), 6, dev), _randn((2, lq, nkv, 128), 7, dev), _randn((2, lq, nkv, 128), 8, dev)
    mask = torch.ones((2, lq), dtype=torch.int32, device=dev)
    mask[0, lq - 300:] = 0
    mask[1, lq // 2:] = 0
    got = flash_attention(q, k, v, mask, causal=True)
    want = flash_attention_plain(q.float(), k.float(), v.float(), mask, causal=True)
    assert torch.isfinite(got).all()
    # Early causal rows average a few keys, so |out| reaches ~4, where the bf16
    # output alone rounds by up to 2^-9 * |out|: the bound has a relative term.
    excess = ((got.float() - want).abs() - 2.0**-7 * want.abs()).max().item()
    assert excess < 1e-2, excess


@pytest.mark.parametrize("lq", [700, 1024, 2048])
def test_flash_kernel_at_the_lm_prefill_shape(dev, lq):
    """4B planner prefill: causal plus a right-padded prompt mask, GQA 32/8
    (700: a length that is not a multiple of the 128-row tile)."""
    _lm_prefill_case(dev, lq, 32, 8)


@pytest.mark.parametrize("lq", [1024, 2048])
def test_flash_kernel_at_a_tp_rank_lm_prefill_shape(dev, lq):
    """The 4B planner's prefill on one rank of tp = 2: its local heads, 16
    query and 4 key-value, at the CoT and codes buckets."""
    _lm_prefill_case(dev, lq, 16, 4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "kt,bq,l",
    [(False, 64, 512), (True, 64, 512), (False, 128, 512), (True, 128, 512),
     (False, 64, 576), (True, 64, 576)],  # 576: the last 128-key tile is half masked
)
def test_attention_probe_kernel_matches_plain(dev, mode, kt, bq, l):
    q, k, v = _randn((1, 16, l, 128), 30, dev), _randn((1, 8, l, 128), 31, dev), _randn((1, 8, l, 128), 32, dev)
    if kt:
        k = k.transpose(2, 3).contiguous()
    before = attention_probe.launches
    got = attention_probe(q, k, v, mode, k_transposed=kt, block_q=bq)
    torch.cuda.synchronize()
    assert attention_probe.launches == before + 1
    want = attention_probe_plain(q, k, v, mode, k_transposed=kt).float()
    assert torch.isfinite(got).all()
    # P is rounded to bf16 at another point than the plain (TPU) version.
    assert (got.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_matmul_f32_keeps_the_fp32_product(dev):
    x, w = _randn((3, 5, 256), 40, dev), _randn((256, 1000), 41, dev)
    got = matmul_f32(x, w)
    assert got.dtype == torch.float32
    want = x.float() @ w.float()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("lk", [300, 769])
def test_flash_kernel_reads_strided_views(dev, lk):
    """K/V as views into a wider buffer (no copy): batch/row strides differ."""
    q = _randn((2, 300, 4, 128), 4, dev)
    kv = _randn((2, lk, 2, 2, 128), 5, dev)
    k, v = kv[:, :, 0], kv[:, :, 1]
    assert not k.is_contiguous()
    got = flash_attention(q, k, v, None, window=32)
    want = flash_attention_plain(q.float(), k.float(), v.float(), None, window=32)
    assert (got.float() - want).abs().max().item() < 1e-2


def test_flash_kernel_refuses_rows_tma_cannot_read(dev):
    """A row stride that is not a multiple of 16 bytes raises; nothing is copied."""
    q = _randn((1, 256, 2, 128), 4, dev)
    buf = _randn((1 * 256 * 260,), 5, dev)
    k = buf.as_strided((1, 256, 2, 128), (256 * 260, 260, 128, 1))
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    assert flash_attention.launches == before


def test_flash_kernel_refuses_fp16_and_routes_fp32(dev):
    """fp16 raises and launches nothing; fp32 takes the fp32 route, counted
    in `f32_launches` and not in `launches`; bf16 the reverse."""
    before = (flash_attention.launches, flash_attention.f32_launches)
    q = torch.zeros((1, 256, 2, 128), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError):  # mixed dtypes
        flash_attention(q.float(), q[:, :, :1].float(), q[:, :, :1].bfloat16())
    assert (flash_attention.launches, flash_attention.f32_launches) == before
    q = _randn((1, 256, 2, 128), 9, dev).float()
    k, v = q[:, :, :1].contiguous(), q[:, :, 1:].contiguous()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert (flash_attention.launches, flash_attention.f32_launches) == (before[0], before[1] + 1)
    flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert (flash_attention.launches, flash_attention.f32_launches) == (before[0] + 1, before[1] + 1)


def _randn32(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


# The fp32 route against the plain version in fp32 (TF32 off): the kernel's
# products are 3xTF32 (each operand split into two TF32 parts, about fp32's
# accuracy), summed in another order, and its online softmax rescales by
# exp(m_old - m_new) where the plain one takes one max. Outputs are averages
# of unit gaussians (|out| < 5); the error is a few units in the last place
# of the largest terms.
F32_TOL = 2e-5


@pytest.mark.parametrize(
    "b,lq,lk,nq,nkv,kw",
    [
        (1, 750, 750, 16, 8, dict(window=128)),  # DiT sliding layer, training at 60 s
        (1, 750, 750, 16, 8, {}),  # DiT full layer
        (1, 750, 512, 16, 8, dict(pad=400)),  # cross-attention onto 512 padded encoder rows
        (2, 750, 750, 16, 8, dict(pad=700, window=128)),  # padded latent mask, batch 2
        (1, 512, 512, 2, 1, dict(window=128)),  # the narrow config (2 / 1 heads)
        (1, 512, 300, 2, 1, dict(pad=250)),  # its cross-attention onto 300 keys
        (2, 384, 384, 4, 2, dict(causal=True)),
        (2, 384, 384, 4, 2, dict(causal=True, window=64)),
        (1, 130, 130, 4, 2, {}),  # one row and one key past a 64 tile
        (2, 1000, 1000, 4, 2, dict(scatter=True, window=200)),
        (1, 7500, 7500, 16, 8, dict(window=128)),  # 600 s sliding: band-only work
    ],
)
def test_flash_f32_matches_plain(dev, b, lq, lk, nq, nkv, kw):
    kw = dict(kw)
    pad = kw.pop("pad", None)
    scatter = kw.pop("scatter", False)
    q, k, v = (_randn32((b, l, n, 128), s, dev) for l, n, s in ((lq, nq, 11), (lk, nkv, 12), (lk, nkv, 13)))
    mask = None
    if pad is not None:
        mask = torch.ones((b, lk), dtype=torch.int32, device=dev)
        mask[:, pad:] = 0
    if scatter:
        mask = _scattered_mask(b, lk, dev)
    before = flash_attention.f32_launches
    got = flash_attention(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert flash_attention.f32_launches == before + 1
    want = flash_attention_plain(q, k, v, mask, **kw)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max().item() < F32_TOL


def _rows_with_a_key(mask, b, lq, lk, window, causal, dev):
    """(B, Lq) bool: the query rows that have at least one valid key."""
    from acestep_tpu_torch.ops.attention import make_attention_bias

    allowed = make_attention_bias(lq, lk, kv_mask=mask, window=window, causal=causal, device=dev)
    if allowed is None:
        return torch.ones((b, lq), dtype=torch.bool, device=dev)
    return allowed.any(dim=-1)[:, 0].expand(b, lq)


@pytest.mark.parametrize(
    "b,lq,lk,nq,nkv,kw",
    [
        (1, 1, 1, 4, 1, {}),  # one row and one key; 4 q heads a kv head
        (2, 33, 33, 1, 1, {}),  # one key past a 32-key tile; one q head a kv head
        (1, 65, 33, 4, 4, dict(window=0)),  # one row past a 64-row tile; a row sees its own key only
        (1, 64, 65, 4, 1, dict(causal=True, window=0)),
        (2, 128, 128, 4, 2, dict(hole=(32, 64))),  # a 32-key tile with every key masked
        (1, 97, 97, 4, 2, dict(causal=True, hole=(0, 8))),  # rows 0-7 have no valid key
        (2, 200, 161, 8, 2, dict(views=True, window=40)),  # batch and row strides that `_rows_ok` takes
    ],
)
def test_flash_f32_tile_edges(dev, b, lq, lk, nq, nkv, kw):
    """The fp32 route at the edges of its 64-row and 32-key tiles, against the
    plain version on the rows that have a valid key (a row without one
    averages the keys the kernel visits); every row finite."""
    kw = dict(kw)
    hole = kw.pop("hole", None)
    views = kw.pop("views", False)
    if views:  # q from every other batch row and past one head, k past 3 rows, v past nkv heads
        q = _randn32((2 * b, lq, nq + 1, 128), 31, dev)[::2, :, 1:]
        k = _randn32((b, lk + 3, nkv, 128), 32, dev)[:, 3:]
        v = _randn32((b, lk, 2 * nkv, 128), 33, dev)[:, :, nkv:]
        assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    else:
        q, k, v = (_randn32((b, l, n, 128), s, dev) for l, n, s in ((lq, nq, 31), (lk, nkv, 32), (lk, nkv, 33)))
    mask = None
    if hole is not None:
        mask = torch.ones((b, lk), dtype=torch.int32, device=dev)
        mask[:, hole[0]:hole[1]] = 0
    before = flash_attention.f32_launches
    got = flash_attention(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert flash_attention.f32_launches == before + 1
    want = flash_attention_plain(q, k, v, mask, **kw)
    rows = _rows_with_a_key(mask, b, lq, lk, kw.get("window"), kw.get("causal", False), dev)
    if hole == (0, 8):
        assert not rows.all()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want)[rows].abs().max().item() < F32_TOL


@pytest.mark.parametrize("kw", [dict(pad=750), dict(pad=750, window=128), dict(causal=True, window=64)])
def test_flash_f32_repeats_bit_for_bit(dev, kw):
    """Two launches on the same inputs give the same bits: no split over keys,
    every sum in a fixed order (a seeded training run repeats itself)."""
    kw = dict(kw)
    pad = kw.pop("pad", None)
    q, k, v = (_randn32((1, 768, n, 128), s, dev) for n, s in ((16, 41), (8, 42), (8, 43)))
    mask = None
    if pad is not None:
        mask = torch.ones((1, 768), dtype=torch.int32, device=dev)
        mask[:, pad:] = 0
    first = flash_attention(q, k, v, mask, **kw)
    second = flash_attention(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_f32_two_ctas_an_sm(dev):
    """The fp32 route's occupancy: its 105 KB of shared memory lets two CTAs
    share an SM, so a 1 x 768 layer's 192 CTAs are one wave."""
    from acestep_tpu_torch.ops.flash_attention import f32_ctas_per_sm

    assert f32_ctas_per_sm() == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kw", [dict(window=128), dict(pad=400), dict(causal=True)])
def test_flash_backward_matches_plain_autograd(dev, dtype, kw):
    """`FlashAttention`'s backward is the plain path's autograd, recomputed:
    with a loss linear in the output its gradients equal the plain path's bit
    for bit, whichever kernel ran the forward."""
    from acestep_tpu_torch.ops import attention as attn

    kw = dict(kw)
    pad = kw.pop("pad", None)
    mask = None
    if pad is not None:
        mask = torch.ones((1, 512), dtype=torch.int32, device=dev)
        mask[:, pad:] = 0
    base = [_randn32((1, 512, n, 128), s, dev).to(dtype) for n, s in ((16, 21), (8, 22), (8, 23))]
    w = _randn32((1, 512, 16, 128), 24, dev).to(dtype)

    def grads(flash: bool):
        attn.set_flash_enabled(flash)
        try:
            q, k, v = (x.clone().requires_grad_(True) for x in base)
            out = attn.attention(q, k, v, kv_mask=mask, **kw)
            (out.float() * w.float()).sum().backward()
            return out.detach(), [x.grad for x in (q, k, v)]
        finally:
            attn.set_flash_enabled(None)

    counter = "launches" if dtype == torch.bfloat16 else "f32_launches"
    before = getattr(flash_attention, counter)
    out_f, g_f = grads(True)
    assert getattr(flash_attention, counter) == before + 1  # the forward only: no launch in the backward
    out_p, g_p = grads(False)
    assert getattr(flash_attention, counter) == before + 1
    # bf16: both outputs round to bf16, where early causal rows reach |out| ~ 4
    # (a unit in the last place is 2^-6 there): the bound has a relative term.
    rel = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    excess = ((out_f.float() - out_p.float()).abs() - rel * out_p.float().abs()).max().item()
    assert excess < (1e-2 if dtype == torch.bfloat16 else F32_TOL)
    for a, b_ in zip(g_f, g_p):
        assert a.dtype == dtype and torch.equal(a, b_)


@pytest.fixture
def oobleck(dev):
    p = init_oobleck_params(OobleckConfig(), seed=3, device=dev)["decoder"]
    g = torch.Generator(device=dev).manual_seed(9)
    for blk in p["block"]:
        for part in [blk["snake1"]] + [blk[f"res_unit{i}"][s] for i in (1, 2, 3) for s in ("snake1", "snake2")]:
            for key in ("alpha", "beta"):
                part[key] = 0.3 * torch.randn(part[key].shape, generator=g, device=dev)
    return p


@pytest.mark.parametrize("block,l_in", [(1, 100), (2, 37), (3, 50), (4, 129)])
def test_decoder_block_kernel_matches_plain(dev, oobleck, block, l_in):
    stride = (10, 6, 4, 4, 2)[block]
    bp = oobleck["block"][block]
    ci = bp["conv_t1"]["kernel"].shape[1]
    x = _randn((2, l_in, ci), 10 + block, dev)
    before = decoder_block_kernel.launches
    got = decoder_block_kernel(x, bp, stride)
    torch.cuda.synchronize()
    assert decoder_block_kernel.launches == before + 1
    want = decoder_block_plain(x.float(), bp, stride)
    assert got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= 3e-2 * max(1.0, want.abs().max().item())


def test_res_units_kernel_matches_plain(dev, oobleck):
    bp = oobleck["block"][0]
    units = (bp["res_unit1"], bp["res_unit2"], bp["res_unit3"])
    x = _randn((2, 333, 1024), 20, dev)
    got = res_units_kernel(x, units)
    want = res_units_plain(x.float(), units)
    assert (got.float() - want).abs().max().item() <= 3e-2 * max(1.0, want.abs().max().item())


@pytest.fixture
def oobleck_biased(oobleck, dev):
    """The `oobleck` weights with random conv biases (the init's are zeros)."""
    g = torch.Generator(device=dev).manual_seed(10)
    blocks = []
    for blk in oobleck["block"]:
        blk = dict(blk)
        blk["conv_t1"] = dict(blk["conv_t1"])
        blk["conv_t1"]["bias"] = 0.3 * torch.randn(blk["conv_t1"]["bias"].shape, generator=g, device=dev)
        for i in (1, 2, 3):
            unit = dict(blk[f"res_unit{i}"])
            for conv in ("conv1", "conv2"):
                unit[conv] = dict(unit[conv])
                unit[conv]["bias"] = 0.3 * torch.randn(unit[conv]["bias"].shape, generator=g, device=dev)
            blk[f"res_unit{i}"] = unit
        blocks.append(blk)
    return dict(oobleck, block=blocks)


def _close(got, want):
    return (got.float() - want).abs().max().item() <= 3e-2 * max(1.0, want.abs().max().item())


# Decoder blocks by output channels: block 1 -> 512, block 2 -> 256, block 3 -> 128.
_BLOCK_OF_C = {512: 1, 256: 2, 128: 3}


@pytest.mark.parametrize("b,l", [(1, 77), (2, 300), (1, 1024)])  # below a tile, ragged, whole tiles
@pytest.mark.parametrize("unit", [1, 2, 3])
@pytest.mark.parametrize("c", [128, 256, 512])
def test_res_unit_sm90_matches_plain(dev, oobleck_biased, c, unit, b, l):
    """One residual unit (fused at C <= 256, k7 + k1 at 512): h' against the
    plain unit, and a_next = bf16(Snake1_next(h')) of the kernel's own h'."""
    bp = oobleck_biased["block"][_BLOCK_OF_C[c]]
    u, d = bp[f"res_unit{unit}"], DILATIONS[unit - 1]
    nxt = bp[f"res_unit{unit % 3 + 1}"]["snake1"]
    h = _randn((b, l, c), 50 + unit, dev)
    a = snake_f32(h.float(), u["snake1"]).to(torch.bfloat16)
    got, got_a = res_unit_sm90(h, a, u, d, nxt)
    torch.cuda.synchronize()
    want = res_unit_plain(h.float(), u, d)
    assert torch.isfinite(got).all()
    assert _close(got, want)
    # The same fp32 Snake on the same bf16 input: at most one bf16 rounding step apart.
    want_a = snake_f32(got.float(), nxt)
    assert ((got_a.float() - want_a).abs() <= 2.0**-7 * want_a.abs() + 1e-6).all()
    last, none = res_unit_sm90(h, a, u, d)
    assert none is None and torch.equal(last, got)


@pytest.mark.parametrize("block,b,l_in", [(1, 1, 23), (1, 2, 64), (2, 1, 100), (2, 2, 37), (3, 1, 300), (4, 2, 700)])
def test_decoder_block_sm90_matches_plain(dev, oobleck_biased, block, b, l_in):
    stride = (10, 6, 4, 4, 2)[block]
    bp = oobleck_biased["block"][block]
    ci = bp["conv_t1"]["kernel"].shape[1]
    x = _randn((b, l_in, ci), 60 + block, dev)
    before = decoder_block_kernel.launches
    got = decoder_block_kernel(x, bp, stride)
    torch.cuda.synchronize()
    assert decoder_block_kernel.launches == before + 1
    want = decoder_block_plain(x.float(), bp, stride)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _close(got, want)


@pytest.mark.parametrize("block", [1, 4])
def test_upsample_sm90_writes_the_first_units_snake(dev, oobleck_biased, block):
    stride = (10, 6, 4, 4, 2)[block]
    bp = oobleck_biased["block"][block]
    a0 = _randn((2, 150, bp["conv_t1"]["kernel"].shape[1]), 70 + block, dev)
    y, a1 = upsample_sm90(a0, bp["conv_t1"], stride, bp["res_unit1"]["snake1"])
    ct = bp["conv_t1"]
    want = conv_transpose1d(a0.float(), ct["kernel"].float(), ct["bias"].float(), stride=stride, padding=stride // 2)
    assert y.shape == want.shape and _close(y, want)
    want_a = snake_f32(y.float(), bp["res_unit1"]["snake1"])
    assert ((a1.float() - want_a).abs() <= 2.0**-7 * want_a.abs() + 1e-6).all()


def test_decoder_block_kernel_refuses_other_channel_counts(dev, oobleck):
    """C_out = 640 is above the 512 the JAX package's fused block takes: the
    wrapper raises before any launch (C_out = 384 takes the narrow route);
    the Hopper unit refuses 384, outside {128, 256, 512}."""
    bp = dict(oobleck["block"][2])
    bp["conv_t1"] = dict(bp["conv_t1"], kernel=torch.zeros((8, 512, 640), device=dev))
    x = _randn((1, 40, 512), 80, dev)
    before = decoder_block_kernel.launches
    with pytest.raises(ValueError):
        decoder_block_kernel(x, bp, 4)
    assert decoder_block_kernel.launches == before
    h = _randn((1, 40, 384), 81, dev)
    with pytest.raises(ValueError):
        res_unit_sm90(h, h, oobleck["block"][2]["res_unit1"], 1)


@pytest.mark.parametrize("l", [40, 77, 333, 2240, 4224, 5440])  # 4224: 132 tiles, whole rounds only
@pytest.mark.parametrize("b", [1, 2])
def test_res_units_kernel_chain_matches_plain(dev, oobleck_biased, b, l):
    """Kernel 3 at block 0's 1024 channels: one call, one count, close to the
    plain chain; ragged and sub-tile lengths (40 rows at d = 9, pad 27) and
    the 224- and 544-frame decode chunks (2240, 5440 rows)."""
    bp = oobleck_biased["block"][0]
    units = (bp["res_unit1"], bp["res_unit2"], bp["res_unit3"])
    x = _randn((b, l, 1024), 90 + l, dev)
    before = res_units_kernel.launches
    got = res_units_kernel(x, units)
    torch.cuda.synchronize()
    assert res_units_kernel.launches == before + 1
    want = res_units_plain(x.float(), units)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _close(got, want)


@pytest.mark.parametrize("b,l", [(1, 40), (2, 77), (1, 2240), (2, 2176), (1, 5440), (2, 5440)])
@pytest.mark.parametrize("d", [1, 9])
def test_streamk_k7_matches_whole_tiles(dev, oobleck_biased, b, l, d):
    """The chain's stream-K k7 against the same launch on whole tiles: the
    same products summed in another fixed order, so z agrees but for rare
    one-step bf16 roundings, and where z is small, for the fp32 sums' order
    (7 168 products of a few units each: ~1e-3, times Snake2's slope, up to
    ~4). A lost or doubled K step would move z by ~0.1 and most of z with it."""
    u = oobleck_biased["block"][0]["res_unit1"]
    a = _randn((b, l, 1024), 110 + l, dev)
    whole = oobleck_kernels._k7(a, u, d, None)
    split = oobleck_kernels._k7(a, u, d, oobleck_kernels._streamk(a))
    torch.cuda.synchronize()
    diff = (split.float() - whole.float()).abs()
    assert (diff <= 2.0**-7 * whole.float().abs() + 4e-3).all()
    assert (diff > 0).float().mean().item() < 1e-2


@pytest.mark.parametrize("b,l", [(1, 2240), (2, 77)])
def test_res_units_kernel_repeats_bit_identical(dev, oobleck_biased, b, l):
    """Each stream-K tile's partial sums add in K order, the same on every call."""
    bp = oobleck_biased["block"][0]
    units = (bp["res_unit1"], bp["res_unit2"], bp["res_unit3"])
    x = _randn((b, l, 1024), 95, dev)
    first = res_units_kernel(x, units)
    again = res_units_kernel(x, units)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_res_units_kernel_refuses_other_channel_counts(dev, oobleck):
    """1152 and 2048 channels are above the 1024 the JAX package's chain
    kernel takes: the wrapper raises before any launch (widths below 1024
    outside CHAIN_CHANNELS take the narrow route)."""
    before = res_units_kernel.launches
    for c in (1152, 2048):
        h = _randn((1, 64, c), 82, dev)
        with pytest.raises(ValueError):
            res_units_kernel(h, [oobleck["block"][3][f"res_unit{i}"] for i in (1, 2, 3)])
    assert res_units_kernel.launches == before


def _units(c, seed, dev):
    """Three residual units at c channels with random conv biases and Snakes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape, scale=1.0: scale * torch.randn(shape, generator=g, device=dev)
    snake = lambda: {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)}
    return [{"snake1": snake(), "snake2": snake(),
             "conv1": {"kernel": rnd(7, c, c, scale=(7 * c) ** -0.5).to(torch.bfloat16), "bias": rnd(c, scale=0.3)},
             "conv2": {"kernel": rnd(1, c, c, scale=c**-0.5).to(torch.bfloat16), "bias": rnd(c, scale=0.3)}}
            for _ in range(3)]


@pytest.mark.parametrize("c", [128, 256, 384, 512, 640, 768, 896])
@pytest.mark.parametrize("b,l", [(1, 40), (2, 300)])
def test_res_units_kernel_takes_every_chain_width(dev, c, b, l):
    """Every width of CHAIN_CHANNELS below block 0's 1024 launches the kernels:
    kernel 2's fused units at 128 and 256, whole 128-channel tiles at 384,
    640 and 896, the stream-K k7s at 512 and 768; one count, close to the
    plain chain."""
    units = _units(c, c + l, dev)
    x = _randn((b, l, c), 120 + c, dev)
    before = res_units_kernel.launches
    got = res_units_kernel(x, units)
    torch.cuda.synchronize()
    assert res_units_kernel.launches == before + 1
    want = res_units_plain(x.float(), units)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _close(got, want)


def test_res_units_kernel_refuses_graph_capture(dev, oobleck_biased):
    """A replayed stream-K launch would keep its epoch, which the flags may
    already hold: the wrapper raises during capture, before any launch."""
    bp = oobleck_biased["block"][0]
    units = (bp["res_unit1"], bp["res_unit2"], bp["res_unit3"])
    x = _randn((1, 77, 1024), 96, dev)
    res_units_kernel(x, units)
    torch.cuda.synchronize()
    before = res_units_kernel.launches
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            res_units_kernel(x, units)
    assert res_units_kernel.launches == before


# The 16-channel VAE of tests/test_torch_vae.py.
_TINY = dict(encoder_hidden_size=16, downsampling_ratios=(2, 4, 4), channel_multiples=(1, 2, 4),
             decoder_channels=16, decoder_input_channels=8, audio_channels=2, sampling_rate=320)


def _tiny_vae(dev):
    cfg = OobleckConfig(**_TINY)
    p = init_oobleck_params(cfg, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for blk in p["decoder"]["block"]:
        for part in [blk["snake1"]] + [blk[f"res_unit{i}"][s] for i in (1, 2, 3) for s in ("snake1", "snake2")]:
            for key in ("alpha", "beta"):
                part[key] = 0.3 * torch.randn(part[key].shape, generator=gen)
    return cfg, p, gen


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_dev(v, dev) for v in tree]
    return tree.to(dev)


def test_tiny_vae_decodes_on_the_card(dev):
    """Widths no Hopper instance takes (64/32/16 channels) take the narrow
    route on the card: one decoder_block_kernel launch per block, all of them
    narrow, no chain launch (the fused block holds the units), and the decode
    agrees with the CPU decode (fp32, TF32 off)."""
    cfg, p, gen = _tiny_vae(dev)
    z = torch.randn((2, 40, cfg.decoder_input_channels), generator=gen)
    before = (decoder_block_kernel.launches, decoder_block_kernel.narrow_launches, res_units_kernel.launches)
    got = vae.decode(_to_dev(p, dev), cfg, z.to(dev))
    torch.cuda.synchronize()
    after = (decoder_block_kernel.launches, decoder_block_kernel.narrow_launches, res_units_kernel.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 3, 0)
    want = vae.decode(p, cfg, z)
    assert got.shape == want.shape == (2, 40 * cfg.hop_length, 2)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# The narrow route against the plain versions. fp32: the same sums in another
# order (1 344 products a k7 sum at 192 channels), 5e-5 of max(1, max|ref|).
# bf16: against the fp32 chain on the same bf16 input, the 3e-2 of the Hopper
# route's checks; against the plain version in bf16 (the same rounding
# points), a flipped rounding step is rare: under 1 % of elements differ by
# more than one bf16 step of the output's largest magnitude (a flip in the
# residual stream carries its absolute size into every later unit).
NARROW_FP32_TOL = 5e-5


def _narrow_case(kind, c, stride, b, l, dtype, dev, seed):
    """A decoder block C_in = 2c -> C_out = c (or c -> c when c is 16, the
    tiny VAE's widths) or the chain at c, with random biases and Snakes."""
    units = _units(c, seed, dev)
    x = _randn((b, l, c if kind == "chain" else (c if c == 16 else 2 * c)), seed + 1, dev).to(dtype)
    if kind == "chain":
        return x, units, None
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    ci = x.shape[-1]
    bp = {"snake1": {"alpha": 0.3 * torch.randn(ci, generator=g, device=dev),
                     "beta": 0.3 * torch.randn(ci, generator=g, device=dev)},
          "conv_t1": {"kernel": torch.randn((2 * stride, ci, c), generator=g, device=dev) * (2 * ci) ** -0.5,
                      "bias": 0.3 * torch.randn(c, generator=g, device=dev)},
          "res_unit1": units[0], "res_unit2": units[1], "res_unit3": units[2]}
    return x, bp, stride


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,c,stride,b,l", [
    ("block", 16, 4, 2, 40), ("block", 16, 2, 1, 333),  # the tiny VAE's blocks
    ("block", 192, 4, 1, 100), ("block", 384, 10, 2, 23),  # 128 < C_out <= 512 outside SM90_CHANNELS
    ("chain", 64, None, 2, 300), ("chain", 16, None, 1, 40),  # chain widths outside CHAIN_CHANNELS
    ("chain", 1024, None, 1, 77),  # fp32 at a Hopper width: narrow; bf16: the Hopper route
    ("block", 24, 4, 1, 50), ("chain", 40, None, 1, 100),  # widths not a multiple of 16
    ("chain", 20, None, 1, 45),  # bf16 rows of 40 bytes: staged element by element, not by cp.async
    ("block", 64, 2, 3, 37), ("chain", 48, None, 3, 90),  # three batch rows
    ("block", 32, 4, 2, 5), ("chain", 64, None, 2, 9),  # L shorter than one 32-row tile
    ("chain", 96, None, 1, 59),  # d = 9: the k7 reads 27 rows across the tile edge at row 32
    ("block", 512, 6, 1, 40),  # 1024 -> 512, stride 6 (block 1 at full width); fp32: narrow
])
def test_narrow_route_matches_plain(dev, kind, c, stride, b, l, dtype):
    x, prm, s = _narrow_case(kind, c, stride, b, l, dtype, dev, 7 * c + l)
    wrapper, plain = ((res_units_kernel, res_units_plain) if kind == "chain"
                      else (decoder_block_kernel, decoder_block_plain))
    narrow = dtype == torch.float32 or (c not in oobleck_kernels.CHAIN_CHANNELS if kind == "chain"
                                        else c not in oobleck_kernels.SM90_CHANNELS)
    before = (wrapper.launches, wrapper.narrow_launches)
    got = wrapper(x, prm) if kind == "chain" else wrapper(x, prm, s)
    torch.cuda.synchronize()
    assert (wrapper.launches - before[0], wrapper.narrow_launches - before[1]) == (1, int(narrow))
    run_plain = (lambda xx: plain(xx, prm)) if kind == "chain" else (lambda xx: plain(xx, prm, s))
    want = run_plain(x.float())
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    if dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= NARROW_FP32_TOL * max(1.0, want.abs().max().item()), err
        return
    assert _close(got, want)
    if narrow:
        same = run_plain(x).float()
        step = 2.0**-7 * same.abs().max().item()
        assert ((got.float() - same).abs() > step).float().mean().item() < 1e-2


def test_narrow_route_repeats_bit_identical(dev):
    x, bp, s = _narrow_case("block", 192, 4, 2, 64, torch.bfloat16, dev, 5)
    first, again = decoder_block_kernel(x, bp, s), decoder_block_kernel(x, bp, s)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def _kernel_names(fn, tries=3):
    """Names of the device kernels one call of `fn` launches, from
    `torch.profiler` (a warm-up call first; 10 ms pauses at the window's
    edges, as chip_smoke.py takes its windows). A window may come back short
    of kernels: taken again, at most `tries` times, until it holds as many
    kernels as launch calls."""
    import time
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        events = prof.events()
        names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        calls = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")]
        if len(names) == len(calls):
            return names
    raise AssertionError(f"no whole profiler window in {tries} tries: {names}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_narrow_route_launches_one_kernel_a_unit(dev, dtype):
    """z fits shared memory at every narrow width, so a unit is one launch: a
    block is the Snake, the upsample and 3 unit launches (5), the chain the
    Snake and 3 (4); no other kernel runs."""
    for kind, c, stride in (("block", 192, 4), ("block", 16, 2), ("chain", 64, None), ("chain", 1024, None)):
        if kind == "chain" and c == 1024 and dtype == torch.bfloat16:
            continue  # the Hopper route's width
        x, prm, s = _narrow_case(kind, c, stride, 1, 100, dtype, dev, 3)
        fn = (lambda: res_units_kernel(x, prm)) if kind == "chain" else (lambda: decoder_block_kernel(x, prm, s))
        names = _kernel_names(fn)
        count = lambda part: sum(part in n for n in names)
        want = (1, 3, 0 if kind == "chain" else 1)
        assert (count("gen_snake_kernel"), count("narrow_unit_kernel"), count("narrow_upsample_kernel")) == want, names
        assert len(names) == sum(want), names


# The serving path's decode on the card: the tiny VAE (narrow route) behind
# an AceStepHandler, 400 latent frames in three 192-frame chunks.


def _card_handler(dev):
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    cfg, p, gen = _tiny_vae(dev)
    h = AceStepHandler(vae_config=cfg, dtype=torch.bfloat16, device=dev)
    h.vae_params = _to_dev(p, dev)
    z = torch.randn((2, 400, cfg.decoder_input_channels), generator=gen)
    return h, z


def test_async_decode_on_the_card_equals_sync(dev):
    """A decode dispatched with its copies started (the pipelined finish),
    finished after another decode was dispatched, equals the synchronous
    decode bit for bit; its chunks land in pinned host memory."""
    import numpy as np

    h, z = _card_handler(dev)
    want = h.decode_latents(z, normalize_db=-1.0, return_int16=True)
    job = h._decode_latents_dispatch(z.to(dev, torch.bfloat16), 192, -1.0, start_copies=True)
    assert len(job.host) == 3 and all(t.is_pinned() for t in job.host) and job.pcm is None
    other = h._decode_latents_dispatch((z * 0.5).to(dev, torch.bfloat16), 192, None, start_copies=True)
    got = h._decode_latents_finish(job, return_int16=True)
    h._decode_latents_finish(other, return_int16=True)
    assert got.dtype == np.int16 and got.shape == (2, 2, 400 * h.vae_config.hop_length)
    np.testing.assert_array_equal(got, want)
    sync = h._decode_latents_dispatch(z.to(dev, torch.bfloat16), 192, -1.0)
    assert sync.host is None  # the synchronous path copies in finish
    np.testing.assert_array_equal(h._decode_latents_finish(sync, return_int16=True), want)


def test_decode_ladder_on_the_card(dev, monkeypatch):
    """An injected CUDA out-of-memory in the second chunk's decode: one retry
    at the halved core (96 frames), every sample streamed once, and the
    audio of a direct decode at that core."""
    import numpy as np

    from acestep_tpu_torch.pipeline import handler as TH

    h, z = _card_handler(dev)
    want = h.decode_latents(z, chunk_frames=96 + 32, return_int16=True)
    real, calls = TH.vae.decode, []

    def decode(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("injected")
        return real(*a, **kw)

    monkeypatch.setattr(TH.vae, "decode", decode)
    got_chunks, timings = [], {}
    got = h.decode_latents(z, return_int16=True, timings=timings,
                           chunk_sink=lambda pos, pcm, total: got_chunks.append((pos, pcm.copy())))
    assert timings["retries"] == 1 and len(calls) == 2 + 5  # 2 chunks tried, then 5 of 96
    assert [p for p, _ in got_chunks] == [i * 96 * h.vae_config.hop_length for i in range(5)]
    np.testing.assert_array_equal(np.concatenate([c for _, c in got_chunks], axis=-1), got)
    np.testing.assert_array_equal(got, want)


def _full_width_dit(dev, layers: int, dtype):
    """The DiT at its shipped widths (2048 hidden, 16/8 × 128 heads), cut to
    `layers` decoder layers, random weights on the card."""
    from acestep_tpu_torch.config import AceStepConfig
    from acestep_tpu_torch.params import init_acestep_params

    cfg = AceStepConfig(num_hidden_layers=layers)
    return cfg, init_acestep_params(cfg, seed=3, device=dev, dtype=dtype)


def test_lora_effective_decoder_on_the_card_matches_cpu(dev, tmp_path):
    """The registry's effective decoder on the card equals the CPU's at fp32
    within the products' summation-order drift: two adapters of rank 32
    over every target of 2 full-width layers, one scaled by 0.5."""
    import json

    import numpy as np

    from acestep_tpu_torch.pipeline.lora_manager import LoRARegistry
    from acestep_tpu_torch.training.lora import get_path, init_lora_params

    cfg, params = _full_width_dit(dev, 2, torch.float32)
    dec = params["decoder"]
    cpu_dec = _to_dev(dec, "cpu")
    reg_card, reg_cpu = LoRARegistry(dev), LoRARegistry("cpu")
    paths = []
    for i, scale in enumerate((1.0, 0.5)):
        lora = init_lora_params(10 + i, cpu_dec, rank=32)
        gen = torch.Generator().manual_seed(20 + i)
        for ab in lora.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.02
        path = str(tmp_path / f"adapter{i}.npz")
        np.savez(path, **{f"{p}|{k}": v.numpy() for p, ab in lora.items() for k, v in ab.items()},
                 __meta__=np.asarray(json.dumps({"rank": 32, "alpha": 32.0})))
        for reg in (reg_card, reg_cpu):
            reg.load(f"a{i}", path)
            reg.set_scale(f"a{i}", scale)
        paths = list(lora)
    assert len(paths) == 2 * 11
    got, want = reg_card.effective_decoder(dec), reg_cpu.effective_decoder(cpu_dec)
    for p in paths:
        g, w = get_path(got, p.split("/")), get_path(want, p.split("/"))
        assert g.device.type == "cuda" and g.dtype == torch.float32
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-7)
        assert not torch.equal(w, get_path(cpu_dec, p.split("/")))


def test_capture_full_width_flash_matches_plain(dev, monkeypatch):
    """`dit_cross_attention_capture` at full width in bf16 over 4 layers of a
    60 s request (750 patched frames: the self-attention takes kernel 1)
    against the same capture with the plain attention on the card: the maps
    agree to 3e-2 relative L2 (bf16 both; only the self-attention's route
    differs)."""
    from acestep_tpu_torch.models import dit
    from acestep_tpu_torch.ops import attention as attn_mod

    capture_tol = 3e-2
    cfg, params = _full_width_dit(dev, 4, torch.bfloat16)
    t, l_enc = 1500, 300
    xt, ctx = _randn((1, t, 64), 1, dev), _randn((1, t, 128), 2, dev)
    enc = _randn((1, l_enc, cfg.hidden_size), 3, dev)
    mask = torch.ones((1, l_enc), dtype=torch.int32, device=dev)
    mask[:, 260:] = 0
    ts = torch.full((1,), 0.125, device=dev)
    args = (params["decoder"], cfg, xt, ts, ctx, enc, mask, [1, 2, 3])
    before = flash_attention.launches
    got = dit.dit_cross_attention_capture(*args)
    assert flash_attention.launches - before >= 3  # layers 0-3's self-attention, the captured ones twice
    monkeypatch.setattr(attn_mod, "flash_wanted", lambda *a: False)
    before = flash_attention.launches
    want = dit.dit_cross_attention_capture(*args)
    assert flash_attention.launches == before
    for layer in (1, 2, 3):
        g, w = got[layer].float(), want[layer].float()
        assert g.shape == (1, cfg.num_attention_heads, l_enc, t // cfg.patch_size)
        rel = float((g - w).norm() / w.norm())
        assert torch.isfinite(g).all() and rel <= capture_tol, (layer, rel)
        assert float(g[:, :, 260:].abs().max()) == 0.0


def test_preprocess_audio_to_sample_on_the_card_matches_cpu(dev):
    """`training.dataset.preprocess_audio_to_sample` on tests/goldens/checkpoint_tiny
    in fp32: the card's tensors (the VAE encode under the strict-fp32 guard,
    the text, lyric and timbre encoders) agree with the CPU's within 1e-4 of
    max(1, max|ref|) (the same sums in other orders); the masks are equal."""
    import os

    import numpy as np

    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.training.dataset import preprocess_audio_to_sample

    ckpt = os.path.join(os.path.dirname(__file__), "goldens", "checkpoint_tiny")
    rng = np.random.default_rng(3)
    audio = (0.3 * rng.standard_normal((2, 2 * 800))).astype(np.float32)
    out = {}
    for where in (dev, "cpu"):
        h = AceStepHandler(dtype=torch.float32, device=where)
        h.initialize_service(ckpt)
        out[str(where)] = preprocess_audio_to_sample(h, audio, "a warm piano", "[Verse]\nhello",
                                                     metas={"bpm": 90}, vocal_language="en")
    got, want = out[str(dev)], out["cpu"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if want[k].dtype == np.int32:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            tol = 1e-4 * max(1.0, float(np.abs(want[k]).max()))
            assert np.isfinite(got[k]).all() and float(np.abs(got[k] - want[k]).max()) <= tol, k


def test_strict_fp32_guard_under_two_cuda_threads(dev, monkeypatch):
    """With TF32 on (PyTorch's default for cuDNN), two threads run fp32
    products and convolutions on the card in guarded sections that overlap
    (A enters, B enters, A leaves, B computes, B leaves), many times: every
    guarded result equals the strict-fp32 reference bit for bit, the flags
    are False inside, and both come back on afterwards. The TF32 product
    differs from the reference, so a leaked flag would show."""
    import threading

    import torch.nn.functional as F

    from acestep_tpu_torch.utils.precision import strict_fp32

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((1024, 1024), generator=g, device=dev)
    x = torch.randn((2, 256, 2048), generator=g, device=dev)
    w = torch.randn((256, 256, 7), generator=g, device=dev) * 0.05

    def work():
        return torch.mm(a, a), F.conv1d(x, w, padding=3)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ref = work()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = work()
    assert not torch.equal(tf32[0], ref[0])

    phase = threading.Barrier(2, timeout=60)
    bad = []

    def run(first: bool):
        for _ in range(20):
            cm = strict_fp32()
            if not first:
                phase.wait()  # A is inside
            cm.__enter__()
            if first:
                phase.wait()
                phase.wait()  # B is inside
                got = work()
                cm.__exit__(None, None, None)
                phase.wait()  # A has left
            else:
                phase.wait()
                phase.wait()  # A has left: B computes alone inside
                got = work()
                flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
                cm.__exit__(None, None, None)
                if flags != (False, False):
                    bad.append(flags)
            torch.cuda.synchronize()
            bad.extend(i for i in range(2) if not torch.equal(got[i], ref[i]))

    threads = [threading.Thread(target=run, args=(first,)) for first in (True, False)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not bad, bad
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
