"""The arithmetic of kernel 1's fp32 route (3xTF32) against JAX, on the CPU.

`csrc/flash_attention_f32.cu` computes both products of the attention on the
tensor cores in TF32, split three ways: every operand x becomes
hi = rna(x) and lo = rna(x - hi), TF32 rounded to nearest (ties away), and a
product is lo.hi + hi.lo + hi.hi accumulated in fp32. The card runs the
kernel; here a plain-torch model of that arithmetic (the rounding done on the
bits) runs at the training shapes, and its output is held against
`acestep_tpu.ops.attention.attention_xla` in fp32 and, at one small shape,
against the Pallas kernel `acestep_tpu.ops.pallas_attention.flash_attention`
in interpret mode.

Tolerance: max abs error at most 2e-6 on rows that have a valid key. The
model read 6.6e-7 (full) and 8.3e-7 (cross) against torch's own fp32 einsum
at (1, 768, 16 / 8, 128), so the bound is about 2.5 times that. Against JAX
the cases here read 9.8e-7 (full, cross), 1.55e-6 (sliding, w = 32) and
9.5e-7 (the Pallas kernel): both sides round. Against an fp64 reference the
model and torch's fp32 einsum read alike (1.2e-6 and 1.4e-6 at 1 x 768 with
w = 128), so 3xTF32 keeps fp32's accuracy. In the same test single-pass TF32
(rna(x) alone, one product) must miss the bound: it reads 4e-4 to 9e-4, so
the test tells the two apart.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.ops.pallas_attention import flash_attention as pallas_flash_attention
from acestep_tpu_torch.ops.attention import make_attention_bias

jattn = importlib.import_module("acestep_tpu.ops.attention")  # the package re-exports a function of that name

TOL = 2e-6
NEG_INF = -0.7 * float(np.finfo(np.float32).max)  # the kernel's masked score


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as `cvt.rna.tf32.f32`: add half of the 13 dropped bits' range to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b as the tensor cores take it: 3xTF32 (small terms first) or one
    TF32 product; fp32 accumulation either way."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    if not split:
        return ah @ bh
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def attention_tf32(q, k, v, kv_mask, window, split):
    """The kernel's attention in torch: (B, L, N, 128) fp32, GQA, the scale
    and mask in fp32, P unnormalised into the product, then divided by
    max(l, 1e-30)."""
    b, lq, nq, h = q.shape
    lk, nkv = k.shape[1], k.shape[2]
    qh = q.permute(0, 2, 1, 3).reshape(b, nkv, nq // nkv, lq, h)
    kh = k.permute(0, 2, 1, 3)[:, :, None]
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    s = product(qh, kh.transpose(-1, -2), split) * h**-0.5
    allowed = make_attention_bias(lq, lk, kv_mask=kv_mask, window=window)
    if allowed is not None:
        s = torch.where(allowed[:, :, None], s, torch.tensor(NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = product(p, vh, split) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, nq, lq, h).permute(0, 2, 1, 3)


def _inputs(seed, b, lq, lk, nq, nkv, valid):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, n, 128)).astype(np.float32) for l, n in ((lq, nq), (lk, nkv), (lk, nkv)))
    mask = np.zeros((b, lk), np.int32)
    mask[:, :valid] = 1
    return q, k, v, mask


def _valid_rows(mask, lq, window):
    allowed = make_attention_bias(lq, mask.shape[1], kv_mask=torch.from_numpy(mask), window=window)
    return np.broadcast_to(allowed.any(dim=-1)[:, 0].numpy(), (mask.shape[0], lq))


def _errors(got_by_route, want, rows):
    return {route: float(np.abs(got[rows] - want[rows]).max()) for route, got in got_by_route.items()}


CASES = {  # name: (b, lq, lk, nq, nkv, valid keys, window)
    "full_1x768": (1, 768, 768, 16, 8, 750, None),  # the training shape: 60 s padded to 768 tokens
    "cross_1x768": (1, 768, 512, 16, 8, 480, None),  # onto 512 encoder rows, 480 valid
    "sliding_1x256": (1, 256, 256, 4, 2, 250, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_model_matches_jax_attention_and_single_pass_does_not(case):
    b, lq, lk, nq, nkv, valid, window = CASES[case]
    q, k, v, mask = _inputs(sorted(CASES).index(case), b, lq, lk, nq, nkv, valid)
    jmask = jattn.make_attention_bias(lq, lk, kv_mask=jnp.asarray(mask), window=window)
    want = np.asarray(jattn.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask))
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    got = {split: attention_tf32(tq, tk, tv, tm, window, split).numpy() for split in (True, False)}
    err = _errors(got, want, _valid_rows(mask, lq, window))
    assert err[True] <= TOL, err
    assert err[False] > TOL, err


def test_3xtf32_model_matches_the_pallas_kernel_in_interpret_mode():
    b, lq, lk, nq, nkv, valid, window = 1, 128, 128, 2, 1, 120, 48
    q, k, v, mask = _inputs(7, b, lq, lk, nq, nkv, valid)
    want = np.asarray(pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                             window=window, interpret=True))
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    got = {split: attention_tf32(tq, tk, tv, tm, window, split).numpy() for split in (True, False)}
    err = _errors(got, want, _valid_rows(mask, lq, window))
    assert err[True] <= TOL, err
    assert err[False] > TOL, err


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # TF32's last place at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0**-23, -(one + ulp / 2), one + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0])
    assert torch.equal(rna_tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = rna_tf32(y)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((y - hi).abs() <= hi.abs() * 2.0**-11)
