"""PyTorch port ops vs the JAX package on the CPU (fp32).

Each test feeds the same numpy inputs, made from a seed, to an
`acestep_tpu.ops` function and its `acestep_tpu_torch.ops` counterpart.
The Pallas flash-attention kernel runs in interpret mode, as
tests/test_pallas_attention.py runs it.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.ops import basic as jbasic
from acestep_tpu.ops import conv as jconv
from acestep_tpu.ops import packing as jpacking
from acestep_tpu.ops import rope as jrope
from acestep_tpu.ops.pallas_attention import flash_attention as pallas_flash
from acestep_tpu_torch.ops import attention as tattn
from acestep_tpu_torch.ops import basic as tbasic
from acestep_tpu_torch.ops import conv as tconv
from acestep_tpu_torch.ops import packing as tpacking
from acestep_tpu_torch.ops import rope as trope
from acestep_tpu_torch.ops.flash_attention import flash_attention

# acestep_tpu.ops re-exports the `attention` function under the submodule's name.
jattn = importlib.import_module("acestep_tpu.ops.attention")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# Elementwise and matmul ops: fp32 on both sides, differences are summation order.
OPS_TOL = dict(atol=1e-5, rtol=1e-5)


def test_linear_rms_norm_mlp():
    x = _np((2, 5, 16), 0)
    p = {"kernel": _np((16, 24), 1), "bias": _np((24,), 2)}
    _close(tbasic.linear({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x)),
           jbasic.linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)), **OPS_TOL)
    w = _np((16,), 3)
    _close(tbasic.rms_norm(torch.tensor(w), torch.tensor(x)),
           jbasic.rms_norm(jnp.asarray(w), jnp.asarray(x)), **OPS_TOL)
    mlp = {n: {"kernel": _np(s, i)} for i, (n, s) in enumerate(
        (("gate_proj", (16, 32)), ("up_proj", (16, 32)), ("down_proj", (32, 16))))}
    _close(
        tbasic.mlp_swiglu({n: {"kernel": torch.tensor(v["kernel"])} for n, v in mlp.items()}, torch.tensor(x)),
        jbasic.mlp_swiglu({n: {"kernel": jnp.asarray(v["kernel"])} for n, v in mlp.items()}, jnp.asarray(x)),
        **OPS_TOL,
    )


def test_sin2_polynomial_matches_jax():
    u = np.linspace(-60.0, 60.0, 4001, dtype=np.float32)
    _close(tbasic.sin2_f32(torch.tensor(u)), jbasic.sin2_f32(jnp.asarray(u)), atol=2e-6, rtol=0)


def test_rope():
    x = _np((2, 7, 3, 16), 4)
    cos_t, sin_t = trope.rope_cos_sin(7, 16, 1e6)
    cos_j, sin_j = jrope.rope_cos_sin(7, 16, 1e6)
    _close(cos_t, cos_j, **OPS_TOL)
    _close(trope.apply_rope(torch.tensor(x), cos_t, sin_t), jrope.apply_rope(jnp.asarray(x), cos_j, sin_j), **OPS_TOL)


def test_pack_sequences_is_stable_valid_first():
    h1, h2 = _np((2, 5, 3), 5), _np((2, 4, 3), 6)
    m1 = np.array([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0]], np.int32)
    m2 = np.array([[1, 0, 1, 1], [1, 1, 0, 0]], np.int32)
    got, got_m = tpacking.pack_sequences(*(torch.tensor(a) for a in (h1, h2, m1, m2)))
    want, want_m = jpacking.pack_sequences(*(jnp.asarray(a) for a in (h1, h2, m1, m2)))
    _close(got, want, atol=0, rtol=0)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize(
    "kw",
    [dict(k=7, padding=3), dict(k=7, padding=9, dilation=3), dict(k=2, stride=2), dict(k=1)],
)
def test_conv1d(kw):
    k = kw.pop("k")
    x, w, b = _np((2, 12, 6), 7), _np((k, 6, 5), 8), _np((5,), 9)
    _close(tconv.conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(b), **kw),
           jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw), **OPS_TOL)


@pytest.mark.parametrize("stride,k,padding", [(4, 8, 2), (2, 4, 1), (10, 20, 5), (2, 2, 0)])
def test_conv_transpose1d(stride, k, padding):
    """Three-matmul fast path (K = 2s, pad s/2) and the general path (the DiT's proj_out)."""
    x, w, b = _np((2, 9, 6), 10), _np((k, 6, 5), 11), _np((5,), 12)
    _close(tconv.conv_transpose1d(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride=stride, padding=padding),
           jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=padding),
           **OPS_TOL)


# ---------------------------------------------------------------------------
# Attention: the port's plain version vs the Pallas kernel (interpret mode).
# ---------------------------------------------------------------------------

# Tolerance of tests/test_pallas_attention.py: the band kernel and the einsum
# sum in different orders over different key sets.
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)


def _attn_case(name):
    b, nq, nkv, h = 2, 4, 2, 128
    lq = lk = 384
    mask = None
    kw = {}
    if name == "window":
        kw = dict(window=64)
    elif name == "causal":
        kw = dict(causal=True)
    elif name == "causal_window":
        kw = dict(causal=True, window=64)
    elif name == "padded":
        b, lq, lk = 1, 200, 200
        mask = np.ones((b, lk), np.int32)
        mask[:, 150:] = 0
    elif name == "cross":
        lq, lk = 256, 130
        mask = np.concatenate([np.ones((b, 100)), np.zeros((b, 30))], 1).astype(np.int32)
    elif name == "fully_masked_row":
        mask = np.ones((b, lk), np.int32)
        mask[1] = 0
        kw = dict(window=64)
    q, k, v = _np((b, lq, nq, h), 20), _np((b, lk, nkv, h), 21), _np((b, lk, nkv, h), 22)
    return q, k, v, mask, kw


@pytest.mark.parametrize(
    "name", ["full", "window", "causal", "causal_window", "padded", "cross", "fully_masked_row"]
)
def test_plain_attention_matches_pallas_flash(name):
    q, k, v, mask, kw = _attn_case(name)
    want = np.asarray(pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if mask is None else jnp.asarray(mask),
        block_q=128, block_k=128, interpret=True, **kw,
    ))
    got = flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), None if mask is None else torch.tensor(mask), **kw
    ).numpy()
    assert np.isfinite(got).all()
    # Rows with no valid key average different key sets in the two versions.
    allowed = tattn.make_attention_bias(
        q.shape[1], k.shape[1], kv_mask=None if mask is None else torch.tensor(mask), **kw
    )
    if allowed is None:
        has_key = np.ones(q.shape[:2], bool)
    else:
        has_key = allowed.expand(q.shape[0], 1, q.shape[1], k.shape[1]).any(-1)[:, 0].numpy()
    assert has_key.any()
    np.testing.assert_allclose(got[has_key], want[has_key], **ATTN_TOL)


def test_attention_dispatch_and_einsum_path():
    """Below the gate the port runs the einsum as the JAX package does; at the
    gate it takes the flash wrapper (plain version on the CPU)."""
    assert not tattn.flash_wanted(255, 1000, 128)
    assert not tattn.flash_wanted(512, 512, 64)
    assert tattn.flash_wanted(256, 256, 128)
    q, k, v = _np((2, 40, 4, 16), 30), _np((2, 33, 2, 16), 31), _np((2, 33, 2, 16), 32)
    mask = np.ones((2, 33), np.int32)
    mask[0, 20:] = 0
    got = tattn.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), kv_mask=torch.tensor(mask), window=5)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask), window=5)
    _close(got, want, **ATTN_TOL)


# ---------------------------------------------------------------------------
# bf16: one rounding in biased linears, fp32 logits.
# ---------------------------------------------------------------------------


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def test_biased_linear_bf16_rounds_once_like_jax():
    """The JAX linear adds the bias to the fp32 product and rounds once; the
    port's agrees to 1 bf16 ulp (the sums run in another order)."""
    xj, xt = _bf16_pair(_np((4, 33, 256), 40))
    kj, kt = _bf16_pair(_np((256, 96), 41, 0.05))
    bj, bt = _bf16_pair(_np((96,), 42))
    want = np.asarray(jbasic.linear({"kernel": kj, "bias": bj}, xj).astype(jnp.float32))
    got = tbasic.linear({"kernel": kt, "bias": bt}, xt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0**16  # bf16 keeps 8 of fp32's 24 bits
    assert (np.abs(got - want) <= ulp).all()


def test_logits_from_hidden_is_fp32_product_of_bf16():
    from acestep_tpu.config import Qwen3Config as JQ
    from acestep_tpu.models import qwen3 as jqwen3
    from acestep_tpu_torch.config import Qwen3Config as TQ
    from acestep_tpu_torch.models import qwen3 as tqwen3

    hj, ht = _bf16_pair(_np((3, 1, 128), 43))
    ej, et = _bf16_pair(_np((500, 128), 44, 0.02))
    cfg = dict(vocab_size=500, hidden_size=128)
    for tied in (True, False):
        if tied:
            jp, tp = {"embed_tokens": {"weight": ej}}, {"embed_tokens": {"weight": et}}
        else:
            jp, tp = {"lm_head": {"kernel": ej.T}}, {"lm_head": {"kernel": et.t().contiguous()}}
        want = np.asarray(jqwen3.logits_from_hidden(jp, JQ(**cfg), hj))
        got = tqwen3.logits_from_hidden(tp, TQ(**cfg), ht)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
