"""`ops.attention.FlashAttention` gradients on the CPU (fp32).

Against JAX's `_flash_diff` (the Pallas kernel in interpret mode forward, the
einsum recompute backward, as `tests/test_pallas_attention.py` runs it) and
against the port's plain path under autograd. Cases: sliding window, full,
causal, cross-attention onto padded keys, and rows with no valid key.

On the CPU the forward is the kernel's plain version, and the backward is the
same einsum recompute as JAX's: against the plain path's autograd the
gradients are equal bit for bit. Against JAX, both sides sum fp32 products in
other orders (XLA against torch's CPU kernels): |got - want| <= 2e-5 ·
max|want| + 1e-6, an order of magnitude above the readings. A row with no
valid key averages the keys the Pallas kernel visits and, in the plain path,
all keys; outputs are compared only on rows that have a valid key. The
gradients take the same recompute on both sides, so they are compared
everywhere.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu_torch.ops import attention as tattn

jattn = importlib.import_module("acestep_tpu.ops.attention")  # the package re-exports a function of that name

RTOL, ATOL = 2e-5, 1e-6

CASES = {
    "sliding": dict(lq=256, lk=256, window=32),
    "full": dict(lq=256, lk=256),
    "causal": dict(lq=256, lk=256, causal=True),
    "cross_padded": dict(lq=256, lk=300, pad=(260, 230)),
    "rows_without_keys": dict(lq=256, lk=256, causal=True, hole=8),  # rows 0-7 see only masked keys
}


def _inputs(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    c = CASES[case]
    b, nq, nkv = 2, 4, 2
    q = rng.standard_normal((b, c["lq"], nq, 128)).astype(np.float32)
    k = rng.standard_normal((b, c["lk"], nkv, 128)).astype(np.float32)
    v = rng.standard_normal((b, c["lk"], nkv, 128)).astype(np.float32)
    w = rng.standard_normal((b, c["lq"], nq, 128)).astype(np.float32)
    mask = None
    if "pad" in c:
        mask = np.ones((b, c["lk"]), np.int32)
        for i, n in enumerate(c["pad"]):
            mask[i, n:] = 0
    if "hole" in c:
        mask = np.ones((b, c["lk"]), np.int32)
        mask[:, : c["hole"]] = 0
    return q, k, v, w, mask, c.get("window"), c.get("causal", False)


def _port(q, k, v, w, mask, window, causal, flash=True):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    mt = None if mask is None else torch.from_numpy(mask)
    if flash:
        out = tattn.FlashAttention.apply(qt, kt, vt, mt, window, causal, 128**-0.5)
    else:
        tattn.set_flash_enabled(False)
        try:
            out = tattn.attention(qt, kt, vt, kv_mask=mt, window=window, causal=causal)
        finally:
            tattn.set_flash_enabled(None)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _valid_rows(mask, lq, window, causal):
    """(B, Lq) bool: the query rows that have at least one valid key."""
    allowed = tattn.make_attention_bias(lq, mask.shape[1] if mask is not None else lq,
                                        kv_mask=None if mask is None else torch.from_numpy(mask),
                                        window=window, causal=causal)
    if allowed is None:
        return np.ones((1, lq), bool)
    return allowed.any(dim=-1)[:, 0].numpy()


def _close(got, want, what):
    err = float(np.abs(got - want).max())
    bound = RTOL * float(np.abs(want).max()) + ATOL
    assert err <= bound, f"{what}: {err} > {bound}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_grads_match_jax_flash_diff(case):
    q, k, v, w, mask, window, causal = _inputs(case)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jattn._flash_diff((window, causal, 128**-0.5, True), q_, k_, v_, jmask)
        return jnp.sum(out * w), out

    (_, out_j), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    out_t, g_t = _port(q, k, v, w, mask, window, causal)
    rows = np.broadcast_to(_valid_rows(mask, q.shape[1], window, causal), out_t.shape[:2])
    if case == "rows_without_keys":
        assert not rows.all()
    _close(out_t[rows], np.asarray(out_j)[rows], "output")
    for name, a, b in zip("qkv", g_t, g_j):
        _close(a, np.asarray(b), f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_grads_equal_plain_autograd(case):
    q, k, v, w, mask, window, causal = _inputs(case)
    out_f, g_f = _port(q, k, v, w, mask, window, causal, flash=True)
    out_p, g_p = _port(q, k, v, w, mask, window, causal, flash=False)
    np.testing.assert_array_equal(out_f, out_p)
    for a, b in zip(g_f, g_p):
        np.testing.assert_array_equal(a, b)


def test_flash_gate_follows_override_and_environment(monkeypatch):
    """`set_flash_enabled` first, then ACESTEP_TPU_NO_FLASH=1, then the shape
    gate, as JAX's `_flash_wanted` (on every device in the port)."""
    assert tattn.flash_wanted(256, 256, 128) and not tattn.flash_wanted(255, 256, 128)
    assert not tattn.flash_wanted(256, 256, 64)
    monkeypatch.setenv("ACESTEP_TPU_NO_FLASH", "1")
    assert not tattn.flash_wanted(256, 256, 128)
    tattn.set_flash_enabled(True)
    try:
        assert tattn.flash_wanted(16, 16, 8)
    finally:
        tattn.set_flash_enabled(None)
    monkeypatch.delenv("ACESTEP_TPU_NO_FLASH")
    tattn.set_flash_enabled(False)
    try:
        assert not tattn.flash_wanted(256, 256, 128)
    finally:
        tattn.set_flash_enabled(None)


def test_attention_runs_the_function_under_inference_mode():
    """Serving calls attention under `torch.inference_mode`: the autograd
    Function's forward runs there and records nothing."""
    q = torch.randn(1, 256, 2, 128)
    k = torch.randn(1, 256, 1, 128)
    with torch.inference_mode():
        out = tattn.attention(q, k, k, window=16)
    assert out.shape == q.shape and not out.requires_grad
