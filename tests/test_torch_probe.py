"""Kernel 4, the attention stage probe: the port's plain version vs the Pallas
probe kernel of tools/probe_kernel_parts.py in interpret mode (CPU, fp32).

The Pallas call is built as `run_mode` builds it (grid (b, nq, lq / bq),
whole-row K/V blocks, the `T` variants with K stored (b, nkv, h, lk)), at
seq 256 and bq 128. With fp32 inputs neither side rounds P, so the two differ
only in summation order.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from acestep_tpu_torch.ops.attention_probe import MODES, attention_probe, exp_poly

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "probe_kernel_parts.py")
_spec = importlib.util.spec_from_file_location("tpu_probe_kernel_parts", _TOOL)
tpu_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tpu_probe)

SEQ, BQ = 256, 128
# Relative to max|ref|: fp32 sums in another order (over 256 keys, 128 dims).
REL_TOL = 1e-5


def _pallas(mode: str, q, k, v):
    kt = mode.endswith("T")
    base = mode[:-1] if kt else mode
    b, nq, lq, h = q.shape
    lk = v.shape[2]
    groups = nq // v.shape[1]
    if kt:
        k = jnp.swapaxes(k, 2, 3)
        k_spec = pl.BlockSpec((1, 1, h, lk), lambda bi, hi, qi: (bi, hi // groups, 0, 0))
    else:
        k_spec = pl.BlockSpec((1, 1, lk, h), lambda bi, hi, qi: (bi, hi // groups, 0, 0))
    return pl.pallas_call(
        tpu_probe.make_kernel(base, BQ, lk, kt=kt),
        grid=(b, nq, lq // BQ),
        in_specs=[
            pl.BlockSpec((1, 1, BQ, h), lambda bi, hi, qi: (bi, hi, qi, 0)),
            k_spec,
            pl.BlockSpec((1, 1, lk, h), lambda bi, hi, qi: (bi, hi // groups, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, BQ, h), lambda bi, hi, qi: (bi, hi, qi, 0)),
        out_shape=jax.ShapeDtypeStruct((b, nq, lq, h), q.dtype),
        interpret=True,
    )(q, k, v)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    mk = lambda n: rng.standard_normal((1, n, SEQ, 128)).astype(np.float32)
    return mk(4), mk(2), mk(2)


@pytest.mark.parametrize("mode", [m + t for m in MODES for t in ("", "T")])
def test_plain_probe_matches_pallas_probe(qkv, mode):
    q, k, v = qkv
    want = np.asarray(_pallas(mode, *(jnp.asarray(a) for a in qkv)))
    kt = mode.endswith("T")
    kk = np.swapaxes(k, 2, 3).copy() if kt else k
    got = attention_probe(torch.tensor(q), torch.tensor(kk), torch.tensor(v), mode.rstrip("T"),
                          k_transposed=kt).numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= REL_TOL * scale


def test_exp_poly_matches_the_tpu_probe():
    x = np.linspace(-100.0, 0.0, 20001, dtype=np.float32)
    np.testing.assert_allclose(exp_poly(torch.tensor(x)).numpy(),
                               np.asarray(tpu_probe._exp_softmax_fast(jnp.asarray(x))), rtol=1e-6, atol=0)


def test_probe_entry_point_prints_the_tpu_lines(capsys):
    from acestep_tpu_torch.tools.probe_kernel_parts import main

    assert main(["--device", "cpu", "--seq", "200", "--loop", "1", "--modes", "full,dotsT"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["full", "dotsT"]
    assert all(ln.endswith("TFLOPS)") and "ms (" in ln for ln in lines)
