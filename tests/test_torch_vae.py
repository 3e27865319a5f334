"""PyTorch port Oobleck decoder vs the JAX package on the CPU (fp32).

The Pallas kernels `decoder_block_pallas` and `res_units_pallas` run in
interpret mode, as tests/test_vae.py runs them; the port's wrappers take their
plain versions on a CPU tensor. Weights are one JAX init carried over with
`from_jax_params`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import OobleckConfig as JOobleckConfig
from acestep_tpu.models import vae as jvae
from acestep_tpu.ops.pallas_vae import TOTAL_HALO, _upsample_halo, decoder_block_pallas, res_units_pallas
from acestep_tpu_torch.config import OobleckConfig
from acestep_tpu_torch.models import vae as tvae
from acestep_tpu_torch.ops.oobleck_kernels import decoder_block_kernel, res_units_kernel
from acestep_tpu_torch.params import from_jax_params

_TINY = dict(
    encoder_hidden_size=16,
    downsampling_ratios=(2, 4, 4),
    channel_multiples=(1, 2, 4),
    decoder_channels=16,
    decoder_input_channels=8,
    audio_channels=2,
    sampling_rate=320,
)
J_TINY, T_TINY = JOobleckConfig(**_TINY), OobleckConfig(**_TINY)

# fp32 on both sides; the kernels and the split path sum in different orders
# (the tolerance of tests/test_vae.py's fused-kernel checks).
TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, rng):
    """Random Snake logs and biases so every channel differs (init has zeros)."""
    if isinstance(tree, dict):
        return {
            k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                if k in ("alpha", "beta", "bias") else _perturb(v, rng))
            for k, v in tree.items()
        }
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def weights():
    jp = _perturb(jvae.init_oobleck_params(jax.random.PRNGKey(0), J_TINY, jnp.float32), np.random.default_rng(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), T_TINY)
    return jp, tp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("block,l_in", [(0, 40), (1, 24), (2, 40), (2, _upsample_halo(2)), (0, _upsample_halo(4))])
def test_decoder_block_plain_matches_pallas(weights, block, l_in):
    """Every TINY decoder block, including the shortest gate-passing inputs."""
    jp, tp = weights
    stride = tuple(reversed(J_TINY.downsampling_ratios))[block]
    jb, tb = jp["decoder"]["block"][block], tp["decoder"]["block"][block]
    ci = jb["conv_t1"]["kernel"].shape[1]
    x = _x((2, l_in, ci), 1 + block)
    want = np.asarray(decoder_block_pallas(jnp.asarray(x), jb, stride, interpret=True))
    split = np.asarray(jvae.decoder_block(jb, jnp.asarray(x), stride))
    got = decoder_block_kernel(torch.tensor(x), tb, stride).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, split, **TOL)


@pytest.mark.parametrize("length", [TOTAL_HALO, 300])
def test_res_units_plain_matches_pallas(weights, length):
    jp, tp = weights
    jb, tb = jp["decoder"]["block"][0], tp["decoder"]["block"][0]
    names = ("res_unit1", "res_unit2", "res_unit3")
    c = jb["res_unit1"]["conv1"]["kernel"].shape[2]
    x = _x((2, length, c), 5)
    want = np.asarray(res_units_pallas(jnp.asarray(x), tuple(jb[n] for n in names), interpret=True))
    got = res_units_kernel(torch.tensor(x), tuple(tb[n] for n in names)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_gates_match_jax():
    for l in range(1, 64):
        assert tvae._res_units_supports(l) == jvae._res_units_supports(l)
        for s in (2, 4, 6, 10):
            assert tvae._fused_block_supports(l, s) == jvae._fused_block_supports(l, s)


def test_decode_and_tiled_decode_match_jax(weights):
    jp, tp = weights
    z = _x((2, 40, J_TINY.latent_dim), 6)
    want = np.asarray(jvae.decode(jp, J_TINY, jnp.asarray(z)))
    got = tvae.decode(tp, T_TINY, torch.tensor(z)).numpy()
    assert got.shape == (2, 40 * J_TINY.hop_length, 2)
    np.testing.assert_allclose(got, want, **TOL)
    want_t = np.asarray(jvae.tiled_decode(jp, J_TINY, jnp.asarray(z), chunk_frames=24, overlap_frames=6))
    got_t = tvae.tiled_decode(tp, T_TINY, torch.tensor(z), chunk_frames=24, overlap_frames=6).numpy()
    np.testing.assert_allclose(got_t, want_t, **TOL)


def test_cpu_routing_follows_the_jax_gates_at_every_width(weights, monkeypatch):
    """On a CPU tensor the widths of the card's kernels do not gate: every
    block of the 16-channel VAE takes the block wrapper (its plain version),
    as the JAX package takes `decoder_block_pallas`, and no call counts as a
    kernel launch on either route."""
    _, tp = weights
    calls = []
    real = tvae.decoder_block_kernel
    monkeypatch.setattr(tvae, "decoder_block_kernel", lambda x, p, s: calls.append(x.shape[-1]) or real(x, p, s))
    counts = lambda: (decoder_block_kernel.launches, decoder_block_kernel.narrow_launches,
                      res_units_kernel.launches, res_units_kernel.narrow_launches)
    before = counts()
    tvae.decode(tp, T_TINY, torch.tensor(_x((1, 40, J_TINY.latent_dim), 7)))
    assert calls == [64, 32, 16]
    assert counts() == before


def _np_units(rng, c):
    snake = lambda: {"alpha": rng.standard_normal(c).astype(np.float32) * 0.3,
                     "beta": rng.standard_normal(c).astype(np.float32) * 0.3}
    conv = lambda k: {"kernel": (rng.standard_normal((k, c, c)) * (k * c) ** -0.5).astype(np.float32),
                      "bias": rng.standard_normal(c).astype(np.float32) * 0.3}
    return [{"snake1": snake(), "conv1": conv(7), "snake2": snake(), "conv2": conv(1)} for _ in range(3)]


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(torch.tensor, tree)


@pytest.mark.parametrize("kind,c,stride,l", [("block", 192, 4, 40), ("chain", 64, None, 120), ("chain", 192, None, 48)])
def test_narrow_widths_plain_match_pallas(kind, c, stride, l):
    """The widths of the card's narrow route between the tiny VAE's 16
    channels and the Hopper widths: a decoder block 384 -> 192 channels and
    chains at 64 and 192, plain versions against the Pallas kernels in
    interpret mode (fp32)."""
    rng = np.random.default_rng(c + l)
    units = _np_units(rng, c)
    if kind == "chain":
        ju, tu = _both(units)
        x = _x((2, l, c), 11)
        want = np.asarray(res_units_pallas(jnp.asarray(x), ju, interpret=True))
        got = res_units_kernel(torch.tensor(x), tu).numpy()
    else:
        ci = 2 * c
        block = {"snake1": {"alpha": rng.standard_normal(ci).astype(np.float32) * 0.3,
                            "beta": rng.standard_normal(ci).astype(np.float32) * 0.3},
                 "conv_t1": {"kernel": (rng.standard_normal((2 * stride, ci, c)) * (2 * ci) ** -0.5).astype(np.float32),
                             "bias": rng.standard_normal(c).astype(np.float32) * 0.3},
                 "res_unit1": units[0], "res_unit2": units[1], "res_unit3": units[2]}
        jb, tb = _both(block)
        x = _x((1, l, ci), 12)
        want = np.asarray(decoder_block_pallas(jnp.asarray(x), jb, stride, interpret=True))
        got = decoder_block_kernel(torch.tensor(x), tb, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
