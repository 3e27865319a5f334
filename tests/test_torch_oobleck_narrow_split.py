"""The arithmetic of the Oobleck kernels' narrow route against JAX, on the CPU.

`csrc/oobleck_generic.cu` computes the narrow route's convolutions on the
tensor cores, the products split so that they keep the plain version's fp32
weights:
- bf16 activations: each fp32 weight w becomes hi = bf16(w) and lo =
  bf16(w - hi); a bf16 activation times either part is exact in fp32, and the
  two products are summed in fp32;
- fp32 activations: 3xTF32, every operand x becomes hi = rna(x) and lo =
  rna(x - hi) (TF32, to nearest, ties away), a product is lo.hi + hi.lo +
  hi.hi, and each run of 16 products (one K step of 16 input channels of one
  tap) is summed from zero and added to its accumulator in fp32.
The card runs the kernels; here a plain-torch model of that arithmetic, on the
weights as the port packs them (`oobleck_kernels.pack_narrow`), runs the
residual chain (kernel 3) and the decoder block (kernel 2) at the route's
rounding points, and is held against the JAX package's Pallas kernels
`res_units_pallas` and `decoder_block_pallas` in interpret mode, as
tests/test_torch_vae.py runs them, at 16, 24 (not a multiple of 16), 64 and
192 channels, fp32 weights and random biases and Snakes.

Tolerances, the card tests' (tests/test_torch_cuda.py): fp32, max abs error
at most NARROW_FP32_TOL = 5e-5 of max(1, max|ref|) against the Pallas kernel
in fp32; bf16, 3e-2 of max(1, max|ref|) against the Pallas kernel in fp32 on
the same bf16 input (the Pallas kernel in bf16 rounds the weights to bf16,
which the port does not), and under 1 % of elements more than one bf16 step
of the largest output from the port's plain version in bf16 (the same
rounding points, fp32 weights). At 1024 channels (block 0's chain, which a
handler in fp32 sends to the narrow route) single-pass TF32 (rna(x) alone,
one product) misses NARROW_FP32_TOL while 3xTF32 keeps it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acestep_tpu.ops.pallas_vae import decoder_block_pallas, res_units_pallas
from acestep_tpu_torch.ops import oobleck_kernels as ok
from acestep_tpu_torch.ops.oobleck_kernels import DILATIONS, snake_f32

NARROW_FP32_TOL = 5e-5
BF16_TOL = 3e-2
RUN = 16  # products summed from zero on the tensor cores (fp32 route)


def _unpacked(kernel: torch.Tensor, dtype: torch.dtype):
    """The (hi, lo) parts the route multiplies, as (K, C_in, N) fp32."""
    k, ci, n = kernel.shape
    hi, lo = ok.pack_narrow(kernel, dtype)
    return tuple(w[:, :n, :ci].permute(0, 2, 1).float() for w in (hi, lo))


def _taps(a: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    """(B, L, C) -> (B, L, k, C): tap j reads row t + j d - pad, zeros outside [0, L)."""
    pad = (k - 1) * dilation // 2
    ap = F.pad(a, (0, 0, pad, pad))
    return torch.stack([ap[:, j * dilation : j * dilation + a.shape[1]] for j in range(k)], dim=2)


def conv(a: torch.Tensor, kernel: torch.Tensor, dilation: int, route: str) -> torch.Tensor:
    """'same' conv of fp32 values a (B, L, C_in) with a (K, C_in, N) kernel,
    fp32 sums, as the route computes it ("bf16": the split weights; "3xtf32";
    "tf32": single pass)."""
    k, ci, n = kernel.shape
    x = _taps(a, k, dilation)  # (B, L, K, Ci)
    if route == "bf16":
        hi, lo = _unpacked(kernel, torch.bfloat16)
        return torch.einsum("blkc,kcn->bln", x, lo) + torch.einsum("blkc,kcn->bln", x, hi)
    if route == "tf32":
        return torch.einsum("blkc,kcn->bln", ok.tf32_rna(x), ok.tf32_rna(kernel.float()))
    wh, wl = _unpacked(kernel, torch.float32)
    xh = ok.tf32_rna(x)
    xl = ok.tf32_rna(x - xh)
    pad = (-ci) % RUN  # runs of RUN input channels of one tap, zero-padded as the packed weights are
    runs_x = lambda t: F.pad(t, (0, pad)).reshape(*t.shape[:3], -1, RUN)  # (B, L, K, R, RUN)
    runs_w = lambda w: F.pad(w, (0, 0, 0, pad)).reshape(k, -1, RUN, n)  # (K, R, RUN, N)
    xh, xl, wh, wl = runs_x(xh), runs_x(xl), runs_w(wh), runs_w(wl)
    part = lambda p, w: torch.einsum("blkrc,krcn->krbln", p, w)
    per_run = (part(xl, wh) + part(xh, wl)) + part(xh, wh)  # (K, R, B, L, N), each run from zero
    acc = torch.zeros(per_run.shape[2:])
    for run in per_run.reshape(-1, *per_run.shape[2:]):
        acc = acc + run
    return acc


def res_units_model(x: torch.Tensor, units, route: str) -> torch.Tensor:
    """The chain at the route's rounding points: the Snake launch, then per
    unit z = T(Snake2(conv_k7 + b1)), h' = T((h + conv_k1(z)) + b2) and the
    next unit's a = T(Snake1(h'))."""
    t = x.dtype
    h, a = x, snake_f32(x.float(), units[0]["snake1"]).to(t)
    for k, (p, d) in enumerate(zip(units, DILATIONS)):
        z = snake_f32(conv(a.float(), p["conv1"]["kernel"], d, route) + p["conv1"]["bias"], p["snake2"]).to(t)
        h = ((h.float() + conv(z.float(), p["conv2"]["kernel"], 1, route)) + p["conv2"]["bias"]).to(t)
        if k + 1 < len(units):
            a = snake_f32(h.float(), units[k + 1]["snake1"]).to(t)
    return h


def decoder_block_model(x: torch.Tensor, p, stride: int, route: str) -> torch.Tensor:
    """The block: a0 = T(Snake(x)), the upsample as a 3-tap conv over the
    phase weights, y = T(acc + bias) in the (B, L, s C_out) layout, then the
    chain from a1 = T(Snake1(y))."""
    t = x.dtype
    b, l, _ = x.shape
    co = p["conv_t1"]["kernel"].shape[2]
    a0 = snake_f32(x.float(), p["snake1"]).to(t)
    acc = conv(a0.float(), ok.phase_weights(p["conv_t1"]["kernel"], stride), 1, route)
    y = (acc + p["conv_t1"]["bias"].repeat(stride)).to(t).reshape(b, l * stride, co)
    return res_units_model(y, (p["res_unit1"], p["res_unit2"], p["res_unit3"]), route)


def _params(kind: str, c: int, stride, seed: int):
    """numpy weights (fp32, not bf16-exact), random biases and Snake logs: the
    chain at c channels or a block 2c -> c (c -> c at 16, the tiny VAE's)."""
    rng = np.random.default_rng(seed)
    rnd = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    snake = lambda n: {"alpha": rnd(n, scale=0.3), "beta": rnd(n, scale=0.3)}
    units = [{"snake1": snake(c), "snake2": snake(c),
              "conv1": {"kernel": rnd(7, c, c, scale=(7 * c) ** -0.5), "bias": rnd(c, scale=0.3)},
              "conv2": {"kernel": rnd(1, c, c, scale=c**-0.5), "bias": rnd(c, scale=0.3)}} for _ in range(3)]
    if kind == "chain":
        return units, c
    ci = c if c == 16 else 2 * c
    return {"snake1": snake(ci),
            "conv_t1": {"kernel": rnd(2 * stride, ci, c, scale=(2 * ci) ** -0.5), "bias": rnd(c, scale=0.3)},
            "res_unit1": units[0], "res_unit2": units[1], "res_unit3": units[2]}, ci


def _tree(p, f):
    if isinstance(p, dict):
        return {k: _tree(v, f) for k, v in p.items()}
    if isinstance(p, list):
        return [_tree(v, f) for v in p]
    return f(p)


def _run(kind, c, stride, b, l, seed, dtype, route):
    """(model output, JAX Pallas fp32 output, port plain output in dtype) on one input."""
    prm, ci = _params(kind, c, stride, seed)
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((b, l, ci)).astype(np.float32)).to(dtype)
    tp, jp = _tree(prm, torch.from_numpy), _tree(prm, jnp.asarray)
    jx = jnp.asarray(x.float().numpy())
    if kind == "chain":
        got = res_units_model(x, tp, route)
        want = np.asarray(res_units_pallas(jx, jp, interpret=True))
        plain = ok.res_units_plain(x, tp)
    else:
        got = decoder_block_model(x, tp, stride, route)
        want = np.asarray(decoder_block_pallas(jx, jp, stride, interpret=True))
        plain = ok.decoder_block_plain(x, tp, stride)
    return got.float().numpy(), want, plain.float().numpy()


CASES = [  # kind, c, stride, b, l
    ("chain", 16, None, 2, 40), ("chain", 24, None, 1, 50), ("chain", 64, None, 2, 45), ("chain", 192, None, 1, 40),
    ("block", 16, 4, 2, 12), ("block", 24, 2, 1, 25), ("block", 64, 4, 1, 10), ("block", 192, 4, 1, 10),
]


@pytest.mark.parametrize("kind,c,stride,b,l", CASES)
def test_3xtf32_model_matches_the_pallas_kernels(kind, c, stride, b, l):
    got, want, _ = _run(kind, c, stride, b, l, c + l, torch.float32, "3xtf32")
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= NARROW_FP32_TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("kind,c,stride,b,l", CASES)
def test_bf16_split_weight_model_matches_the_pallas_kernels(kind, c, stride, b, l):
    got, want, plain = _run(kind, c, stride, b, l, c + l, torch.bfloat16, "bf16")
    assert got.shape == want.shape == plain.shape
    assert float(np.abs(got - want).max()) <= BF16_TOL * max(1.0, float(np.abs(want).max()))
    step = 2.0**-7 * float(np.abs(plain).max())
    assert float((np.abs(got - plain) > step).mean()) < 1e-2


def test_single_pass_tf32_misses_the_fp32_tolerance_at_1024_channels():
    """Block 0's chain at 1024 channels (7 168 products a k7 sum): 3xTF32
    within NARROW_FP32_TOL of the Pallas kernel in fp32, one TF32 product
    not."""
    prm, _ = _params("chain", 1024, None, 3)
    x = np.random.default_rng(4).standard_normal((1, 40, 1024)).astype(np.float32)
    want = np.asarray(res_units_pallas(jnp.asarray(x), _tree(prm, jnp.asarray), interpret=True))
    tol = NARROW_FP32_TOL * max(1.0, float(np.abs(want).max()))
    tp = _tree(prm, torch.from_numpy)
    err = {route: float(np.abs(res_units_model(torch.from_numpy(x), tp, route).numpy() - want).max())
           for route in ("3xtf32", "tf32")}
    assert err["3xtf32"] <= tol < err["tf32"], (err, tol)


def test_split_weights_keep_the_fp32_weight():
    """bf16 hi + lo holds a weight to about 2^-16 of it, TF32 hi + lo to about
    2^-21; each part is exact in its type (TF32: the 13 low bits clear)."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = ok.split_weights(w, torch.bfloat16)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.all((hi.float() + lo.float() - w).abs() <= w.abs() * 2.0**-16)
    hi, lo = ok.split_weights(w, torch.float32)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0) and torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((hi + lo - w).abs() <= w.abs() * 2.0**-21)
