"""The base model's guided sampling in the port, on the CPU in fp32.

- `tests/goldens/base_tiny.npz` (recorded from the reference base model and
  its `apg_guidance.py`) through the port's own converter: the APG momentum
  chain and ADG within 2e-5, the four base trajectories within 5e-5 (the
  tolerances of tests/test_golden_parity.py). `cfg_interval` (interval
  0.3-0.8 over `build_linspace_schedule(6, shift=2.0)`, which holds the step
  t = 0.8) checks that the interval test compares in float32.
- The port's `generate_audio` against the JAX package's on the same weights
  (`params.from_jax_params`) and numpy inputs: APG, ADG at batch 2, the
  interval, guidance over two cover-strength segments (the momentum starts
  from zero in each), and SDE fed the per-step noise that JAX's keys draw.
- The denoise loop in bf16 against JAX's, with the DiT forward replaced in
  both by the same one-op stand-in: the port rounds to bf16 where JAX does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.config import AceStepConfig as JA
from acestep_tpu.models import dit as jdit
from acestep_tpu.params import init_acestep_params
from acestep_tpu_torch.config import AceStepConfig as TA
from acestep_tpu_torch.models import dit as tdit
from acestep_tpu_torch.params import convert_torch_state_dict, from_jax_params

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

GOLDEN_CFG = TA(
    hidden_size=64, intermediate_size=128, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=8,
    text_hidden_dim=32, num_lyric_encoder_hidden_layers=2,
    num_timbre_encoder_hidden_layers=2, num_attention_pooler_hidden_layers=1,
    fsq_dim=64, timbre_fix_frame=10,
)
_DIT = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
    num_attention_pooler_hidden_layers=1, fsq_dim=64, timbre_fix_frame=10,
)
J_DIT, T_DIT = JA(**_DIT), TA(**_DIT)

# fp32 on both sides, a few layers and six guided steps deep: summation-order
# drift only (the same tolerance as the port's other JAX parity tests).
TOL = dict(rtol=1e-4, atol=1e-4)


def _max_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{got.shape} vs {want.shape}"
    return float(np.abs(got - want).max())


# ---------------------------------------------------------------------------
# The reference's goldens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base_golden():
    z = np.load(os.path.join(GOLDEN_DIR, "base_tiny.npz"))
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    inp = {k[3:]: torch.tensor(z[k]) for k in z.files if k.startswith("in/")}
    out = {k[4:]: z[k] for k in z.files if k.startswith("out/")}
    return convert_torch_state_dict(sd, GOLDEN_CFG, torch.float32), inp, out


def test_apg_momentum_chain_golden(base_golden):
    _, IN, OUT = base_golden
    momentum = torch.zeros(IN["apg_cond"].shape[1:], dtype=torch.float32)
    for i in range(3):
        got, momentum = tdit.apg_forward(IN["apg_cond"][i], IN["apg_uncond"][i], 3.0, momentum)
        assert _max_err(got, OUT["apg_chain"][i]) < 2e-5, f"step {i}"


def test_adg_golden(base_golden):
    """Batch 1, the only batch the reference's ADG takes."""
    _, IN, OUT = base_golden
    got = tdit.adg_forward(IN["adg_latents"][:1], IN["apg_cond"][0][:1], IN["apg_uncond"][0][:1], 0.7, 3.0)
    assert _max_err(got, OUT["adg"]) < 2e-5


@pytest.mark.parametrize("tag,use_adg,gs,ci", [
    ("cfg_apg", False, 3.0, (0.0, 1.0)),
    ("cfg_adg", True, 3.0, (0.0, 1.0)),
    ("cfg_interval", False, 3.0, (0.3, 0.8)),
    ("noguidance", False, 1.0, (0.0, 1.0)),
])
def test_base_trajectory_golden(base_golden, tag, use_adg, gs, ci):
    params, IN, OUT = base_golden
    sl = slice(0, 1 if use_adg else 2)  # the reference's ADG is batch 1 only
    enc, _, ctx = tdit.prepare_condition(
        params, GOLDEN_CFG,
        text_hidden_states=IN["text_h"][sl], text_attention_mask=IN["text_m"][sl],
        lyric_hidden_states=IN["lyric_h"][sl], lyric_attention_mask=IN["lyric_m"][sl],
        refer_packed=IN["refer_packed"][sl], refer_order_mask=IN["refer_order"][sl].to(torch.int32),
        src_latents=IN["src_latents"][sl], chunk_masks=IN["chunk_masks"][sl],
        is_covers=IN["is_covers"][sl], silence_latent=IN["silence_latent"], max_refs=1,
    )
    dec = params["decoder"]
    kvs = tdit.precompute_cross_kv(dec, GOLDEN_CFG, enc)
    null_kvs = None
    if gs > 1.0:
        null_kvs = tdit.precompute_cross_kv(dec, GOLDEN_CFG, params["null_condition_emb"].expand(enc.shape))
    sched = tdit.build_linspace_schedule(6, shift=2.0)
    assert np.float32(0.8) in np.asarray(sched, np.float32)  # the step the interval test must keep
    xt = tdit.denoise(dec, GOLDEN_CFG, IN["noise"][sl], sched, ctx, kvs, None, None,
                      null_cross_kvs=null_kvs, guidance_scale=gs, use_adg=use_adg,
                      cfg_interval_start=ci[0], cfg_interval_end=ci[1])
    assert _max_err(xt, OUT[f"gen_{tag}"]) < 5e-5, tag


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dit_params():
    jp = init_acestep_params(jax.random.PRNGKey(0), J_DIT, jnp.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), T_DIT)


def _inputs(b=2, t=20, text_len=7, lyric_len=9):
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    text_mask = np.ones((b, text_len), np.int32)
    text_mask[1, 5:] = 0
    lyric_mask = np.ones((b, lyric_len), np.int32)
    lyric_mask[0, 6:] = 0
    lat = np.ones((b, t), np.int32)
    lat[0, 17:] = 0
    return dict(
        text_hidden_states=f32(b, text_len, J_DIT.text_hidden_dim),
        text_attention_mask=text_mask,
        lyric_hidden_states=f32(b, lyric_len, J_DIT.text_hidden_dim),
        lyric_attention_mask=lyric_mask,
        refer_packed=f32(b, J_DIT.timbre_fix_frame, J_DIT.timbre_hidden_dim),
        refer_order_mask=np.arange(b, dtype=np.int32),
        src_latents=f32(b, t, J_DIT.audio_acoustic_hidden_dim),
        chunk_masks=np.ones((b, t), np.float32),
        is_covers=np.asarray([0, 1][:b], np.int32),
        silence_latent=f32(1, t, J_DIT.audio_acoustic_hidden_dim),
        precomputed_lm_hints_25hz=f32(b, t, J_DIT.audio_acoustic_hidden_dim),
        attention_mask=lat,
        noise=f32(b, t, J_DIT.audio_acoustic_hidden_dim),
    )


def _both(inp):
    return ({k: jnp.asarray(v) for k, v in inp.items()}, {k: torch.tensor(v) for k, v in inp.items()})


def _jax_sde_noise(seed: int, segments, shape) -> list:
    """The per-step noise JAX's generate_audio draws: per segment
    split(fold_in(PRNGKey(seed), s0), s1 - s0), one normal draw per key."""
    base = jax.random.PRNGKey(seed & 0x7FFFFFFF)
    out = []
    for s0, s1 in segments:
        for key in jax.random.split(jax.random.fold_in(base, s0), s1 - s0):
            out.append(torch.tensor(np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))))
    return out


# (name, batch, generate_audio kwargs): six base steps at shift 2.0.
CASES = [
    ("apg", 2, dict(guidance_scale=3.0)),
    ("apg_scale7", 1, dict(guidance_scale=7.0)),
    ("adg_batch2", 2, dict(guidance_scale=3.0, use_adg=True)),
    ("interval", 2, dict(guidance_scale=3.0, cfg_interval_start=0.3, cfg_interval_end=0.8)),
    ("cover_strength_apg", 2, dict(guidance_scale=3.0, audio_cover_strength=0.5)),
    ("cover_strength_adg", 2, dict(guidance_scale=3.0, use_adg=True, audio_cover_strength=0.5)),
]


@pytest.mark.parametrize("name,b,kw", CASES, ids=[c[0] for c in CASES])
def test_generate_audio_guidance_matches_jax(dit_params, name, b, kw):
    jp, tp = dit_params
    inp = {k: v[:b] if k not in ("silence_latent",) else v for k, v in _inputs().items()}
    ji, ti = _both(inp)
    common = dict(max_refs=1, infer_steps=6, shift=2.0, seeds=[5, 6][:b])
    want = jdit.generate_audio(jp, J_DIT, **ji, **common, **kw)
    got = tdit.generate_audio(tp, T_DIT, **ti, **common, **kw)
    assert got["num_steps"] == want["num_steps"] == 6
    assert got["target_latents"].shape == (b, 20, 64)
    np.testing.assert_allclose(got["target_latents"].numpy(), np.asarray(want["target_latents"]), **TOL)
    # Guidance moved the result by far more than the tolerance: the same
    # request without it differs.
    plain = tdit.generate_audio(tp, T_DIT, **ti, **common, **{**kw, "guidance_scale": 1.0})
    assert float((plain["target_latents"] - got["target_latents"]).abs().max()) > 1e-3


def test_cfg_forward_matches_jax():
    rng = np.random.default_rng(8)
    c, u = (rng.standard_normal((2, 20, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jdit.cfg_forward(jnp.asarray(c), jnp.asarray(u), 4.5))
    np.testing.assert_allclose(tdit.cfg_forward(torch.tensor(c), torch.tensor(u), 4.5).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_adg_batch2_rows_are_independent():
    """ADG at batch 2 (the JAX package's generalisation of the reference's
    batch-1 ADG): each row equals that row run alone, in both packages."""
    rng = np.random.default_rng(7)
    x, c, u = (rng.standard_normal((2, 20, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jdit.adg_forward(jnp.asarray(x), jnp.asarray(c), jnp.asarray(u), jnp.float32(0.6), 4.0))
    got = tdit.adg_forward(torch.tensor(x), torch.tensor(c), torch.tensor(u), 0.6, 4.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    for i in range(2):
        row = tdit.adg_forward(torch.tensor(x[i:i + 1]), torch.tensor(c[i:i + 1]), torch.tensor(u[i:i + 1]),
                               0.6, 4.0)
        np.testing.assert_array_equal(row.numpy(), got[i:i + 1].numpy())


@pytest.mark.parametrize("cover_strength", [1.0, 0.5])
def test_sde_with_jax_noise_matches_jax(dit_params, cover_strength):
    """SDE over one segment and over two (the second segment's keys fold in
    its first step), turbo schedule and guided base schedule: the port fed
    the noise JAX's keys draw follows JAX's trajectory."""
    jp, tp = dit_params
    ji, ti = _both(_inputs())
    for extra in (dict(), dict(infer_steps=6, shift=2.0, guidance_scale=3.0)):
        common = dict(max_refs=1, seeds=[11, 12], infer_method="sde", audio_cover_strength=cover_strength, **extra)
        want = jdit.generate_audio(jp, J_DIT, **ji, **common)
        n = want["num_steps"]
        c = int(n * cover_strength)
        segments = [(0, c), (c, n)] if cover_strength < 1.0 else [(0, n)]
        noise = _jax_sde_noise(11, segments, (2, 20, 64))
        got = tdit.generate_audio(tp, T_DIT, **ti, **common, sde_noise=noise)
        np.testing.assert_allclose(got["target_latents"].numpy(), np.asarray(want["target_latents"]), **TOL)


def test_sde_is_deterministic_per_seed_and_differs_from_ode(dit_params):
    _, tp = dit_params
    _, ti = _both(_inputs())
    run = lambda seeds, method: tdit.generate_audio(
        tp, T_DIT, **ti, max_refs=1, seeds=seeds, infer_method=method)["target_latents"]
    a, b = run([1, 2], "sde"), run([1, 2], "sde")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all()
    assert float((a - run([1, 2], "ode")).abs().max()) > 1e-2
    assert float((a - run([3, 2], "sde")).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# bf16 rounding points of the denoise loop
# ---------------------------------------------------------------------------


def _jax_stand_in(params, cfg, xt, t, t_r, context, kvs, encoder_mask=None, latent_mask=None):
    return (kvs - xt.astype(jnp.float32)).astype(xt.dtype)


def _torch_stand_in(params, cfg, xt, t, t_r, context, kvs, encoder_mask=None, latent_mask=None, shards=None):
    return (kvs - xt.float()).to(xt.dtype)


BF16_CASES = [
    ("ode", dict()),
    ("sde", dict(infer_method="sde")),
    ("apg", dict(guidance_scale=3.0)),
    ("adg", dict(guidance_scale=3.0, use_adg=True)),
    ("interval", dict(guidance_scale=3.0, cfg_interval_start=0.3, cfg_interval_end=0.8)),
]


@pytest.mark.parametrize("name,kw", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_rounding_points_match_jax(monkeypatch, name, kw):
    """Twelve bf16 steps of `denoise` against JAX's `denoise_scan`, the DiT
    forward replaced in both by v = condition - x (one fp32 subtraction, then
    bf16; the cross K/V argument carries the condition, the null branch's
    another). JAX is compiled with `xla_allow_excess_precision` off, so each
    of its bf16 casts is kept: the APG update's cast before the add, the SDE
    noise drawn in fp32 and mixed in bf16, the Euler step. The port must give
    the same bits; ADG differs only where arccos / sin / cos differ in the
    last fp32 bit (at most 0.1% of the elements)."""
    monkeypatch.setattr(jdit, "dit_forward", _jax_stand_in)
    monkeypatch.setattr(tdit, "dit_forward", _torch_stand_in)
    rng = np.random.default_rng(3)
    x0, cond, null = (rng.standard_normal((2, 40, 64)).astype(np.float32) for _ in range(3))
    sched = np.asarray(tdit.build_linspace_schedule(12, shift=3.0), np.float32)
    t_next = np.append(sched[1:], np.float32(0.0))
    guided = "guidance_scale" in kw
    static = {k: kw[k] for k in ("infer_method", "use_adg") if k in kw}
    dynamic = {k: v for k, v in kw.items() if k not in static}
    keys = jax.random.split(jax.random.PRNGKey(9), len(sched)) if name == "sde" else None
    if guided:
        dynamic["null_cross_kvs_tree"] = jnp.asarray(null)
    args = (None, jnp.asarray(x0, jnp.bfloat16), jnp.asarray(sched), jnp.asarray(t_next), None, jnp.asarray(cond),
            None, None, keys)
    scan = jax.jit(jdit.denoise_scan.__wrapped__, static_argnames=("cfg", "infer_method", "use_adg"))
    compiled = scan.lower(args[0], None, *args[1:], **static, **dynamic).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(compiled(*args, **dynamic).astype(jnp.float32))

    noise = [np.asarray(jax.random.normal(k, x0.shape, dtype=jnp.float32)) for k in keys] if name == "sde" else None
    got = tdit.denoise(
        None, None, torch.tensor(x0).bfloat16(), [float(t) for t in sched], None, torch.tensor(cond), None, None,
        null_cross_kvs=torch.tensor(null) if guided else None,
        sde_noise=(lambda i: torch.tensor(noise[i])) if noise else None, **kw,
    )
    assert got.dtype == torch.bfloat16
    differ = float((got.float().numpy() != want).mean())
    assert differ <= (1e-3 if name == "adg" else 0.0), f"{differ:.2%} of the bf16 elements differ"
