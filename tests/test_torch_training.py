"""The port's training core against the JAX package (CPU, fp32).

`training/{train_step,trainer,optim,dataset,estimate}.py` and the presets on
JAX's `TINY` config of `tests/test_training.py`, with the same weights
(`params.from_jax_params`), the same numpy batches and JAX's own draws fed to
the port through `draws=`: JAX keys give t, noise and the dropout's uniforms,
the port takes them as tensors.

Tolerances. Losses and gradients: fp32 on both sides through two DiT layers
(and the condition encoders) and their backward, with sums taken in other
orders (XLA against torch's CPU kernels). Over every parameter of the model
the readings are a median 5e-7 and at most 1.2e-5 of a leaf's largest entry,
so |got - want| <= 1e-4 · max|want| + 1e-7 per leaf leaves a factor of 8. The optimizer alone
(`optim.py` against optax on the same gradients) holds 1e-6 relative: AdamW's
update m̂/(√v̂ + ε) is not contractive in the gradient's rounding, so an ulp in
√v̂ moves the update by an ulp. Trainer steps compound both: after three steps
the factors agree to 1e-4 relative of their largest entry.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acestep_tpu.config import AceStepConfig as JA
from acestep_tpu.params import init_acestep_params as j_init
from acestep_tpu.training import dataset as jds
from acestep_tpu.training import estimate as jest
from acestep_tpu.training import lora as jlora
from acestep_tpu.training import train_step as jts
from acestep_tpu.training import trainer as jtr
from acestep_tpu_torch.config import AceStepConfig as TA
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.training import dataset as tds
from acestep_tpu_torch.training import estimate as test_
from acestep_tpu_torch.training import optim
from acestep_tpu_torch.training import train_step as tts
from acestep_tpu_torch.training import trainer as ttr
from acestep_tpu_torch.training.lora import apply_lora as t_apply_lora
from acestep_tpu_torch.training.presets import list_presets, load_preset

TINY = dict(
    hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=8, sliding_window=4, text_hidden_dim=16, num_lyric_encoder_hidden_layers=2,
    num_timbre_encoder_hidden_layers=1, num_attention_pooler_hidden_layers=1, fsq_dim=32, timbre_fix_frame=8,
)
JCFG, TCFG = JA(**TINY), TA(**TINY)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
OPT_RTOL = 1e-6
STEP_RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """JAX's fp32 TINY parameters and the port's copy."""
    jp = j_init(jax.random.PRNGKey(0), JCFG, jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), TCFG)
    return jp, tp


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(tree):
    """A JAX / numpy tree as the port's: dicts of CPU tensors."""
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got, want, rtol, atol=0.0, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    bound = rtol * max(float(np.abs(w).max()), 1e-30) + atol
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= bound, f"{what}: {err} > {bound}"


def _close_trees(got, want, rtol, atol=0.0):
    """Leaf by leaf: the port's tree (sorted as `optim.tree_leaves` walks it)
    against JAX's (`jax.tree.leaves`, sorted too)."""
    g, w = optim.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, rtol, atol, what=f"leaf {i}")


def _jax_draws(key, b: int, shape, *, discrete=False, mu=-0.4, sigma=1.0):
    """The draws JAX's losses make from `key` (k_t, k_noise, k_drop), as the
    port's `draws=` dict."""
    k_t, k_noise, k_drop = jax.random.split(key, 3)
    t = jts.sample_discrete_timesteps(k_t, b) if discrete else jts.sample_timesteps(k_t, b, mu, sigma)
    noise = jax.random.normal(k_noise, shape, dtype=jnp.float32)
    u = jax.random.uniform(k_drop, (b, 1, 1))
    return {"t": torch.from_numpy(np.array(t, np.float32)), "noise": torch.from_numpy(np.array(noise)),
            "u": torch.from_numpy(np.array(u).reshape(b))}


def _trainer_draws(seed: int, n: int, b: int, shape, **kw):
    """The per-step draws of JAX's `LoRATrainer.train`: key seed + 1, split
    once a step."""
    key, out = jax.random.PRNGKey(seed + 1), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_jax_draws(sub, b, shape, **kw))
    return out


def _batch(b=2, t=20, l=12, seed=0, pad=True):
    """A preprocessed batch: the second row's latents and encoder rows padded."""
    rng = np.random.default_rng(seed)
    batch = {
        "target_latents": rng.standard_normal((b, t, 64)).astype(np.float32),
        "context_latents": rng.standard_normal((b, t, 128)).astype(np.float32),
        "attention_mask": np.ones((b, t), np.int32),
        "encoder_hidden_states": rng.standard_normal((b, l, TINY["hidden_size"])).astype(np.float32),
        "encoder_attention_mask": np.ones((b, l), np.int32),
    }
    if pad:
        batch["attention_mask"][-1, t - 5:] = 0
        batch["encoder_attention_mask"][-1, l - 4:] = 0
    return batch


def _factors(jp, kind: str, seed: int = 1):
    """JAX-initialised factors with the zero-initialised ones made nonzero, so
    every factor has a gradient."""
    key = jax.random.PRNGKey(seed)
    if kind == "lokr":
        fac = jlora.init_lokr_params(key, jp["decoder"], rank=2, factor=4)
        zero = "w2b"
    else:
        fac = jlora.init_lora_params(key, jp["decoder"], rank=4)
        zero = "b"
    rng = np.random.default_rng(seed)
    for p in fac:
        fac[p][zero] = jnp.asarray((rng.standard_normal(fac[p][zero].shape) * 0.1).astype(np.float32))
    return fac


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lora", "lokr"])
def test_decoder_loss_and_grads_match_jax(models, kind):
    jp, tp = models
    fac = _factors(jp, kind)
    lcfg_j = jtr.LoRAConfig(rank=2 if kind == "lokr" else 4, alpha=8.0, adapter_type=kind, lokr_factor=4)
    lcfg_t = ttr.LoRAConfig(rank=lcfg_j.rank, alpha=8.0, adapter_type=kind, lokr_factor=4)
    batch = _batch()
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, 2, batch["target_latents"].shape)
    # A ratio between the two rows' uniforms: one row drops to the null condition.
    ratio = float(draws["u"].mean())
    tcfg_j, tcfg_t = jtr.TrainingConfig(cfg_ratio=ratio), ttr.TrainingConfig(cfg_ratio=ratio)

    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda f, dec, null, b, k: jtr.decoder_flow_matching_loss(f, dec, null, JCFG, lcfg_j, tcfg_j, b, k)))(
        fac, jp["decoder"], jp["null_condition_emb"], jax.tree.map(jnp.asarray, batch), key)
    tb = ttr.to_device_batch(batch, "cpu")
    loss_t, g_t = tts.value_and_grad(
        lambda f: ttr.decoder_flow_matching_loss(f, tp["decoder"], tp["null_condition_emb"], TCFG, lcfg_t, tcfg_t,
                                                 tb, draws=draws), _t(fac))
    _close(loss_t, loss_j, 1e-5, what="loss")
    _close_trees(g_t, g_j, GRAD_RTOL, GRAD_ATOL)


def _full_batch(b=2, t=20, text_len=7, lyric_len=9, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    batch = dict(
        target_latents=f32(b, t, 64), src_latents=f32(b, t, 64), chunk_masks=np.ones((b, t, 64), np.float32),
        attention_mask=np.ones((b, t), np.int32), text_hidden_states=f32(b, text_len, TINY["text_hidden_dim"]),
        text_attention_mask=np.ones((b, text_len), np.int32),
        lyric_hidden_states=f32(b, lyric_len, TINY["text_hidden_dim"]),
        lyric_attention_mask=np.ones((b, lyric_len), np.int32),
        refer_packed=f32(b, TINY["timbre_fix_frame"], JCFG.timbre_hidden_dim), refer_order_mask=np.arange(b),
        is_covers=np.array([0, 1], np.int32), silence_latent=f32(1, t, 64),
    )
    batch["attention_mask"][1, t - 3:] = 0
    batch["text_attention_mask"][1, text_len - 2:] = 0
    return batch


def _lora_or_full(jp, tp, mode):
    """(JAX trainable, port trainable, JAX base, port base, step kwargs): the
    whole model's factors over its full paths, or the whole model."""
    if mode == "lora":
        fac = {f"decoder/{p}": v for p, v in _factors(jp, "lora", seed=3).items()}
        return fac, _t(fac), jp, tp, dict(lora_alpha=8.0, lora_rank=4)
    return jp, tp, None, None, {}


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_flow_matching_loss_grads_match_jax(models, mode):
    """`flow_matching_loss` (condition encoders included) and its gradients
    over the adapter's factors, or over every parameter of the model."""
    jp, tp = models
    j_train, t_train, j_base, t_base, kw = _lora_or_full(jp, tp, mode)
    batch = _full_batch()
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, 2, batch["target_latents"].shape, mu=JCFG.timestep_mu, sigma=JCFG.timestep_sigma)

    def j_loss(tr):
        params = jlora.apply_lora(j_base, tr, alpha=8.0, rank=4) if j_base is not None else tr
        return jts.flow_matching_loss(params, JCFG, jax.tree.map(jnp.asarray, batch), key, cfg_ratio=0.5)

    tb = ttr.to_device_batch(batch, "cpu")

    def t_loss(tr):
        params = t_apply_lora(t_base, tr, alpha=8.0, rank=4) if t_base is not None else tr
        return tts.flow_matching_loss(params, TCFG, tb, cfg_ratio=0.5, draws=draws)

    loss_j, g_j = jax.jit(jax.value_and_grad(j_loss))(j_train)
    loss_t, g_t = tts.value_and_grad(t_loss, t_train)
    _close(loss_t, loss_j, 1e-5, what="loss")
    _close_trees(g_t, g_j, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_train_step_matches_jax(models, mode):
    """Two `make_train_step` updates (the first at learning rate 0), LoRA mode
    and full-parameter mode: the losses and the optimizer's moments; in LoRA
    mode the updated factors too. (In full mode some parameters get gradients
    at rounding level, and Adam turns those into updates of up to ±lr whatever
    their size, so there the moments, linear and quadratic in the gradient,
    carry the comparison.)"""
    jp, tp = models
    j_train, t_train, j_base, t_base, kw = _lora_or_full(jp, tp, mode)
    batch = _full_batch()
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, 2, batch["target_latents"].shape, mu=JCFG.timestep_mu, sigma=JCFG.timestep_sigma)
    state_j, tx_j = jts.create_train_state(j_train, learning_rate=1e-2, warmup_steps=1, total_steps=10)
    state_t, tx_t = tts.create_train_state(t_train, learning_rate=1e-2, warmup_steps=1, total_steps=10)
    step_j = jts.make_train_step(JCFG, tx_j, lora_base=j_base, cfg_ratio=0.5, donate=False, **kw)
    step_t = tts.make_train_step(TCFG, tx_t, lora_base=t_base, cfg_ratio=0.5, **kw)
    tb = ttr.to_device_batch(batch, "cpu")
    p_j, o_j = state_j.params, state_j.opt_state
    p_t, o_t = state_t.params, state_t.opt_state
    for i in range(2):
        p_j, o_j, loss_j, fin_j = step_j(p_j, o_j, jax.tree.map(jnp.asarray, batch), key)
        p_t, o_t, loss_t, fin_t = step_t(p_t, o_t, tb, draws=draws)
        assert bool(fin_j) and fin_t
        _close(loss_t, loss_j, 1e-5, what=f"loss {i}")
    if mode == "lora":
        _close_trees(p_t, p_j, STEP_RTOL)
    _close_trees(o_t["adam"]["mu"], o_j[1][0].mu, GRAD_RTOL, GRAD_ATOL)
    _close_trees(o_t["adam"]["nu"], o_j[1][0].nu, 2 * GRAD_RTOL, GRAD_ATOL**2)
    assert int(o_t["adam"]["count"]) == int(o_j[1][0].count) == 2
    assert int(o_t["schedule"]["count"]) == int(o_j[1][2].count) == 2


def test_train_step_guard_keeps_params_and_state(models):
    """A non-finite loss leaves the parameters and the whole optimizer state
    as they were (JAX's make_train_step: `where(finite, new, old)`)."""
    jp, tp = models
    fac = {f"decoder/{p}": v for p, v in _t(_factors(jp, "lora", seed=4)).items()}
    state, tx = tts.create_train_state(fac, learning_rate=1e-2, warmup_steps=1)
    step = tts.make_train_step(TCFG, tx, lora_base=tp, lora_alpha=8.0, lora_rank=4)
    batch = ttr.to_device_batch(_full_batch(), "cpu")
    batch["target_latents"][0, 3, 5] = float("nan")
    p, o, loss, finite = step(state.params, state.opt_state, batch, torch.Generator().manual_seed(0))
    assert not finite and not bool(torch.isfinite(loss))
    assert p is state.params and o is state.opt_state


# ---------------------------------------------------------------------------
# The optimizer against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("every_k", [1, 2])
def test_optim_matches_optax(every_k):
    """Five updates of the chain (MultiSteps(2) too), state leaf by leaf:
    warmup from lr 0 (the first update leaves the parameters), gradients above
    and below the clip norm in turn."""
    rng = np.random.default_rng(every_k)
    params = {p: {"a": rng.standard_normal((6, 3)).astype(np.float32),
                  "b": rng.standard_normal((3, 5)).astype(np.float32)} for p in ("x/0", "x/1", "y")}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.01))
    if every_k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=every_k)
    opt = optim.make_optimizer(1e-2, warmup_steps=2, total_steps=6, every_k=every_k)
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    js, ts = tx.init(jp), opt.init(tp)
    first = None
    for i in range(5):
        scale = 3.0 if i % 2 == 0 else 0.01  # global norm above, then below, max_norm 1
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32), params)
        u_j, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u_j)
        u_t, ts = opt.update(_t(g), ts, tp)
        tp = optim.apply_updates(tp, u_t)
        if first is None:
            first = optim.tree_leaves(u_t)
        _close_trees(tp, jp, OPT_RTOL)
    assert all(float(u.abs().max()) == 0.0 for u in first)  # lr 0 at the first update
    if every_k == 1:
        leaves_j = jax.tree.leaves(js)  # adam (count, mu, nu), schedule count
        leaves_t = [ts["adam"]["count"], *optim.tree_leaves(ts["adam"]["mu"]),
                    *optim.tree_leaves(ts["adam"]["nu"]), ts["schedule"]["count"]]
    else:
        leaves_j = jax.tree.leaves(js)  # mini_step, gradient_step, inner, acc_grads
        inner = ts["inner"]
        leaves_t = [ts["mini_step"], ts["gradient_step"], inner["adam"]["count"],
                    *optim.tree_leaves(inner["adam"]["mu"]), *optim.tree_leaves(inner["adam"]["nu"]),
                    inner["schedule"]["count"], *optim.tree_leaves(ts["acc_grads"])]
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        if a.dtype == torch.int32:
            assert int(a) == int(b)
        else:
            _close(a, b, OPT_RTOL)


def test_schedule_and_clip_formulas():
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10)
    for c in range(12):
        assert abs(float(sched(c)) - float(ref(c))) <= 1e-10, c
    assert float(sched(0)) == 0.0
    with pytest.raises(ValueError):
        optim.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 5)


# ---------------------------------------------------------------------------
# The trainer against JAX's
# ---------------------------------------------------------------------------


def _write_dataset(path, n=3, t=20, l=12, seed=0):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        ti, li = t - 2 * i, l - i
        sample = {
            "target_latents": rng.standard_normal((ti, 64)).astype(np.float32),
            "encoder_hidden_states": rng.standard_normal((li, TINY["hidden_size"])).astype(np.float32),
            "encoder_attention_mask": np.ones((li,), np.int32),
            "context_latents": rng.standard_normal((ti, 128)).astype(np.float32),
            "attention_mask": np.ones((ti,), np.int32),
        }
        tds.save_sample(os.path.join(path, f"s{i}.npz"), sample)
        entries.append({"file": f"s{i}.npz"})
    tds.write_manifest(str(path), entries)
    return str(path)


def _trainers(models, out_j, out_t, **tkw):
    jp, tp = models
    lcfg = dict(rank=4, alpha=8.0)
    base = dict(learning_rate=1e-2, warmup_steps=1, max_steps=3, checkpoint_every=100, log_every=1, cfg_ratio=0.5)
    base.update(tkw)
    tj = jtr.LoRATrainer(jp, JCFG, jtr.LoRAConfig(**lcfg), jtr.TrainingConfig(output_dir=out_j, **base))
    tt = ttr.LoRATrainer(tp, TCFG, ttr.LoRAConfig(**lcfg), ttr.TrainingConfig(output_dir=out_t, **base))
    # JAX's initial factors (its init draws from a JAX key), B made nonzero
    # so the first steps move every factor.
    rng = np.random.default_rng(5)
    for p in tj.lora:
        tj.lora[p]["b"] = jnp.asarray((rng.standard_normal(tj.lora[p]["b"].shape) * 0.1).astype(np.float32))
    tt.lora = _t(tj.lora)
    tj.opt_state, tt.opt_state = tj.tx.init(tj.lora), tt.tx.init(tt.lora)
    return tj, tt


def _batches(ds_dir, nan_at=None):
    out = []
    for i, b in enumerate(tds.PreprocessedDataset(ds_dir).batches(2, shuffle=False, pad_multiple=8)):
        if i == 4:
            break
        if i == nan_at:
            b = dict(b, target_latents=b["target_latents"].copy())
            b["target_latents"][0, 2, 1] = np.nan
        out.append(b)
    return out


def _opt_leaves_t(state, every_k):
    inner = state if every_k == 1 else state["inner"]
    head = [] if every_k == 1 else [state["mini_step"], state["gradient_step"]]
    tail = [] if every_k == 1 else optim.tree_leaves(state["acc_grads"])
    return head + [inner["adam"]["count"], *optim.tree_leaves(inner["adam"]["mu"]),
                   *optim.tree_leaves(inner["adam"]["nu"]), inner["schedule"]["count"]] + tail


def _assert_opt_close(state_t, state_j, every_k):
    lt, lj = _opt_leaves_t(state_t, every_k), jax.tree.leaves(state_j)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        if a.dtype == torch.int32:
            assert int(a) == int(b)
        else:
            _close(a, b, STEP_RTOL, 1e-12)


@pytest.mark.parametrize("case", ["plain", "multisteps", "nonfinite"])
def test_trainer_steps_match_jax(models, tmp_path, case):
    """Three `LoRATrainer.train` steps with JAX's draws: the losses, the
    factors and the whole optimizer state against JAX's trainer; with
    MultiSteps(2); and with a NaN in the second batch (that step's factors
    kept, its optimizer update taken with zero gradients, as JAX does)."""
    every_k = 2 if case == "multisteps" else 1
    ds_dir = _write_dataset(tmp_path / "data")
    batches = _batches(ds_dir, nan_at=1 if case == "nonfinite" else None)
    tj, tt = _trainers(models, str(tmp_path / "j"), str(tmp_path / "t"), gradient_accumulation_steps=every_k)
    draws = _trainer_draws(0, 3, 2, batches[0]["target_latents"].shape)
    before = {p: {k: v.clone() for k, v in ab.items()} for p, ab in tt.lora.items()}
    out_j = list(tj.train(iter(batches)))
    out_t = list(tt.train(iter(batches), draws=draws))
    assert [s for s, _, _ in out_t] == [s for s, _, _ in out_j] == [1, 2, 3]
    for (_, lt, _), (_, lj, _) in zip(out_t, out_j):
        assert (lt is None) == (lj is None)
        if lt is not None:
            assert abs(lt - lj) <= 1e-5 * abs(lj)
    _close_trees(tt.lora, tj.lora, STEP_RTOL)
    _assert_opt_close(tt.opt_state, tj.opt_state, every_k)
    assert tt.nonfinite_steps == tj.nonfinite_steps == (1 if case == "nonfinite" else 0)
    if case == "multisteps":
        assert int(tt.opt_state["gradient_step"]) == 1 and int(tt.opt_state["mini_step"]) == 1
    if case == "nonfinite":
        # Step 2 kept the factors of step 1: step 1 had lr 0, so they are the initial ones.
        with open(os.path.join(tmp_path, "t", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert rows[1]["loss"] is None and rows[1]["nonfinite_steps"] == 1
        assert out_t[1][1] is None


def test_nonfinite_step_keeps_the_factors(models, tmp_path):
    jp, tp = models
    tt = ttr.LoRATrainer(tp, TCFG, ttr.LoRAConfig(rank=4, alpha=8.0), ttr.TrainingConfig(
        output_dir=str(tmp_path), learning_rate=1e-2, warmup_steps=0, max_steps=2, log_every=1))
    batch = _batch()
    nan = dict(batch, target_latents=batch["target_latents"].copy())
    nan["target_latents"][1, 0, 0] = np.inf
    steps = list(tt.train(iter([batch])))
    after_one = {p: {k: v.clone() for k, v in ab.items()} for p, ab in tt.lora.items()}
    count = int(tt.opt_state["adam"]["count"])
    tt.tcfg.max_steps = 2
    steps += list(tt.train(iter([nan])))
    assert [s for s, _, _ in steps] == [1, 2] and steps[1][1] is None
    assert tt.nonfinite_steps == 1
    for p, ab in tt.lora.items():
        for k, v in ab.items():
            assert torch.equal(v, after_one[p][k])
    assert int(tt.opt_state["adam"]["count"]) == count + 1  # the optimizer's step was taken, with zero gradients
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1] == {**rows[-1], "step": 2, "loss": None, "nonfinite_steps": 1}


def test_checkpoint_round_trip_and_resume_match_jax(models, tmp_path):
    """A saved checkpoint loads back bit for bit; a run resumed from step 2
    (max_steps 4) ends where JAX's resumed run ends with the same draws (each
    `train` call re-keys at seed + 1, so the resumed steps redraw from the
    start, as JAX's do)."""
    ds_dir = _write_dataset(tmp_path / "data")
    batches = _batches(ds_dir)
    tj, tt = _trainers(models, str(tmp_path / "j"), str(tmp_path / "t"), max_steps=2)
    draws = _trainer_draws(0, 2, 2, batches[0]["target_latents"].shape)
    list(tj.train(iter(batches)))
    list(tt.train(iter(batches), draws=draws))
    ckpt_t = os.path.join(tmp_path, "t", "checkpoints", "step_2.pt")
    assert os.path.exists(ckpt_t)

    jp, tp = models
    again = ttr.LoRATrainer(tp, TCFG, ttr.LoRAConfig(rank=4, alpha=8.0), ttr.TrainingConfig(output_dir=str(tmp_path / "t")))
    again.load_checkpoint(ckpt_t)
    assert again.step == 2
    for a, b in zip(optim.tree_leaves(again.lora), optim.tree_leaves(tt.lora)):
        assert torch.equal(a, b)
    for a, b in zip(optim.tree_leaves(again.opt_state), optim.tree_leaves(tt.opt_state)):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)

    kw = dict(learning_rate=1e-2, warmup_steps=1, max_steps=4, checkpoint_every=100, log_every=1, cfg_ratio=0.5)
    rj = jtr.LoRATrainer(jp, JCFG, jtr.LoRAConfig(rank=4, alpha=8.0), jtr.TrainingConfig(
        output_dir=str(tmp_path / "j"), resume_from=os.path.join(tmp_path, "j", "checkpoints", "step_2"), **kw))
    rt = ttr.LoRATrainer(tp, TCFG, ttr.LoRAConfig(rank=4, alpha=8.0), ttr.TrainingConfig(
        output_dir=str(tmp_path / "t"), resume_from=ckpt_t, **kw))
    out_j = list(rj.train(iter(batches[2:])))
    out_t = list(rt.train(iter(batches[2:]), draws=_trainer_draws(0, 2, 2, batches[0]["target_latents"].shape)))
    assert [s for s, _, _ in out_t] == [s for s, _, _ in out_j] == [3, 4]
    _close_trees(rt.lora, rj.lora, STEP_RTOL)
    _assert_opt_close(rt.opt_state, rj.opt_state, 1)


def test_adapter_npz_reads_across_packages(models, tmp_path):
    """The port's adapter.npz through JAX's `load_adapter` and JAX's through
    the port's: every factor bit for bit, the same meta."""
    ds_dir = _write_dataset(tmp_path / "data")
    batches = _batches(ds_dir)
    tj, tt = _trainers(models, str(tmp_path / "j"), str(tmp_path / "t"), max_steps=2)
    list(tj.train(iter(batches)))
    list(tt.train(iter(batches)))
    for src, reader, other in ((tmp_path / "t", jtr.load_adapter, tt.lora), (tmp_path / "j", ttr.load_adapter, tj.lora)):
        lora, meta = reader(str(src / "adapter.npz"))
        assert meta == {"rank": 4, "alpha": 8.0, "adapter_type": "lora", "step": 2}
        assert sorted(lora) == sorted(other)
        for p in other:
            for k in other[p]:
                np.testing.assert_array_equal(_np(lora[p][k]), _np(other[p][k]))


@pytest.mark.parametrize("kind", ["lora", "lokr"])
def test_export_merged_matches_jax(models, tmp_path, kind):
    jp, tp = models
    lcfg = dict(rank=2 if kind == "lokr" else 4, alpha=8.0, adapter_type=kind, lokr_factor=4)
    tj = jtr.LoRATrainer(jp, JCFG, jtr.LoRAConfig(**lcfg), jtr.TrainingConfig(output_dir=str(tmp_path / "j")))
    tt = ttr.LoRATrainer(tp, TCFG, ttr.LoRAConfig(**lcfg), ttr.TrainingConfig(output_dir=str(tmp_path / "t")))
    tj.lora = _factors(jp, kind, seed=9)
    tt.lora = _t(tj.lora)
    mj, mt = tj.export_merged(), tt.export_merged()
    assert mt["encoder"] is tp["encoder"]  # only the decoder changes
    for path in tt.lora:
        node_j, node_t = mj["decoder"], mt["decoder"]
        for part in path.split("/"):
            node_j = node_j[int(part)] if isinstance(node_j, list) else node_j[part]
            node_t = node_t[int(part)] if isinstance(node_t, list) else node_t[part]
        _close(node_t, node_j, 1e-6, what=path)


# ---------------------------------------------------------------------------
# Dataset, estimate, presets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(batch_size=2, shuffle=False, pad_multiple=8),
                                dict(batch_size=2, shuffle=True, seed=3, epochs=2),
                                dict(batch_size=9, shuffle=False, epochs=1)])
def test_dataset_batches_match_jax(tmp_path, kw):
    ds_dir = _write_dataset(tmp_path / "data", n=5)
    kw = dict(kw)
    bs = kw.pop("batch_size")
    got = list(tds.PreprocessedDataset(ds_dir).batches(bs, **{"epochs": 2, **kw}))
    want = list(jds.PreprocessedDataset(ds_dir).batches(bs, **{"epochs": 2, **kw}))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_dataset_listing_and_errors(tmp_path):
    ds_dir = _write_dataset(tmp_path / "data", n=2)
    os.remove(os.path.join(ds_dir, "manifest.json"))
    assert len(tds.PreprocessedDataset(ds_dir)) == 2  # the directory's .npz files
    empty = tmp_path / "empty"
    empty.mkdir()
    tds.write_manifest(str(empty), [])
    with pytest.raises(ValueError, match="no samples"):
        tds.PreprocessedDataset(str(empty))
    np.savez(os.path.join(ds_dir, "bad.npz"), target_latents=np.zeros((4, 64), np.float32))
    tds.write_manifest(ds_dir, [{"file": "bad.npz"}])
    with pytest.raises(KeyError, match="missing keys"):
        tds.PreprocessedDataset(ds_dir).load(0)


@pytest.mark.parametrize("granularity", ["module", "layer"])
def test_run_estimation_matches_jax(models, tmp_path, granularity):
    """The ranking JAX's `run_estimation` returns, with the same draws; the
    sensitivities (sums of gradient norms) within the gradient tolerance."""
    jp, tp = models
    ds_dir = _write_dataset(tmp_path / "est", n=2, t=16, l=8)
    batches = list(tds.PreprocessedDataset(ds_dir).batches(1, shuffle=False, epochs=1))
    key, draws = jax.random.PRNGKey(0), []
    for b in batches:
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, 1, b["target_latents"].shape))
    kw = dict(num_batches=2, top_k=16 if granularity == "module" else 8, granularity=granularity, cfg_ratio=0.0)
    want = jest.run_estimation(jp, JCFG, iter(batches), **kw)
    got = test_.run_estimation(tp, TCFG, iter(batches), draws=draws, **kw)
    assert [r["module"] for r in got] == [r["module"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["sensitivity"] - w["sensitivity"]) <= GRAD_RTOL * w["sensitivity"] + GRAD_ATOL
    with pytest.raises(ValueError):
        test_.run_estimation(tp, TCFG, iter(batches), granularity="head")


@pytest.mark.parametrize("name", ["v5e_16gb", "v5p_95gb", "h100_80gb"])
def test_load_preset(name):
    from acestep_tpu.training.presets import list_presets as j_list, load_preset as j_load

    p = load_preset(name)
    assert {"description", "rank", "alpha", "learning_rate", "batch_size", "max_steps", "checkpoint_every",
            "warmup_steps"} <= set(p)
    if name in j_list():
        assert p == j_load(name)
    assert name in list_presets()
    ttr.TrainingConfig(**{k: v for k, v in p.items() if k not in ("description", "rank", "alpha")})


def test_timestep_samplers_and_config_check():
    gen = torch.Generator().manual_seed(0)
    from acestep_tpu_torch.models.dit import SHIFT_TIMESTEPS

    schedule = {float(np.float32(v)) for v in SHIFT_TIMESTEPS[3.0]}
    seen = {float(v) for v in tts.sample_discrete_timesteps(gen, 4096)}
    assert seen == schedule
    tc = tts.sample_timesteps(gen, 4096)
    assert len(torch.unique(tc)) > 4000 and not ({float(v) for v in tc} & schedule)
    assert bool(((tc > 0) & (tc < 1)).all())
    for bad in ("v1-discrete", "V1_discrete", "discrete", ""):
        with pytest.raises(ValueError, match="timestep_sampling"):
            ttr.TrainingConfig(timestep_sampling=bad)
    d = tts.sample_draws(torch.Generator().manual_seed(1), (3, 10, 64), discrete=True)
    assert d["t"].shape == (3,) and d["noise"].shape == (3, 10, 64) and d["u"].shape == (3,)


def test_cli_train_and_estimate_on_the_cpu(tmp_path, monkeypatch):
    """`cli train` and `cli estimate` end to end with `--device cpu`, on a
    handler of the TINY DiT (the handler class patched to build it): the
    trainer writes its adapter, checkpoint and metrics; the estimate its
    ranking."""
    from acestep_tpu_torch import cli
    from acestep_tpu_torch.config import OobleckConfig, Qwen3Config
    from acestep_tpu_torch.pipeline import handler as th
    from test_torch_pipeline import _TEXT, _VAE

    real = th.AceStepHandler
    monkeypatch.setattr(th, "AceStepHandler", lambda device=None: real(
        TCFG, OobleckConfig(**_VAE), Qwen3Config(**_TEXT), dtype=torch.float32, device=device))
    ds_dir = _write_dataset(tmp_path / "data")
    out = tmp_path / "run"
    assert cli.main(["train", "--random-init", "--device", "cpu", "--dataset-dir", ds_dir, "--output-dir", str(out),
                     "--max-steps", "2", "--rank", "4", "--alpha", "8", "--batch-size", "2"]) == 0
    lora, meta = ttr.load_adapter(str(out / "adapter.npz"))
    assert meta == {"rank": 4, "alpha": 8.0, "adapter_type": "lora", "step": 2} and len(lora) == 22
    assert (out / "checkpoints" / "step_2.pt").exists()
    assert (out / "metrics.jsonl").exists()  # log_every 10: no row in two steps
    ranks = tmp_path / "ranks.json"
    assert cli.main(["estimate", "--random-init", "--device", "cpu", "--dataset-dir", ds_dir, "--num-batches", "2",
                     "--top-k", "5", "--json-out", str(ranks)]) == 0
    with open(ranks) as f:
        got = json.load(f)
    assert len(got) == 5 and all(r["module"].startswith("layers.") for r in got)
    assert got == sorted(got, key=lambda r: r["sensitivity"], reverse=True)
