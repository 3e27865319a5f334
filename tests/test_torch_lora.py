"""LoRA and LoKr adapters of the port against the JAX package (CPU).

`training/lora.py` (apply, merge, LoKr, init), `training/trainer.load_adapter`,
`pipeline/lora_manager.LoRARegistry` against JAX's serving path
(`apply_lora_stacked` on the stacked decoder), and the handler's LoRA
lifecycle end to end against the JAX handler with the same adapter file.

Integer-valued factors make every product exact in any order of sums, so
there the port equals JAX bit for bit. With gaussian factors the products'
sums may run in another order (JAX's fp32 product on the CPU is itself a unit
in the last place away from the float64 one), and a sum with cancellation
errs by units of its largest term, not of its result. So an element may
differ by two units in the last place (ulp, in the kernel's dtype) of
s·(|A|@|B|) and one of the sum: |got - want| <= 2 ulp(s·|A|@|B|) + ulp(want).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
from acestep_tpu.config import AceStepConfig as JA
from acestep_tpu.params import init_acestep_params as j_init
from acestep_tpu.pipeline import lora_manager as jlm
from acestep_tpu.training import lora as jlora
from acestep_tpu.training.trainer import load_adapter as j_load_adapter
from acestep_tpu_torch.config import AceStepConfig as TA
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.pipeline import lora_manager as tlm
from acestep_tpu_torch.training import lora as tlora
from acestep_tpu_torch.training.trainer import load_adapter as t_load_adapter
from test_torch_pipeline import _DIT, LATENT_TOL, handlers  # noqa: F401 — the fixture

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32), np.float32)


def _ulp(x: np.ndarray, tdtype) -> np.ndarray:
    """One unit in the last place of |x| in the kernel's dtype."""
    mant = 7 if tdtype == torch.bfloat16 else 23
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - mant)


def _decoders(dtype_name: str):
    """The tiny DiT decoder of both packages from one JAX init: JAX's in the
    list layout and stacked (its serving layout), the port's as a list."""
    jdt, tdt = DTYPES[dtype_name]
    cfg = JA(**_DIT)
    params = j_init(jax.random.PRNGKey(0), cfg, jdt)
    stacked = jdit.stack_acestep_params(params, cfg)
    port = from_jax_params(jax.tree.map(np.asarray, {"decoder": params["decoder"]}), TA(**_DIT))["decoder"]
    return params["decoder"], stacked["decoder"], port, tdt


def _factors(paths_shapes, rank: int, kind: str, seed: int):
    """{path: {"a", "b"}} as float32 numpy: integer-valued or gaussian."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, (d_in, d_out) in paths_shapes.items():
        if kind == "int":
            a = rng.integers(-3, 4, (d_in, rank)).astype(np.float32)
            b = rng.integers(-3, 4, (rank, d_out)).astype(np.float32) / 64.0
        else:
            a = (rng.standard_normal((d_in, rank)) / rank).astype(np.float32)
            b = (rng.standard_normal((rank, d_out)) * 0.05).astype(np.float32)
        out[path] = {"a": a, "b": b}
    return out


def _target_shapes(tree):
    return {p: tuple(leaf.shape) for p, leaf in tlora._targets(tree, tlora.DEFAULT_TARGETS)}


def _mag(factors, s: float):
    """{path: s·(|A|@|B|)} in float64: the size of the terms a delta sums."""
    return {p: abs(s) * (np.abs(f["a"]).astype(np.float64) @ np.abs(f["b"]).astype(np.float64))
            for p, f in factors.items()}


def _assert_trees_close(got_tree, want_tree, paths, tdt, exact: bool, mag=None):
    for path in paths:
        parts = path.split("/")
        got = _np(tlora.get_path(got_tree, parts))
        want = _np(tlora.get_path(want_tree, parts))
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            bound = 2 * _ulp(mag[path], tdt) + _ulp(want, tdt)
            assert (np.abs(got - want) <= bound).all(), (path, float((np.abs(got - want) / bound).max()))


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_apply_merge_and_lokr_match_jax(dtype_name, kind):
    jdec, _, tdec, tdt = _decoders(dtype_name)
    shapes = _target_shapes(tdec)
    ab = _factors(shapes, 4, kind, seed=1)
    jab = {p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in ab.items()}
    tab = {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in ab.items()}
    for fn in ("apply_lora", "merge_lora"):
        want = getattr(jlora, fn)(jdec, jab, alpha=8.0, rank=4, scale=0.75)
        got = getattr(tlora, fn)(tdec, tab, alpha=8.0, rank=4, scale=0.75)
        _assert_trees_close(got, want, shapes, tdt, exact=kind == "int", mag=_mag(ab, 0.75 * 8.0 / 4))
        assert got["layers"][0]["self_attn"]["q_norm"] is tdec["layers"][0]["self_attn"]["q_norm"]

    rng = np.random.default_rng(2)
    lokr = {}
    for path, (d_in, d_out) in shapes.items():
        a1, b1 = tlora._kron_factors(d_in), tlora._kron_factors(d_out)
        assert (a1, b1) == (jlora._kron_factors(d_in), jlora._kron_factors(d_out))
        draw = (lambda s: rng.integers(-3, 4, s).astype(np.float32)) if kind == "int" else \
            (lambda s: rng.standard_normal(s).astype(np.float32) * 0.1)
        lokr[path] = {"w1": draw((a1, b1)), "w2a": draw((d_in // a1, 3)), "w2b": draw((3, d_out // b1)) / 64.0}
    want = jlora.apply_lokr(jdec, {p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in lokr.items()},
                            scale=0.5)
    got = tlora.apply_lokr(tdec, {p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in lokr.items()},
                           scale=0.5)
    mag = {p: 0.5 * np.kron(np.abs(f["w1"]).astype(np.float64), _mag({p: {"a": f["w2a"], "b": f["w2b"]}}, 1.0)[p])
           for p, f in lokr.items()}
    _assert_trees_close(got, want, shapes, tdt, exact=kind == "int", mag=mag)


def test_init_params_paths_match_jax():
    """The same 22 paths on the tiny 2-layer decoder (2 × (8 attention + 3
    MLP projections)); B is zero, so the adapted tree equals the base; LoKr
    starts from the identity too."""
    jdec, _, tdec, _ = _decoders("fp32")
    want = jlora.init_lora_params(jax.random.PRNGKey(0), jdec, rank=8)
    got = tlora.init_lora_params(0, tdec, rank=8)
    assert len(got) == 22 and sorted(got) == sorted(want)
    for p in got:
        assert tuple(got[p]["a"].shape) == want[p]["a"].shape and tuple(got[p]["b"].shape) == want[p]["b"].shape
        assert not got[p]["b"].any() and got[p]["a"].any()
        assert abs(float(got[p]["a"].std()) - 1 / 8) < 0.05
    adapted = tlora.apply_lora(tdec, got, alpha=8.0, rank=8)
    _assert_trees_close(adapted, tdec, got, torch.float32, exact=True)
    lokr = tlora.init_lokr_params(torch.Generator().manual_seed(3), tdec)
    assert sorted(lokr) == sorted(jlora.init_lokr_params(jax.random.PRNGKey(0), jdec))
    _assert_trees_close(tlora.apply_lokr(tdec, lokr), tdec, lokr, torch.float32, exact=True)


def _save_npz(path, factors, meta):
    np.savez(path, **{f"{p}|{k}": v for p, f in factors.items() for k, v in f.items()},
             __meta__=np.asarray(json.dumps(meta)))
    return str(path)


def test_load_adapter_matches_jax(tmp_path):
    ab = _factors({"layers/0/mlp/up_proj/kernel": (64, 128), "condition_embedder/kernel": (32, 64)}, 4, "gauss", 5)
    meta = {"rank": 4, "alpha": 8.0, "adapter_type": "lora", "step": 12}
    path = _save_npz(tmp_path / "adapter.npz", ab, meta)
    want, want_meta = j_load_adapter(path)
    got, got_meta = t_load_adapter(path)
    assert got_meta == want_meta == meta
    assert sorted(got) == sorted(want)
    for p in got:
        assert sorted(got[p]) == sorted(want[p]) == ["a", "b"]
        for k in got[p]:
            assert got[p][k].dtype == torch.float32 and got[p][k].device.type == "cpu"
            np.testing.assert_array_equal(got[p][k].numpy(), np.asarray(want[p][k]))


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_registry_matches_jax_stacked(tmp_path, dtype_name, kind):
    """Two adapters through both registries: one scaled by 0.5 (every layer
    and a path outside the layers), one disabled (layer 1 only); then the
    disabled one enabled, so both apply in load order. The port's per-layer
    application equals JAX's `apply_lora_stacked` on the stacked tree."""
    _, jstacked, tdec, tdt = _decoders(dtype_name)
    shapes = _target_shapes(tdec)
    first = _factors({**shapes, "condition_embedder/kernel": tuple(tdec["condition_embedder"]["kernel"].shape)},
                     4, kind, seed=7)
    second = _factors({p: s for p, s in shapes.items() if p.startswith("layers/1/")}, 2, kind, seed=8)
    p1 = _save_npz(tmp_path / "one.npz", first, {"rank": 4, "alpha": 8.0})
    p2 = _save_npz(tmp_path / "two.npz", second, {"rank": 2, "alpha": 2.0})
    jr, tr = jlm.LoRARegistry(), tlm.LoRARegistry()
    for r in (jr, tr):
        r.load("one", p1)
        r.load("two", p2)
        r.set_scale("one", 0.5)
        assert r.toggle("two", False) is False
    assert tr.status() == jr.status()
    paths = list(first)
    for round_ in range(2):
        if round_:
            for r in (jr, tr):
                assert r.toggle("two") is True
        want = from_jax_params(jax.tree.map(np.asarray, {"decoder": jr.effective_decoder(jstacked, 2)}),
                               TA(**_DIT))["decoder"]
        got = tr.effective_decoder(tdec)
        mag = _mag(first, 0.5 * 8.0 / 4)
        if round_:
            for p, m in _mag(second, 2.0 / 2).items():
                mag[p] = mag[p] + m
        _assert_trees_close(got, want, paths, tdt, exact=kind == "int", mag=mag)
        changed = _np(tlora.get_path(got, paths[0].split("/"))) - _np(tlora.get_path(tdec, paths[0].split("/")))
        assert np.abs(changed).max() > 0


def test_registry_cache():
    """The merged decoder is cached until an adapter changes (the dirty
    flag), the base tree changes (compared with `is`: an equal copy is
    another tree), or `invalidate_cache`; disabled adapters leave the base
    tree itself."""
    _, _, tdec, _ = _decoders("fp32")
    lora = {p: {"a": torch.ones(s[0], 2), "b": torch.ones(2, s[1])} for p, s in _target_shapes(tdec).items()}
    r = tlm.LoRARegistry()
    r._adapters["x"] = {"lora": lora, "meta": {"rank": 2, "alpha": 2.0}, "enabled": True, "scale": 1.0, "path": "-"}
    first = r.effective_decoder(tdec)
    assert first is not tdec and r.effective_decoder(tdec) is first
    r.set_scale("x", 1.0)  # the same value still marks the cache dirty
    second = r.effective_decoder(tdec)
    assert second is not first and r.effective_decoder(tdec) is second
    copy = dict(tdec)
    third = r.effective_decoder(copy)
    assert third is not second and r.effective_decoder(copy) is third
    r.invalidate_cache()
    assert r._cache is None and r._cache_base is None
    assert r.effective_decoder(copy) is not third
    r.toggle("x", False)
    assert r.effective_decoder(tdec) is tdec
    assert r.unload("x") and not r.unload("x") and r.status() == {}
    with pytest.raises(KeyError):
        r.toggle("x")
    with pytest.raises(KeyError):
        r.set_scale("x", 2.0)


def test_generate_music_with_adapter_matches_jax(handlers, tmp_path):  # noqa: F811
    """One adapter file through both handlers: the adapted request equals
    JAX's at fp32 (the pipeline tests' tolerance) and differs from the base;
    toggled off it is the base request bit for bit; unloaded, the handler
    runs the base tree again. `initialize_service` drops the merged cache."""
    jh, th = handlers
    shapes = _target_shapes(th.params["decoder"])
    path = _save_npz(tmp_path / "adapter.npz", _factors(shapes, 4, "gauss", seed=11),
                     {"rank": 4, "alpha": 4.0, "adapter_type": "lora", "step": 1})
    kw = dict(captions=["warm lofi beat", "slow piano ballad"], lyrics=["[Instrumental]", "[Verse]\nhello"],
              batch_size=2, audio_duration=2.0, seeds=[3, 4], use_random_seed=False, normalize_db=-1.0)
    base = th.generate_music(**kw)["latents"]
    assert th._effective_params() is th.params
    assert th.load_lora("style", path) == jh.load_lora("style", path)
    jh.set_lora_scale("style", 0.8)
    th.set_lora_scale("style", 0.8)
    assert th.lora_status() == jh.lora_status()
    want, got = jh.generate_music(**kw), th.generate_music(**kw)
    np.testing.assert_allclose(got["latents"], want["latents"], **LATENT_TOL)
    rel = np.linalg.norm(got["latents"] - base) / np.linalg.norm(base)
    assert rel > 10 * LATENT_TOL["rtol"], rel
    assert th.toggle_lora("style") is False
    np.testing.assert_array_equal(th.generate_music(**kw)["latents"], base)
    assert th.toggle_lora("style") is True
    eff = th._effective_params()["decoder"]
    assert th._effective_params()["decoder"] is eff
    th.initialize_service(random_init=True)
    assert th.lora._cache is None and th.lora._cache_base is None
    assert th._effective_params()["decoder"] is not eff
    assert th.unload_lora("style") and th._effective_params() is th.params
