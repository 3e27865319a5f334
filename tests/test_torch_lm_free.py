"""The planner's free-form APIs in the port vs the JAX package (CPU, fp32).

`sampling.generate_free`, the understand / create_sample / format_sample
APIs on both of their routes (the understand grammar through the DFA loop,
and unconstrained decoding when that grammar does not compile), the grammar
cache, the service's analysis modes and drafts, and `cli generate-examples`.
One tiny planner's JAX init goes into both packages through
`from_jax_params`; decoding is greedy (temperature 0), so both packages must
give the same tokens.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.lm.dfa as jdfa
import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu.service.inference as jservice
import acestep_tpu_torch.lm.dfa as tdfa
import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.pipeline.handler as TH
import acestep_tpu_torch.service.inference as tservice
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu.lm import sampling as jsampling
from acestep_tpu.lm.handler import LLMHandler as JLLM
from acestep_tpu.service.params import GenerationConfig as JConfig, GenerationParams as JParams
from acestep_tpu_torch.config import AceStepConfig as TA, OobleckConfig as TO, Qwen3Config as TQ
from acestep_tpu_torch.lm import sampling as tsampling
from acestep_tpu_torch.lm.handler import LLMHandler as TLLM
from acestep_tpu_torch.params import LM_CONFIGS, from_jax_params
from acestep_tpu_torch.service.params import GenerationConfig as TConfig, GenerationParams as TParams

_LM = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=8)
_DIT = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=1,
    num_attention_pooler_hidden_layers=1, fsq_dim=64, timbre_fix_frame=10,
)
_VAE = dict(
    encoder_hidden_size=128, downsampling_ratios=(2, 4, 4), channel_multiples=(1, 1, 1),
    decoder_channels=16, decoder_input_channels=64, audio_channels=2, sampling_rate=800,
)
BUCKETS = dict(LATENT_BUCKETS=(64, 128, 256), TEXT_BUCKETS=(32, 64), LYRIC_BUCKETS=(32, 64))
CODES = "".join(f"<|audio_code_{i}|>" for i in (5, 9, 13, 40))
# The service drafts and analyses at the APIs' default budget (512 tokens);
# the service tests hand both packages' planners this smaller one instead.
DRAFT_TOKENS = 48
APIS = ("understand_audio_from_codes", "create_sample_from_query", "format_sample_from_input")


def _noise(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def lm_pair():
    """One tiny planner in both packages (untied head), same weights."""
    jcfg, tcfg = JQ(**_LM, tie_word_embeddings=False), TQ(**_LM, tie_word_embeddings=False)
    jh = JLLM(jcfg, dtype=jnp.float32)
    jh.initialize(random_init=True, seed=3)
    th = TLLM(tcfg, dtype=torch.float32, device="cpu")
    th.initialize(random_init=True)
    th.params = from_jax_params(jax.tree.map(np.asarray, jh.params), tcfg)
    return jh, th


def _patch_buckets(mp):
    for mod in (JH, TH):
        for name, val in BUCKETS.items():
            mp.setattr(mod, name, val)


@pytest.fixture(scope="module")
def dit_pair():
    """Both DiT handlers on one set of weights."""
    with pytest.MonkeyPatch.context() as mp:
        _patch_buckets(mp)
        jd = JH.AceStepHandler(JA(**_DIT), JO(**_VAE), JQ(**_LM), dtype=jnp.float32)
        jd.initialize_service(random_init=True)
        td = TH.AceStepHandler(TA(**_DIT), TO(**_VAE), TQ(**_LM), dtype=torch.float32, device="cpu")
        td.initialize_service(random_init=True)
    for name, cfg in (("params", td.config), ("vae_params", td.vae_config), ("text_params", td.text_config)):
        setattr(td, name, from_jax_params(jax.tree.map(np.asarray, getattr(jd, name)), cfg))
    return jd, td


@pytest.fixture
def services(dit_pair, lm_pair, monkeypatch):
    """Both services' handlers, the same injected noise, and both planners'
    draft APIs at `DRAFT_TOKENS`."""
    _patch_buckets(monkeypatch)
    monkeypatch.setattr(jdit, "prepare_noise", lambda shape, seeds, dtype=jnp.bfloat16: jnp.asarray(_noise(shape), dtype))
    monkeypatch.setattr(tdit, "prepare_noise", lambda shape, seeds, dtype=torch.bfloat16, device=None:
                        torch.tensor(_noise(shape), dtype=dtype, device=device))
    for llm in lm_pair:
        for api in ("create_sample_from_query", "format_sample_from_input"):
            monkeypatch.setattr(llm, api, functools.partial(getattr(llm, api), max_new_tokens=DRAFT_TOKENS))
    (jd, td), (jl, tl) = dit_pair, lm_pair
    return (jd, jl), (td, tl)


# ---------------------------------------------------------------------------
# generate_free
# ---------------------------------------------------------------------------


def _prefilled(h, prompts, budget):
    ids, mask, bucket = h._encode_prompts(prompts, budget=budget)
    logits, cache = h._prefill(ids, mask, bucket + budget)
    return logits, cache, mask.sum(axis=1).astype(np.int32)


def test_generate_free_greedy_matches_jax(lm_pair):
    """Two rows, greedy: the same tokens; then with EOS set to a token that
    row 0 emits at step 5, each row stops on its own (per-row `done`), the
    rest of the row is EOS, and the loop ends early."""
    jh, th = lm_pair
    prompts = [th.build_formatted_prompt("calm piano", ""), th.build_formatted_prompt("dark techno", "x")]
    steps = 24

    def both(eos):
        lj, cj, pj = _prefilled(jh, prompts, steps)
        want, _ = jsampling.generate_free(jh.params, jh.config, lj, jnp.asarray(pj), cj, jax.random.PRNGKey(0),
                                          jnp.float32(0.0), max_steps=steps, eos_token=eos, top_k=0, top_p=0.9)
        lt, ct, pt = _prefilled(th, prompts, steps)
        got, n = tsampling.generate_free(th.params, th.config, lt, torch.tensor(pt), ct,
                                         torch.Generator().manual_seed(0), 0.0, max_steps=steps, eos_token=eos,
                                         top_k=0, top_p=0.9)
        return np.asarray(want), got.numpy(), n

    want, got, n = both(2)
    np.testing.assert_array_equal(got, want)
    eos = int(got[0, 5])
    assert eos not in got[0, :5]
    want, got, n = both(eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 5:] == eos).all()
    if (got[1] == eos).any():
        assert n < steps and (got == eos).any(axis=1).all()


# ---------------------------------------------------------------------------
# The free-form APIs and the grammar cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["grammar", "free_env", "free_fallback"])
@pytest.mark.parametrize("api", APIS)
def test_free_form_apis_match_jax(lm_pair, monkeypatch, api, route):
    """Each API gives JAX's text and metadata on each route: the understand
    grammar; unconstrained decoding when the device FSM is switched off; and
    the fallback when the grammar cannot compile (`route` tells them apart)."""
    jh, th = lm_pair
    if route == "free_env":
        monkeypatch.setenv("ACESTEP_TPU_NO_DEVICE_FSM", "1")
    if route == "free_fallback":
        def refuse(*a, **kw):
            raise ValueError("no grammar for this tokenizer")

        monkeypatch.setattr(jdfa, "compile_cot_dfa", refuse)
        monkeypatch.setattr(tdfa, "compile_cot_dfa", refuse)
        for h in (jh, th):
            monkeypatch.setattr(h, "_dfa_cache", {})
    arg = CODES if api == "understand_audio_from_codes" else "a warm lofi beat with rain"
    kw = dict(temperature=0.0, max_new_tokens=96, seed=7)
    want = getattr(jh, api)(arg, **kw)
    got = getattr(th, api)(arg, **kw)
    assert got["route"] == ("grammar" if route == "grammar" else "free")
    assert 0 < got["tokens"] <= 96
    assert got["text"] == want["text"]
    assert got["metadata"] == want["metadata"]
    if route == "grammar":
        assert got["text"].startswith("<think>") and "bpm" in got["metadata"]


def test_free_form_device_errors_propagate(lm_pair, monkeypatch):
    """Only the errors of a tokenizer the grammar cannot use switch to free
    decoding: a RuntimeError (what a CUDA fault raises) propagates."""
    _, th = lm_pair

    def device_fault(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tdfa, "compile_cot_dfa", device_fault)
    monkeypatch.setattr(th, "_dfa_cache", {})
    with pytest.raises(RuntimeError, match="illegal memory access"):
        th.create_sample_from_query("a warm lofi beat", temperature=0.0, max_new_tokens=8, seed=7)


def test_grammar_cache_keeps_cot_and_understand_apart(lm_pair):
    """The CoT grammar (genres skipped, stops at </think>) and the understand
    grammar (genres emitted, free text after) are cached under different
    keys, and each equals the JAX package's tables."""
    jh, th = lm_pair
    th._dfa_cache.clear()
    cot = th._cot_dfa_for(None, 96)
    und = th._cot_dfa_for(None, 96, phase="understand", skip_genres=False)
    assert len(th._dfa_cache) == 2 and und is not cot
    assert th._cot_dfa_for(None, 96) is cot
    assert th._cot_dfa_for(None, 96, phase="understand", skip_genres=False) is und
    assert not np.array_equal(cot[0].finished, und[0].finished) or cot[0].trans.shape != und[0].trans.shape
    for mine, (phase, skip) in ((cot, ("cot", True)), (und, ("understand", False))):
        ref = jh._cot_dfa_for(None, 96, phase=phase, skip_genres=skip)[0]
        for name in ("trans", "alpha_allow", "allow_other", "finished", "prob_end", "alpha_tokens", "vocab_to_sym"):
            np.testing.assert_array_equal(getattr(mine[0], name), getattr(ref, name), err_msg=f"{phase} {name}")


def test_service_wrappers_match_jax(lm_pair):
    jh, th = lm_pair
    kw = dict(temperature=0.0, max_new_tokens=64, seed=2)
    got, want = tservice.understand_music(th, CODES, **kw), jservice.understand_music(jh, CODES, **kw)
    assert got.success and got.to_dict() == want.to_dict()
    for name in ("create_sample", "format_sample"):
        got = getattr(tservice, name)(th, "rainy night jazz", **kw)
        want = getattr(jservice, name)(jh, "rainy night jazz", **kw)
        assert got == want and got["success"]
    bad = tservice.understand_music(None, CODES)
    assert not bad.success and bad.error


# ---------------------------------------------------------------------------
# The service's analysis modes and drafts
# ---------------------------------------------------------------------------


def _both_services(services, params: dict, config: dict, lm=True):
    (jd, jl), (td, tl) = services
    want = jservice.generate_music(jd, jl if lm else None, JParams(**params), JConfig(**config), save_audio=False)
    got = tservice.generate_music(td, tl if lm else None, TParams(**params), TConfig(**config), save_audio=False)
    return got, want


def _same_result(got, want, audio=True):
    assert got.success == want.success, (got.error, want.error)
    assert got.status_message.split(" in ")[0] == want.status_message.split(" in ")[0]
    for key in ("lm_metadata", "lm_draft", "audio_codes"):
        assert (key in got.extra_outputs) == (key in want.extra_outputs), key
        assert got.extra_outputs.get(key) == want.extra_outputs.get(key), key
    assert len(got.audios) == len(want.audios)
    for g, w in zip(got.audios, want.audios):
        assert g["params"] == w["params"] and g["metas"] == w["metas"] and g["key"] == w["key"]
        if audio:
            np.testing.assert_allclose(g["audio"], w["audio"], rtol=0, atol=3)


GREEDY = dict(lm_temperature=0.0, seed=5, duration=2.0, thinking=False)
ONE = dict(batch_size=1, use_random_seed=False)


def test_analysis_modes_match_jax(services, monkeypatch):
    """analysis_only (the CoT metadata, no audio) and full_analysis_only from
    audio codes. The deep analysis pins temperature 0.3 in both services: a
    spy records the call and runs it greedy, so the two can be compared."""
    got, want = _both_services(services, dict(caption="warm piano", lyrics="[Verse]\nla", analysis_only=True,
                                              **GREEDY), ONE)
    _same_result(got, want)
    assert got.success and got.audios == [] and "analysis_time_cost" in got.extra_outputs["time_costs"]
    calls = []
    for _, llm in services:
        orig = llm.understand_audio_from_codes

        def spy(codes, orig=orig, **kw):
            calls.append((codes, kw))
            return orig(codes, **{**kw, "temperature": 0.0, "max_new_tokens": DRAFT_TOKENS})

        monkeypatch.setattr(llm, "understand_audio_from_codes", spy)
    got, want = _both_services(services, dict(full_analysis_only=True, audio_codes=CODES, **GREEDY), ONE)
    _same_result(got, want)
    assert got.success and got.extra_outputs["audio_codes"] == CODES
    assert calls == [(CODES, dict(temperature=0.3, seed=5))] * 2
    got, want = _both_services(services, dict(full_analysis_only=True, **GREEDY), ONE)
    assert not got.success and not want.success and "src_audio" in got.error
    got, want = _both_services(services, dict(caption="x", analysis_only=True, **GREEDY), ONE, lm=False)
    assert not got.success and "require the 5Hz LM" in got.error and not want.success


@pytest.mark.parametrize("params", [
    dict(caption="", sample_mode=True),
    dict(sample_query="a rainy night in the city"),
    dict(caption="warm piano", lyrics="[Verse]\nhello", use_format=True),
    dict(caption="warm piano", use_format=True, instrumental=True),
    dict(caption="", lyrics="", use_format=True, instrumental=True),
], ids=["sample_mode", "sample_query", "use_format", "use_format_instrumental", "use_format_nothing"])
def test_drafts_match_jax(services, params):
    """The draft fills the request before generation: the same draft, the
    same drafted params in each entry, the same audio (injected noise)."""
    got, want = _both_services(services, dict(**params, **GREEDY), ONE)
    _same_result(got, want)
    assert got.success and got.extra_outputs["lm_draft"]["seed"] == 5
    assert "lm_draft_time_cost" in got.extra_outputs["time_costs"]
    if params.get("instrumental"):
        assert "lyrics" not in got.extra_outputs["lm_draft"] and got.audios[0]["params"]["instrumental"]


def test_sample_query_demotes_without_lm(services):
    params = dict(sample_query="warm piano mood", seed=5, duration=2.0, thinking=False)
    got, want = _both_services(services, params, ONE, lm=False)
    _same_result(got, want)
    assert got.success and got.audios[0]["params"]["caption"] == "warm piano mood"
    got, want = _both_services(services, dict(sample_mode=True, seed=5, duration=2.0), ONE, lm=False)
    assert not got.success and not want.success and "require the 5Hz LM" in got.error


def test_unseeded_draft_uses_a_fresh_lm_seed(services):
    """seed < 0 draws a fresh 31-bit LM seed per request; a set seed passes."""
    _, (td, _) = services
    seen = []

    class FakeLM:
        initialized = True

        def create_sample_from_query(self, query, temperature=0.85, seed=0):
            seen.append(seed)
            return {"metadata": {"caption": f"drafted {seed}"}}

    for _ in range(2):
        r = tservice.generate_music(td, FakeLM(), TParams(sample_mode=True, duration=2.0, thinking=False),
                                    save_audio=False)
        assert r.success, r.error
        assert r.extra_outputs["lm_draft"]["seed"] == seen[-1]
        assert r.audios[0]["params"]["caption"] == f"drafted {seen[-1]}"
    assert all(0 <= s < 2**31 for s in seen) and seen[0] != seen[1]
    r = tservice.generate_music(td, FakeLM(), TParams(sample_mode=True, duration=2.0, thinking=False, seed=91),
                                save_audio=False)
    assert r.success and seen[-1] == 91


def test_generate_examples_writes_json(tmp_path, monkeypatch):
    """`cli generate-examples --device cpu --random-init` (the 0.6B entry
    pointed at the tiny planner, drafts at `DRAFT_TOKENS`) writes one params
    file per draft, draft i at seed i."""
    from acestep_tpu_torch.cli import main

    monkeypatch.setitem(LM_CONFIGS, "0.6B", TQ(**_LM))
    draft = TLLM.create_sample_from_query
    seeds = []

    def short_draft(self, query, **kw):
        seeds.append(kw.get("seed"))
        return draft(self, query, **{**kw, "max_new_tokens": DRAFT_TOKENS})

    monkeypatch.setattr(TLLM, "create_sample_from_query", short_draft)
    out = tmp_path / "ex"
    rc = main(["generate-examples", "--device", "cpu", "--random-init", "--num", "2",
               "--output-dir", str(out), "--start-index", "3"])
    assert rc == 0
    assert seeds == [0, 1]  # draft i at seed i
    files = sorted(p.name for p in out.iterdir())
    assert files == ["example_03.json", "example_04.json"]
    for name in files:
        ex = json.loads((out / name).read_text())
        assert set(ex) == {"think", "caption", "lyrics", "bpm", "duration", "keyscale", "language",
                           "timesignature"}
        assert ex["think"] is True and isinstance(ex["timesignature"], str)
