"""The port's LM planner slice vs the JAX package on the CPU (fp32).

FSQ codec, audio-code decode, Qwen3 prefill/decode with the KV cache, the
CoT DFA tables, the samplers' filters, the LLMHandler end to end at
temperature 0 with CFG 2.0, and its codes through both AceStepHandlers. The
same JAX init goes into both packages through `from_jax_params`; inputs are
numpy arrays made from a seed.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.models.dit as jdit
import acestep_tpu.pipeline.handler as JH
import acestep_tpu_torch.models.dit as tdit
import acestep_tpu_torch.pipeline.handler as TH
from acestep_tpu.config import AceStepConfig as JA, OobleckConfig as JO, Qwen3Config as JQ
from acestep_tpu.lm import sampling as jsampling
from acestep_tpu.lm.constrained import ConstrainedDecoderFSM as JFSM
from acestep_tpu.lm.dfa import compile_cot_dfa as j_compile
from acestep_tpu.lm.handler import LLMHandler as JLLM
from acestep_tpu.models import qwen3 as jqwen3
from acestep_tpu.ops import fsq as jfsq
from acestep_tpu.params import init_acestep_params
from acestep_tpu.utils.tokenizer import ByteFallbackTokenizer as JTok
from acestep_tpu_torch.config import AceStepConfig as TA, OobleckConfig as TO, Qwen3Config as TQ
from acestep_tpu_torch.lm import sampling as tsampling
from acestep_tpu_torch.lm.constrained import ConstrainedDecoderFSM as TFSM
from acestep_tpu_torch.lm.dfa import compile_cot_dfa as t_compile
from acestep_tpu_torch.lm.handler import LLMHandler as TLLM
from acestep_tpu_torch.lm.prefix_cache import PrefillCache
from acestep_tpu_torch.models import qwen3 as tqwen3
from acestep_tpu_torch.ops import fsq as tfsq
from acestep_tpu_torch.params import LM_CONFIGS, from_jax_params
from acestep_tpu_torch.utils import flac
from acestep_tpu_torch.utils.tokenizer import ByteFallbackTokenizer as TTok

LEVELS = (8, 8, 8, 5, 5, 5)
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
# The byte tokenizer has no code tokens: point the code range at byte ids.
CODE_START, N_CODES = 100, 64

# fp32 on both sides, a few layers deep: summation-order drift only.
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def lm_pair():
    """One tiny LM in both packages (untied head), same weights."""
    jcfg, tcfg = JQ(**_LM, tie_word_embeddings=False), TQ(**_LM, tie_word_embeddings=False)
    jh = JLLM(jcfg, dtype=jnp.float32)
    jh.initialize(random_init=True, seed=3)
    th = TLLM(tcfg, dtype=torch.float32, device="cpu")
    th.initialize(random_init=True)
    th.params = from_jax_params(jax.tree.map(np.asarray, jh.params), tcfg)
    assert "lm_head" in th.params
    for h in (jh, th):
        h.fsm.code_token_start, h.fsm.num_code_tokens = CODE_START, N_CODES
    return jh, th


# ---------------------------------------------------------------------------
# FSQ and the audio-code decode
# ---------------------------------------------------------------------------


def test_fsq_index_codec_is_bit_exact():
    idx = np.arange(64000, dtype=np.int32)
    want = np.asarray(jfsq.fsq_indices_to_codes(jnp.asarray(idx), LEVELS))
    got = tfsq.fsq_indices_to_codes(_t(idx), LEVELS).numpy()
    np.testing.assert_array_equal(got, want)
    back = tfsq.fsq_codes_to_indices(_t(want), LEVELS).numpy()
    np.testing.assert_array_equal(back, np.asarray(jfsq.fsq_codes_to_indices(jnp.asarray(want), LEVELS)))
    np.testing.assert_array_equal(back, idx)
    z = _np((3, 50, 6), 1, 2.0)
    np.testing.assert_array_equal(tfsq.fsq_quantize(_t(z), LEVELS).numpy(),
                                  np.asarray(jfsq.fsq_quantize(jnp.asarray(z), LEVELS)))


def test_decode_audio_codes_matches_jax():
    jcfg, tcfg = JA(**_DIT), TA(**_DIT)
    jp = init_acestep_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    idx = np.random.default_rng(2).integers(0, 64000, (2, 7)).astype(np.int32)
    want = np.asarray(jdit.decode_audio_codes(jp, jcfg, jnp.asarray(idx), jnp.float32))
    got = tdit.decode_audio_codes(tp, tcfg, _t(idx), torch.float32)
    assert got.shape == (2, 35, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Qwen3 prefill / decode with the KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [True, False])
def test_prefill_and_decode_match_jax(tied):
    jcfg, tcfg = JQ(**_LM, tie_word_embeddings=tied), TQ(**_LM, tie_word_embeddings=tied)
    jp = jqwen3.init_qwen3_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    assert ("lm_head" in tp) == (not tied)
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 259, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 11:] = 0
    mask[2, 7:] = 0
    max_len = 22
    jl, jc = jqwen3.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                            jqwen3.KVCache.create(jcfg, 3, max_len, jnp.float32))
    tl, tc = tqwen3.prefill(tp, tcfg, _t(ids), _t(mask), tqwen3.KVCache.create(tcfg, 3, max_len, torch.float32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    assert int(tc.length) == int(jc.length) == 16
    # Per-row positions; row 0 runs past the allocation, where a write is a no-op.
    pos = mask.sum(1).astype(np.int32)
    pos[0] = max_len - 2
    for step in range(4):
        tok = rng.integers(3, 259, (3,)).astype(np.int32)
        jl, jc = jqwen3.decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = tqwen3.decode_step(tp, tcfg, _t(tok), _t(pos), tc)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
        pos = pos + 1
    assert int(tc.length) == int(jc.length)


def test_lm_configs_match_jax():
    from acestep_tpu.lm.handler import LM_CONFIGS as J_CONFIGS

    assert {k: v.__dict__ for k, v in LM_CONFIGS.items()} == {k: v.__dict__ for k, v in J_CONFIGS.items()}


# ---------------------------------------------------------------------------
# Constrained decoding tables and samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("meta", [None, {"bpm": "120", "duration": "45", "keyscale": "G major"}])
def test_cot_dfa_tables_equal(meta):
    tabs = []
    for fsm_cls, tok, compile_ in ((JFSM, JTok(), j_compile), (TFSM, TTok(), t_compile)):
        fsm = fsm_cls(tok, caption_max_tokens=40)
        fsm.reset(phase="cot", stop_at_reasoning=True, user_metadata=meta)
        tabs.append(compile_(fsm, 300))
    want, got = tabs
    for name in ("alpha_tokens", "vocab_to_sym", "trans", "alpha_allow", "allow_other", "finished", "prob_end"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.start_state, got.eos_token_id, got.newline_token_id) == (
        want.start_state, want.eos_token_id, want.newline_token_id)


def test_filter_top_p_and_prefilter_keep_mask_equal():
    logits = _np((4, 3000), 7, 3.0)
    for top_p in (0.5, 0.9):
        want = np.asarray(jsampling._filter_top_p(jnp.asarray(logits), top_p))
        np.testing.assert_array_equal(tsampling._filter_top_p(_t(logits), top_p).numpy(), want)
        # The K = 512 prefilter's keep-mask, normalised by the full-vocab logsumexp.
        vals_j, _ = jax.lax.top_k(jnp.asarray(logits), 512)
        lse = jax.nn.logsumexp(jnp.asarray(logits), axis=-1, keepdims=True)
        probs = jnp.exp(vals_j - lse)
        keep_j = (jnp.cumsum(probs, axis=-1) - probs < top_p).at[..., 0].set(True)
        vals_t, _ = torch.topk(_t(logits), 512)
        keep_t = tsampling.nucleus_keep(vals_t, torch.logsumexp(_t(logits), -1, keepdim=True), top_p)
        np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def test_sampled_tokens_stay_inside_the_exact_nucleus():
    v = 151_936
    logits = np.full((2, v), -30.0, np.float32)
    logits[:, 100:164] = _np((2, 64), 8, 2.0)
    exact = tsampling._filter_top_p(_t(logits) / 0.85, 0.9)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsampling.sample(_t(logits), gen, 0.85, top_k=0, top_p=0.9)
        picked = torch.gather(exact, -1, tok[:, None])[:, 0]
        assert (picked > tsampling.NEG / 2).all()
    gen = torch.Generator().manual_seed(0)
    sub = tsampling.sample_allow(_t(logits), torch.tensor([[120, 130, -1], [5, -1, -1]]), gen, 0.0)
    assert sub.tolist() == [120 if logits[0, 120] > logits[0, 130] else 130, 5]
    assert tsampling.sample(_t(logits), gen, 0.0).tolist() == np.argmax(logits, -1).tolist()


# ---------------------------------------------------------------------------
# The handler end to end
# ---------------------------------------------------------------------------

GREEDY = dict(temperature=0.0, cfg_scale=2.0, top_k=0, top_p=0.9, target_duration=3.0)


def test_llm_handler_greedy_cfg_matches_jax(lm_pair):
    jh, th = lm_pair
    kw = dict(GREEDY, seed=4, batch_size=2)
    want = jh.generate_with_stop_condition("calm piano", "[Verse]\nla la", **kw)
    got = th.generate_with_stop_condition("calm piano", "[Verse]\nla la", **kw)
    assert "<think>" in got["cot_text"] and got["cot_text"] == want["cot_text"]
    assert got["batch_codes"] == want["batch_codes"]
    assert len(got["codes"]) == 15 and all(0 <= c < N_CODES for c in got["codes"])
    assert got["batch_audio_codes"] == want["batch_audio_codes"]
    assert got["metadata"] == want["metadata"]


def test_host_fsm_loop_and_prefix_cache_keep_the_result(lm_pair, monkeypatch):
    """The host FSM fallback equals the device DFA loop, with and without the
    prefix cache (greedy, so no randomness is involved)."""
    _, th = lm_pair
    kw = dict(GREEDY, seed=0)
    ref = th.generate_with_stop_condition("dark techno", "", **kw)
    monkeypatch.setenv("ACESTEP_TPU_NO_DEVICE_FSM", "1")
    host = th.generate_with_stop_condition("dark techno", "", **kw)
    monkeypatch.setenv("ACESTEP_TPU_LM_PREFIX_CACHE", "0")
    plain = th.generate_with_stop_condition("dark techno", "", **kw)
    assert host["cot_text"] == plain["cot_text"] == ref["cot_text"]
    assert host["codes"] == plain["codes"] == ref["codes"]


def test_prefill_cache_dedup_and_reuse(lm_pair):
    _, th = lm_pair
    p1, p2 = th.build_formatted_prompt("warm piano", ""), th.build_formatted_prompt("dark techno", "")
    ids, mask, bucket = th._encode_prompts([p1, p1, p2, p2], budget=16)
    total = bucket + 16
    plain_logits, plain = tqwen3.prefill(th.params, th.config, _t(ids), _t(mask),
                                         tqwen3.KVCache.create(th.config, 4, total, torch.float32))
    pc = PrefillCache()
    logits, cache = pc.prefill(th.params, th.config, ids, mask, total, torch.float32, "cpu")
    assert pc.stats()["dedup_rows_saved"] == 2 and pc.stats()["misses"] == 2
    np.testing.assert_allclose(logits.numpy(), plain_logits.numpy(), **TOL)
    np.testing.assert_allclose(cache.k.numpy(), plain.k.numpy(), **TOL)
    cache.k.add_(1.0)  # the decode loop writes in place: stored rows must not move
    logits2, cache2 = pc.prefill(th.params, th.config, ids, mask, total, torch.float32, "cpu")
    assert pc.stats()["hits"] == 2
    np.testing.assert_allclose(cache2.k.numpy(), plain.k.numpy(), **TOL)
    np.testing.assert_array_equal(logits2.numpy(), logits.numpy())


def test_parsers_match_jax():
    text = ("<think>\nbpm: 95\ncaption: A haunting melody.\nduration: 120\nkeyscale: D minor\n"
            "language: en\ntimesignature: 4\n</think>\n<|audio_code_1|><|audio_code_64001|>")
    assert TLLM.parse_lm_output(text) == JLLM.parse_lm_output(text)
    assert TH.AceStepHandler.parse_audio_codes(text) == JH.AceStepHandler.parse_audio_codes(text) == [1, 63999]
    assert TH.AceStepHandler.format_audio_codes([3, 4]) == JH.AceStepHandler.format_audio_codes([3, 4])


def _noise(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


def test_lm_codes_through_both_dit_handlers(lm_pair, monkeypatch):
    """The whole slice: the tiny LM's greedy CFG codes become hints of a cover
    in both AceStepHandlers (injected noise): latents 1e-4, audio 2.5/32767."""
    jlm, tlm = lm_pair
    out = tlm.generate_with_stop_condition("synth pop", "", **dict(GREEDY, target_duration=2.0), seed=1)
    codes = out["audio_codes"]
    assert codes == jlm.generate_with_stop_condition("synth pop", "", **dict(GREEDY, target_duration=2.0),
                                                     seed=1)["audio_codes"]
    for mod in (JH, TH):
        for name, val in BUCKETS.items():
            monkeypatch.setattr(mod, name, val)
    monkeypatch.setattr(jdit, "prepare_noise",
                        lambda shape, seeds, dtype=jnp.bfloat16: jnp.asarray(_noise(shape), dtype))
    monkeypatch.setattr(tdit, "prepare_noise", lambda shape, seeds, dtype=torch.bfloat16, device=None:
                        torch.tensor(_noise(shape), dtype=dtype, device=device))
    jh = JH.AceStepHandler(JA(**_DIT), JO(**_VAE), JQ(**_LM), dtype=jnp.float32)
    jh.initialize_service(random_init=True)
    th = TH.AceStepHandler(TA(**_DIT), TO(**_VAE), TQ(**_LM), dtype=torch.float32, device="cpu")
    th.initialize_service(random_init=True)
    th.params = from_jax_params(jax.tree.map(np.asarray, jh.params), th.config)
    th.vae_params = from_jax_params(jax.tree.map(np.asarray, jh.vae_params), th.vae_config)
    th.text_params = from_jax_params(jax.tree.map(np.asarray, jh.text_params), th.text_config)
    kw = dict(captions="synth pop", lyrics="[Instrumental]", batch_size=2, audio_duration=2.4,
              seeds=[3, 4], use_random_seed=False, normalize_db=-1.0, audio_code_strings=[codes, None])
    want, got = jh.generate_music(**kw), th.generate_music(**kw)
    assert got["latents"].shape == want["latents"].shape == (2, 60, 64)
    np.testing.assert_allclose(got["latents"], want["latents"], **TOL)
    np.testing.assert_allclose(got["audios"], want["audios"], rtol=0, atol=2.5 / 32767)
    assert np.abs(got["audios"]).max() > 0


def test_service_generate_music_with_thinking(lm_pair, monkeypatch, tmp_path):
    """The service entry with thinking on: the LM's codes reach the DiT as
    cover hints (instruction switched), one WAV-ready int16 entry per row;
    saved (`save_audio=True`), the same rows as FLAC files with sidecars."""
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    _, tlm = lm_pair
    for name, val in BUCKETS.items():
        monkeypatch.setattr(TH, name, val)
    th = TH.AceStepHandler(TA(**_DIT), TO(**_VAE), TQ(**_LM), dtype=torch.float32, device="cpu")
    th.initialize_service(random_init=True)
    seen = {}
    orig = th.generate_music

    def spy(**kw):
        seen.update(kw)
        return orig(**kw)

    monkeypatch.setattr(th, "generate_music", spy)
    params = GenerationParams(caption="synth", lyrics="hi", duration=10.0, seed=3, lm_temperature=0.0)
    cfg = GenerationConfig(batch_size=2, allow_lm_batch=True, use_random_seed=False, seeds=[1, 2])
    r = first = generate_music(th, tlm, params, cfg, save_audio=False)
    assert r.success, r.error
    assert [a["audio"].shape for a in r.audios] == [(2, 8000)] * 2
    assert all(a["audio"].dtype == np.int16 for a in r.audios)
    assert seen["instructions"] == [TH.TASK_INSTRUCTIONS["cover"]] * 2
    assert [len(TH.AceStepHandler.parse_audio_codes(c)) for c in seen["audio_code_strings"]] == [50, 50]
    assert "lm_codes_time_cost" in r.extra_outputs["time_costs"]
    # Ported since: a draft and an analysis request run (drafted caption in
    # the entries; metadata without audio), and so does auto LRC (an LRC line
    # per lyric line, on a head map the 2-layer DiT has). The draft runs at a
    # small token budget (the API's default is 512).
    monkeypatch.setattr(tlm, "create_sample_from_query",
                        functools.partial(tlm.create_sample_from_query, max_new_tokens=32))
    r = generate_music(th, tlm, GenerationParams(caption="", sample_mode=True, duration=10.0, thinking=False,
                                                 lm_temperature=0.0, seed=3), cfg, save_audio=False)
    assert r.success, r.error
    assert r.extra_outputs["lm_draft"]["mode"] == "create_sample"
    assert [a["audio"].shape for a in r.audios] == [(2, 8000)] * 2
    assert r.audios[0]["params"]["caption"] == r.extra_outputs["lm_draft"].get("caption", "")
    r = generate_music(th, tlm, GenerationParams(caption="x", analysis_only=True, lm_temperature=0.0, seed=3), cfg,
                       save_audio=False)
    assert r.success and r.audios == [] and "lm_metadata" in r.extra_outputs, r.error
    th.custom_layers_config = {0: [1], 1: [2, 3]}
    r = generate_music(th, tlm, GenerationParams(caption="x", lyrics="[Verse]\nhello\nworld", auto_lrc=True,
                                                 duration=10.0, thinking=False, seed=3), cfg, save_audio=False)
    assert r.success, r.error
    assert [a["lrc"].count("\n") for a in r.audios] == [2, 2]
    assert all(len(a["sentence_timestamps"]) == 3 and "lyrics_score" not in a for a in r.audios)
    # Ported since: a source audio that cannot be read fails the request (the
    # service reports failures in its result), and a repaint runs.
    r = generate_music(th, tlm, GenerationParams(caption="x", src_audio="x.wav", thinking=False), cfg,
                       save_audio=False)
    assert not r.success and "x.wav" in r.error
    r = generate_music(th, tlm, GenerationParams(caption="x", task_type="repaint", repainting_start=1.0,
                                                 repainting_end=3.0, duration=10.0, thinking=False), cfg,
                       save_audio=False)
    assert r.success, r.error
    assert [a["audio"].shape for a in r.audios] == [(2, 8000)] * 2
    # Ported since: save_audio=True writes each row as FLAC (the config's
    # default format) beside its params sidecar; the files hold the rows of
    # the same request returned as PCM.
    saved = generate_music(th, tlm, params, dataclasses.replace(cfg, output_dir=str(tmp_path)), save_audio=True)
    assert saved.success, saved.error
    for entry, row in zip(saved.audios, first.audios):
        assert entry["path"].endswith(".flac") and "audio" not in entry
        with open(entry["path"], "rb") as f:
            pcm, sr, bps = flac.decode(f.read())
        assert (sr, bps) == (800, 16)
        np.testing.assert_array_equal(pcm, row["audio"])
        with open(entry["params_path"]) as f:
            assert json.load(f)["seed"] == entry["seed"] == row["seed"]
    out = tlm.create_sample_from_query("x", temperature=0.0, max_new_tokens=32)
    assert out["route"] == "grammar" and out["text"].startswith("<think>")
