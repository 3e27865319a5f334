"""The port's `scoring/` against the JAX package's (CPU).

The alignment and lyric-score functions are float64 numpy in both packages,
so on the same seeded matrices they agree exactly. The LM reward's pieces run
a tiny Qwen3 planner of each package with one set of weights
(`from_jax_params`), both in fp32: within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.scoring as jscoring
from acestep_tpu.config import Qwen3Config as JQ
from acestep_tpu.lm.handler import LLMHandler as JLLM
from acestep_tpu.scoring import alignment as jal
from acestep_tpu.scoring import lm_score as jlm
from acestep_tpu.scoring import lyric_score as jls
from acestep_tpu.utils.tokenizer import ByteFallbackTokenizer as JTok
from acestep_tpu_torch import scoring as tscoring
from acestep_tpu_torch.config import Qwen3Config as TQ
from acestep_tpu_torch.lm.handler import LLMHandler as TLLM
from acestep_tpu_torch.params import from_jax_params
from acestep_tpu_torch.scoring import alignment as tal
from acestep_tpu_torch.scoring import lm_score as tlm
from acestep_tpu_torch.scoring import lyric_score as tls
from acestep_tpu_torch.utils.tokenizer import ByteFallbackTokenizer as TTok

LYRICS = "[Verse]\nhello world\nsing it loud\n\n[Chorus]\nla la la"
SCORE_TOL = 1e-5


def _attention(n_text: int, n_frames: int, heads: int, seed: int) -> np.ndarray:
    """Seeded softmax-like maps (heads, n_text, n_frames) with a diagonal
    ridge, so the DTW path has something to follow."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((heads, n_text, n_frames))
    ridge = np.arange(n_text)[:, None] * (n_frames / n_text) - np.arange(n_frames)[None, :]
    x = x - 0.02 * ridge**2
    p = np.exp(x - x.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def test_public_names_match_jax():
    assert tscoring.__all__ == jscoring.__all__
    assert all(hasattr(tscoring, n) for n in tscoring.__all__)


@pytest.mark.parametrize("shape", [(1, 1), (5, 40), (17, 9), (30, 120)])
def test_dtw_and_median_filter_equal(shape):
    rng = np.random.default_rng(sum(shape))
    cost = rng.standard_normal(shape)
    for got, want in zip(tal.dtw_align(cost), jal.dtw_align(cost)):
        np.testing.assert_array_equal(got, want)
    # A tie-heavy cost (integers) takes the same moves.
    ties = rng.integers(0, 3, shape).astype(np.float64)
    for got, want in zip(tal.dtw_align(ties), jal.dtw_align(ties)):
        np.testing.assert_array_equal(got, want)
    for width in (1, 3, 7):
        np.testing.assert_array_equal(tal.median_filter(cost, width), jal.median_filter(cost, width))


@pytest.mark.parametrize("medfilt", [1, 3])
def test_stamps_confidence_and_lrc_equal(medfilt):
    tok_t, tok_j = TTok(), JTok()
    ids = tok_t.encode(LYRICS)
    assert ids == tok_j.encode(LYRICS)
    attn = _attention(len(ids), 150, heads=4, seed=3)
    ta, ja = tal.MusicStampsAligner(tok_t, 12.5), jal.MusicStampsAligner(tok_j, 12.5)
    for got, want in zip(ta._apply_bidirectional_consensus(attn, 2.0, medfilt),
                         ja._apply_bidirectional_consensus(attn, 2.0, medfilt)):
        np.testing.assert_array_equal(got, want)
    got = [s.__dict__ for s in ta.token_timestamps(attn, ids, medfilt_width=medfilt)]
    want = [s.__dict__ for s in ja.token_timestamps(attn, ids, medfilt_width=medfilt)]
    assert got == want and len(got) == len(ids)
    sentences = [line for line in LYRICS.split("\n") if line.strip()]
    got = ta.sentence_timestamps(attn, ids, sentences)
    want = ja.sentence_timestamps(attn, ids, sentences)
    assert [s.__dict__ for s in got] == [s.__dict__ for s in want] and len(got) == len(sentences)
    assert tal.format_lrc(got) == jal.format_lrc(want)
    assert tal.format_lrc(got).count("\n") == len(sentences) - 1
    assert tal.alignment_confidence(attn) == jal.alignment_confidence(attn)


def test_lyric_scorer_equal():
    tok_t, tok_j = TTok(), JTok()
    ids = tok_t.encode(LYRICS)
    attn = _attention(len(ids), 90, heads=3, seed=4)
    ts, js = tls.MusicLyricScorer(tok_t), jls.MusicLyricScorer(tok_j)
    np.testing.assert_array_equal(ts.token_type_mask(ids), js.token_type_mask(ids))
    assert ts.score(attn, ids, {}) == js.score(attn, ids, {})
    # The capture dict form, {layer: (B, H, T, F)}, with a head map.
    cap = {2: attn[None], 5: attn[None, ::-1]}
    layers = {2: [0, 2], 5: [1, 7]}
    assert ts.score(cap, ids, layers, medfilt_width=3) == js.score(cap, ids, layers, medfilt_width=3)
    dense = np.stack([attn, attn[::-1]])  # (L, H, T, F)
    for got, want in zip(ts.preprocess_attention(dense, layers), js.preprocess_attention(dense, layers)):
        np.testing.assert_array_equal(got, want)
    assert ts.score(cap, ids, {9: [0]}) == js.score(cap, ids, {9: [0]})  # no head: score 0 with an error
    calc, energy = ts.preprocess_attention(attn)
    path = np.stack(tal.dtw_align(-calc), axis=1)
    mask = ts.token_type_mask(ids)
    assert ts.alignment_metrics(energy, path, mask) == js.alignment_metrics(energy, path, mask)
    assert tls.MusicLyricScorer.alignment_metrics(energy, path[:0], mask) == \
        jls.MusicLyricScorer.alignment_metrics(energy, path[:0], mask)


# ---------------------------------------------------------------------------
# The LM reward score on a tiny planner of both packages
# ---------------------------------------------------------------------------

_LM = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=8)


@pytest.fixture(scope="module")
def planners():
    jcfg, tcfg = JQ(**_LM), TQ(**_LM)
    jh = JLLM(jcfg, dtype=jnp.float32)
    jh.initialize(random_init=True, seed=4)
    th = TLLM(tcfg, dtype=torch.float32, device="cpu")
    th.initialize(random_init=True)
    th.params = from_jax_params(jax.tree.map(np.asarray, jh.params), tcfg)
    return jh, th


def _codes(n: int, seed: int) -> str:
    return "".join(f"<|audio_code_{c}|>" for c in np.random.default_rng(seed).integers(0, 64000, n))


def test_token_log_probs_and_sequence_log_prob_match_jax(planners):
    jh, th = planners
    ids = np.random.default_rng(5).integers(0, 300, (2, 40)).astype(np.int32)
    mask = np.zeros_like(ids)
    mask[:, 17:] = 1
    want = jlm._token_log_probs(jh.params, jh.config, jnp.asarray(ids), jnp.asarray(mask))
    got = tlm._token_log_probs(th.params, th.config, torch.as_tensor(ids), torch.as_tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCORE_TOL, atol=SCORE_TOL)
    prompt = th.build_formatted_prompt("warm lofi beat", LYRICS, generation_phase="codes")
    cont = th.tokenizer.encode(_codes(12, 1))
    got, want = tlm.sequence_log_prob(th, prompt, cont), jlm.sequence_log_prob(jh, prompt, cont)
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL)
    for k in (1, 10):
        assert tlm.topk_recall(th, prompt, cont, k=k) == pytest.approx(jlm.topk_recall(jh, prompt, cont, k=k),
                                                                       abs=SCORE_TOL)


@pytest.mark.parametrize("meta", [None, {"bpm": 120, "keyscale": "C major", "duration": 30}])
def test_calculate_reward_score_matches_jax(planners, meta):
    jh, th = planners
    codes = _codes(30, 2)
    kw = dict(generated_meta={"bpm": "125", "keyscale": "c major"}, reference_meta=meta)
    got = tlm.calculate_reward_score(th, "warm lofi beat", LYRICS, codes, **kw)
    want = jlm.calculate_reward_score(jh, "warm lofi beat", LYRICS, codes, **kw)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=SCORE_TOL, abs=SCORE_TOL), k
    assert 0.0 <= got["reward"] <= 1.0 and 0.0 <= got["pmi_normalized"] <= 1.0
    assert tlm.calculate_reward_score(th, "x", "", "") == jlm.calculate_reward_score(jh, "x", "", "")
    assert tlm.metadata_recall(kw["generated_meta"], meta or {}) == jlm.metadata_recall(kw["generated_meta"],
                                                                                        meta or {})
    assert tlm.pmi_to_normalized_score(0.3) == jlm.pmi_to_normalized_score(0.3)
