"""CoT FSM compiled to a device-side DFA.

A copy of `acestep_tpu/lm/dfa.py` (numpy tables; the port imports nothing of
`acestep_tpu`). Keep the two in step. In the port the tables drive the
device loop `acestep_tpu_torch.lm.sampling.generate_cot_dfa`.

The reference masks a (V,)-sized logits row on the host every token and
advances a Python FSM between steps (`acestep/constrained_logits_processor.py`
`__call__` :1568 / `update_state` :2139) — one host↔device round trip per
token. This module compiles the whole CoT grammar (fixed strings, value
prefix-tries, user-metadata injection, caption length limits) into dense
transition/allow tables so the ENTIRE constrained CoT phase runs as one
`lax.while_loop` on device (`acestep_tpu.lm.sampling.generate_cot_dfa`) with a
single readback at the end — the TPU-native answer to SURVEY §7.3's
"FSM-in-the-loop LM decoding" hard part.

Construction walks the host `ConstrainedDecoderFSM` itself (clone → advance →
canonical-key), so device behavior is defined by the same object the host
fallback path uses; a divergence is a test failure, not a drift.

Tables (S states, A alphabet symbols = tokens that appear on any FSM edge):
- ``vocab_to_sym``  (V,)    token id → symbol id, A = "other"
- ``trans``         (S,A+1) next state per (state, symbol); column A = other
- ``alpha_allow``   (S,A)   symbol permitted in this state
- ``allow_other``   (S,)    non-alphabet tokens permitted (caption body)
- ``finished``      (S,)    terminal (forced-EOS) states
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from acestep_tpu_torch.lm.constrained import ConstrainedDecoderFSM


@dataclasses.dataclass
class CotDFA:
    alpha_tokens: np.ndarray  # (A,) int32 token ids
    vocab_to_sym: np.ndarray  # (V,) int32 — A for non-alphabet tokens
    trans: np.ndarray  # (S, A+1) int32
    alpha_allow: np.ndarray  # (S, A) bool
    allow_other: np.ndarray  # (S,) bool
    finished: np.ndarray  # (S,) bool
    prob_end: np.ndarray  # (S,) bool — force newline when P(nl) > max P(other)
    start_state: int
    eos_token_id: int
    newline_token_id: int

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    @property
    def num_symbols(self) -> int:
        return self.alpha_tokens.shape[0]


def _state_key(f: ConstrainedDecoderFSM) -> tuple:
    """Canonical key over ONLY the attributes that drive behavior in the
    current mode — e.g. `caption_tokens` is never reset after the caption
    field, and keying on it unconditionally multiplies every downstream
    state by caption_max_tokens (a ~5M-state explosion)."""
    if f.finished:
        return ("finished",)
    if f.state == "fixed":
        return ("fixed", tuple(f.queue), f._after_queue)
    if f.state == "value":
        return ("value", f._field, id(f._trie_node))
    if f.state == "caption":
        return ("caption", f.caption_tokens)
    if f.state == "textfield":
        return ("textfield", f._field, f._text_has_content)
    return (f.state,)


def _clone(f: ConstrainedDecoderFSM) -> ConstrainedDecoderFSM:
    c = copy.copy(f)
    c.queue = list(f.queue)
    c._value_toks = list(getattr(f, "_value_toks", []))
    c.user_metadata = f.user_metadata  # shared, read-only during walk
    return c


def compile_cot_dfa(fsm: ConstrainedDecoderFSM, vocab_size: int) -> CotDFA:
    """Compile a reset() CoT-phase FSM (stop_at_reasoning=True) to tables.

    Only the CoT grammar is compiled — the codes phase already runs on device
    (`sampling.generate_codes_scan`) and free phases need no FSM.
    """
    assert fsm.phase == "understand" or (fsm.phase == "cot" and fsm.stop_at_reasoning), (
        "compile_cot_dfa expects a CoT FSM with stop_at_reasoning=True, or an "
        "understand-phase FSM (constrained metadata then free text until EOS)"
    )
    eos = fsm.eos_token_id

    # state key -> index; per-state row descriptors filled during BFS
    index: Dict[tuple, int] = {}
    fsms: List[ConstrainedDecoderFSM] = []
    rows: List[dict] = []

    def intern(f: ConstrainedDecoderFSM) -> int:
        k = _state_key(f)
        if k in index:
            return index[k]
        index[k] = len(fsms)
        fsms.append(f)
        rows.append({})
        return index[k]

    start = intern(_clone(fsm))
    todo = [start]
    seen = {start}
    while todo:
        si = todo.pop()
        f = fsms[si]
        row = rows[si]
        spec = f.step_spec()

        if f.finished or spec.kind == "eos":
            row["kind"] = "eos"
            row["edges"] = {eos: si}
            row["allowed"] = {eos}
            continue

        if spec.kind in ("force", "allow"):
            allowed = [spec.token] if spec.kind == "force" else list(spec.ids)
            row["kind"] = spec.kind
            row["allowed"] = set(allowed)
            edges = {}
            for tok in allowed:
                g = _clone(f)
                g.advance(int(tok))
                ni = intern(g)
                edges[tok] = ni
                if ni not in seen:
                    seen.add(ni)
                    todo.append(ni)
            row["edges"] = edges
            continue

        if spec.kind == "block":
            # Caption body: everything allowed except the blocked set; any
            # non-newline token advances the caption counter identically.
            row["kind"] = "block"
            row["blocked"] = set(spec.ids or [])
            # generic advance (probe with a token that is neither newline nor
            # blocked — its identity doesn't matter to the FSM)
            probe = 0
            while probe in f.newline_ids or probe in row["blocked"]:
                probe += 1
            g = _clone(f)
            g.advance(probe)
            other_ni = intern(g)
            if other_ni not in seen:
                seen.add(other_ni)
                todo.append(other_ni)
            row["other_next"] = other_ni
            edges = {}
            for nl in f.newline_ids:
                if nl in row["blocked"]:
                    continue
                g = _clone(f)
                g.advance(int(nl))
                ni = intern(g)
                edges[nl] = ni
                if ni not in seen:
                    seen.add(ni)
                    todo.append(ni)
            row["edges"] = edges
            continue

        if spec.kind == "prob_end":
            # Genres free-text with probability-gated newline ending: anything
            # non-newline stays in this state; newline advances the grammar.
            row["kind"] = "prob_end"
            row["blocked"] = {eos}
            probe = 0
            while probe in f.newline_ids or probe == eos:
                probe += 1
            g = _clone(f)
            g.advance(probe)
            other_ni = intern(g)
            if other_ni not in seen:
                seen.add(other_ni)
                todo.append(other_ni)
            row["other_next"] = other_ni
            edges = {}
            for nl in f.newline_ids:
                g = _clone(f)
                g.advance(int(nl))
                ni = intern(g)
                edges[nl] = ni
                if ni not in seen:
                    seen.add(ni)
                    todo.append(ni)
            row["edges"] = edges
            continue

        if spec.kind == "free":
            # Understand-phase tail: unconstrained until EOS.
            row["kind"] = "free"
            probe = 0
            while probe == eos:
                probe += 1
            g = _clone(f)
            g.advance(probe)
            other_ni = intern(g)
            if other_ni not in seen:
                seen.add(other_ni)
                todo.append(other_ni)
            row["other_next"] = other_ni
            g = _clone(f)
            g.advance(eos)
            eos_ni = intern(g)
            if eos_ni not in seen:
                seen.add(eos_ni)
                todo.append(eos_ni)
            row["edges"] = {eos: eos_ni}
            continue

        raise ValueError(f"CoT DFA cannot express step kind {spec.kind!r}")  # pragma: no cover

    # ---- alphabet ----
    alpha = set()
    for row in rows:
        alpha |= set(row.get("edges", {}).keys())
        alpha |= row.get("allowed", set())
        alpha |= row.get("blocked", set())
    alpha |= set(fsm.newline_ids)
    alpha.add(eos)
    alpha_tokens = np.asarray(sorted(t for t in alpha if 0 <= t < vocab_size), np.int32)
    sym_of = {int(t): i for i, t in enumerate(alpha_tokens)}
    a = len(alpha_tokens)
    s = len(rows)

    vocab_to_sym = np.full((vocab_size,), a, np.int32)
    vocab_to_sym[alpha_tokens] = np.arange(a, dtype=np.int32)

    trans = np.tile(np.arange(s, dtype=np.int32)[:, None], (1, a + 1))  # default self
    alpha_allow = np.zeros((s, a), bool)
    allow_other = np.zeros((s,), bool)
    finished = np.zeros((s,), bool)
    prob_end = np.zeros((s,), bool)

    for si, row in enumerate(rows):
        kind = row["kind"]
        if kind == "eos":
            finished[si] = True
            alpha_allow[si, sym_of[eos]] = True
            continue
        if kind in ("force", "allow"):
            for tok, ni in row["edges"].items():
                sy = sym_of[int(tok)]
                trans[si, sy] = ni
                alpha_allow[si, sy] = True
            continue
        # open-vocabulary states: caption body ("block"), genres free text
        # ("prob_end"), understand tail ("free")
        prob_end[si] = kind == "prob_end"
        allow_other[si] = True
        alpha_allow[si, :] = True
        trans[si, :] = row["other_next"]
        for tok in row.get("blocked", ()):  # "free" blocks nothing
            if int(tok) in sym_of:
                sy = sym_of[int(tok)]
                alpha_allow[si, sy] = False
                trans[si, sy] = si  # unreachable; keep well-defined
        for tok, ni in row["edges"].items():
            trans[si, sym_of[int(tok)]] = ni

    return CotDFA(
        alpha_tokens=alpha_tokens,
        vocab_to_sym=vocab_to_sym,
        trans=trans,
        alpha_allow=alpha_allow,
        allow_other=allow_other,
        finished=finished,
        prob_end=prob_end,
        start_state=start,
        eos_token_id=eos,
        newline_token_id=fsm.canonical_newline,
    )
