"""FSM-based constrained decoding for the 5 Hz planner LM.

A copy of `acestep_tpu/lm/constrained.py` (host-side; the port imports
nothing of `acestep_tpu`). Keep the two in step. In the port the device-side
sampler is `acestep_tpu_torch.lm.sampling`.

Functional equivalent of the reference's MetadataConstrainedLogitsProcessor
(`acestep/constrained_logits_processor.py`: FSMState :53-79, prefix trees
:676-1169, user-metadata injection :425, __call__ masking :1568, update_state
:2139), re-designed for TPU decoding:

Instead of masking a full (V,)-sized logits row on the host every token, the
FSM emits a compact per-step `StepSpec` — a forced token, a small ALLOW set,
or a BLOCK set — which the device-side sampler applies via gather (see
`acestep_tpu.lm.sampling`). The bulk of generation (audio codes at 5/sec) runs
entirely on device as a scan over the contiguous code-token range, so the
host↔device round-trip only happens during the short CoT phase.

Enforced format:
    <think>\nbpm: V\ncaption: V\nduration: V\nkeyscale: V\nlanguage: V\ntimesignature: V\n</think>
then `<|audio_code_N|>`* with a duration-driven token budget (5 codes/s).
Genres follows the reference's gating: skipped in the main two-phase generate
(ref llm_inference.py:1233) but generated in understand/create/format phases
(skip_genres=False), via the vocab trie when a genres vocabulary is loaded or
the probability-ended free-text fallback otherwise (ref :1958-1977).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from acestep_tpu_torch.utils.constants import (
    BPM_MAX,
    BPM_MIN,
    DURATION_MAX,
    DURATION_MIN,
    VALID_KEYSCALES,
    VALID_LANGUAGES,
    VALID_TIME_SIGNATURES,
)

_COMPLETE = -1  # trie key marking "a valid value ends here"


@dataclasses.dataclass
class StepSpec:
    """What the sampler may emit this step.

    kind: "force" (token preordained), "allow" (sample among ids),
    "block" (sample anything but ids), "codes" (audio-code range),
    "free" (unconstrained), "eos" (force eos / stop).
    """

    kind: str
    token: Optional[int] = None
    ids: Optional[List[int]] = None
    # "prob_end" (genres free-text fallback, ref constrained_logits_processor
    # `_should_end_text_field` :1495-1513): unconstrained sampling, except the
    # field ends with `token` (newline) WHEN P(newline) > max P(other).


def _encode(tokenizer, text: str) -> List[int]:
    if hasattr(tokenizer, "encode"):
        try:
            return list(tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return list(tokenizer.encode(text))
    return list(tokenizer(text)["input_ids"])


class ConstrainedDecoderFSM:
    """Per-sequence FSM over token ids (host-side; device applies StepSpecs)."""

    FIELD_ORDER = ["bpm", "caption", "duration", "genres", "keyscale", "language", "timesignature"]

    def __init__(
        self,
        tokenizer,
        *,
        enabled: bool = True,
        skip_genres: bool = True,
        skip_caption: bool = False,
        skip_language: bool = False,
        max_duration: Optional[int] = None,
        genres_vocab: Optional[Sequence[str]] = None,
        codes_per_second: int = 5,
        caption_max_tokens: int = 512,
    ):
        self.tokenizer = tokenizer
        self.enabled = enabled
        self.skip = {
            "genres": skip_genres,
            "caption": skip_caption,
            "language": skip_language,
        }
        self.max_duration = int(max_duration or DURATION_MAX)
        self.codes_per_second = codes_per_second
        self.caption_max_tokens = caption_max_tokens

        self.newline_ids = set(_encode(tokenizer, "\n"))
        self.canonical_newline = min(self.newline_ids)
        self.eos_token_id = getattr(tokenizer, "eos_token_id", None) or 2

        # Audio-code token range: `<|audio_code_0|>` .. discovered from tokenizer.
        self.code_token_start, self.num_code_tokens = self._discover_code_tokens()

        # Fixed strings → forced token queues (tokenized with the newline
        # context so BPE merges match in-sequence usage).
        self._fixed: Dict[str, List[int]] = {
            "<think>": _encode(tokenizer, "<think>"),
            "</think>": _encode(tokenizer, "</think>"),
            "\n": _encode(tokenizer, "\n"),
        }
        for f in self.FIELD_ORDER:
            self._fixed[f + ":"] = _encode(tokenizer, f + ":")

        # Value tries (token-id level) built from tokenizing " value\n" in the
        # "field: " context (ref: context_prefix_for_tokenization).
        self._tries: Dict[str, dict] = {}
        self._tries["bpm"] = self._build_value_trie(
            "bpm", [str(v) for v in range(BPM_MIN, BPM_MAX + 1)]
        )
        self._tries["duration"] = self._build_value_trie(
            "duration", [str(v) for v in range(DURATION_MIN, self.max_duration + 1)]
        )
        self._tries["timesignature"] = self._build_value_trie(
            "timesignature", [str(v) for v in VALID_TIME_SIGNATURES]
        )
        self._tries["keyscale"] = self._build_value_trie("keyscale", sorted(VALID_KEYSCALES))
        self._tries["language"] = self._build_value_trie("language", VALID_LANGUAGES)
        if genres_vocab:
            self._tries["genres"] = self._build_value_trie("genres", list(genres_vocab))

        self.reset()

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    def _discover_code_tokens(self) -> Tuple[int, int]:
        t0 = _encode(self.tokenizer, "<|audio_code_0|>")
        if len(t0) == 1:
            t1 = _encode(self.tokenizer, "<|audio_code_1|>")
            start = t0[0]
            if len(t1) == 1 and t1[0] == start + 1:
                return start, 64_000
        return -1, 0  # tokenizer without native code tokens (dev mode)

    def _tokenize_value(self, field: str, value: str) -> List[int]:
        """Tokenize ' value' in the 'field:' context, return the value's tokens."""
        ctx = _encode(self.tokenizer, field + ":")
        full = _encode(self.tokenizer, field + ": " + value)
        # find longest common prefix with ctx, rest is the value
        i = 0
        while i < len(ctx) and i < len(full) and ctx[i] == full[i]:
            i += 1
        return full[i:]

    def _build_value_trie(self, field: str, values: Sequence[str]) -> dict:
        trie: dict = {}
        for v in values:
            toks = self._tokenize_value(field, v)
            node = trie
            for t in toks:
                node = node.setdefault(t, {})
            node[_COMPLETE] = True
        return trie

    # ------------------------------------------------------------------
    # Per-generation state
    # ------------------------------------------------------------------

    def reset(
        self,
        *,
        phase: str = "cot",
        stop_at_reasoning: bool = False,
        user_metadata: Optional[Dict[str, Optional[str]]] = None,
        target_duration: Optional[float] = None,
    ) -> None:
        assert phase in ("cot", "codes", "understand")
        self.phase = phase
        self.stop_at_reasoning = stop_at_reasoning
        self.user_metadata = {k: None for k in self.FIELD_ORDER}
        if user_metadata:
            for k, v in user_metadata.items():
                if k in self.user_metadata and v not in (None, "", "N/A"):
                    self.user_metadata[k] = str(v)
        self.target_duration = target_duration
        self.codes_emitted = 0
        self.queue: List[int] = []
        self.caption_tokens = 0
        self._trie_node: Optional[dict] = None
        self._field: Optional[str] = None
        self.finished = False
        self.parsed_duration: Optional[float] = None

        if phase == "codes":
            # Prompt already contains CoT; go straight to codes.
            self.state = "codes"
        else:
            self.state = "fixed"
            self.queue = list(self._fixed["<think>"]) + list(self._fixed["\n"])
            self._after_queue = ("field_name", "bpm")

    def _next_field(self, current: str) -> Optional[str]:
        idx = self.FIELD_ORDER.index(current)
        for f in self.FIELD_ORDER[idx + 1 :]:
            if self.skip.get(f):
                continue
            return f
        return None

    def _enter_field_name(self, field: str) -> None:
        self._field = field
        self.state = "fixed"
        self.queue = list(self._fixed[field + ":"])
        user_val = self.user_metadata.get(field)
        if user_val is not None:
            # Inject user value + newline directly (ref :425 user injection).
            self.queue += self._tokenize_value(field, user_val) + list(self._fixed["\n"])
            if field == "duration":
                try:
                    self.parsed_duration = float(user_val)
                except ValueError:
                    pass
            self._after_queue = self._after_field(field)
        else:
            self._after_queue = ("value", field)

    def _after_field(self, field: str):
        nxt = self._next_field(field)
        if nxt is None:
            return ("end_think", None)
        return ("field_name", nxt)

    def _enter(self, target) -> None:
        kind, arg = target
        if kind == "field_name":
            self._enter_field_name(arg)
        elif kind == "value":
            field = arg
            self._field = field
            if field == "caption":
                # Force the separating space so output reads "caption: text"
                # even when the model would not emit a leading-space token.
                space = _encode(self.tokenizer, " ")
                if space:
                    self.state = "fixed"
                    self.queue = list(space)
                    self._after_queue = ("caption_body", None)
                else:
                    self._enter(("caption_body", None))
            elif field == "genres" and "genres" not in self._tries:
                # No genres vocabulary: free-text value with probability-based
                # ending (ref GENRES_VALUE fallback, :1958-1977).
                self.state = "textfield"
                self._text_has_content = False
            else:
                self.state = "value"
                self._trie_node = self._tries[field]
                self._value_toks: List[int] = []
        elif kind == "caption_body":
            self._field = "caption"
            self.state = "caption"
            self.caption_tokens = 0
        elif kind == "end_think":
            self.state = "fixed"
            self.queue = list(self._fixed["</think>"])
            self._after_queue = ("post_think", None)
        elif kind == "post_think":
            if self.stop_at_reasoning:
                self.state = "eos"
            elif self.phase == "understand":
                self.state = "free"
            else:
                self.state = "codes"

    # ------------------------------------------------------------------
    # Step interface
    # ------------------------------------------------------------------

    def step_spec(self) -> StepSpec:
        """What may be generated next."""
        if not self.enabled:
            return StepSpec("free")
        if self.finished:
            return StepSpec("eos", token=self.eos_token_id)
        if self.state == "fixed":
            return StepSpec("force", token=self.queue[0])
        if self.state == "value":
            allowed = [t for t in self._trie_node.keys() if t != _COMPLETE]
            if self._trie_node.get(_COMPLETE):
                allowed += list(self.newline_ids)
            return StepSpec("allow", ids=allowed)
        if self.state == "caption":
            blocked = list(self.newline_ids) if self.caption_tokens == 0 else []
            if self.caption_tokens >= self.caption_max_tokens:
                return StepSpec("allow", ids=list(self.newline_ids))
            return StepSpec("block", ids=blocked + [self.eos_token_id])
        if self.state == "textfield":
            if not self._text_has_content:
                return StepSpec("block", ids=list(self.newline_ids) + [self.eos_token_id])
            return StepSpec("prob_end", token=self.canonical_newline)
        if self.state == "codes":
            if self.code_token_start < 0:
                return StepSpec("free")
            budget = self.codes_budget()
            if budget is not None and self.codes_emitted >= budget:
                return StepSpec("eos", token=self.eos_token_id)
            return StepSpec("codes")
        if self.state == "free":
            return StepSpec("free")
        return StepSpec("eos", token=self.eos_token_id)

    def codes_budget(self) -> Optional[int]:
        dur = self.target_duration or self.parsed_duration
        if dur is None:
            return None
        return int(round(dur * self.codes_per_second))

    def advance(self, token_id: int) -> None:
        """Consume the emitted token, moving the FSM."""
        if not self.enabled or self.finished:
            if token_id == self.eos_token_id:
                self.finished = True
            return
        if self.state == "fixed":
            assert token_id == self.queue[0], (token_id, self.queue[0], self.state)
            self.queue.pop(0)
            if not self.queue:
                self._enter(self._after_queue)
                if self.state == "eos":
                    self.finished = True
            return
        if self.state == "value":
            if token_id in self.newline_ids:
                value = self.tokenizer.decode(self._value_toks).strip()
                if self._field == "duration":
                    try:
                        self.parsed_duration = float(value)
                    except ValueError:
                        pass
                self._enter(self._after_field(self._field))
            else:
                self._value_toks.append(token_id)
                self._trie_node = self._trie_node[token_id]
            return
        if self.state == "caption":
            if token_id in self.newline_ids and self.caption_tokens > 0:
                self._enter(self._after_field("caption"))
            else:
                self.caption_tokens += 1
            return
        if self.state == "textfield":
            if token_id in self.newline_ids and self._text_has_content:
                self._enter(self._after_field(self._field))
            else:
                self._text_has_content = True
            return
        if self.state == "codes":
            if token_id == self.eos_token_id:
                self.finished = True
            elif self.code_token_start < 0 or (
                self.code_token_start <= token_id < self.code_token_start + self.num_code_tokens
            ):
                self.codes_emitted += 1
            return
        if self.state == "free":
            if token_id == self.eos_token_id:
                self.finished = True
            return
        self.finished = True
