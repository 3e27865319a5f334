"""LLMHandler: lifecycle and two-phase constrained generation for the 5 Hz LM.

Port of `acestep_tpu/lm/handler.py` (reference `acestep/llm_inference.py`):

- Phase 1 (CoT metadata): the grammar compiled to DFA tables
  (`lm/dfa.py`) drives one device loop (`sampling.generate_cot_dfa`) with a
  single read-back at the end; `_constrained_loop`, the host-driven FSM loop,
  is the fallback for grammars too large for the tables
  (ACESTEP_TPU_NO_DEVICE_FSM=1 forces it).
- Phase 2 (audio codes): `sampling.generate_codes_scan` generates the
  duration-driven budget (5 codes/s) on the device with lockstep logit-space
  CFG, one read-back at the end.
- KV cache: preallocated, bucketed prompt lengths, prefill dedup and reuse
  (`lm/prefix_cache.py`).
- The free-form APIs (`understand_audio_from_codes`,
  `create_sample_from_query`, `format_sample_from_input`): the understand
  grammar (metadata with genres, then free text until EOS) through
  `generate_cot_dfa`, or `sampling.generate_free` when that grammar does not
  compile to device tables.

Weights come from the reference checkpoint layout (config.json, safetensors
and `genres_vocab.txt`, which constrains the CoT's genres) or from a seed.

Tensor parallelism (`enable_tensor_parallel`, JAX's method of that name)
splits the planner over the tp ranks of a `parallel.mesh.Mesh` by the tp
plan. The port runs it SPMD, as JAX runs one program: each public call that
runs forwards is a mesh op on the planner's line, the ranks of dp group 0
and sp 0 (ranks 0 … tp−1), which run the same call with the same arguments
and seed. The rowwise products' fp32 partials are summed over the line and
the embeddings, norms and head stay whole, so the logits, the draws and the
host DFA agree bit for bit on every rank; rank 0 compares the tokens each
rank drew and raises at the first that differs.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from acestep_tpu_torch.config import Qwen3Config
from acestep_tpu_torch.device import resolve_device
from acestep_tpu_torch.lm import prefix_cache, sampling
from acestep_tpu_torch.lm.constrained import ConstrainedDecoderFSM
from acestep_tpu_torch.models import qwen3
from acestep_tpu_torch.params import LM_CONFIGS, init_qwen3_params, load_safetensors_state
from acestep_tpu_torch.parallel.mesh import make_mesh, shard_params_dp, shard_params_tp
from acestep_tpu_torch.utils import debug
from acestep_tpu_torch.utils.constants import (
    DEFAULT_LM_INSPIRED_INSTRUCTION,
    DEFAULT_LM_INSTRUCTION,
    DEFAULT_LM_REWRITE_INSTRUCTION,
    DEFAULT_LM_UNDERSTAND_INSTRUCTION,
)
from acestep_tpu_torch.utils.tokenizer import load_tokenizer, tokenize_padded

PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)

CODE_RE = re.compile(r"<\|audio_code_(\d+)\|>")


def _has_meaningful_negative_prompt(p: Optional[str]) -> bool:
    return bool(p) and p.strip() not in ("", "NO USER INPUT")


def _device_fsm_enabled() -> bool:
    return os.environ.get("ACESTEP_TPU_NO_DEVICE_FSM", "0") != "1"


# The environment switches a planner call reads; a mesh op takes rank 0's.
_SWITCHES = {"device_fsm": _device_fsm_enabled, "prefix_cache": prefix_cache.enabled}


def _mesh_op(method):
    """A planner call that runs forwards. With the planner split over a mesh
    (`enable_tensor_parallel`) rank 0 runs it as one mesh op on the
    planner's line (`LLMHandler._lead`); inside such an op, and without a
    mesh, it runs here."""

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        if self.mesh is None or self._in_op():
            return method(self, *args, **kwargs)
        return self._lead(method.__name__, args, kwargs)

    return call


def _first_difference(want: List[np.ndarray], got: List[np.ndarray]) -> Optional[str]:
    """Where two ranks' token sequences first differ, or None."""
    for i, (a, b) in enumerate(zip(want, got)):
        n = min(len(a), len(b))
        diff = np.flatnonzero(a[:n] != b[:n])
        if diff.size:
            j = int(diff[0])
            return f"sequence {i}, step {j}: token {int(b[j])} where rank 0 drew {int(a[j])}"
        if len(a) != len(b):
            return f"sequence {i}, step {n}: {len(b)} tokens where rank 0 drew {len(a)}"
    if len(want) != len(got):
        return f"{len(got)} sequences where rank 0 drew {len(want)}"
    return None


class LLMHandler:
    """5 Hz planner LM: CoT metadata + audio-code generation."""

    # Largest DFA worth shipping to the device: S * (A + 1) int32 entries.
    _DFA_MAX_TABLE_ENTRIES = 16_000_000

    def __init__(self, config: Optional[Qwen3Config] = None, dtype: torch.dtype = torch.bfloat16, device=None):
        self.config = config or LM_CONFIGS["0.6B"]
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params = None
        self.tokenizer = None
        self.fsm: Optional[ConstrainedDecoderFSM] = None
        self.genres_vocab = None
        self.prefill_cache: Optional[prefix_cache.PrefillCache] = None
        self._dfa_cache: Dict[tuple, Any] = {}
        self.initialized = False
        self.max_model_len = 4096
        self.mesh = None  # set by enable_tensor_parallel
        self._op = threading.local()  # the mesh op this thread runs: its switches and the tokens drawn

    def initialize(
        self,
        checkpoint_dir: Optional[str] = None,
        *,
        random_init: Optional[bool] = None,
        max_duration: Optional[int] = None,
        seed: int = 0,
    ) -> str:
        """Load the planner from `checkpoint_dir` (config.json, *.safetensors,
        its tokenizer where `transformers` can read one, `genres_vocab.txt`
        where present), or random weights from `seed` with the byte-level
        fallback tokenizer, as the JAX handler decides."""
        if self.mesh is not None:
            raise RuntimeError("the planner is split over a mesh: load it on every rank before enable_tensor_parallel")
        t0 = time.time()
        if random_init is None:
            random_init = checkpoint_dir is None or not os.path.isdir(checkpoint_dir)
        if random_init:
            tokenizer = load_tokenizer(None)
            params = init_qwen3_params(self.config, seed=seed, device=self.device, dtype=self.dtype)
        else:
            with open(os.path.join(checkpoint_dir, "config.json")) as f:
                raw = json.load(f)
            config = Qwen3Config(
                vocab_size=raw["vocab_size"],
                hidden_size=raw["hidden_size"],
                intermediate_size=raw["intermediate_size"],
                num_hidden_layers=raw["num_hidden_layers"],
                num_attention_heads=raw["num_attention_heads"],
                num_key_value_heads=raw["num_key_value_heads"],
                head_dim=raw.get("head_dim", 128),
                rope_theta=raw.get("rope_theta", 1e6),
                tie_word_embeddings=raw.get("tie_word_embeddings", True),
            )
            state = load_safetensors_state(checkpoint_dir)
            if not state:
                raise FileNotFoundError(
                    f"LM checkpoint at {checkpoint_dir!r} has no *.safetensors "
                    "weights; re-download it or pass random_init=True"
                )
            params = qwen3.convert_torch_qwen3_state(state, config, self.dtype, self.device)
            self.config = config
            tokenizer = load_tokenizer(checkpoint_dir)
        genres_vocab = None
        if checkpoint_dir:
            gpath = os.path.join(checkpoint_dir, "genres_vocab.txt")
            if os.path.exists(gpath):
                with open(gpath) as f:
                    genres_vocab = [l.strip() for l in f if l.strip()]
        self.tokenizer, self.params, self.genres_vocab = tokenizer, params, genres_vocab
        self.fsm = ConstrainedDecoderFSM(self.tokenizer, max_duration=max_duration, genres_vocab=genres_vocab)
        self.prefill_cache = prefix_cache.PrefillCache()  # entries are tied to these weights
        self._dfa_cache = {}
        self.initialized = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return f"LM initialized in {time.time() - t0:.1f}s (random_init={random_init}, device={self.device})"

    # ------------------------------------------------------------------
    # Prompt building (ref llm_inference.py:1487-1620)
    # ------------------------------------------------------------------

    def _apply_chat_template(self, messages: List[Dict[str, str]], add_generation_prompt: bool) -> str:
        out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages]
        if add_generation_prompt:
            out.append("<|im_start|>assistant\n")
        return "".join(out)

    def build_formatted_prompt(
        self,
        caption: str,
        lyrics: str = "",
        is_negative_prompt: bool = False,
        generation_phase: str = "cot",
        negative_prompt: str = "NO USER INPUT",
    ) -> str:
        if is_negative_prompt:
            if generation_phase == "cot":
                if _has_meaningful_negative_prompt(negative_prompt):
                    prompt = f"# Caption\n{negative_prompt}\n\n# Lyric\n{lyrics}\n"
                else:
                    prompt = f"# Lyric\n{lyrics}\n"
            else:
                prompt = caption
        else:
            prompt = f"# Caption\n{caption}\n\n# Lyric\n{lyrics}\n"
        return self._apply_chat_template(
            [
                {"role": "system", "content": f"# Instruction\n{DEFAULT_LM_INSTRUCTION}\n\n"},
                {"role": "user", "content": prompt},
            ],
            add_generation_prompt=True,
        )

    def build_formatted_prompt_with_cot(
        self,
        caption: str,
        lyrics: str,
        cot_text: str,
        is_negative_prompt: bool = False,
        negative_prompt: str = "NO USER INPUT",
    ) -> str:
        if is_negative_prompt:
            cot_for_prompt = "<think>\n</think>"
            caption_for_prompt = negative_prompt if _has_meaningful_negative_prompt(negative_prompt) else caption
        else:
            cot_for_prompt = cot_text
            caption_for_prompt = caption
        user_prompt = f"# Caption\n{caption_for_prompt}\n\n# Lyric\n{lyrics}\n"
        formatted = self._apply_chat_template(
            [
                {"role": "system", "content": f"# Instruction\n{DEFAULT_LM_INSTRUCTION}\n\n"},
                {"role": "user", "content": user_prompt},
                {"role": "assistant", "content": cot_for_prompt},
            ],
            add_generation_prompt=False,
        )
        if not formatted.endswith("\n"):
            formatted += "\n"
        return formatted

    def build_formatted_prompt_for_understanding(
        self, audio_codes: str, is_negative_prompt: bool = False, negative_prompt: str = "NO USER INPUT"
    ) -> str:
        if is_negative_prompt:
            user = negative_prompt if _has_meaningful_negative_prompt(negative_prompt) else ""
        else:
            user = audio_codes
        return self._chat_prompt(DEFAULT_LM_UNDERSTAND_INSTRUCTION, user)

    # ------------------------------------------------------------------
    # Core decode machinery
    # ------------------------------------------------------------------

    def _encode_prompts(self, prompts: List[str], budget: int) -> Tuple[np.ndarray, np.ndarray, int]:
        ids, mask = tokenize_padded(self.tokenizer, prompts, self.max_model_len - budget, buckets=PROMPT_BUCKETS)
        return ids, mask, ids.shape[1]

    def check_tensor_parallel(self, tp: int) -> None:
        """Raise ValueError for a tp that does not divide the planner's
        attention heads, key-value heads and MLP width."""
        for name in ("num_attention_heads", "num_key_value_heads", "intermediate_size"):
            if getattr(self.config, name) % tp:
                raise ValueError(f"tp={tp} does not divide the planner's {name} ({getattr(self.config, name)})")

    def enable_tensor_parallel(self, mesh=None) -> None:
        """Split the planner over the tp axis of `mesh` (by default one tp
        line over every rank of the process group, as JAX's `make_mesh(tp=n)`)
        by the tp plan: q/k/v/gate/up keep this rank's output columns, o/down
        its input rows (`parallel.mesh.shard_params_tp`). Every rank calls it.

        A tp that does not divide the heads, the KV heads or the MLP width
        raises ValueError on every rank before any group call. Then the whole
        weights' digests are compared across the ranks (`shard_params_dp`),
        the planner's line keeps its slices, the other ranks drop theirs, and
        the prefill cache is cleared (its rows were whole).

        From then on `generate_with_stop_condition`, the free-form APIs and
        `on_line` (the LM score) are mesh ops: rank 0 sends each through the
        mesh's one command channel, which the DiT handler's followers serve
        (`AceStepHandler.serve_followers`, `Mesh.serve`): the planner
        attaches itself to the mesh as "planner" beside the DiT's "dit"
        (`Mesh.attach`), and one lock keeps their ops apart. The planner's
        line runs each call, the other ranks return None at once."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        if mesh is None and not dist.is_initialized():
            raise RuntimeError("enable_tensor_parallel needs a process group: run under mesh.launch")
        tp = dist.get_world_size() if mesh is None else mesh.shape["tp"]
        self.check_tensor_parallel(tp)
        if mesh is None:
            mesh = make_mesh(tp=tp, device=self.device)
        shard_params_dp(mesh, self.params)
        self.mesh = mesh
        mesh.attach("planner", self)
        self.params = shard_params_tp(mesh, self.params) if self._on_line() else None
        if self.prefill_cache is not None:
            self.prefill_cache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # the whole planner's blocks, for the ranks that share the card

    def _on_line(self) -> bool:
        """This rank computes the split planner's calls: dp group 0, sp 0."""
        return self.mesh.coord["dp"] == 0 and self.mesh.coord["sp"] == 0

    def _in_op(self) -> bool:
        return getattr(self._op, "switches", None) is not None

    @property
    def _tp_sum(self):
        """The fp32 sum over the planner's tp line, or None for a whole
        planner. A split planner's forward outside a mesh op would wait on
        ranks that never join it: refused."""
        if self.mesh is None:
            return None
        if not self._in_op():
            raise RuntimeError("the planner is split over a mesh: its forwards run only in a public call on rank 0")
        if self.mesh.shape["tp"] == 1:
            return None
        return lambda x: self.mesh.reduce_sum(x, "tp")

    def _switch(self, name: str) -> bool:
        """An environment switch (`_SWITCHES`) as rank 0 read it for the mesh
        op in progress, so every rank takes the same route; else as read here."""
        return self._op.switches[name] if self._in_op() else _SWITCHES[name]()

    def _note(self, rows) -> None:
        """Keep the token ids a mesh op drew, for rank 0's lockstep check."""
        if self._in_op():
            self._op.tokens.extend(np.asarray(r, np.int64).reshape(-1) for r in rows)

    def _lead(self, op: str, args: tuple, kwargs: Dict[str, Any]) -> Any:
        """Rank 0: `op` as one mesh op (`Mesh.lead`) with this process's
        switches; rank 0's value once every rank of the line drew the same
        tokens (or, for a call that draws none, returned the same value)."""
        payload = dict(args=args, kwargs=kwargs, switches={k: f() for k, f in _SWITCHES.items()})
        line = self.mesh.lead("planner", op, payload)[: self.mesh.shape["tp"]]
        value, tokens = line[0]
        for r, (v, t) in enumerate(line[1:], start=1):
            where = _first_difference(tokens, t)
            if where is None and not tokens and pickle.dumps(v) != pickle.dumps(value):
                where = f"it returned {v!r} where rank 0 returned {value!r}"
            if where is not None:
                raise RuntimeError(f"the planner's tp rank {r} is out of step with rank 0 in {op}: {where}")
        return value

    def _local(self, op: str, payload: Dict[str, Any]) -> Any:
        """A mesh op on this rank: on the planner's line the call itself
        under rank 0's switches, returning (value, tokens drawn); elsewhere
        None at once."""
        if not self._on_line():
            return None
        self._op.switches, self._op.tokens = payload["switches"], []
        try:
            return getattr(self, op)(*payload["args"], **payload["kwargs"]), self._op.tokens
        finally:
            self._op.switches = None

    @_mesh_op
    def on_line(self, fn, *args, **kwargs) -> Any:
        """`fn(self, *args, **kwargs)` as one planner call: under a split
        planner a mesh op on the line (`fn` travels by reference, so it is a
        module-level function, and its value must be equal on every rank of
        the line), else here. The LM score runs its forwards this way."""
        return fn(self, *args, **kwargs)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _prefill(self, ids: np.ndarray, mask: np.ndarray, total_len: int):
        """Prefill through the dedup/prefix cache; a plain batched prefill when
        it is disabled."""
        tp_sum = self._tp_sum
        if self._switch("prefix_cache") and self.prefill_cache is not None:
            return self.prefill_cache.prefill(
                self.params, self.config, np.asarray(ids), np.asarray(mask), total_len, self.dtype, self.device,
                tp_sum,
            )
        cache = qwen3.KVCache.create(self.config, ids.shape[0], total_len, self.dtype, self.device,
                                     qwen3.kv_heads(self.params, self.config))
        return qwen3.prefill(self.params, self.config, self._tensor(ids), self._tensor(mask), cache, tp_sum)

    def _constrained_loop(
        self,
        fsms: List[ConstrainedDecoderFSM],
        logits: torch.Tensor,  # (R, V) from prefill
        cache: qwen3.KVCache,
        positions: np.ndarray,  # (R,)
        *,
        max_new_tokens: int,
        temperature: float,
        top_k: int,
        top_p: float,
        cfg_scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[List[List[int]], torch.Tensor, qwen3.KVCache, np.ndarray]:
        """Host-driven FSM loop (fallback of the device DFA): one read-back per
        token. ALLOW sets gather-sample at a bucketed width, BLOCK/FREE rows
        scatter-mask, PROB_END rows use the probability-gated newline."""
        allow_buckets = (96, 256, 1024, 4096)
        b = len(fsms)
        r = logits.shape[0]
        use_cfg = cfg_scale > 1.0 and r == 2 * b
        gen = generator if generator is not None else self._generator(0)
        generated: List[List[int]] = [[] for _ in range(b)]
        positions = positions.copy()
        tp_sum = self._tp_sum

        for _ in range(max_new_tokens):
            if all(f.finished for f in fsms):
                break
            specs = [f.step_spec() for f in fsms]
            if all(s.kind in ("force", "eos") for s in specs):
                toks = np.asarray([s.token for s in specs], np.int64)
            else:
                lg = sampling.cfg_combine(logits[:b], logits[b:], cfg_scale) if use_cfg else logits
                toks = np.full((b,), -1, np.int64)
                for i, s in enumerate(specs):
                    if s.kind in ("force", "eos"):
                        toks[i] = s.token
                allow_rows = [i for i, s in enumerate(specs) if s.kind == "allow"]
                block_rows = [i for i, s in enumerate(specs) if s.kind in ("block", "free")]
                prob_rows = [i for i, s in enumerate(specs) if s.kind == "prob_end"]
                if allow_rows:
                    longest = max(len(specs[i].ids) for i in allow_rows)
                    width = next((w for w in allow_buckets if w >= longest), longest)
                    ids = np.full((b, width), -1, np.int64)
                    for i in allow_rows:
                        ids[i, : len(specs[i].ids)] = specs[i].ids[:width]
                    got = sampling.sample_allow(lg, self._tensor(ids), gen, temperature, top_k=top_k, top_p=top_p)
                    toks[allow_rows] = got.cpu().numpy()[allow_rows]
                if block_rows:
                    width = max((len(specs[i].ids) for i in block_rows if specs[i].ids), default=1)
                    ids = np.full((b, max(width, 1)), -1, np.int64)
                    for i in block_rows:
                        if specs[i].ids:
                            ids[i, : len(specs[i].ids)] = specs[i].ids
                    got = sampling.sample_block(lg, self._tensor(ids), gen, temperature, top_k=top_k, top_p=top_p)
                    toks[block_rows] = got.cpu().numpy()[block_rows]
                if prob_rows:
                    got = sampling.sample_prob_end(
                        lg, gen, temperature, newline_token=specs[prob_rows[0]].token,
                        eos_token=self.fsm.eos_token_id, top_k=top_k, top_p=top_p,
                    )
                    toks[prob_rows] = got.cpu().numpy()[prob_rows]

            for i, f in enumerate(fsms):
                if not f.finished:
                    f.advance(int(toks[i]))
                    generated[i].append(int(toks[i]))
            feed = np.concatenate([toks, toks]) if use_cfg else toks
            logits, cache = qwen3.decode_step(
                self.params, self.config, self._tensor(feed), self._tensor(positions), cache, tp_sum
            )
            positions = positions + 1
        self._note(generated)
        return generated, logits, cache, positions

    # ------------------------------------------------------------------
    # Device-side DFA path (lm/dfa.py)
    # ------------------------------------------------------------------

    def _cot_dfa_for(
        self,
        user_metadata,
        max_cot_tokens: int,
        target_duration: Optional[float] = None,
        phase: str = "cot",
        skip_genres: bool = True,
    ):
        """Compile (and cache) the CoT or understand grammar into device DFA
        tables; None when the dense tables would be too large (host loop or
        free decoding instead). The main CoT skips genres; the understand /
        create / format grammar (`phase="understand"`, `skip_genres=False`)
        emits them. Both choices are part of the cache key."""
        from acestep_tpu_torch.lm.dfa import compile_cot_dfa

        md = tuple(sorted((k, str(v)) for k, v in (user_metadata or {}).items() if v not in (None, "", "N/A")))
        key = (md, max_cot_tokens, self.genres_vocab is not None, target_duration, phase, skip_genres)
        if key in self._dfa_cache:
            return self._dfa_cache[key]
        fsm = ConstrainedDecoderFSM(
            self.tokenizer, max_duration=self.fsm.max_duration, genres_vocab=self.genres_vocab,
            skip_genres=skip_genres, caption_max_tokens=min(512, max_cot_tokens // 3),
        )
        fsm.reset(phase=phase, stop_at_reasoning=phase == "cot", user_metadata=user_metadata,
                  target_duration=target_duration)
        dfa = compile_cot_dfa(fsm, self.config.vocab_size)
        entry = None
        if dfa.trans.size <= self._DFA_MAX_TABLE_ENTRIES:
            tables = {
                name: self._tensor(getattr(dfa, name))
                for name in ("trans", "alpha_allow", "allow_other", "finished", "prob_end",
                             "alpha_tokens", "vocab_to_sym")
            }
            entry = (dfa, tables)
        if len(self._dfa_cache) >= 8:
            self._dfa_cache.pop(next(iter(self._dfa_cache)))
        self._dfa_cache[key] = entry
        return entry

    def _cot_device_generate(
        self,
        b: int,
        logits: torch.Tensor,
        cache: qwen3.KVCache,
        positions: np.ndarray,
        *,
        user_metadata,
        max_cot_tokens: int,
        temperature: float,
        top_k: int,
        top_p: float,
        cfg_scale: float,
        seed: int,
        target_duration: Optional[float] = None,
        repetition_penalty: float = 1.0,
    ) -> Optional[List[List[int]]]:
        """The whole CoT phase on the device; one read-back at the end. None
        when the grammar is too large for the device tables."""
        compiled = self._cot_dfa_for(user_metadata, max_cot_tokens, target_duration)
        if compiled is None:
            return None
        dfa, tables = compiled
        toks, _ = sampling.generate_cot_dfa(
            self.params, self.config, logits, self._tensor(positions), cache, self._generator(seed),
            tables, torch.full((b,), dfa.start_state, dtype=torch.int64, device=self.device),
            float(temperature),
            max_steps=max_cot_tokens, eos_token=dfa.eos_token_id,
            newline_token=dfa.newline_token_id if bool(dfa.prob_end.any()) else -1,
            top_k=top_k, top_p=top_p, cfg_scale=cfg_scale if cfg_scale > 1.0 else 1.0,
            repetition_penalty=repetition_penalty, tp_sum=self._tp_sum,
        )
        self._note(toks.cpu().numpy())
        out: List[List[int]] = []
        for row in toks.cpu().numpy():
            ids = []
            for t in row:
                if int(t) == dfa.eos_token_id:
                    break
                ids.append(int(t))
            out.append(ids)
        return out

    # ------------------------------------------------------------------
    # Public generation API (ref generate_with_stop_condition)
    # ------------------------------------------------------------------

    @_mesh_op
    @torch.inference_mode()
    def generate_with_stop_condition(
        self,
        caption: str,
        lyrics: str = "",
        *,
        temperature: float = 0.85,
        cfg_scale: float = 1.0,
        top_k: int = 0,
        top_p: float = 0.9,
        repetition_penalty: float = 1.0,
        negative_prompt: str = "NO USER INPUT",
        user_metadata: Optional[Dict[str, Optional[str]]] = None,
        target_duration: Optional[float] = None,
        stop_at_reasoning: bool = False,
        use_constrained_decoding: bool = True,
        max_cot_tokens: int = 350,
        seed: int = 0,
        batch_size: int = 1,
        batch_chunk_size: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Two-phase generation: CoT metadata, then duration-driven audio codes.

        batch_size > 1 generates a distinct plan per item in lockstep;
        batch_chunk_size bounds the decode batch (larger requests run as
        sequential chunks, concatenated). Returns the first sample's fields
        plus per-sample lists under "batch_*".
        """
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        if batch_chunk_size and batch_size > batch_chunk_size:
            merged: Dict[str, Any] = {}
            done = 0
            while done < batch_size:
                n = min(batch_chunk_size, batch_size - done)
                part = self.generate_with_stop_condition(
                    caption, lyrics, temperature=temperature, cfg_scale=cfg_scale,
                    top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
                    negative_prompt=negative_prompt, user_metadata=user_metadata,
                    target_duration=target_duration, stop_at_reasoning=stop_at_reasoning,
                    use_constrained_decoding=use_constrained_decoding,
                    max_cot_tokens=max_cot_tokens, seed=seed + done, batch_size=n,
                )
                if not merged:
                    merged = part
                else:
                    for k in ("batch_metadata", "batch_cot_texts", "batch_audio_codes", "batch_codes"):
                        if k in part:
                            merged.setdefault(k, []).extend(part[k])
                    for k, v in part.get("time_costs", {}).items():
                        merged["time_costs"][k] = merged["time_costs"].get(k, 0.0) + v
                done += n
            return merged
        t0 = time.time()
        time_costs: Dict[str, float] = {}
        b = max(1, batch_size)

        # ---------------- Phase 1: CoT ----------------
        prompts = [self.build_formatted_prompt(caption, lyrics, generation_phase="cot")] * b
        use_cfg = cfg_scale > 1.0
        if use_cfg:
            prompts = prompts + [
                self.build_formatted_prompt(
                    caption, lyrics, is_negative_prompt=True, generation_phase="cot",
                    negative_prompt=negative_prompt,
                )
            ] * b
        ids, mask, bucket = self._encode_prompts(prompts, budget=max_cot_tokens)
        logits, cache = self._prefill(ids, mask, bucket + max_cot_tokens)
        positions = mask.sum(axis=1).astype(np.int32)
        generated = None
        if use_constrained_decoding and self._switch("device_fsm"):
            generated = self._cot_device_generate(
                b, logits, cache, positions,
                user_metadata=user_metadata, max_cot_tokens=max_cot_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                cfg_scale=cfg_scale, seed=seed, target_duration=target_duration,
                repetition_penalty=repetition_penalty,
            )
        if generated is None:
            fsms = []
            for _ in range(b):
                # skip_genres always: main-generation CoT never emits genres,
                # the same grammar as the device DFA.
                fsm = ConstrainedDecoderFSM(
                    self.tokenizer, enabled=use_constrained_decoding, max_duration=self.fsm.max_duration,
                    genres_vocab=self.genres_vocab, skip_genres=True,
                    caption_max_tokens=min(512, max_cot_tokens // 3),
                )
                fsm.reset(phase="cot", stop_at_reasoning=True, user_metadata=user_metadata,
                          target_duration=target_duration)
                fsms.append(fsm)
            generated, _, _, _ = self._constrained_loop(
                fsms, logits, cache, positions, max_new_tokens=max_cot_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p, cfg_scale=cfg_scale,
                generator=self._generator(seed),
            )
        cot_texts = [self.tokenizer.decode(g) for g in generated]
        time_costs["lm_cot_time_cost"] = time.time() - t0
        metadatas = [self.parse_lm_output(t)[0] for t in cot_texts]

        if stop_at_reasoning:
            time_costs["lm_total_time_cost"] = time.time() - t0
            return {"metadata": metadatas[0], "cot_text": cot_texts[0], "audio_codes": "",
                    "batch_metadata": metadatas, "batch_cot_texts": cot_texts, "time_costs": time_costs}

        # ---------------- Phase 2: codes ----------------
        t1 = time.time()
        durations = []
        for md in metadatas:
            duration = target_duration or md.get("duration")
            try:
                duration = float(duration)
            except (TypeError, ValueError):
                duration = 30.0
            durations.append(max(1.0, min(duration, self.fsm.max_duration)))
        n_codes_each = [int(round(d * 5)) for d in durations]
        codes_batch = self._generate_codes(
            caption, lyrics, cot_texts, max(n_codes_each),
            temperature=temperature, cfg_scale=cfg_scale, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, negative_prompt=negative_prompt, seed=seed,
        )
        codes_batch = [c[: n_codes_each[i]] for i, c in enumerate(codes_batch)]
        audio_codes_batch = ["".join(f"<|audio_code_{c}|>" for c in codes) for codes in codes_batch]
        time_costs["lm_codes_time_cost"] = time.time() - t1
        time_costs["lm_total_time_cost"] = time.time() - t0
        debug.log("lm", f"generate b={b} cfg={cfg_scale} "
                  + " ".join(f"{k}={v:.3f}" for k, v in time_costs.items()))
        return {
            "metadata": metadatas[0],
            "cot_text": cot_texts[0],
            "audio_codes": audio_codes_batch[0],
            "codes": codes_batch[0],
            "batch_metadata": metadatas,
            "batch_cot_texts": cot_texts,
            "batch_audio_codes": audio_codes_batch,
            "batch_codes": codes_batch,
            "time_costs": time_costs,
        }

    def _generate_codes(
        self,
        caption: str,
        lyrics: str,
        cot_texts,
        n_codes: int,
        *,
        temperature: float,
        cfg_scale: float,
        top_k: int,
        top_p: float,
        negative_prompt: str,
        seed: int,
        repetition_penalty: float = 1.0,
    ) -> List[List[int]]:
        """Device code generation for a batch of CoT plans. A tokenizer
        without native code tokens gets deterministic pseudo-codes instead."""
        if isinstance(cot_texts, str):
            cot_texts = [cot_texts]
        b = len(cot_texts)
        prompts = [self.build_formatted_prompt_with_cot(caption, lyrics, c) for c in cot_texts]
        use_cfg = cfg_scale > 1.0
        if use_cfg:
            prompts = prompts + [
                self.build_formatted_prompt_with_cot(
                    caption, lyrics, cot_texts[i], is_negative_prompt=True, negative_prompt=negative_prompt
                )
                for i in range(b)
            ]
        code_start = self.fsm.code_token_start
        n_vocab_codes = self.fsm.num_code_tokens
        if code_start < 0:
            # Dev tokenizer: pseudo-codes, before any prefill.
            rng = np.random.default_rng(seed)
            codes = [[int(x) for x in rng.integers(0, 64000, size=n_codes)] for _ in range(b)]
            self._note(codes)
            return codes

        ids, mask, bucket = self._encode_prompts(prompts, budget=n_codes + 8)
        logits, cache = self._prefill(ids, mask, bucket + n_codes + 8)
        positions = self._tensor(mask.sum(axis=1).astype(np.int32))
        gen = self._generator(seed + 1)

        # First code from the prefill logits.
        code_logits = logits[:, code_start : code_start + n_vocab_codes]
        if use_cfg:
            code_logits = sampling.cfg_combine(code_logits[:b], code_logits[b:], cfg_scale)
        seen = None
        if repetition_penalty != 1.0:
            # Seed the penalty set with the code tokens already in the prompt
            # and penalise the first sampled code from that set too.
            seen_np = np.zeros((b, n_vocab_codes), bool)
            in_range = (ids[:b] >= code_start) & (ids[:b] < code_start + n_vocab_codes)
            rows, cols = np.nonzero(in_range)
            seen_np[rows, ids[:b][rows, cols] - code_start] = True
            seen = self._tensor(seen_np)
            code_logits = sampling._apply_repetition_penalty(code_logits.float(), seen, repetition_penalty)
        first = sampling.sample(code_logits, gen, temperature, top_k=top_k, top_p=top_p)
        if seen is not None:
            seen[torch.arange(b, device=self.device), first] = True
        first_tok = first + code_start
        feed = torch.cat([first_tok, first_tok]) if use_cfg else first_tok
        toks, _ = sampling.generate_codes_scan(
            self.params, self.config, feed, positions, cache, gen, seen,
            n_steps=n_codes - 1, code_start=code_start, n_codes=n_vocab_codes,
            temperature=temperature, top_k=top_k, top_p=top_p,
            cfg_scale=cfg_scale if use_cfg else 1.0, repetition_penalty=repetition_penalty, tp_sum=self._tp_sum,
        )
        codes = torch.cat([first[:, None], toks - code_start], dim=1).cpu().numpy()  # the one read-back
        self._note(codes)
        return [[int(c) for c in row] for row in codes]

    # ------------------------------------------------------------------
    # LM-only task APIs (ref inference.py:779-1253 surface)
    # ------------------------------------------------------------------

    def _chat_prompt(self, instruction: str, user: str) -> str:
        return self._apply_chat_template(
            [
                {"role": "system", "content": f"# Instruction\n{instruction}\n\n"},
                {"role": "user", "content": user},
            ],
            add_generation_prompt=True,
        )

    def _free_api(self, prompt: str, temperature: float, max_new_tokens: int, seed: int) -> Dict[str, Any]:
        ids, route = self._free_generate(prompt, temperature=temperature, max_new_tokens=max_new_tokens, seed=seed)
        text = self.tokenizer.decode(ids)
        metadata, _ = self.parse_lm_output(text)
        return {"metadata": metadata, "text": text, "route": route, "tokens": len(ids)}

    @_mesh_op
    def understand_audio_from_codes(self, audio_codes: str, *, temperature: float = 0.85,
                                    max_new_tokens: int = 512, seed: int = 0) -> Dict[str, Any]:
        """Codes -> metadata + lyrics. Each free-form API returns the parsed
        metadata, the text, `route` (the decode that ran: "grammar", the
        understand grammar, or "free") and `tokens` (generated before EOS)."""
        return self._free_api(self.build_formatted_prompt_for_understanding(audio_codes),
                              temperature, max_new_tokens, seed)

    @_mesh_op
    def create_sample_from_query(self, query: str, *, temperature: float = 0.85,
                                 max_new_tokens: int = 512, seed: int = 0) -> Dict[str, Any]:
        """Query -> a drafted sample (caption, lyrics, metadata)."""
        return self._free_api(self._chat_prompt(DEFAULT_LM_INSPIRED_INSTRUCTION, query),
                              temperature, max_new_tokens, seed)

    @_mesh_op
    def format_sample_from_input(self, user_input: str, *, temperature: float = 0.85,
                                 max_new_tokens: int = 512, seed: int = 0) -> Dict[str, Any]:
        """Free-form input -> a formatted sample."""
        return self._free_api(self._chat_prompt(DEFAULT_LM_REWRITE_INSTRUCTION, user_input),
                              temperature, max_new_tokens, seed)

    @torch.inference_mode()
    def _free_generate(self, prompt: str, *, temperature: float, max_new_tokens: int,
                       seed: int) -> Tuple[List[int], str]:
        """Decode until EOS on the device, one read-back at the end. Returns
        (token ids before EOS, route). The understand grammar runs
        (constrained metadata including genres, then free text until EOS);
        when it cannot compile (a tokenizer without the grammar's tokens),
        its tables are too large, or the device FSM is switched off,
        unconstrained `generate_free` runs instead. This is a grammar
        fallback: both routes run on the handler's device."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        ids, mask, bucket = self._encode_prompts([prompt], budget=max_new_tokens)
        logits, cache = self._prefill(ids, mask, bucket + max_new_tokens)
        positions = self._tensor(np.asarray([mask[0].sum()], np.int32))
        eos = getattr(self.tokenizer, "eos_token_id", None) or 2

        compiled = None
        if self._switch("device_fsm"):
            try:
                compiled = self._cot_dfa_for(None, max_new_tokens, phase="understand", skip_genres=False)
            except (KeyError, IndexError, TypeError, ValueError, AttributeError):
                # a tokenizer the grammar cannot use; device errors propagate
                compiled = None
        if compiled is not None:
            dfa, tables = compiled
            toks, _ = sampling.generate_cot_dfa(
                self.params, self.config, logits, positions, cache, self._generator(seed), tables,
                torch.full((1,), dfa.start_state, dtype=torch.int64, device=self.device),
                float(temperature), max_steps=max_new_tokens, eos_token=dfa.eos_token_id,
                newline_token=dfa.newline_token_id if bool(dfa.prob_end.any()) else -1,
                top_k=0, top_p=0.9, tp_sum=self._tp_sum,
            )
            route = "grammar"
        else:
            toks, _ = sampling.generate_free(
                self.params, self.config, logits, positions, cache, self._generator(seed),
                float(temperature), max_steps=max_new_tokens, eos_token=eos, top_k=0, top_p=0.9,
                tp_sum=self._tp_sum,
            )
            route = "free"
        self._note(toks.cpu().numpy())
        out = []
        for t in toks[0].cpu().numpy():
            if int(t) == eos:
                break
            out.append(int(t))
        return out, route

    # ------------------------------------------------------------------
    # Output parsing (ref llm_inference.py:2535-2658)
    # ------------------------------------------------------------------

    @staticmethod
    def parse_lm_output(output_text: str) -> Tuple[Dict[str, Any], str]:
        """Extract the metadata dict and the audio-code string of LM output."""
        audio_codes = "".join(m.group(0) for m in CODE_RE.finditer(output_text))
        m = re.search(r"<think>(.*?)</think>", output_text, re.DOTALL)
        reasoning = m.group(1).strip() if m else output_text.split("<|audio_code_")[0].strip()

        metadata: Dict[str, Any] = {}
        current_key: Optional[str] = None
        value_lines: List[str] = []

        def flush():
            nonlocal current_key, value_lines
            if current_key and value_lines:
                value = "\n".join(value_lines)
                if current_key in ("bpm", "duration"):
                    try:
                        metadata[current_key] = int(value.strip())
                    except ValueError:
                        metadata[current_key] = value.strip()
                elif current_key == "caption":
                    lines = [l.strip() for l in value.split("\n") if l.strip()]
                    metadata["caption"] = " ".join(lines)
                elif current_key in ("genres", "keyscale", "language", "timesignature", "lyrics"):
                    metadata[current_key] = value.strip()
            current_key, value_lines = None, []

        for line in reasoning.split("\n"):
            if line.strip().startswith("<"):
                continue
            if line and not line[0].isspace() and ":" in line:
                flush()
                k, v = line.split(":", 1)
                current_key = k.strip().lower()
                if v.strip():
                    value_lines.append(v)
            elif line.startswith((" ", "\t")) and current_key:
                value_lines.append(line)
        flush()
        return metadata, audio_codes
