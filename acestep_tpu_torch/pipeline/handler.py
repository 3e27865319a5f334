"""Generation orchestration for the turbo DiT on the card.

Port of `acestep_tpu/pipeline/handler.py` (`AceStepHandler`): loading the
reference checkpoint layout (or random weights); host-side prompt formatting,
seeds, repaint spans, chunk masks, bucketing and tokenization in numpy; text
encoding, the VAE encode of source and reference audio, condition
preparation, the denoise (the turbo model's 8 steps, or the base model's
`inference_steps` with CFG through APG or ADG inside the CFG interval; ODE or
SDE steps), the chunked Oobleck decode and the peak normalisation in torch on
the handler's device.

Every task of the JAX handler runs: text2music, cover, repaint, extract,
lego and complete. Audio-code hints (`<|audio_code_N|>` strings) decode
through the FSQ chain and the detokenizer into 25 Hz hints, and a row with
hints runs as a cover of them; a cover without hints takes its hints from the
source latents through the audio tokenizer chain. Reference audio becomes
packed timbre latents.

The decode of a request (`decode_latents`, and `generate_music`'s) is
dispatched whole on the compute stream: the chunked Oobleck decode, the
per-sample peak and each chunk's scale, clip and round to int16 PCM. The
PCM then crosses to pinned host buffers on a copy stream (at dispatch with
`async_finish`, so the transfer rides under the next request's compute; at
finish otherwise), and `finish` only waits on the copies in order, handing
each chunk to a `chunk_sink` on an emitter thread (streaming; `StreamCursor`
keeps the delivery exactly once). A CUDA out-of-memory at dispatch retries
the decode with halved chunks down to 64 frames (the retry ladder), counted
in `vae_decode_hbm_retries`.

LoRA adapters (`load_lora`, `unload_lora`, `toggle_lora`, `set_lora_scale`,
`lora_status`) live in a `LoRARegistry`; every denoise runs the decoder
with the enabled adapters applied (`_effective_params`). The lyric
post-pass (`get_lyric_timestamps`) re-runs one decoder step with the
cross-attention captured and aligns it to the lyric tokens: LRC text, token
and sentence stamps and a lyric-quality score.

The mesh (`enable_mesh`, `enable_data_parallel`, `enable_sequence_parallel`;
JAX's mesh methods) runs one handler a rank over dp x sp x tp ranks. Rank 0
takes the requests: its `generate_music` sends the request to the other
ranks, which wait in `serve_followers`. The ranks of one dp group (the same
dp coordinate) compute the same rows of the batch (`parallel.mesh.shard_batch`);
a batch that does not divide by dp runs on dp group 0. Within a group the
DiT is split (`parallel.tensor.Shards`): over tp each rank holds its slice
of the decoder's attention and MLP kernels (`shard_params_tp`, after the
digest check of the whole weights), over sp its slice of the latent frames;
the condition encoders, the tokenizer chain, the text encoder and the VAE
stay whole on every rank. The group's representative (sp = 0, tp = 0)
decodes the gathered latents, and rank 0 gathers the representatives' rows
in row order. The host-side preparation and the text encoder cover the
whole batch on every rank; seeds, references, hints and the SDE noise follow
their rows. Each representative decodes its rows in the chunks of the whole
request, so a request's PCM does not depend on dp; as in JAX's mesh branch,
the decode is not deferred across requests and a `chunk_sink` gets the whole
PCM once. LoRA changes and a reload reach every rank the same way, and the
lyric capture runs on dp group 0's first tp line (tp-sharded, the whole
sequence); the lyric alignment and training run on rank 0 alone, training
on the decoder gathered whole (`training_params`).

The requests and changes travel the mesh's one command channel
(`parallel.mesh.Mesh.lead` / `serve`), to which this handler attaches its
ops as "dit". A planner split by `LLMHandler.enable_tensor_parallel` over the
same mesh attaches its own as "planner": the followers' `serve_followers`
runs both, one op at a time under the mesh's lock, and the planner's calls
(the CoT and codes, the free-form APIs, the LM score) run on dp group 0's
sp-0 tp line. A planner left whole runs on rank 0 alone.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import random
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from acestep_tpu_torch.config import (
    LATENT_FPS,
    LATENT_HOP,
    SAMPLE_RATE,
    AceStepConfig,
    OobleckConfig,
    Qwen3Config,
)
from acestep_tpu_torch.device import resolve_device
from acestep_tpu_torch.models import dit, qwen3, vae
from acestep_tpu_torch.lm.constrained import _encode
from acestep_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    Mesh,
    make_mesh,
    shard_batch,
    shard_params_dp,
    shard_params_tp,
    unshard_params_tp,
)
from acestep_tpu_torch.parallel.tensor import Shards
from acestep_tpu_torch.params import (
    convert_torch_state_dict,
    init_acestep_params,
    init_oobleck_params,
    init_qwen3_params,
    load_safetensors_state,
)
from acestep_tpu_torch.pipeline.lora_manager import LoRARegistry
from acestep_tpu_torch.scoring.alignment import MusicStampsAligner, format_lrc
from acestep_tpu_torch.scoring.lyric_score import MusicLyricScorer
from acestep_tpu_torch.utils import debug
from acestep_tpu_torch.utils.constants import MAX_AUDIO_CODE, SFT_GEN_PROMPT, TASK_INSTRUCTIONS
from acestep_tpu_torch.utils.tokenizer import load_tokenizer, pick_bucket, tokenize_padded

LATENT_BUCKETS = (250, 500, 750, 1500, 2250, 3000, 4500, 6000, 7500, 15000)
TEXT_BUCKETS = (64, 128, 256)
LYRIC_BUCKETS = (64, 128, 256, 512, 1024, 2048)
DECODE_OVERLAP = 16  # latent frames on each side of a decode chunk
AUDIO_CODE_RE = re.compile(r"<\|audio_code_(\d+)\|>")
# Mesh ops that change no rank's model: one that fails on some ranks leaves them in step.
_READ_ONLY_OPS = ("generate_music", "capture_lyric_attention", "gather_decoder")


class StreamCursor:
    """Exactly-once, in-order PCM delivery for a chunked decode (a copy of
    the JAX handler's).

    Wraps a sink `sink(pos, pcm_i16, total_samples)` so the decode's retry
    ladder can restart an attempt with other chunk sizes without emitting
    audio twice: samples already forwarded are skipped and a partly new
    chunk is cut to its unseen suffix. Positions are absolute sample offsets.

    The port relies on emission starting after dispatch: a CUDA
    out-of-memory is raised at allocation, in dispatch, and the sink is fed
    only in finish, so a failed attempt has emitted nothing and the skip and
    cut never run on the card (unlike the JAX handler's, whose attempts can
    fail at readback after emitting). The tests drive them by hand."""

    def __init__(self, sink):
        self._sink = sink
        self.emitted = 0  # absolute samples forwarded so far
        self.chunks = 0

    def __call__(self, pos: int, pcm: np.ndarray, total: int) -> None:
        end = pos + pcm.shape[-1]
        if end <= self.emitted:
            return  # a retry re-covered an already delivered span
        if pos < self.emitted:
            pcm = pcm[..., self.emitted - pos :]
            pos = self.emitted
        self.emitted = end
        self.chunks += 1
        self._sink(pos, pcm, total)


class _DecodeJob:
    """One dispatched decode: its int16 PCM chunks (B, 2, Lc) on the device,
    in order, and the event on the compute stream after which all of them
    are written (None on the CPU).

    `start_copies` enqueues each chunk's copy into its own contiguous part
    of one pinned host buffer (one pinned allocation a job, not one a chunk:
    pinning host memory is slow) on the handler's copy stream, behind
    that event, and hands the device memory back to the allocator in the
    copy stream's order (`record_stream`). `wait_compute` and `chunk(i)`
    only wait: after dispatch the job launches no kernel."""

    def __init__(self, pcm: List[torch.Tensor], done, copy_stream):
        self.pcm = pcm
        self.done = done
        self.copy_stream = copy_stream
        self.batch = pcm[0].shape[0]
        self.takes = [c.shape[-1] for c in pcm]
        self.total = sum(self.takes)
        self.host: Optional[list] = None
        self.copied: Optional[list] = None

    def start_copies(self) -> None:
        if self.host is not None:
            return
        if self.done is None:  # the CPU: the chunks are host memory already
            self.host, self.copied = [c.numpy() for c in self.pcm], [None] * len(self.pcm)
        else:
            host, copied = [], []
            flat = torch.empty(sum(c.numel() for c in self.pcm), dtype=self.pcm[0].dtype, pin_memory=True)
            off = 0
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(self.done)
                for c in self.pcm:
                    h = flat[off : off + c.numel()].view(c.shape)
                    off += c.numel()
                    h.copy_(c, non_blocking=True)
                    c.record_stream(self.copy_stream)
                    ev = torch.cuda.Event()
                    ev.record(self.copy_stream)
                    host.append(h)
                    copied.append(ev)
            self.host, self.copied = host, copied
        self.pcm = None

    def wait_compute(self) -> None:
        if self.done is not None:
            self.done.synchronize()

    def chunk(self, i: int) -> np.ndarray:
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        h = self.host[i]
        return h if isinstance(h, np.ndarray) else h.numpy()


class AceStepHandler:
    """Holds the three models and runs the DiT-side text2music pipeline."""

    sample_rate = SAMPLE_RATE

    def __init__(
        self,
        config: Optional[AceStepConfig] = None,
        vae_config: Optional[OobleckConfig] = None,
        text_config: Optional[Qwen3Config] = None,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        self.config = config or AceStepConfig()
        self.vae_config = vae_config or OobleckConfig()
        self.text_config = text_config or Qwen3Config()
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params: Optional[Dict[str, Any]] = None
        self.vae_params: Optional[Dict[str, Any]] = None
        self.text_params: Optional[Dict[str, Any]] = None
        self.text_tokenizer = None
        self.silence_latent: Optional[np.ndarray] = None  # (1, T, 64)
        self.initialized = False
        # Device-to-host copies of the decoded PCM run on their own stream, so
        # a finished request's transfer overlaps the next request's compute.
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # Cumulative decode retries after a CUDA out-of-memory (each re-runs
        # the decode at smaller chunks: a throughput cost to be seen).
        self._decode_retries = 0
        self.lora = LoRARegistry(self.device)
        self.mesh: Optional[Mesh] = None

    # ------------------------------------------------------------------
    # LoRA lifecycle (on every rank under a mesh)
    # ------------------------------------------------------------------

    def load_lora(self, name: str, path: str) -> Dict[str, Any]:
        return self._everywhere("load_lora", name=name, path=path)

    def unload_lora(self, name: str) -> bool:
        return self._everywhere("unload_lora", name=name)

    def toggle_lora(self, name: str, enabled: Optional[bool] = None) -> bool:
        return self._everywhere("toggle_lora", name=name, enabled=enabled)

    def set_lora_scale(self, name: str, scale: float) -> None:
        self._everywhere("set_lora_scale", name=name, scale=scale)

    def lora_status(self) -> Dict[str, Any]:
        return self.lora.status()

    def _effective_params(self) -> Dict[str, Any]:
        """The model's parameters with the enabled adapters applied to the
        decoder; the base tree itself while no adapter is loaded."""
        if not self.lora.status():
            return self.params
        return {**self.params, "decoder": self.lora.effective_decoder(self.params["decoder"])}

    def initialize_service(
        self, checkpoint_dir: Optional[str] = None, *, random_init: Optional[bool] = None, seed: int = 0
    ) -> str:
        """Load the reference checkpoint layout from `checkpoint_dir`, or
        random weights from `seed` (dev mode, the JAX package's
        `--random-init`), as the JAX handler decides: random when no
        directory is given or found, unless `random_init` says otherwise.
        Under a mesh, rank 0 reloads every rank and then checks that they
        hold the same weights."""
        msg = self._everywhere("initialize_service", checkpoint_dir=checkpoint_dir, random_init=random_init,
                               seed=seed)
        if self.mesh is not None:
            self._everywhere("replicate")
        return msg

    def _initialize(self, checkpoint_dir: Optional[str], *, random_init: Optional[bool], seed: int) -> str:
        t0 = time.time()
        if random_init is None:
            random_init = checkpoint_dir is None or not os.path.isdir(checkpoint_dir)
        if random_init:
            self.params = init_acestep_params(self.config, seed=seed, device=self.device, dtype=self.dtype)
            self.vae_params = init_oobleck_params(self.vae_config, seed=seed + 1, device=self.device)
            self.text_params = init_qwen3_params(
                self.text_config, seed=seed + 2, device=self.device, dtype=self.dtype
            )
            self.silence_latent = np.zeros((1, 750, self.config.audio_acoustic_hidden_dim), np.float32)
            self.text_tokenizer = load_tokenizer(None)
        else:
            self._load_from_checkpoint(checkpoint_dir)
        # The merged decoder was built on the old weights; drop it with its pin.
        self.lora.invalidate_cache()
        self.initialized = True
        self._sync()
        return f"initialized in {time.time() - t0:.1f}s (random_init={random_init}, device={self.device})"

    def _load_from_checkpoint(self, checkpoint_dir: str) -> None:
        """The reference layout: the DiT's config.json and safetensors at the
        root, silence_latent.pt (or .npy), vae/ and Qwen3-Embedding-0.6B/,
        each required: a missing one raises FileNotFoundError naming it, and
        nothing is kept. DiT and text-encoder weights go to the handler's
        dtype, the VAE's stay fp32, all on the handler's device."""

        def missing(what: str, path: str) -> FileNotFoundError:
            return FileNotFoundError(
                f"checkpoint at {checkpoint_dir!r} is missing {what} ({path}); "
                "re-run the downloader (`acestep-tpu download`) or pass "
                "random_init=True for a dev instance"
            )

        cfg_path = os.path.join(checkpoint_dir, "config.json")
        config = self.config
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                raw = json.load(f)
            fields = {f.name for f in dataclasses.fields(AceStepConfig)}
            rename = {"fsq_input_levels": "fsq_levels", "fsq_input_num_quantizers": "fsq_num_quantizers"}
            kw = {}
            for k, v in raw.items():
                k = rename.get(k, k)
                if k in fields:
                    kw[k] = tuple(v) if isinstance(v, list) else v
            config = AceStepConfig(**kw)
        state = load_safetensors_state(checkpoint_dir)
        if not state:
            raise missing("the DiT model weights (*.safetensors)", checkpoint_dir)
        params = convert_torch_state_dict(state, config, self.dtype, self.device)
        del state

        sil_pt = os.path.join(checkpoint_dir, "silence_latent.pt")
        sil_npy = os.path.join(checkpoint_dir, "silence_latent.npy")
        if os.path.exists(sil_pt):
            sil = torch.load(sil_pt, map_location="cpu", weights_only=True).float().numpy()
        elif os.path.exists(sil_npy):
            sil = np.load(sil_npy)
        else:
            raise missing("silence_latent.pt (or .npy)", sil_pt)
        sil = np.asarray(sil, np.float32)
        if sil.ndim == 2:
            sil = sil[None]

        vae_dir = os.path.join(checkpoint_dir, "vae")
        vcfg_path = os.path.join(vae_dir, "config.json")
        if not os.path.exists(vcfg_path):
            raise missing("the VAE (vae/config.json)", vcfg_path)
        with open(vcfg_path) as f:
            vraw = json.load(f)
        vae_config = OobleckConfig(
            encoder_hidden_size=vraw.get("encoder_hidden_size", 128),
            downsampling_ratios=tuple(vraw.get("downsampling_ratios", (2, 4, 4, 6, 10))),
            channel_multiples=tuple(vraw.get("channel_multiples", (1, 2, 4, 8, 16))),
            decoder_channels=vraw.get("decoder_channels", 128),
            decoder_input_channels=vraw.get("decoder_input_channels", 64),
            audio_channels=vraw.get("audio_channels", 2),
            sampling_rate=vraw.get("sampling_rate", 48_000),
        )
        vstate = load_safetensors_state(vae_dir)
        if not vstate:
            raise missing("the VAE weights (vae/*.safetensors)", vae_dir)
        vae_params = vae.convert_torch_vae_state(vstate, vae_config, torch.float32, self.device)

        te_dir = os.path.join(checkpoint_dir, "Qwen3-Embedding-0.6B")
        tcfg_path = os.path.join(te_dir, "config.json")
        if not os.path.exists(tcfg_path):
            raise missing("the text encoder (Qwen3-Embedding-0.6B/)", te_dir)
        with open(tcfg_path) as f:
            traw = json.load(f)
        text_config = Qwen3Config(
            vocab_size=traw["vocab_size"],
            hidden_size=traw["hidden_size"],
            intermediate_size=traw["intermediate_size"],
            num_hidden_layers=traw["num_hidden_layers"],
            num_attention_heads=traw["num_attention_heads"],
            num_key_value_heads=traw["num_key_value_heads"],
            head_dim=traw.get("head_dim", 128),
            rope_theta=traw.get("rope_theta", 1e6),
            tie_word_embeddings=traw.get("tie_word_embeddings", True),
        )
        tstate = load_safetensors_state(te_dir)
        if not tstate:
            raise missing("the text encoder weights", te_dir)
        text_params = qwen3.convert_torch_qwen3_state(tstate, text_config, self.dtype, self.device)
        self.config, self.params, self.silence_latent = config, params, sil
        self.vae_config, self.vae_params = vae_config, vae_params
        self.text_config, self.text_params = text_config, text_params
        self.text_tokenizer = load_tokenizer(te_dir)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # Host-side conditioning helpers (copies of the JAX handler's)
    # ------------------------------------------------------------------

    def prepare_seeds(self, batch_size: int, seed, use_random: bool) -> Tuple[List[int], str]:
        """Per-item seeds."""
        seeds: List[int] = []
        if use_random or seed is None:
            seeds = [random.randint(0, 2**32 - 1) for _ in range(batch_size)]
        else:
            if isinstance(seed, str):
                vals = []
                for s in (s.strip() for s in seed.split(",")):
                    try:
                        vals.append(int(float(s)) if s not in ("", "-1") else -1)
                    except ValueError:
                        vals.append(-1)
            elif isinstance(seed, (int, float)):
                vals = [int(seed)]
            elif isinstance(seed, (list, tuple)):
                vals = [int(s) for s in seed]
            else:
                vals = [-1]
            single = len(vals) == 1 and vals[0] != -1
            for i in range(batch_size):
                v = vals[i] if i < len(vals) else -1
                if (single and batch_size > 1 and i > 0) or v == -1:
                    seeds.append(random.randint(0, 2**32 - 1))
                else:
                    seeds.append(v)
        return seeds, ", ".join(str(s) for s in seeds)

    def _default_meta(self) -> str:
        return "- bpm: N/A\n- timesignature: N/A\n- keyscale: N/A\n- duration: 30 seconds\n"

    def _dict_to_meta_string(self, meta: Dict[str, Any]) -> str:
        bpm = meta.get("bpm", meta.get("tempo", "N/A"))
        ts = meta.get("timesignature", meta.get("time_signature", "N/A"))
        ks = meta.get("keyscale", meta.get("key", meta.get("scale", "N/A")))
        dur = meta.get("duration", meta.get("length", 30))
        if isinstance(dur, (int, float)):
            dur = f"{int(dur)} seconds"
        return f"- bpm: {bpm}\n- timesignature: {ts}\n- keyscale: {ks}\n- duration: {dur}\n"

    def parse_metas(self, metas: Optional[List[Union[str, Dict[str, Any], None]]], batch: int) -> List[str]:
        if metas is None:
            return [self._default_meta()] * batch
        out = []
        for m in metas:
            if isinstance(m, str):
                out.append(m)
            elif isinstance(m, dict):
                out.append(self._dict_to_meta_string(m))
            else:
                out.append(self._default_meta())
        while len(out) < batch:
            out.append(self._default_meta())
        return out

    def generate_instruction(
        self,
        task_type: str,
        track_name: Optional[str] = None,
        complete_track_classes: Optional[List[str]] = None,
    ) -> str:
        """Task -> instruction text (ref task_utils.py:69-101)."""
        if task_type in ("text2music", "repaint", "cover"):
            return TASK_INSTRUCTIONS[task_type]
        if task_type in ("extract", "lego"):
            if track_name:
                return TASK_INSTRUCTIONS[task_type].format(TRACK_NAME=track_name.upper())
            return TASK_INSTRUCTIONS[f"{task_type}_default"]
        if task_type == "complete":
            if complete_track_classes:
                return TASK_INSTRUCTIONS["complete"].format(
                    TRACK_CLASSES=" | ".join(t.upper() for t in complete_track_classes)
                )
            return TASK_INSTRUCTIONS["complete_default"]
        return TASK_INSTRUCTIONS["text2music"]

    @staticmethod
    def parse_audio_codes(code_str: str) -> List[int]:
        """``<|audio_code_N|>`` -> clamped ints (ref audio_codes.py:21-46)."""
        if not code_str:
            return []
        return [max(0, min(int(x), MAX_AUDIO_CODE)) for x in AUDIO_CODE_RE.findall(code_str)]

    @staticmethod
    def format_audio_codes(indices: Sequence[int]) -> str:
        return "".join(f"<|audio_code_{int(i)}|>" for i in indices)

    @torch.inference_mode()
    def encode_reference_audio(self, audio: np.ndarray) -> np.ndarray:
        """Stereo audio (2, L) at the VAE's rate -> mean latents (L // hop, 64)
        through the tiled fp32 VAE encode."""
        x = self._tensor(np.ascontiguousarray(np.asarray(audio, np.float32).T[None]), torch.float32)
        z = vae.tiled_encode(self.vae_params, self.vae_config, x)
        return z[0].float().cpu().numpy()

    @torch.inference_mode()
    def convert_audio_to_codes(self, audio: np.ndarray) -> str:
        """Source audio (2, L) -> a `<|audio_code_N|>` string: the latents,
        padded with silence to a pool-window multiple, through the audio
        tokenizer (ref audio_codes.py:68-99)."""
        z = self.encode_reference_audio(audio)
        pad = (-z.shape[0]) % self.config.pool_window_size
        if pad:
            z = np.concatenate([z, self._silence_tiled(pad)[:pad]], axis=0)
        _, indices = dit.audio_tokenize(self.params["tokenizer"], self.config, self._tensor(z[None], self.dtype))
        return self.format_audio_codes(indices[0].cpu().tolist())

    @staticmethod
    def format_lyrics(lyrics: str, language: str) -> str:
        return f"# Languages\n{language}\n\n# Lyric\n{lyrics}<|endoftext|>"

    @staticmethod
    def format_instruction(instruction: str) -> str:
        return instruction if instruction.endswith(":") else instruction + ":"

    def build_chunk_masks_and_src_latents(
        self,
        batch_size: int,
        t_latent: int,
        instructions: List[str],
        has_code_hints: List[bool],
        target_latents: Optional[np.ndarray],  # (B, T, 64) or None
        has_target_audio: List[bool],
        repainting_start: Optional[List[Optional[float]]],
        repainting_end: Optional[List[Optional[float]]],
        silence_tiled: np.ndarray,  # (T, 64)
    ) -> Tuple[np.ndarray, List[Tuple[str, int, int]], np.ndarray, np.ndarray]:
        """Repaint spans, chunk masks, is_covers, src latents (ref conditioning_masks.py:15-83)."""
        chunk_masks = np.zeros((batch_size, t_latent), bool)
        spans: List[Tuple[str, int, int]] = []
        is_covers = np.zeros((batch_size,), bool)
        repaint_ranges: Dict[int, Tuple[int, int, int]] = {}
        for i in range(batch_size):
            rs = repainting_start[i] if repainting_start else None
            re_ = repainting_end[i] if repainting_end else None
            if rs is not None and re_ is not None and re_ > (rs or 0.0):
                start_sec = rs or 0.0
                left_pad = max(0.0, -start_sec)
                pad_lat = min(int(left_pad * self.sample_rate // LATENT_HOP), t_latent - 1)
                s_lat = int((start_sec + left_pad) * self.sample_rate // LATENT_HOP)
                e_lat = int((re_ + left_pad) * self.sample_rate // LATENT_HOP)
                s_lat = max(0, min(s_lat, t_latent - 1))
                e_lat = max(s_lat + 1, min(e_lat, t_latent))
                chunk_masks[i, s_lat:e_lat] = True
                spans.append(("repainting", s_lat, e_lat))
                repaint_ranges[i] = (s_lat, e_lat, pad_lat)
                continue
            chunk_masks[i, :] = True
            spans.append(("full", 0, t_latent))
            instr = (instructions[i] if i < len(instructions) else "").lower()
            is_covers[i] = (
                "generate audio semantic tokens" in instr and "based on the given conditions" in instr
            ) or has_code_hints[i]

        src = np.zeros((batch_size, t_latent, silence_tiled.shape[-1]), np.float32)
        for i in range(batch_size):
            if has_code_hints[i] or has_target_audio[i]:
                base = target_latents[i] if target_latents is not None else silence_tiled
                if i in repaint_ranges and repaint_ranges[i][2] > 0:
                    pad_lat = repaint_ranges[i][2]
                    row = np.array(silence_tiled, np.float32, copy=True)
                    n = min(base.shape[0], t_latent - pad_lat)
                    row[pad_lat : pad_lat + n] = base[:n]
                    base = row
                src[i] = base
                if i in repaint_ranges:
                    s_lat, e_lat = repaint_ranges[i][:2]
                    src[i, s_lat:e_lat] = silence_tiled[s_lat:e_lat]
            else:
                src[i] = silence_tiled
        return chunk_masks, spans, is_covers, src

    def _silence_tiled(self, t_latent: int) -> np.ndarray:
        sil = self.silence_latent[0]
        reps = -(-t_latent // sil.shape[0])
        return np.tile(sil, (reps, 1))[:t_latent]

    # ------------------------------------------------------------------
    # Device stages
    # ------------------------------------------------------------------

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def infer_text_embeddings(self, ids: np.ndarray) -> torch.Tensor:
        """Prompt embeddings: full causal forward, no key mask."""
        return qwen3.forward_hidden(self.text_params, self.text_config, self._tensor(ids))

    def infer_lyric_embeddings(self, ids: np.ndarray) -> torch.Tensor:
        return qwen3.embed_tokens(self.text_params, self._tensor(ids))

    @staticmethod
    def _decode_chunk_core(t: int, b: int) -> int:
        """Overlap-discard decode chunk size: about 4 chunks, capped so the
        decode working set stays about constant with batch."""
        core = max(192, min(512, -(-t // 4), 4096 // max(b, 1)))
        return core + (-core) % 8

    @torch.inference_mode()
    def decode_latents(
        self,
        latents: torch.Tensor,  # (B, T, 64)
        *,
        chunk_frames: Optional[int] = None,
        normalize_db: Optional[float] = None,
        return_int16: bool = False,
        timings: Optional[Dict[str, float]] = None,
        chunk_sink: Optional[Any] = None,
    ) -> np.ndarray:
        """Latents -> audio (B, 2, L): int16 PCM, or float32 = PCM / 32767.

        Overlap-discard chunks of `core` frames with 16 edge-replicated
        frames each side; the last chunk's padding is trimmed before the
        global per-sample peak, which drives normalisation to `normalize_db`
        (or only a clip guard when None). `chunk_sink(pos, pcm_i16, total)`
        receives the PCM in order as each chunk reaches the host. A CUDA
        out-of-memory halves the chunk core down to 64 frames and retries;
        `timings` gets the successful attempt's `compute_wait_s` and
        `transfer_s`, and `retries`.
        """
        z = latents.to(device=self.device, dtype=self.dtype)
        b, t, _ = z.shape
        core = self._decode_chunk_core(t, b) if chunk_frames is None else max(8, chunk_frames - 2 * DECODE_OVERLAP)
        if chunk_sink is not None and not isinstance(chunk_sink, StreamCursor):
            chunk_sink = StreamCursor(chunk_sink)
        while True:
            # Fresh timings per attempt: a failed attempt's partial split must
            # not pollute the published one.
            attempt: Dict[str, float] = {}
            try:
                job = self._decode_latents_dispatch(z, core, normalize_db)
                out = self._decode_latents_finish(job, return_int16=return_int16, timings=attempt,
                                                  chunk_sink=chunk_sink)
                if timings is not None:
                    retries = timings.get("retries", 0)
                    timings.update(attempt)
                    if retries:
                        timings["retries"] = retries
                return out
            except torch.OutOfMemoryError:
                if core <= 64:
                    raise
            job = None  # the failed attempt's tensors go before empty_cache
            core = max(64, core // 2)
            self._after_oom(timings)
            debug.log("vae", f"CUDA out of memory; retrying decode with chunk core={core}")

    def _after_oom(self, timings: Optional[Dict[str, float]]) -> None:
        """Count a decode retry after a CUDA out-of-memory and hand the failed
        attempt's cached blocks back to the card."""
        self._decode_retries += 1
        if timings is not None:
            timings["retries"] = timings.get("retries", 0) + 1
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _decode_latents_dispatch(
        self, z: torch.Tensor, core: int, normalize_db: Optional[float], start_copies: bool = False
    ) -> _DecodeJob:
        """Enqueue the whole decode of z (B, T, 64) on the current stream:
        the chunked VAE decode, the peak and the int16 conversion of each
        chunk; then an event. No host sync. `start_copies` also enqueues the
        host copies now (pipelined serving); otherwise `finish` starts them
        after the compute, so the compute / transfer split stays exact."""
        b, t, _ = z.shape
        hop = self.vae_config.hop_length
        ov = DECODE_OVERLAP
        n = -(-t // core) if t > core else 1
        wavs = []
        if n == 1:
            wavs.append(vae.decode(self.vae_params, self.vae_config, z)[:, : t * hop])
        else:
            pad_t = n * core - t
            padded = F.pad(z.transpose(1, 2), (ov, pad_t + ov), mode="replicate").transpose(1, 2)
            for ci in range(n):
                w = vae.decode(self.vae_params, self.vae_config, padded[:, ci * core : ci * core + core + 2 * ov])
                valid = core if ci < n - 1 else t - (n - 1) * core
                wavs.append(w[:, ov * hop : (ov + valid) * hop])
        pcm = self._to_pcm(wavs, normalize_db)
        del wavs
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        job = _DecodeJob(pcm, done, self._copy_stream)
        if start_copies:
            job.start_copies()
        return job

    def _decode_latents_finish(
        self,
        job: _DecodeJob,
        *,
        return_int16: bool,
        timings: Optional[Dict[str, float]] = None,
        chunk_sink: Optional[Any] = None,
    ) -> np.ndarray:
        """Wait for a dispatched decode and gather its PCM on the host. The
        wait on the compute marks `compute_wait_s`; the copies (started here
        unless dispatch started them) and the gather are `transfer_s`. A sink
        gets each chunk from an emitter thread while this one waits on the
        next copy."""
        t0 = time.time()
        job.wait_compute()
        t1 = time.time()
        if timings is not None:
            timings["compute_wait_s"] = timings.get("compute_wait_s", 0.0) + (t1 - t0)
        job.start_copies()
        out = np.empty((job.batch, 2, job.total), np.int16)
        emit_q: Optional[queue.Queue] = None
        emit_err: list = []
        emitter = None
        if chunk_sink is not None:
            emit_q = queue.Queue()

            def _emit():
                while True:
                    item = emit_q.get()
                    if item is None:
                        return
                    p, tk = item
                    try:
                        chunk_sink(p, out[:, :, p : p + tk], job.total)
                    except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
                        emit_err.append(e)
                        return

            emitter = threading.Thread(target=_emit, daemon=True)
            emitter.start()
        try:
            pos = 0
            for i, take in enumerate(job.takes):
                out[:, :, pos : pos + take] = job.chunk(i)
                if emit_q is not None:
                    emit_q.put((pos, take))
                pos += take
        finally:
            if emitter is not None:
                emit_q.put(None)
                emitter.join()
        if emit_err:
            raise emit_err[0]
        if timings is not None:
            timings["transfer_s"] = timings.get("transfer_s", 0.0) + (time.time() - t1)
        if return_int16:
            return out
        t2 = time.time()
        outf = out.astype(np.float32) / 32767.0
        if timings is not None:
            timings["f32_convert_s"] = timings.get("f32_convert_s", 0.0) + (time.time() - t2)
        return outf

    @staticmethod
    def _to_pcm(wavs: Sequence[torch.Tensor], normalize_db: Optional[float]) -> List[torch.Tensor]:
        """Chunks (B, Lc, 2) of one waveform -> int16 chunks (B, 2, Lc),
        scaled by the per-sample peak over all chunks: fp32 product, clip,
        x 32767, round half to even."""
        peak = torch.stack([w.float().abs().amax(dim=(1, 2)) for w in wavs]).amax(dim=0)[:, None, None]
        if normalize_db is not None:
            scale = (10.0 ** (normalize_db / 20.0)) / peak.clamp_min(1e-9)
        else:
            scale = 1.0 / peak.clamp_min(1.0)  # clip guard only
        return [
            torch.round(torch.clamp(w.float() * scale, -1.0, 1.0) * 32767.0).to(torch.int16).transpose(1, 2).contiguous()
            for w in wavs
        ]

    def _mark(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the current stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _fetch(self, x: torch.Tensor):
        """Start x's copy to the host as fp32 (pinned memory, on the current
        stream, behind the work that produces x). Returns the wait, which
        gives the numpy array, and the copy's timing event (None on the CPU)."""
        x = x.float().contiguous()
        if self.device.type != "cuda":
            return x.numpy, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ev = self._mark()

        def wait() -> np.ndarray:
            ev.synchronize()
            return host.numpy()

        return wait, ev

    def _code_hints(self, code_hints: List[Optional[str]], t_latent: int, silence: torch.Tensor) -> torch.Tensor:
        """(B, t_latent, 64) LM hints: each row's codes through FSQ and the
        detokenizer, cut or padded with silence to t_latent; rows without
        codes hold silence."""
        rows = []
        for cs in code_hints:
            ids = self.parse_audio_codes(cs) if cs and cs.strip() else []
            if not ids:
                rows.append(silence)
                continue
            h = dit.decode_audio_codes(self.params, self.config, self._tensor([ids], torch.int32), self.dtype)[0]
            n = min(h.shape[0], t_latent)
            rows.append(torch.cat([h[:n], silence[n:]], dim=0))
        return torch.stack(rows).to(self.dtype)

    def _target_latents(self, target_latents, b: int, t_latent: int, silence_tiled: np.ndarray) -> np.ndarray:
        """Source latents cut or padded with silence to the bucketed length,
        one row per batch item (the reference crops the target wav by
        duration before encoding)."""
        tl = np.asarray(target_latents, np.float32)
        if tl.ndim == 2:
            tl = tl[None]
        if tl.shape[0] != b:
            tl = np.repeat(tl[:1], b, axis=0)
        if tl.shape[1] >= t_latent:
            return tl[:, :t_latent]
        pad = np.broadcast_to(silence_tiled[tl.shape[1] : t_latent], (b, t_latent - tl.shape[1], tl.shape[2]))
        return np.concatenate([tl, pad], axis=1)

    def _reference_latents(
        self, reference_audios, b: int, silence_tiled: np.ndarray, rows: Optional[slice] = None
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Reference audio -> packed timbre latents (N, timbre_fix_frame, 64),
        the batch row of each packed row, and the most references of a row.
        A row may carry one array or a list; a row without any gets one
        silence row; each distinct array is encoded once and cut or
        zero-padded to timbre_fix_frame frames. With `rows`, only those rows
        of the batch are packed and numbered from 0; the most references is
        still the whole batch's."""
        tf = self.config.timbre_fix_frame
        silence_ref = silence_tiled[:tf] if silence_tiled.shape[0] >= tf else self._silence_tiled(tf)
        per_row = []
        for i in range(b):
            refs = reference_audios[i] if reference_audios else None
            if refs is None:
                refs = []
            elif isinstance(refs, np.ndarray):
                refs = [refs]
            per_row.append([r for r in refs if r is not None])
        max_count = max([1] + [len(refs) for refs in per_row])
        packed, order, cache = [], [], {}
        for i, refs in enumerate(per_row[rows or slice(0, b)]):
            if not refs:
                packed.append(silence_ref)
                order.append(i)
                continue
            for ref in refs:
                z = cache.get(id(ref))
                if z is None:
                    z = self.encode_reference_audio(ref)
                    z = z[:tf] if z.shape[0] >= tf else np.pad(z, ((0, tf - z.shape[0]), (0, 0)))
                    cache[id(ref)] = z
                packed.append(z)
                order.append(i)
        return np.stack(packed), np.asarray(order, np.int32), max_count

    # ------------------------------------------------------------------
    # The mesh over ranks (JAX handler.py:886-957)
    # ------------------------------------------------------------------

    def enable_mesh(self, dp: int = 1, sp: int = 1, tp: int = 1, *, timeout: float = DEFAULT_TIMEOUT_S) -> None:
        """Build one dp x sp x tp mesh over the ranks and shard the serving
        path over it; every rank calls it. Nothing at 1 x 1 x 1. A shape the
        model cannot take raises on every rank before the mesh is built
        (`check_mesh_shape`)."""
        if dp * sp * tp <= 1:
            return
        self.check_mesh_shape(sp, tp)  # before make_mesh, whose groups every rank must enter
        self._use_mesh(make_mesh(dp=dp, sp=sp, tp=tp, timeout=timeout, device=self.device))

    def enable_data_parallel(self, mesh: Optional[Mesh] = None) -> None:
        """Split request batches over the mesh's dp axis (by default every
        rank's), and over its sp and tp axes as `enable_mesh` does."""
        self._use_mesh(mesh if mesh is not None else make_mesh(tp=1, device=self.device))

    def enable_sequence_parallel(self, mesh: Optional[Mesh] = None, sp: Optional[int] = None) -> None:
        """Split the DiT's latent-time axis over the mesh's sp axis (by
        default every rank's), composed with its dp and tp axes; the mesh
        needs sp above 1. JAX replicates the weights here even on a tp axis;
        the port slices the decoder by the tp plan on any mesh with tp above
        1 (the same numbers, less memory)."""
        if mesh is None:
            if not dist.is_initialized():
                raise RuntimeError("enable_sequence_parallel needs a process group: run under mesh.launch")
            mesh = make_mesh(sp=sp or dist.get_world_size(), device=self.device)
        if mesh.shape["sp"] <= 1:
            raise ValueError(f"the mesh {mesh.shape} needs an sp axis above 1")
        self._use_mesh(mesh)

    def check_mesh_shape(self, sp: int, tp: int) -> None:
        """Raise ValueError for a tp that does not divide the DiT's attention
        heads, key-value heads and MLP width, and for an sp that splits no
        latent bucket (no bucket divides by sp·patch_size)."""
        cfg = self.config
        for name in ("num_attention_heads", "num_key_value_heads", "intermediate_size"):
            if getattr(cfg, name) % tp:
                raise ValueError(f"tp={tp} does not divide the DiT's {name} ({getattr(cfg, name)})")
        if sp > 1 and not any(t % (sp * cfg.patch_size) == 0 for t in LATENT_BUCKETS):
            raise ValueError(f"sp={sp}: no latent bucket of {LATENT_BUCKETS} divides by sp * patch_size "
                             f"({sp * cfg.patch_size}), so no request could split over it")

    def _use_mesh(self, mesh: Mesh) -> None:
        self.check_mesh_shape(mesh.shape["sp"], mesh.shape["tp"])
        self.mesh = mesh
        mesh.attach("dit", self)
        self._replicate()

    def _replicate(self) -> None:
        """Check that every rank holds the same DiT, VAE and text weights,
        whole; a rank that does not is no longer initialised. Then, on a tp
        axis above 1, keep this rank's slice of the decoder (the tp plan);
        the rest stays whole."""
        try:
            for tree in (self.params, self.vae_params, self.text_params):
                shard_params_dp(self.mesh, tree)
        except ValueError:
            self.initialized = False
            raise
        if self.mesh.shape["tp"] > 1:
            self.lora.invalidate_cache()
            self.params = {**self.params, "decoder": shard_params_tp(self.mesh, self.params["decoder"])}
            self.lora.tp = (self.mesh.coord["tp"], self.mesh.shape["tp"])
            if self.device.type == "cuda":
                torch.cuda.empty_cache()  # the whole decoder's blocks, for the ranks that share the card

    def training_params(self) -> Dict[str, Any]:
        """The weights a trainer takes on rank 0: `params`, with the decoder
        gathered whole from the tp ranks under a mesh whose tp axis is above
        1 (a copy the trainer holds for its run)."""
        if self.mesh is None or self.mesh.shape["tp"] == 1:
            return self.params
        return {**self.params, "decoder": self._lead("gather_decoder", {})[0]}

    def _shard_batch_array(self, x):
        """This rank's rows of a batch-leading array under a mesh (the whole
        array when its batch does not divide by dp, or without a mesh). The
        latent-time axis is split inside `dit.generate_audio`."""
        if self.mesh is None:
            return x
        return shard_batch(self.mesh, x)

    def serve_followers(self) -> None:
        """A follower rank's loop: run each request or change rank 0 sends,
        until rank 0 calls `stop_followers` (`Mesh.serve`: the ops of every
        handler on the mesh, a split planner's too). A failure goes back to
        rank 0, which raises it; the loop goes on."""
        self.mesh.serve()

    def stop_followers(self) -> None:
        """Rank 0: end every follower's `serve_followers`."""
        if self.mesh is not None and self.mesh.is_leader:
            self.mesh.stop_followers()

    def _local(self, op: str, kwargs: Dict[str, Any]) -> Any:
        """`op` on this rank alone."""
        if op == "generate_music":
            return self.generate_music(**kwargs, _shard=True)
        if op == "gather_decoder":
            whole = unshard_params_tp(self.mesh, self.params["decoder"])
            return whole if self.mesh.is_leader else None
        if op == "capture_lyric_attention":
            # dp group 0's first tp line computes; rank 0 alone returns the maps.
            if self.mesh.coord["dp"] or self.mesh.coord["sp"]:
                return None
            out = self._capture_lyric_attention(**kwargs, shards=Shards(self.mesh, split_time=False))
            return out if self.mesh.is_leader else None
        return {
            "load_lora": self.lora.load,
            "unload_lora": self.lora.unload,
            "toggle_lora": self.lora.toggle,
            "set_lora_scale": self.lora.set_scale,
            "initialize_service": self._initialize,
            "replicate": self._replicate,
        }[op](**kwargs)

    def _everywhere(self, op: str, **kwargs) -> Any:
        """`op` here without a mesh; under one, on every rank (`_lead`).
        Returns this rank's value."""
        if self.mesh is None:
            return self._local(op, kwargs)
        return self._lead(op, kwargs)[0]

    def _lead(self, op: str, kwargs: Dict[str, Any]) -> List[Any]:
        """Rank 0: `op` on every rank through the mesh's command channel
        (`Mesh.lead`); every rank's value in rank order."""
        return self.mesh.lead("dit", op, kwargs, read_only=op in _READ_ONLY_OPS)

    def _lead_generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Rank 0's `generate_music` under a mesh. The seeds are fixed here,
        so every rank draws the same ones; each dp group computes its rows,
        and its representative (sp = 0, tp = 0) returns them as int16 PCM,
        gathered here in row order. A batch that does not divide by dp runs
        on dp group 0. Then, as JAX's mesh branch: the whole PCM to
        `chunk_sink` once, the float conversion, and with `async_finish`
        both deferred to `finish`. `time_costs` are rank 0's."""
        t_start = time.time()
        if self.mesh.out_of_step is not None:
            raise RuntimeError(self.mesh.out_of_step)
        captions = request["captions"]
        b = request["batch_size"] or (1 if isinstance(captions, str) else len(captions))
        seeds, _ = self.prepare_seeds(b, request["seeds"], request["use_random_seed"] and request["seeds"] is None)
        sink, int16, deferred = request["chunk_sink"], request["return_int16"], request["async_finish"]
        request.update(seeds=seeds, use_random_seed=False, chunk_sink=None, return_int16=True, async_finish=False)
        group = self.mesh.shape["sp"] * self.mesh.shape["tp"]
        groups = 1 if b % self.mesh.shape["dp"] else self.mesh.shape["dp"]
        every = self._lead("generate_music", request)
        parts = [every[g * group] for g in range(groups)]
        result = parts[0]
        if groups > 1:
            for key in ("latents", "audios"):
                if key in result:
                    result[key] = np.concatenate([p[key] for p in parts])
            if "condition" in result:
                result["condition"] = {k: np.concatenate([p["condition"][k] for p in parts])
                                       for k in result["condition"]}
        pcm = result.pop("audios", None)

        def _finish():
            if sink is not None:
                sink(0, pcm, pcm.shape[-1])
            result["audios"] = pcm if int16 else pcm.astype(np.float32) / 32767.0
            return result["audios"]

        if pcm is not None:
            if deferred:
                result["finish"] = _finish
            else:
                _finish()
        result["time_costs"]["total_time_cost"] = time.time() - t_start
        return result

    # ------------------------------------------------------------------
    # LRC lyric timestamps and the lyric score
    # ------------------------------------------------------------------

    # The attention layer -> heads map the alignment reads (ref handler.py:129).
    custom_layers_config = {2: [6], 3: [10, 11], 4: [3], 5: [8, 9], 6: [8]}

    def get_lyric_timestamps(
        self,
        pred_latents: np.ndarray,  # (B, T, 64)
        condition: Dict[str, Any],  # from generate_music(return_condition=True)
        lyric_token_ids: np.ndarray,  # (B, L) tokens of the formatted lyric prompts
        lyrics_text: str,
        total_duration_seconds: float,
        *,
        vocal_language: str = "en",
        inference_steps: int = 8,
        seed: int = 42,
        custom_layers_config: Optional[Dict[int, List[int]]] = None,
        sample_idx: int = 0,
        lyric_mask: Optional[np.ndarray] = None,  # (B, L): each row's valid length
    ) -> Dict[str, Any]:
        """Re-run one decoder step at t = 1/steps with the cross-attention
        captured, DTW-align it to the lyric tokens, and return the LRC text,
        the token and sentence stamps and the composite lyric score of batch
        row `sample_idx`: the capture on the device
        (`capture_lyric_attention`), then the alignment on the host
        (`align_lyrics`)."""
        captured = self.capture_lyric_attention(
            pred_latents, condition, lyric_token_ids, vocal_language=vocal_language,
            inference_steps=inference_steps, seed=seed, custom_layers_config=custom_layers_config,
            sample_idx=sample_idx, lyric_mask=lyric_mask,
        )
        return self.align_lyrics(captured, lyrics_text, total_duration_seconds)

    def capture_lyric_attention(
        self,
        pred_latents: np.ndarray,
        condition: Dict[str, Any],
        lyric_token_ids: np.ndarray,
        *,
        vocal_language: str = "en",
        inference_steps: int = 8,
        seed: int = 42,
        custom_layers_config: Optional[Dict[int, List[int]]] = None,
        sample_idx: int = 0,
        lyric_mask: Optional[np.ndarray] = None,
    ) -> Dict[str, Any]:
        """The device half of `get_lyric_timestamps`: row `sample_idx`'s
        latents renoised to t = 1/steps (`dit.prepare_noise(seed)`), the
        capture forward on the base decoder (as in the JAX handler, not the
        LoRA-adapted one), and the configured heads' maps cut to the lyric
        rows. Returns {"attn": (n_maps, n_lyric, L_audio) float32, "ids":
        the lyric token ids} or, with no map, {"attn": None}. Under a mesh
        rank 0 sends the row to every rank, and the capture runs tp-sharded
        on dp group 0's first tp line."""
        i = sample_idx
        pred_latents = pred_latents[i : i + 1]
        condition = {
            k: (v[i : i + 1] if hasattr(v, "ndim") and v.ndim >= 2 and v.shape[0] > i else v)
            for k, v in condition.items()
        }
        if hasattr(lyric_token_ids, "ndim") and lyric_token_ids.ndim == 2 and lyric_token_ids.shape[0] > i:
            lyric_token_ids = lyric_token_ids[i : i + 1]
            if lyric_mask is not None and np.asarray(lyric_mask).shape[0] > i:
                # Each row keeps its own lyric length: pad ids at the tail
                # would shift the attention rows cut below.
                lyric_token_ids = lyric_token_ids[:, : int(np.asarray(lyric_mask[i]).sum())]
        kwargs = dict(pred_latents=pred_latents[:1], condition={k: condition[k] for k in (
            "context_latents", "encoder_hidden_states", "encoder_attention_mask")},
            lyric_token_ids=lyric_token_ids, vocal_language=vocal_language, inference_steps=inference_steps,
            seed=seed, cfgmap=custom_layers_config or self.custom_layers_config)
        if self.mesh is None:
            return self._capture_lyric_attention(**kwargs)
        return self._lead("capture_lyric_attention", kwargs)[0]

    @torch.inference_mode()
    def _capture_lyric_attention(self, pred_latents, condition, lyric_token_ids, *, vocal_language: str,
                                 inference_steps: int, seed: int, cfgmap: Dict[int, List[int]],
                                 shards: Optional[Shards] = None) -> Dict[str, Any]:
        t_last = 1.0 / max(inference_steps, 1)
        xt_np = pred_latents
        # The latents were cropped to the duration; pad back to the bucketed
        # context length for the capture forward.
        t_ctx = condition["context_latents"].shape[1]
        if xt_np.shape[1] < t_ctx:
            xt_np = np.pad(xt_np, ((0, 0), (0, t_ctx - xt_np.shape[1]), (0, 0)))
        b, t, d = xt_np.shape
        noise = dit.prepare_noise((b, t, d), [seed], self.dtype, device=self.device)
        xt = t_last * noise + (1.0 - t_last) * self._tensor(xt_np, self.dtype)
        captured = dit.dit_cross_attention_capture(
            self.params["decoder"],
            self.config,
            xt,
            torch.full((b,), t_last, dtype=torch.float32, device=self.device),
            self._tensor(condition["context_latents"][:1], self.dtype),
            self._tensor(condition["encoder_hidden_states"][:1], self.dtype),
            self._tensor(condition["encoder_attention_mask"][:1]),
            sorted(cfgmap.keys()),
            shards=shards,
        )
        maps = []
        for layer, heads in cfgmap.items():
            probs = captured[layer][0]  # (heads, L_enc, L_audio), still on the device
            keep = [h for h in heads if h < probs.shape[0]]
            if keep:  # only the configured heads cross to the host
                maps.append(probs[keep].float().cpu().numpy())
        if not maps:
            return {"attn": None}
        attn = np.concatenate(maps)
        # The lyric tokens lead the packed condition sequence (lyric, timbre,
        # text); the lyric prompt's header comes first among them.
        header = self.format_lyrics("", vocal_language).split("<|endoftext|>")[0]
        header_len = len(_encode(self.text_tokenizer, header))
        ids = [int(x) for x in np.asarray(lyric_token_ids).reshape(-1)]
        start = min(header_len, len(ids))
        pure_ids = ids[start:]
        return {"attn": attn[:, start : start + len(pure_ids), :], "ids": pure_ids}

    def align_lyrics(self, captured: Dict[str, Any], lyrics_text: str,
                     total_duration_seconds: float) -> Dict[str, Any]:
        """The host half of `get_lyric_timestamps` (numpy): token and
        sentence stamps at the patched frame rate, clamped to the duration,
        the LRC text and the lyric score."""
        if captured["attn"] is None:
            return {"success": False, "error": "no attention maps captured"}
        attn_lyric, pure_ids = captured["attn"], captured["ids"]
        # Patched latent frames at a fixed rate (LATENT_FPS / patch_size), not
        # frames over duration: the capture ran at the bucketed length.
        aligner = MusicStampsAligner(self.text_tokenizer, frames_per_second=LATENT_FPS / self.config.patch_size)
        token_stamps = aligner.token_timestamps(attn_lyric, pure_ids)
        sentences = [l for l in lyrics_text.split("\n") if l.strip()]
        sent_stamps = aligner.sentence_timestamps(attn_lyric, pure_ids, sentences)
        # Attention on the bucket's pad frames would stamp past the audio's end.
        for st in token_stamps + sent_stamps:
            st.start = min(st.start, total_duration_seconds)
            st.end = min(st.end, total_duration_seconds)
        quality = MusicLyricScorer(self.text_tokenizer).score(attn_lyric, pure_ids, {})
        return {
            "success": True,
            "lrc_text": format_lrc(sent_stamps),
            "token_timestamps": [st.__dict__ for st in token_stamps],
            "sentence_timestamps": [st.__dict__ for st in sent_stamps],
            "lyrics_score": quality.get("lyrics_score", 0.0),
            "lyrics_score_detail": quality,
        }

    # ------------------------------------------------------------------
    # generate_music
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate_music(
        self,
        captions: Union[str, List[str]],
        lyrics: Union[str, List[str]],
        *,
        batch_size: Optional[int] = None,
        metas: Optional[List[Union[str, Dict[str, Any], None]]] = None,
        vocal_languages: Optional[List[str]] = None,
        audio_duration: float = -1.0,
        task_type: str = "text2music",
        instructions: Optional[List[str]] = None,
        seeds: Optional[Union[str, int, List[int]]] = None,
        use_random_seed: bool = True,
        inference_steps: Optional[int] = None,
        shift: float = 3.0,
        timesteps: Optional[List[float]] = None,
        infer_method: str = "ode",
        guidance_scale: float = 1.0,
        use_adg: bool = False,
        cfg_interval_start: float = 0.0,
        cfg_interval_end: float = 1.0,
        audio_code_strings: Optional[List[Optional[str]]] = None,
        target_latents: Optional[np.ndarray] = None,
        reference_audios: Optional[List[Optional[np.ndarray]]] = None,
        repainting_start: Optional[List[Optional[float]]] = None,
        repainting_end: Optional[List[Optional[float]]] = None,
        audio_cover_strength: float = 1.0,
        cover_noise_strength: float = 0.0,
        latent_shift: float = 0.0,
        latent_rescale: float = 1.0,
        decode_audio: bool = True,
        normalize_db: Optional[float] = None,
        return_int16: bool = False,
        return_condition: bool = False,
        sde_noise: Optional[Sequence[torch.Tensor]] = None,
        async_finish: bool = False,
        chunk_sink: Optional[Any] = None,
        _shard: bool = False,
    ) -> Dict[str, Any]:
        """Run the DiT side of any task: `task_type` picks the default
        instruction; source latents (`target_latents`), repaint spans, code
        hints and reference audio condition each row as in the JAX handler.
        `sde_noise[i]`, when given, is SDE step i's noise in place of the
        seeded draw, shaped like the padded latents (B, T_pad, 64). Returns latents, audio and stage timings.

        `async_finish=True` returns once the denoise is done and the decode
        and its host copies are enqueued: `result["finish"]()` gathers the
        audio later (a serving loop calls it after dispatching the next
        request). `chunk_sink(pos, pcm_i16, total)` streams the int16 PCM
        chunk by chunk (see `decode_latents`).

        Under a mesh rank 0 runs the request on every rank (`_lead_generate`);
        `_shard` marks a rank's own share of it, which returns its dp group's
        rows on the group's representative (sp = 0, tp = 0) and None on the
        other ranks, and on every rank outside dp group 0 for a batch that
        does not divide by dp."""
        if not self.initialized:
            raise RuntimeError("call initialize_service() first")
        if self.mesh is not None and not _shard:
            return self._lead_generate({k: v for k, v in locals().items() if k not in ("self", "_shard")})
        time_costs: Dict[str, float] = {}
        t_start = time.time()
        if chunk_sink is not None and not isinstance(chunk_sink, StreamCursor):
            chunk_sink = StreamCursor(chunk_sink)

        captions = [captions] if isinstance(captions, str) else list(captions)
        lyrics = [lyrics] if isinstance(lyrics, str) else list(lyrics)
        b = batch_size or len(captions)
        if self.mesh is not None and b % self.mesh.shape["dp"] and self.mesh.coord["dp"]:
            return None  # the batch runs on dp group 0
        captions = (captions * b)[:b]
        lyrics = (lyrics * b)[:b]
        parsed_metas = self.parse_metas(metas, b)
        vocal_languages = vocal_languages or ["unknown"] * b
        seed_list, seed_str = self.prepare_seeds(b, seeds, use_random_seed and seeds is None)

        duration = audio_duration if audio_duration and audio_duration > 0 else 30.0
        t_exact = int(duration * LATENT_FPS)
        t_latent = pick_bucket(t_exact, LATENT_BUCKETS)
        t_exact = min(t_exact, t_latent)
        latent_mask = np.zeros((b, t_latent), np.int32)
        latent_mask[:, :t_exact] = 1

        instructions = instructions or [self.generate_instruction(task_type)] * b
        instructions = [self.format_instruction(i) for i in instructions]
        code_hints = audio_code_strings or [None] * b
        has_code_hints = [bool(c and c.strip()) for c in code_hints]
        silence_tiled = self._silence_tiled(t_latent)
        if target_latents is not None:
            target_latents = self._target_latents(target_latents, b, t_latent, silence_tiled)
        chunk_masks, spans, is_covers, src_latents = self.build_chunk_masks_and_src_latents(
            b, t_latent, instructions, has_code_hints, target_latents, [target_latents is not None] * b,
            repainting_start, repainting_end, silence_tiled,
        )

        text_prompts = [SFT_GEN_PROMPT.format(instructions[i], captions[i], parsed_metas[i]) for i in range(b)]
        lyric_texts = [self.format_lyrics(lyrics[i], vocal_languages[i]) for i in range(b)]
        text_ids, text_mask = tokenize_padded(self.text_tokenizer, text_prompts, 256, buckets=TEXT_BUCKETS)
        lyric_ids, lyric_mask = tokenize_padded(self.text_tokenizer, lyric_texts, 2048, buckets=LYRIC_BUCKETS)

        # Under a mesh this rank's rows (every row for a batch that does not
        # divide by dp): the DiT's inputs, seeds, references and hints.
        rows = self.mesh.rows(b) if self.mesh is not None else slice(0, b)
        sb = self._shard_batch_array
        t0 = time.time()
        text_hidden = self.infer_text_embeddings(text_ids)
        lyric_hidden = self.infer_lyric_embeddings(lyric_ids)
        t_enc = time.time()
        packed, order, max_refs = self._reference_latents(reference_audios, b, silence_tiled, rows)
        if reference_audios and any(r is not None for r in reference_audios):
            time_costs["vae_encode_time_cost"] = time.time() - t_enc
        refer_packed = self._tensor(packed, self.dtype)
        refer_order = self._tensor(order, torch.int32)
        self._sync()
        time_costs["encoder_time_cost"] = time.time() - t0

        t0 = time.time()
        t0_mark = self._mark()
        silence_dev = self._tensor(silence_tiled[None], self.dtype)
        if not any(has_code_hints[rows]) and target_latents is None:
            src = silence_dev.expand(rows.stop - rows.start, -1, -1)  # every row's source is the tiled silence
        else:
            src = self._tensor(sb(src_latents), self.dtype)
        if any(has_code_hints[rows]):
            hints = self._code_hints(code_hints[rows], t_latent, silence_dev[0])
        elif not is_covers[rows].any():
            hints = src  # no cover row: the hints go unused, so no tokenizer chain runs
        else:
            hints = None  # cover rows without codes: hints from the source latents
        outputs = dit.generate_audio(
            self._effective_params(),
            self.config,
            text_hidden_states=sb(text_hidden.to(self.dtype)),
            text_attention_mask=self._tensor(sb(text_mask)),
            lyric_hidden_states=sb(lyric_hidden.to(self.dtype)),
            lyric_attention_mask=self._tensor(sb(lyric_mask)),
            refer_packed=refer_packed,
            refer_order_mask=refer_order,
            src_latents=src,
            chunk_masks=self._tensor(sb(chunk_masks)),
            is_covers=self._tensor(sb(is_covers.astype(np.int32))),
            silence_latent=silence_dev,
            attention_mask=self._tensor(sb(latent_mask)),
            seeds=seed_list[rows],
            shift=shift,
            timesteps=timesteps,
            infer_method=infer_method,
            audio_cover_strength=audio_cover_strength,
            cover_noise_strength=cover_noise_strength,
            precomputed_lm_hints_25hz=hints,
            guidance_scale=guidance_scale,
            use_adg=use_adg,
            cfg_interval_start=cfg_interval_start,
            cfg_interval_end=cfg_interval_end,
            infer_steps=inference_steps,
            max_refs=max_refs,
            return_condition=return_condition,
            sde_noise=sde_noise,
            sde_rows=(rows.start, rows.stop, b, seed_list[0]),
            shards=Shards(self.mesh) if self.mesh is not None else None,
        )
        if self.mesh is not None and (self.mesh.coord["sp"] or self.mesh.coord["tp"]):
            return None  # the group's representative decodes and answers
        pred = outputs["target_latents"]
        if latent_shift != 0.0 or latent_rescale != 1.0:
            pred = pred * latent_rescale + latent_shift
        pred = pred[:, :t_exact, :]
        # The latents' copy first, then the decode, then the wait on the
        # latents: the copy is ordered before the decode on the compute
        # stream, so the latents land when the denoise ends while the decode
        # runs on under the host work below. diffusion_time_cost is the
        # card's own span up to the copy: the host's wait would also hold
        # the decode's dispatch, which the host enqueues first.
        fetch, fetched = self._fetch(pred)
        decode_job = None
        dec_timings: Dict[str, float] = {}
        if decode_audio:
            try:
                decode_job = self._decode_latents_dispatch(
                    pred.to(self.dtype), self._decode_chunk_core(t_exact, b), normalize_db, start_copies=async_finish
                )
            except torch.OutOfMemoryError:
                pass
        pred_np = fetch()
        time_costs["diffusion_time_cost"] = (time.time() - t0 if t0_mark is None
                                             else t0_mark.elapsed_time(fetched) / 1000.0)
        time_costs["diffusion_per_step_time_cost"] = time_costs["diffusion_time_cost"] / max(outputs["num_steps"], 1)
        if not np.isfinite(pred_np).all():
            raise RuntimeError("Generation produced NaN or Inf latents.")
        if pred_np.size and np.abs(pred_np).sum() == 0:
            raise RuntimeError("Generation produced zero latents.")

        result: Dict[str, Any] = {
            "latents": pred_np,
            "seeds": seed_list,
            "seed_str": seed_str,
            "spans": spans,
            "num_steps": outputs["num_steps"],
        }
        if return_condition:
            cond = outputs["condition"]
            result["condition"] = {
                "encoder_hidden_states": cond["encoder_hidden_states"].float().cpu().numpy(),
                "encoder_attention_mask": cond["encoder_attention_mask"].cpu().numpy(),
                "context_latents": cond["context_latents"].float().cpu().numpy(),
            }
            # The whole (B, L) ids and mask: the LRC pass crops each row to
            # its own lyric length.
            result["lyric_token_ids"] = lyric_ids
            result["lyric_mask"] = np.asarray(lyric_mask)
        if decode_audio:
            decoded = None
            decoded_s = 0.0
            if decode_job is None:
                # A CUDA out-of-memory is raised at allocation, in dispatch:
                # the JAX handler's finish-time fallback to 128-frame chunks
                # (then the ladder) runs here, on the thread that owns the
                # compute, before finish.
                self._after_oom(dec_timings)
                t1 = time.time()
                decoded = self.decode_latents(pred, chunk_frames=128, normalize_db=normalize_db,
                                              return_int16=return_int16, timings=dec_timings, chunk_sink=chunk_sink)
                decoded_s = time.time() - t1

            def _finish():
                t1 = time.time()
                if decoded is not None:
                    wavs = decoded
                else:
                    wavs = self._decode_latents_finish(decode_job, return_int16=return_int16, timings=dec_timings,
                                                       chunk_sink=chunk_sink)
                time_costs["vae_decode_time_cost"] = decoded_s + time.time() - t1
                # compute_wait: decode compute still outstanding when finish
                # ran; transfer: the copies to the host and the gather.
                time_costs["vae_decode_compute_wait_time_cost"] = dec_timings.get("compute_wait_s", 0.0)
                time_costs["vae_decode_transfer_time_cost"] = dec_timings.get("transfer_s", 0.0)
                if dec_timings.get("f32_convert_s"):
                    time_costs["vae_decode_f32_convert_time_cost"] = dec_timings["f32_convert_s"]
                if dec_timings.get("retries"):
                    time_costs["vae_decode_hbm_retries"] = dec_timings["retries"]
                time_costs["total_time_cost"] = time.time() - t_start
                result["audios"] = wavs
                return wavs

            if async_finish:
                result["finish"] = _finish
            else:
                _finish()
        if "total_time_cost" not in time_costs:
            time_costs["total_time_cost"] = time.time() - t_start
        result["time_costs"] = time_costs
        debug.log("generation", f"generate_music b={b} t={t_latent} "
                  + " ".join(f"{k}={v:.3f}" for k, v in time_costs.items()))
        return result
