"""Public parameter/result dataclasses — API-compatible with the reference's
`acestep/inference.py` (GenerationParams :38-165, GenerationConfig :168-194,
GenerationResult :197-221).

A copy of `acestep_tpu/service/params.py` (the port imports nothing of
`acestep_tpu`); keep the two in step. The port's `service.inference` serves
every field but `auto_lrc` and `auto_score`, which raise until their slice.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Union


@dataclass
class GenerationParams:
    """Music generation parameters (field-for-field with the reference API)."""

    # Required inputs
    task_type: str = "text2music"
    # Left at this default, the instruction is AUTO-GENERATED from task_type
    # (+ track_name / complete_track_classes) — the role the reference UI's
    # update_instruction_ui fills (ui_helpers.py:126-145); set it explicitly
    # to override.
    instruction: str = "Fill the audio semantic mask based on the given conditions:"
    # Extract/Lego: which stem (constants.TRACK_NAMES); Complete: which track
    # classes to add (ref task_utils.py:69-101 instruction templates).
    track_name: Optional[str] = None
    complete_track_classes: Optional[List[str]] = None

    # Audio uploads. reference_audio accepts one path or a LIST of paths —
    # multiple timbre references are packed per sample with an order mask
    # (ref conditioning_embed.infer_refer_latent List[List[Tensor]] semantics).
    reference_audio: Optional[Union[str, List[str]]] = None
    src_audio: Optional[str] = None

    # LM code hints
    audio_codes: str = ""

    # Text inputs
    caption: str = ""
    lyrics: str = ""
    instrumental: bool = False

    # Metadata
    vocal_language: str = "unknown"
    bpm: Optional[int] = None
    keyscale: str = ""
    timesignature: str = ""
    duration: float = -1.0

    # Post-generation analysis (ref UI auto-LRC/auto-score post-pass,
    # generation_progress.py:386-427 — exposed as params here so REST gets it)
    auto_lrc: bool = False
    auto_score: bool = False

    # Audio post-processing
    enable_normalization: bool = True
    normalization_db: float = -1.0

    # Latent post-processing (before VAE decode)
    latent_shift: float = 0.0
    latent_rescale: float = 1.0

    # Advanced settings
    inference_steps: int = 8
    seed: int = -1
    guidance_scale: float = 7.0
    use_adg: bool = False
    cfg_interval_start: float = 0.0
    cfg_interval_end: float = 1.0
    shift: float = 1.0
    infer_method: str = "ode"
    timesteps: Optional[List[float]] = None

    repainting_start: float = 0.0
    repainting_end: float = -1
    audio_cover_strength: float = 1.0
    cover_noise_strength: float = 0.0

    # One-call LM pre-phases (ref api_server.py:467-471 → :1641-1723):
    # sample_mode (or a non-empty sample_query) drafts caption/lyrics/metas
    # via the LM's create_sample BEFORE generation; use_format runs
    # format_sample over the provided caption/lyrics. Both record their
    # drafted fields in `extra_outputs["lm_draft"]`.
    sample_mode: bool = False
    sample_query: str = ""
    use_format: bool = False

    # Metadata-only job modes (ref api_server.py:496-497 → :1852-1919):
    # analysis_only runs the LM's CoT metas phase over caption/lyrics and
    # returns them without generating audio; full_analysis_only encodes
    # src_audio to semantic codes and runs LM understanding over them
    # (deep analysis: metas + lyric transcription), also audio-free.
    analysis_only: bool = False
    full_analysis_only: bool = False

    # 5 Hz LM parameters
    thinking: bool = True
    lm_temperature: float = 0.85
    lm_cfg_scale: float = 2.0
    lm_top_k: int = 0
    lm_top_p: float = 0.9
    lm_repetition_penalty: float = 1.0
    lm_negative_prompt: str = "NO USER INPUT"
    use_cot_metas: bool = True
    use_cot_caption: bool = True
    use_cot_lyrics: bool = False
    use_cot_language: bool = True
    use_constrained_decoding: bool = True

    cot_bpm: Optional[int] = None
    cot_keyscale: str = ""
    cot_timesignature: str = ""
    cot_duration: Optional[float] = None
    cot_vocal_language: str = "unknown"
    cot_caption: str = ""
    cot_lyrics: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class GenerationConfig:
    """Batch/seed/output configuration (reference :168-194)."""

    batch_size: int = 2
    allow_lm_batch: bool = False
    use_random_seed: bool = True
    seeds: Optional[List[int]] = None
    lm_batch_chunk_size: int = 8
    constrained_decoding_debug: bool = False
    audio_format: str = "flac"
    output_dir: str = "./outputs"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class GenerationResult:
    """Generation result payload (reference :197-221).

    With `generate_music(..., defer_finish=True)` the device decode is already
    queued but `audios` is empty until `finish()` runs — call it AFTER
    dispatching the next request's compute to overlap this result's
    device→host transfer + save under that compute (pipelined serving)."""

    audios: List[Dict[str, Any]] = field(default_factory=list)
    status_message: str = ""
    extra_outputs: Dict[str, Any] = field(default_factory=dict)
    success: bool = True
    error: Optional[str] = None
    _finish: Optional[Any] = field(default=None, repr=False, compare=False)

    def finish(self) -> "GenerationResult":
        """Complete a deferred decode/save; idempotent."""
        if self._finish is not None:
            fn, self._finish = self._finish, None
            fn(self)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d.pop("_finish", None)
        return d


@dataclass
class UnderstandResult:
    """Result of `understand_music` (reference :223-268)."""

    caption: str = ""
    lyrics: str = ""
    bpm: Optional[int] = None
    duration: Optional[float] = None
    keyscale: str = ""
    language: str = ""
    timesignature: str = ""
    status_message: str = ""
    success: bool = True
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)
