"""`generate_music`: the orchestration entry of the service layer.

Port of `acestep_tpu/service/inference.py` (reference
`acestep/inference.py:309-776`): LM phase (CoT metadata + audio codes when
`thinking`) -> metadata merge -> source audio through the VAE encoder
(`src_audio`) and reference audio for timbre (`reference_audio`) -> the
instruction of the task (text2music, cover, repaint, extract, lego,
complete; text2music becomes cover when codes arrive) -> DiT phase
(`AceStepHandler.generate_music`) -> int16 PCM entries.

The LM phase runs whenever `thinking` is on and a planner is loaded, for
every task, as in the JAX package (`acestep_tpu/service/inference.py:289`);
the original system skips it for cover and repaint (ROADMAP C, followed
here, not fixed).

Raise `NotImplementedError` until their slices land: drafts (`sample_mode`,
`sample_query`, `use_format`), the analysis modes, auto LRC/score,
`save_audio=True` (the CLI writes WAV files itself), deferred finish and
streaming sinks.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import traceback
import uuid
from typing import Any, Dict, Optional

import numpy as np

from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams, GenerationResult
from acestep_tpu_torch.utils import audio as audio_utils
from acestep_tpu_torch.utils.constants import DURATION_MAX, DURATION_MIN, TASK_INSTRUCTIONS


def _merge_metadata_from_lm(params: GenerationParams, lm_meta: Dict[str, Any]) -> Dict[str, Any]:
    """Fill user-missing fields from the LM CoT (ref inference.py:262-306)."""
    merged: Dict[str, Any] = {}
    merged["bpm"] = params.bpm if params.bpm else lm_meta.get("bpm", "N/A")
    merged["keyscale"] = params.keyscale or lm_meta.get("keyscale", "N/A")
    merged["timesignature"] = params.timesignature or lm_meta.get("timesignature", "N/A")
    duration = params.duration if params.duration and params.duration > 0 else lm_meta.get("duration")
    try:
        duration = float(duration)
    except (TypeError, ValueError):
        duration = 30.0
    merged["duration"] = max(DURATION_MIN, min(duration, DURATION_MAX))
    caption = lm_meta.get("caption") if params.use_cot_caption else None
    merged["caption"] = caption or params.caption
    language = lm_meta.get("language") if params.use_cot_language else None
    merged["language"] = language or params.vocal_language
    return merged


def _resolve_lyrics(params: GenerationParams) -> str:
    return "[Instrumental]" if params.instrumental and not params.lyrics else params.lyrics


def _metas_string(merged: Dict[str, Any]) -> str:
    return (
        f"- bpm: {merged['bpm']}\n"
        f"- timesignature: {merged['timesignature']}\n"
        f"- keyscale: {merged['keyscale']}\n"
        f"- duration: {int(merged['duration'])} seconds\n"
    )


def deterministic_uuid(params: Dict[str, Any]) -> str:
    """Stable UUID from generation params (a copy of `acestep_tpu/utils/audio.py`'s)."""
    blob = json.dumps(params, sort_keys=True, default=str).encode()
    return str(uuid.UUID(hashlib.md5(blob).hexdigest()))


def _unported(params: GenerationParams, save_audio: bool, defer_finish: bool, chunk_sink) -> Optional[str]:
    if params.sample_mode or (params.sample_query or "").strip() or params.use_format:
        return "LM drafts (sample_mode/sample_query/use_format) need generate_free"
    if params.analysis_only or params.full_analysis_only:
        return "analysis_only/full_analysis_only"
    if params.auto_lrc or params.auto_score:
        return "auto LRC / lyric score"
    if save_audio:
        return "save_audio=True (write the returned int16 PCM, as the CLI does)"
    if defer_finish or chunk_sink is not None:
        return "deferred finish / streaming sinks"
    return None


def generate_music(
    dit_handler,
    llm_handler,
    params: GenerationParams,
    config: Optional[GenerationConfig] = None,
    save_audio: bool = False,
    defer_finish: bool = False,
    chunk_sink=None,
) -> GenerationResult:
    """Any task, with or without the LM planner, source audio or reference
    audio. Returns a GenerationResult whose `audios` entries hold int16
    (2, L) PCM under "audio"."""
    what = _unported(params, save_audio, defer_finish, chunk_sink)
    if what is not None:
        raise NotImplementedError(f"{what} is not ported yet")
    config = config or GenerationConfig()
    t_start = time.time()
    time_costs: Dict[str, float] = {}
    extra: Dict[str, Any] = {}
    try:
        lyrics = _resolve_lyrics(params)
        # One resolved seed for the LM stages; an unseeded request draws anew.
        lm_seed = params.seed if params.seed >= 0 else int.from_bytes(os.urandom(4), "little") >> 1

        # ------------------ LM phase ------------------
        lm_meta: Dict[str, Any] = {}
        audio_codes = params.audio_codes or ""
        batch_codes = None
        if params.thinking and llm_handler is not None and llm_handler.initialized:
            dur = params.cot_duration or params.duration
            user_metadata = {
                "bpm": str(params.cot_bpm or params.bpm) if (params.cot_bpm or params.bpm) else None,
                "keyscale": params.cot_keyscale or params.keyscale or None,
                "timesignature": params.cot_timesignature or params.timesignature or None,
                "duration": str(int(dur)) if dur and dur > 0 else None,
                "language": None,
            }
            lm_out = llm_handler.generate_with_stop_condition(
                caption=params.caption,
                lyrics=lyrics,
                temperature=params.lm_temperature,
                cfg_scale=params.lm_cfg_scale,
                top_k=params.lm_top_k,
                top_p=params.lm_top_p,
                repetition_penalty=params.lm_repetition_penalty,
                negative_prompt=params.lm_negative_prompt,
                user_metadata=user_metadata if params.use_cot_metas else None,
                target_duration=params.duration if params.duration > 0 else None,
                use_constrained_decoding=params.use_constrained_decoding,
                seed=lm_seed,
                batch_size=config.batch_size if config.allow_lm_batch else 1,
                batch_chunk_size=config.lm_batch_chunk_size,
            )
            lm_meta = lm_out["metadata"]
            if not audio_codes:
                audio_codes = lm_out.get("audio_codes", "")
            batch_codes = lm_out.get("batch_audio_codes")
            extra["lm_metadata"] = lm_meta
            extra["lm_seed"] = lm_seed
            extra["cot_text"] = lm_out.get("cot_text", "")
            time_costs.update(lm_out.get("time_costs", {}))

        merged = _merge_metadata_from_lm(params, lm_meta)
        metas_str = _metas_string(merged)

        # ------------------ DiT phase ------------------
        b = config.batch_size
        reference_audio = None
        if params.reference_audio:
            paths = (params.reference_audio if isinstance(params.reference_audio, (list, tuple))
                     else [params.reference_audio])
            # One row's reference set; the handler packs several per row and
            # encodes each distinct array once.
            reference_audio = [audio_utils.load_audio(p) for p in paths]
        target_latents = None
        src_encode_s = 0.0
        if params.src_audio:
            src = audio_utils.load_audio(params.src_audio)
            t0 = time.time()
            z = dit_handler.encode_reference_audio(src)
            src_encode_s = time.time() - t0
            target_latents = np.repeat(z[None], b, axis=0)

        repaint = params.task_type in ("repaint", "lego") and params.repainting_end != 0
        rep_end = params.repainting_end
        if repaint and rep_end is not None and rep_end < 0:
            rep_end = merged["duration"]  # a negative end repaints to the end of the song

        instruction = params.instruction
        if not instruction or instruction == TASK_INSTRUCTIONS["text2music"]:
            task_for_instr = params.task_type
            if (audio_codes or "").strip() or (batch_codes and any((c or "").strip() for c in batch_codes)):
                # Audio codes switch text2music to the cover instruction (ref
                # generate_music_request.py:46-56), as the per-sample cover
                # flag already does.
                task_for_instr = "cover"
            instruction = dit_handler.generate_instruction(
                task_for_instr, params.track_name, params.complete_track_classes
            )
        if batch_codes and not params.audio_codes:
            code_strings = [c or None for c in batch_codes][:b] + [audio_codes or None] * max(0, b - len(batch_codes))
        else:
            code_strings = [audio_codes or None] * b

        out = dit_handler.generate_music(
            captions=[merged["caption"]] * b,
            lyrics=[lyrics] * b,
            batch_size=b,
            metas=[metas_str] * b,
            vocal_languages=[merged["language"]] * b,
            audio_duration=merged["duration"],
            task_type=params.task_type,
            instructions=[instruction] * b,
            seeds=config.seeds if config.seeds is not None else (params.seed if params.seed >= 0 else None),
            use_random_seed=config.use_random_seed and params.seed < 0 and config.seeds is None,
            inference_steps=(None if params.inference_steps == 8 else params.inference_steps),
            shift=params.shift if params.shift else 3.0,
            timesteps=params.timesteps,
            infer_method=params.infer_method,
            guidance_scale=params.guidance_scale if params.inference_steps > 8 else 1.0,
            audio_code_strings=code_strings,
            target_latents=target_latents,
            reference_audios=[reference_audio] * b if reference_audio is not None else None,
            repainting_start=[params.repainting_start] * b if repaint else None,
            repainting_end=[rep_end] * b if repaint else None,
            audio_cover_strength=params.audio_cover_strength,
            cover_noise_strength=params.cover_noise_strength,
            latent_shift=params.latent_shift,
            latent_rescale=params.latent_rescale,
            normalize_db=params.normalization_db if params.enable_normalization else None,
            return_int16=True,
        )
        time_costs.update(out["time_costs"])
        if params.src_audio:
            time_costs["vae_encode_time_cost"] = time_costs.get("vae_encode_time_cost", 0.0) + src_encode_s

        audios = []
        for i in range(out["audios"].shape[0]):
            seed = out["seeds"][i]
            audios.append({
                "params": params.to_dict(),
                "seed": seed,
                "key": deterministic_uuid({**params.to_dict(), "seed": seed, "index": i}),
                "metas": metas_str,
                "audio": out["audios"][i],
            })
        time_costs["pipeline_total_time_cost"] = time.time() - t_start
        extra["time_costs"] = time_costs
        extra["latents_shape"] = list(out["latents"].shape)
        extra["audio_codes"] = audio_codes
        extra["batch_audio_codes"] = code_strings
        return GenerationResult(
            audios=audios,
            status_message=f"Generated {len(audios)} audio(s) in {time_costs['pipeline_total_time_cost']:.2f}s",
            extra_outputs=extra,
            success=True,
        )
    except Exception as e:  # noqa: BLE001 — job servers need failure payloads
        return GenerationResult(
            audios=[], status_message="Generation failed", extra_outputs=extra, success=False,
            error=f"{e}\n{traceback.format_exc()}",
        )
