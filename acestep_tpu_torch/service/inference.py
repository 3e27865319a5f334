"""`generate_music`: the orchestration entry of the service layer.

Port of `acestep_tpu/service/inference.py` (reference
`acestep/inference.py:309-776`): LM phase (CoT metadata + audio codes when
`thinking`) -> metadata merge -> source audio through the VAE encoder
(`src_audio`) and reference audio for timbre (`reference_audio`) -> the
instruction of the task (text2music, cover, repaint, extract, lego,
complete; text2music becomes cover when codes arrive) -> DiT phase
(`AceStepHandler.generate_music`) -> int16 PCM entries.

Before the LM phase, one call can run the planner's free-form APIs: the
analysis modes (`analysis_only`: the CoT metadata of the caption and lyrics;
`full_analysis_only`: understanding of `audio_codes` or of the source audio's
codes) return metadata without audio, and the drafts (`sample_mode` or a
`sample_query`: create_sample; `use_format`: format_sample) fill the request
before generation. `understand_music`, `create_sample` and `format_sample`
wrap the planner's APIs. The DiT call guides (APG or ADG, the CFG interval)
only when `inference_steps > 8`.

The LM phase runs whenever `thinking` is on and a planner is loaded, for
every task, as in the JAX package (`acestep_tpu/service/inference.py:289`);
the original system skips it for cover and repaint (ROADMAP C, followed
here, not fixed).

Results are saved (`save_audio=True`, the default) in the request's
`audio_format` (FLAC by default, WAV, WAV32, others through ffmpeg) with a
`{key}.json` params sidecar, or returned as int16 PCM under "audio"
(`save_audio=False`). `defer_finish=True` returns once the decode is queued
on the card; `result.finish()` completes the transfer and the save later (the
server's pipelined worker). `chunk_sink` streams the PCM as the decode's
chunks reach the host. `merge_eligible`, `merge_group_key` and
`generate_music_merged` fuse compatible single-sample requests into one
batch (the server's dynamic batching).

`auto_lrc` and `auto_score` add the lyric post-pass: one capture forward per
row on the card (`AceStepHandler.capture_lyric_attention`), then the host's
alignment (`align_lyrics`), whose `lrc`, `sentence_timestamps` and
`lyrics_score` join that row's entry (at finish when it is deferred). An
error of the alignment becomes that row's `{"success": False, "error"}` and
the entry goes without them, as in the JAX package. An error of the capture
forward (the card's out-of-memory or a failed launch) fails the request,
where the JAX package records it on the row as well (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np

from acestep_tpu_torch.service.params import (
    GenerationConfig,
    GenerationParams,
    GenerationResult,
    UnderstandResult,
)
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


def _draft_updates(params: GenerationParams, md: Dict[str, Any], wants_sample: bool) -> Dict[str, Any]:
    """The request fields a draft fills. Drafted lyrics never override an
    instrumental request in format mode (create_sample drafts from nothing,
    so there its lyrics win); drafted metadata fills only the fields the user
    left unset."""
    updates: Dict[str, Any] = {}
    if md.get("caption"):
        updates["caption"] = str(md["caption"])
    if md.get("lyrics") and (wants_sample or not params.instrumental):
        updates["lyrics"] = str(md["lyrics"])
        updates["instrumental"] = False
    if md.get("bpm") and not params.bpm:
        try:
            updates["bpm"] = int(md["bpm"])
        except (TypeError, ValueError):
            pass
    if md.get("keyscale") and not params.keyscale:
        updates["keyscale"] = str(md["keyscale"])
    if md.get("timesignature") and not params.timesignature:
        updates["timesignature"] = str(md["timesignature"])
    if md.get("duration") and params.duration <= 0:
        try:
            updates["duration"] = float(md["duration"])
        except (TypeError, ValueError):
            pass
    return updates


def _save_entry(
    dit_handler,
    params: GenerationParams,
    config: GenerationConfig,
    wav: np.ndarray,
    seed: int,
    metas_str: str,
    audio_codes: str,
    index: int,
    save_audio: bool,
) -> Dict[str, Any]:
    """One result entry, shared by the solo and merged paths so their files
    cannot differ: the deterministic key; with `save_audio` the audio file
    in `config.audio_format` and its `{key}.json` params sidecar, else the
    int16 PCM under "audio"."""
    entry: Dict[str, Any] = {
        "params": params.to_dict(),
        "seed": seed,
        "key": audio_utils.deterministic_uuid({**params.to_dict(), "seed": seed, "index": index}),
        "metas": metas_str,
    }
    if save_audio:
        os.makedirs(config.output_dir, exist_ok=True)
        path = os.path.join(config.output_dir, entry["key"])
        entry["path"] = audio_utils.save_audio(path, wav, fmt=config.audio_format,
                                               sample_rate=dit_handler.vae_config.sampling_rate)
        sidecar = {**entry["params"], "seed": seed, "metas": metas_str, "audio_codes": audio_codes}
        entry["params_path"] = path + ".json"
        with open(entry["params_path"], "w", encoding="utf-8") as f:
            json.dump(sidecar, f, indent=2, ensure_ascii=False)
    else:
        entry["audio"] = wav
    return entry


def generate_music(
    dit_handler,
    llm_handler,
    params: GenerationParams,
    config: Optional[GenerationConfig] = None,
    save_audio: bool = True,
    defer_finish: bool = False,
    chunk_sink=None,
) -> GenerationResult:
    """Any task, with or without the LM planner, source audio or reference
    audio. Returns a GenerationResult with one entry per row: saved files
    (`save_audio`) or int16 (2, L) PCM under "audio".

    `defer_finish=True` returns as soon as the denoise is done and the
    decode is queued on the card: `result.audios` stays empty until
    `result.finish()` completes the transfer and the save.
    `chunk_sink(pos, pcm_i16, total_samples)` receives the PCM chunk by
    chunk (`/v1/generate_stream`)."""
    config = config or GenerationConfig()
    t_start = time.time()
    time_costs: Dict[str, float] = {}
    extra: Dict[str, Any] = {}
    try:
        lyrics = _resolve_lyrics(params)
        wants_sample = params.sample_mode or bool((params.sample_query or "").strip())
        lm_ok = llm_handler is not None and llm_handler.initialized
        # One resolved seed for every LM stage of the request (analysis, draft,
        # thinking); an unseeded request draws a fresh 31-bit seed.
        lm_seed = params.seed if params.seed >= 0 else int.from_bytes(os.urandom(4), "little") >> 1

        # ------------------ metadata-only modes ------------------
        if params.analysis_only or params.full_analysis_only:
            if not lm_ok:
                raise RuntimeError(
                    "analysis_only/full_analysis_only require the 5Hz LM, which is not initialized")
            t_an = time.time()
            if params.full_analysis_only:
                codes = (params.audio_codes or "").strip()
                if not codes:
                    if not params.src_audio:
                        raise ValueError("full_analysis_only needs src_audio (or audio_codes)")
                    codes = dit_handler.convert_audio_to_codes(audio_utils.load_audio(params.src_audio))
                # The deep analysis runs at temperature 0.3, as the reference worker does.
                md = llm_handler.understand_audio_from_codes(codes, temperature=0.3, seed=lm_seed).get(
                    "metadata", {})
                status = "full analysis complete"
                extra["audio_codes"] = codes
            else:
                md = llm_handler.generate_with_stop_condition(
                    caption=params.caption,
                    lyrics=lyrics,
                    temperature=params.lm_temperature,
                    top_p=params.lm_top_p,
                    use_constrained_decoding=True,
                    stop_at_reasoning=True,
                    seed=lm_seed,
                ).get("metadata", {})
                status = "analysis complete"
            extra["lm_metadata"] = md
            time_costs["analysis_time_cost"] = time.time() - t_an
            time_costs["total_time_cost"] = time.time() - t_start
            extra["time_costs"] = time_costs
            return GenerationResult(audios=[], status_message=status, extra_outputs=extra, success=True)

        # ------------------ drafts ------------------
        if (wants_sample or params.use_format) and not lm_ok:
            if params.sample_mode or params.use_format:
                raise RuntimeError(
                    "sample_mode/sample_query/use_format require the 5Hz LM, which is not initialized")
            # A sample query alone demotes to the caption when no LM is loaded.
            params = dataclasses.replace(params, sample_query="", caption=params.caption or params.sample_query)
            wants_sample = False
        if wants_sample or params.use_format:
            t_draft = time.time()
            if wants_sample:
                query = (params.sample_query or "").strip() or "NO USER INPUT"
                md = llm_handler.create_sample_from_query(
                    query, temperature=params.lm_temperature, seed=lm_seed).get("metadata", {})
            else:
                # Only the user's own caption and lyrics count as input: the
                # "[Instrumental]" placeholder of an instrumental request does not.
                raw_lyrics = (params.lyrics or "").strip()
                if not (params.caption or raw_lyrics):
                    md = {}
                else:
                    fmt_input = params.caption
                    if raw_lyrics and not params.instrumental:
                        fmt_input = f"{fmt_input}\n\n# Lyrics\n{raw_lyrics}".strip()
                    md = llm_handler.format_sample_from_input(
                        fmt_input, temperature=params.lm_temperature, seed=lm_seed).get("metadata", {})
            updates = _draft_updates(params, md, wants_sample)
            if updates:
                params = dataclasses.replace(params, **updates)
                lyrics = _resolve_lyrics(params)
            extra["lm_draft"] = {**updates, "mode": "create_sample" if wants_sample else "format_sample",
                                 "seed": lm_seed}
            time_costs["lm_draft_time_cost"] = time.time() - t_draft

        # ------------------ LM phase ------------------
        lm_meta: Dict[str, Any] = {}
        audio_codes = params.audio_codes or ""
        batch_codes = None
        if params.thinking and lm_ok:
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
            use_adg=params.use_adg,
            cfg_interval_start=params.cfg_interval_start,
            cfg_interval_end=params.cfg_interval_end,
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
            return_condition=params.auto_lrc or params.auto_score,
            async_finish=defer_finish,
            chunk_sink=chunk_sink,
        )
        time_costs.update(out["time_costs"])

        # ------------------ auto LRC / lyric score ------------------
        lrc_per_sample: List[Optional[Dict[str, Any]]] = [None] * b
        if (params.auto_lrc or params.auto_score) and "condition" in out:
            for i in range(out["latents"].shape[0]):
                captured = dit_handler.capture_lyric_attention(
                    out["latents"], out["condition"], out["lyric_token_ids"],
                    vocal_language=merged.get("language") or "en",
                    inference_steps=params.inference_steps,
                    sample_idx=i,
                    lyric_mask=out.get("lyric_mask"),
                )
                try:
                    lrc_per_sample[i] = dit_handler.align_lyrics(captured, lyrics, float(merged["duration"]))
                except Exception as lrc_err:  # noqa: BLE001 — the score is best-effort
                    lrc_per_sample[i] = {"success": False, "error": str(lrc_err)}

        def complete_save() -> List[Dict[str, Any]]:
            wavs = out["finish"]() if "finish" in out else out["audios"]
            time_costs.update(out["time_costs"])  # the decode's split lands here
            if params.src_audio:
                time_costs["vae_encode_time_cost"] = out["time_costs"].get("vae_encode_time_cost", 0.0) + src_encode_s
            audios = []
            for i in range(wavs.shape[0]):
                entry = _save_entry(dit_handler, params, config, wavs[i], out["seeds"][i], metas_str, audio_codes,
                                    i, save_audio)
                lrc = lrc_per_sample[i] if i < len(lrc_per_sample) else None
                if lrc and lrc.get("success"):
                    if params.auto_lrc:
                        entry["lrc"] = lrc["lrc_text"]
                        entry["sentence_timestamps"] = lrc["sentence_timestamps"]
                    if params.auto_score:
                        entry["lyrics_score"] = lrc.get("lyrics_score")
                audios.append(entry)
            time_costs["pipeline_total_time_cost"] = time.time() - t_start
            return audios

        extra["time_costs"] = time_costs
        extra["latents_shape"] = list(out["latents"].shape)
        extra["audio_codes"] = audio_codes
        extra["batch_audio_codes"] = code_strings

        if defer_finish and "finish" in out:
            def _fin(result: GenerationResult) -> None:
                try:
                    result.audios = complete_save()
                    result.status_message = (
                        f"Generated {len(result.audios)} audio(s) in {time_costs['pipeline_total_time_cost']:.2f}s")
                except Exception as fin_err:  # noqa: BLE001
                    result.success = False
                    result.status_message = "Generation failed"
                    result.error = f"{fin_err}\n{traceback.format_exc()}"

            return GenerationResult(audios=[], status_message="decode queued (call finish())", extra_outputs=extra,
                                    success=True, _finish=_fin)

        audios = complete_save()
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


def merge_eligible(params: GenerationParams) -> bool:
    """Whether a request can join a dynamically batched generation: plain
    text2music with no per-request device inputs beyond caption, lyrics and
    seed (no LM phase, no audio or codes, no repaint, no LRC post-pass, the
    default schedule surface). Everything else runs solo."""
    return (
        not params.thinking
        and not params.sample_mode
        and not (params.sample_query or "").strip()
        and not params.use_format
        and not params.analysis_only
        and not params.full_analysis_only
        and params.task_type == "text2music"
        and not params.reference_audio
        and not params.src_audio
        and not params.audio_codes
        and not params.auto_lrc
        and not params.auto_score
        and not params.timesteps
    )


def merge_group_key(params: GenerationParams, config: GenerationConfig):
    """Requests with equal keys run as one batch: one denoise and one decode."""
    if not merge_eligible(params) or config.batch_size != 1:
        return None
    return (
        round(float(params.duration), 3),
        params.inference_steps,
        params.shift,
        params.infer_method,
        params.guidance_scale,
        params.use_adg,
        params.cfg_interval_start,
        params.cfg_interval_end,
        params.enable_normalization,
        params.normalization_db,
        params.latent_shift,
        params.latent_rescale,
        params.instruction,
        config.audio_format,
    )


def generate_music_merged(
    dit_handler,
    items: List[tuple],  # [(GenerationParams, GenerationConfig), ...] with one merge key
    save_audio: bool = True,
    defer_finish: bool = False,
) -> List[GenerationResult]:
    """Run N merged single-sample requests as ONE batch-N generation; the
    per-request captions, lyrics and seeds ride the handler's batch axis, and
    the results split back into one GenerationResult per request, each with
    its own key and sidecar. With `defer_finish`, the results share one
    decode finish (lock-guarded): the first `finish()` pays the transfer."""
    n = len(items)
    if n < 1:
        raise ValueError("generate_music_merged needs at least one request")
    t_start = time.time()
    p0, _ = items[0]

    captions, lyricses, metas, langs, seeds = [], [], [], [], []
    for params, config in items:
        merged = _merge_metadata_from_lm(params, {})
        captions.append(merged["caption"])
        lyricses.append(_resolve_lyrics(params))
        metas.append(_metas_string(merged))
        langs.append(merged["language"])
        # The draw of the handler's prepare_seeds, so merged and solo
        # requests resolve random seeds from one range.
        if config.seeds:
            seeds.append(int(config.seeds[0]))
        elif params.seed >= 0:
            seeds.append(int(params.seed))
        else:
            seeds.append(random.randint(0, 2**32 - 1))

    instruction = p0.instruction
    if not instruction or instruction == TASK_INSTRUCTIONS["text2music"]:
        instruction = dit_handler.generate_instruction("text2music", None, None)

    duration = max(DURATION_MIN, min(float(p0.duration or 30.0), DURATION_MAX))
    try:
        out = dit_handler.generate_music(
            captions=captions,
            lyrics=lyricses,
            batch_size=n,
            metas=metas,
            vocal_languages=langs,
            audio_duration=duration,
            task_type="text2music",
            instructions=[instruction] * n,
            seeds=seeds,
            use_random_seed=False,
            inference_steps=(None if p0.inference_steps == 8 else p0.inference_steps),
            shift=p0.shift if p0.shift else 3.0,
            infer_method=p0.infer_method,
            guidance_scale=p0.guidance_scale if p0.inference_steps > 8 else 1.0,
            use_adg=p0.use_adg,
            cfg_interval_start=p0.cfg_interval_start,
            cfg_interval_end=p0.cfg_interval_end,
            latent_shift=p0.latent_shift,
            latent_rescale=p0.latent_rescale,
            normalize_db=p0.normalization_db if p0.enable_normalization else None,
            return_int16=True,
            async_finish=defer_finish,
        )
    except Exception as e:  # noqa: BLE001 — every job gets the failure payload
        err = f"{e}\n{traceback.format_exc()}"
        return [GenerationResult(audios=[], status_message="Generation failed", success=False, error=err)
                for _ in items]

    shared: Dict[str, Any] = {"wavs": None}
    fin_lock = threading.Lock()

    def shared_finish():
        with fin_lock:
            if shared["wavs"] is None:
                shared["wavs"] = out["finish"]() if "finish" in out else out["audios"]
        return shared["wavs"]

    def save_one(i: int, params: GenerationParams, config: GenerationConfig) -> List[Dict[str, Any]]:
        wavs = shared_finish()
        # index 0: each merged request is batch 1 from its client's view.
        return [_save_entry(dit_handler, params, config, wavs[i], out["seeds"][i], metas[i], "", 0, save_audio)]

    results: List[GenerationResult] = []
    for i, (params, config) in enumerate(items):
        # Each job publishes the batch's costs; merged_share marks the
        # fraction that is this job's.
        extra = {
            "time_costs": {**out["time_costs"], "merged_share": round(1.0 / n, 4)},
            "latents_shape": list(out["latents"].shape),
            "audio_codes": "",
            "merged_batch": n,
        }
        if defer_finish and "finish" in out:
            def _fin(result: GenerationResult, i=i, params=params, config=config, extra=extra) -> None:
                try:
                    result.audios = save_one(i, params, config)
                    extra["time_costs"].update(out["time_costs"])
                    extra["time_costs"]["pipeline_total_time_cost"] = time.time() - t_start
                    result.status_message = "Generated 1 audio(s) (merged batch)"
                except Exception as fin_err:  # noqa: BLE001
                    result.success = False
                    result.status_message = "Generation failed"
                    result.error = f"{fin_err}\n{traceback.format_exc()}"

            results.append(GenerationResult(audios=[], status_message="decode queued (call finish())",
                                            extra_outputs=extra, success=True, _finish=_fin))
        else:
            try:
                audios = save_one(i, params, config)
                extra["time_costs"]["pipeline_total_time_cost"] = time.time() - t_start
                results.append(GenerationResult(audios=audios, status_message="Generated 1 audio(s) (merged batch)",
                                                extra_outputs=extra, success=True))
            except Exception as e:  # noqa: BLE001
                results.append(GenerationResult(audios=[], status_message="Generation failed", extra_outputs=extra,
                                                success=False, error=f"{e}\n{traceback.format_exc()}"))
    return results


def understand_music(llm_handler, audio_codes: str, **kw) -> UnderstandResult:
    """Audio codes -> metadata and lyrics."""
    try:
        md = llm_handler.understand_audio_from_codes(audio_codes, **kw)["metadata"]
        return UnderstandResult(
            caption=md.get("caption", ""),
            lyrics=md.get("lyrics", ""),
            bpm=md.get("bpm"),
            duration=md.get("duration"),
            keyscale=md.get("keyscale", ""),
            language=md.get("language", ""),
            timesignature=str(md.get("timesignature", "")),
            success=True,
        )
    except Exception as e:  # noqa: BLE001
        return UnderstandResult(success=False, error=str(e))


def create_sample(llm_handler, query: str = "", **kw) -> Dict[str, Any]:
    """A sample drafted from a query, or at random from an empty one."""
    out = llm_handler.create_sample_from_query(query or "Create a random music sample.", **kw)
    return {"metadata": out["metadata"], "text": out["text"], "success": True}


def format_sample(llm_handler, user_input: str, **kw) -> Dict[str, Any]:
    """Free-form input formatted into caption, lyrics and metadata."""
    out = llm_handler.format_sample_from_input(user_input, **kw)
    return {"metadata": out["metadata"], "text": out["text"], "success": True}
