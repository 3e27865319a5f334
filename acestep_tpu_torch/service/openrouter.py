"""OpenAI chat-completions-compatible facade over the generation pipeline.

A copy of `acestep_tpu/service/openrouter.py` on the port's service layer
(role parity with the reference's OpenRouter adapter,
`acestep/openrouter_adapter.py:199-773`): chat messages (text prompts and
base64 audio parts) become a GenerationParams, the audio parts are routed by
task, generation runs, and a chat completion embeds the saved audio as
base64. Mounted as extra routes on the port's API server. As in the JAX
package, an `input_audio` part's `format` is not read: every upload is
written as `.wav` (ROADMAP C, followed, not fixed).
"""

from __future__ import annotations

import base64
import json
import re
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

_DURATION_RE = re.compile(r"(\d+)\s*(?:s\b|sec|seconds?)", re.IGNORECASE)
_BPM_RE = re.compile(r"(\d+)\s*bpm", re.IGNORECASE)
_LYRICS_RE = re.compile(r"(?:#+\s*lyrics?|\[lyrics?\])\s*\n(.*)", re.IGNORECASE | re.DOTALL)
_TAG_PROMPT_RE = re.compile(r"<prompt>(.*?)</prompt>", re.IGNORECASE | re.DOTALL)
_TAG_LYRICS_RE = re.compile(r"<lyrics>(.*?)</lyrics>", re.IGNORECASE | re.DOTALL)
# Structural markers that identify a text block as song lyrics (ref
# openrouter_adapter.py:164-185 _looks_like_lyrics).
_LYRIC_MARKERS = ("[verse", "[chorus", "[bridge", "[intro", "[outro",
                  "[hook", "[pre-chorus", "[refrain", "[inst")


def _extract_tagged_content(text: str) -> Tuple[Optional[str], Optional[str], str]:
    """<prompt>/<lyrics> tagged-mode extraction (ref
    openrouter_adapter.py:140-162): returns (prompt, lyrics, remaining)."""
    prompt = lyric = None
    remaining = text
    m = _TAG_PROMPT_RE.search(text)
    if m:
        prompt = m.group(1).strip()
        remaining = remaining.replace(m.group(0), "").strip()
    m = _TAG_LYRICS_RE.search(text)
    if m:
        lyric = m.group(1).strip()
        remaining = remaining.replace(m.group(0), "").strip()
    return prompt, lyric, remaining


def _looks_like_lyrics(text: str) -> bool:
    """Heuristic lyric detection (ref openrouter_adapter.py:164-185):
    structural markers, or a ≥4-line block of short lines."""
    if not text:
        return False
    lower = text.lower()
    if any(marker in lower for marker in _LYRIC_MARKERS):
        return True
    lines = [ln.strip() for ln in text.split("\n") if ln.strip()]
    if len(lines) >= 4:
        return sum(len(ln) for ln in lines) / len(lines) < 60
    return False


def parse_chat_messages(messages: List[Dict[str, Any]]) -> Tuple[GenerationParams, List[bytes]]:
    """Chat messages → GenerationParams + ALL uploaded audio parts, in order.

    Input-mode resolution (ref openrouter_adapter.py:197-318 + the
    Openrouter_API_DOC "Input Modes" contract):
      - TAGGED: <prompt>…</prompt> / <lyrics>…</lyrics> blocks are explicit
        (a legacy "# Lyrics"-heading split is also honored);
      - LYRICS-ONLY: text with [verse]/[chorus]/… markers or a ≥4-short-line
        structure is treated as lyrics;
      - NATURAL LANGUAGE: untagged non-lyric text becomes `sample_query`
        (LM sample mode — `build_chat_request` demotes it to the caption
        when no LM is available).
    Inline "NN seconds" / "NN bpm" are additionally extracted as explicit
    metas (extension; the reference leaves these to audio_config or the LM).
    Multiple input_audio blocks are collected like multiple images;
    `route_chat_audio` assigns them to src/reference audio by task type."""
    prompt_parts: List[str] = []
    lyrics = ""
    has_tags = False
    audio_parts: List[bytes] = []

    for msg in messages:
        if msg.get("role") != "user":
            continue
        content = msg.get("content")
        parts = content if isinstance(content, list) else [{"type": "text", "text": str(content)}]
        for part in parts:
            if part.get("type") == "text":
                text = (part.get("text") or "").strip()
                if not text:
                    continue
                t_prompt, t_lyrics, remaining = _extract_tagged_content(text)
                if t_prompt is not None or t_lyrics is not None:
                    has_tags = True
                    if t_prompt:
                        prompt_parts.append(t_prompt)
                    if t_lyrics:
                        lyrics = t_lyrics
                    if remaining:
                        prompt_parts.append(remaining)
                    continue
                m = _LYRICS_RE.search(text)
                if m:
                    has_tags = True  # an explicit lyrics heading IS a tag
                    lyrics = m.group(1).strip()
                    head = text[: m.start()].strip()
                    if head:
                        prompt_parts.append(head)
                elif _looks_like_lyrics(text):
                    lyrics = text
                else:
                    prompt_parts.append(text)
            elif part.get("type") in ("input_audio", "audio"):
                data = part.get("input_audio", part.get("audio", {}))
                b64 = data.get("data") if isinstance(data, dict) else data
                if b64:
                    audio_parts.append(base64.b64decode(b64))

    caption = " ".join(p for p in prompt_parts if p).strip()
    sample_query = ""
    # Natural-language mode: no tags, no lyrics → the text is a sample query
    # for the LM to draft prompt+lyrics from (ref :313-316).
    if not has_tags and not lyrics and caption:
        sample_query, caption = caption, ""
    params = GenerationParams(caption=caption, lyrics=lyrics,
                              sample_query=sample_query)
    scan_text = caption or sample_query
    m = _DURATION_RE.search(scan_text)
    if m:
        params.duration = float(m.group(1))
    m = _BPM_RE.search(scan_text)
    if m:
        params.bpm = int(m.group(1))
    if lyrics:
        params.instrumental = False
    return params, audio_parts


# Tasks whose PRIMARY audio is the content being edited/covered — for these
# the first upload is src_audio (the reference's _SRC_AUDIO_TASK_TYPES,
# openrouter_adapter.py:712).
SRC_AUDIO_TASK_TYPES = frozenset({"cover", "repaint", "lego", "extract", "complete"})


def route_chat_audio(
    task_type: Optional[str], n_audio: int
) -> Tuple[str, Optional[int], Optional[int]]:
    """Audio-part routing by task (ref openrouter_adapter.py:700-722,364-369).

    Returns (resolved_task_type, src_index, reference_index) into the
    collected audio-part list:
      - cover/repaint/lego/extract/complete: audio[0] → src_audio (the song
        being edited/covered), audio[1] → reference_audio (timbre style);
      - text2music (default): audio[0] → reference_audio, and the task
        auto-promotes to "music_continuation" (style-conditioned generation —
        downstream it runs the text2music path with reference conditioning,
        exactly as in the reference where the label exists only here).
    An explicit task_type from the request body is honored as-is."""
    task = task_type or "text2music"
    if n_audio <= 0:
        return task, None, None
    if task in SRC_AUDIO_TASK_TYPES:
        return task, 0, (1 if n_audio > 1 else None)
    if task == "text2music":
        task = "music_continuation"
    return task, None, 0


def chat_body_overrides(body: Dict[str, Any]) -> Dict[str, Any]:
    """Coerced one-call LM pre-phase flags from the chat request body —
    shared by the streaming and non-streaming paths so a client sending
    e.g. `sample_mode: 1` gets identical typing on both."""
    out: Dict[str, Any] = {}
    for k in ("sample_mode", "use_format"):
        if body.get(k) is not None:
            out[k] = bool(body[k])
    if body.get("sample_query"):
        out["sample_query"] = str(body["sample_query"])
    return out


def build_chat_request(
    body: Dict[str, Any], llm_available: bool
) -> Tuple[GenerationParams, Dict[str, Any], List[bytes], Tuple[Optional[int], Optional[int]]]:
    """Full chat request body → (params, config_overrides, audio_parts,
    (src_index, reference_index)) — ONE assembly shared by the streaming and
    non-streaming chat paths (ref openrouter_adapter.py:323-427,660-722).

    Covers the reference's whole request schema: message input modes,
    explicit `lyrics` / `sample_mode` role switches, the `audio_config`
    object (duration/bpm/vocal_language/instrumental/format/key_scale/
    time_signature), `seed` (int or comma-separated), `guidance_scale`,
    `batch_size`, repaint/cover knobs, `use_cot_caption`/`use_cot_language`,
    and the OpenAI sampling params. Deviation: auto-detected sample mode
    degrades to caption text when no LM is loaded (the reference would fail
    the job; a caption-only generation is strictly more useful)."""
    params, audio_parts = parse_chat_messages(body.get("messages", []))

    # Explicit `lyrics` / `sample_mode` fields pin the message text's role,
    # overriding auto-detection (ref :677-694).
    if body.get("lyrics") or body.get("sample_mode"):
        raw_text = params.caption or params.sample_query or ""
        if body.get("lyrics"):
            params.caption = raw_text
            params.lyrics = str(body["lyrics"])
            params.sample_query = ""
            params.instrumental = params.lyrics.strip().lower() in (
                "", "[inst]", "[instrumental]")
        else:
            params.caption = ""
            params.lyrics = ""
            params.sample_query = raw_text
    for k, v in chat_body_overrides(body).items():
        setattr(params, k, v)
    # Auto-detected natural-language mode needs the LM; without one the
    # query text serves as the caption instead of failing the request.
    if params.sample_query and not llm_available and not body.get("sample_mode"):
        params.caption, params.sample_query = params.sample_query, ""
        params.sample_mode = False

    # audio_config object (ref :343-427).
    ac = body.get("audio_config") or {}
    if ac.get("duration"):
        params.duration = float(ac["duration"])
    if ac.get("bpm"):
        params.bpm = int(ac["bpm"])
    if ac.get("vocal_language"):
        params.vocal_language = str(ac["vocal_language"])
    if ac.get("key_scale"):
        params.keyscale = str(ac["key_scale"])
    if ac.get("time_signature"):
        params.timesignature = str(ac["time_signature"])
    if ac.get("instrumental") is not None:
        params.instrumental = bool(ac["instrumental"])

    # Generation / edit knobs.
    if body.get("guidance_scale") is not None:
        params.guidance_scale = float(body["guidance_scale"])
    if body.get("inference_steps") is not None:
        params.inference_steps = int(body["inference_steps"])
    if body.get("repainting_start") is not None:
        params.repainting_start = float(body["repainting_start"])
    if body.get("repainting_end") is not None:
        params.repainting_end = float(body["repainting_end"])
    if body.get("audio_cover_strength") is not None:
        params.audio_cover_strength = float(body["audio_cover_strength"])
    for k in ("use_cot_caption", "use_cot_language"):
        if body.get(k) is not None:
            setattr(params, k, bool(body[k]))
    # Default False for schema parity (ref ChatCompletionRequest
    # `thinking: bool = False`, openrouter_api_server.py:126): an
    # unadorned chat request generates without the CoT planner.
    params.thinking = bool(body.get("thinking", False)) and llm_available
    for k, v in lm_sampling_overrides(body).items():
        setattr(params, k, v)

    # Task-routed upload assignment (ref :700-722).
    task, src_i, ref_i = route_chat_audio(body.get("task_type"), len(audio_parts))
    params.task_type = task

    # Config: batch size, output format (wav default here — the progressive
    # streamer and zero-dependency path; mp3/opus ride ffmpeg when present),
    # seed as int (params.seed) or comma list (config.seeds), matching
    # prepare_seeds' accepted forms (ref task_utils.py:19-66 semantics).
    cfg: Dict[str, Any] = {
        "batch_size": max(int(body.get("batch_size", 1) or 1), 1),
        "audio_format": str(ac.get("format") or "wav"),
    }
    seed = body.get("seed")
    if seed is not None:
        cfg["use_random_seed"] = False
        if isinstance(seed, str) and "," in seed:
            cfg["seeds"] = [int(float(s)) for s in seed.split(",") if s.strip()]
        else:
            params.seed = int(float(seed))
    return params, cfg, audio_parts, (src_i, ref_i)


def chat_upload_assignments(
    audio_parts: List[bytes],
    src_i: Optional[int],
    ref_i: Optional[int],
    prefix: str = "acestep_chat_",
) -> Tuple[List[str], Dict[str, str]]:
    """Persist uploads and map the routed slots to param fields — the ONE
    place that turns (audio_parts, src_index, ref_index) into
    src_audio/reference_audio paths, shared by the streaming and
    non-streaming chat paths. Returns (temp_paths, assignments)."""
    tmp = write_chat_audio_temp_files(audio_parts, prefix=prefix)
    out: Dict[str, str] = {}
    if src_i is not None:
        out["src_audio"] = tmp[src_i]
    if ref_i is not None:
        out["reference_audio"] = tmp[ref_i]
    return tmp, out


def write_chat_audio_temp_files(audio_parts: List[bytes], prefix: str = "acestep_chat_") -> List[str]:
    """Persist uploaded audio parts to temp files; caller owns cleanup."""
    import tempfile

    paths: List[str] = []
    for data in audio_parts:
        with tempfile.NamedTemporaryFile(suffix=".wav", prefix=prefix, delete=False) as f:
            f.write(data)
            paths.append(f.name)
    return paths


def lm_sampling_overrides(body: Dict[str, Any]) -> Dict[str, Any]:
    """OpenAI request sampling fields → LM sampling params, shared by the
    streaming and non-streaming chat paths (ref openrouter_adapter.py:386-388
    maps temperature/top_p/top_k onto lm_*; lm_-prefixed fields pass through)."""
    out: Dict[str, Any] = {}
    for src, dst in (("temperature", "lm_temperature"), ("top_p", "lm_top_p"),
                     ("top_k", "lm_top_k")):
        if body.get(src) is not None:
            out[dst] = body[src]
    for k in ("lm_temperature", "lm_top_p", "lm_top_k", "lm_cfg_scale",
              "lm_repetition_penalty", "lm_negative_prompt"):
        if body.get(k) is not None:
            out[k] = body[k]
    return out


def chat_completion_response(
    model: str,
    result,
    *,
    include_audio_base64: bool = True,
) -> Dict[str, Any]:
    """GenerationResult → OpenAI chat.completion payload with audio content."""
    content: List[Dict[str, Any]] = []
    if result.success:
        meta = result.extra_outputs.get("lm_metadata", {})
        text = result.status_message
        if meta:
            text += "\n" + json.dumps(meta)
        content.append({"type": "text", "text": text})
        for a in result.audios:
            path = a.get("path")
            if include_audio_base64 and path:
                with open(path, "rb") as f:
                    b64 = base64.b64encode(f.read()).decode()
                content.append({
                    "type": "audio",
                    "audio": {"data": b64, "format": path.rsplit(".", 1)[-1]},
                })
            elif path:
                content.append({"type": "text", "text": f"audio: {path}"})
    else:
        content.append({"type": "text", "text": f"error: {result.error}"})

    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "message": {"role": "assistant", "content": content},
                "finish_reason": "stop" if result.success else "error",
            }
        ],
        "usage": {"prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0},
    }


def handle_chat_completions(
    dit_handler, llm_handler, body: Dict[str, Any], output_dir: str
) -> Dict[str, Any]:
    """POST /v1/chat/completions implementation."""
    from acestep_tpu_torch.service.inference import generate_music

    model = body.get("model", "acestep-v15-tpu")
    llm_ok = llm_handler is not None and getattr(llm_handler, "initialized", False)
    params, cfg_kw, audio_parts, (src_i, ref_i) = build_chat_request(body, llm_ok)
    # src_audio carries the content for the cover-family tasks;
    # reference_audio is always timbre-only (ref openrouter_adapter.py:700-722
    # — a "cover my song" chat upload MUST be src_audio or the cover
    # generates fresh audio with the upload as style).
    tmp_uploads, assignments = chat_upload_assignments(audio_parts, src_i, ref_i)
    for field, path in assignments.items():
        setattr(params, field, path)
    cfg = GenerationConfig(output_dir=output_dir, **cfg_kw)
    try:
        result = generate_music(dit_handler, llm_handler, params, cfg)
    finally:
        # Uploads were only needed during generation (ref parity: the job
        # server cleans multipart temp files after the job turns terminal).
        import os

        for p in tmp_uploads:
            try:
                os.remove(p)
            except OSError:
                pass
    return chat_completion_response(model, result)


def models_response(model_ids: Optional[List[str]] = None) -> Dict[str, Any]:
    """OpenAI-format model listing (ref openrouter_api_server.py GET
    /v1/models); merged into the job server's /v1/models response so OpenAI
    clients read `.data` while the studio UI keeps reading `.models`."""
    return {
        "object": "list",
        "data": [
            {
                "id": mid,
                "object": "model",
                "name": f"ACE-Step {mid}",
                "created": 0,
                "owned_by": "acestep-tpu",
                "capabilities": {"audio_generation": True},
                # OpenRouter ModelInfo metadata (ref openrouter_models.py
                # ModelInfo/ModelPricing; openrouter_adapter.py:600-614):
                # clients use these to pick an audio-capable free model.
                "input_modalities": ["text", "audio"],
                "output_modalities": ["audio", "text"],
                "context_length": 4096,
                "max_output_length": 300,
                "pricing": {
                    "prompt": "0", "completion": "0",
                    "request": "0", "image": "0",
                },
                "description": "AI music generation model",
            }
            for mid in (model_ids or ["acestep-v15-tpu"])
        ],
    }
