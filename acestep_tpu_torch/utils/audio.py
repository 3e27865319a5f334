"""Host-side audio I/O: read, resample and save (numpy, scipy, the native codec).

A copy of `acestep_tpu/utils/audio.py`. Reading: WAV through
`scipy.io.wavfile`, FLAC through the native decoder (`utils/native_audio.py`,
then the pure-Python `utils/flac.py` for a stream it finds malformed) when
ffmpeg is missing, every other format through ffmpeg, which raises when there
is none; resampling through the native polyphase resampler (scipy's for
layouts other than (C, L)). Saving
(`save_audio`): WAV (16-bit, or 32-bit float as "wav32"), FLAC through the
native encoder (`utils/native_audio.py`, which raises rather than fall back),
every other format through ffmpeg, or WAV when there is no ffmpeg, as the JAX
package does. `wav_header` heads the streamed WAV of `/v1/generate_stream`;
`deterministic_uuid` names saved results. Levels: `peak_normalize`,
`clip_guard` and `is_silence`.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import subprocess
import uuid
import wave
from math import gcd
from typing import Any, Dict, Optional

import numpy as np


def peak_normalize(audio: np.ndarray, target_db: float = -1.0) -> np.ndarray:
    """Scale so that the peak sits at `target_db` dBFS (silence as it is)."""
    peak = float(np.max(np.abs(audio)))
    if peak <= 0:
        return audio
    return audio * (10.0 ** (target_db / 20.0) / peak)


def clip_guard(audio: np.ndarray) -> np.ndarray:
    """Divide by the peak only where it exceeds 1.0."""
    peak = float(np.max(np.abs(audio)))
    return audio / peak if peak > 1.0 else audio


def is_silence(audio: np.ndarray, threshold_db: float = -60.0) -> bool:
    """True when the peak level lies below `threshold_db` dBFS (or is 0)."""
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    return peak <= 0 or 20.0 * np.log10(peak) < threshold_db


def resample(audio: np.ndarray, sr_in: int, sr_out: int, axis: int = -1) -> np.ndarray:
    """(C, L) along L through the native polyphase resampler, as the JAX
    package does (its channels all at their own offsets here, see
    `native_audio.resample`); any other layout through scipy's."""
    if sr_in == sr_out:
        return audio
    if audio.ndim == 2 and axis in (-1, 1):
        from acestep_tpu_torch.utils import native_audio

        return native_audio.resample(audio.astype(np.float32), sr_in, sr_out)
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g, axis=axis)


def to_stereo(audio: np.ndarray) -> np.ndarray:
    """(C, L) or (L,) -> (2, L)."""
    if audio.ndim == 1:
        audio = audio[None]
    if audio.shape[0] == 1:
        audio = np.concatenate([audio, audio], axis=0)
    return audio[:2]


def save_wav(path: str, audio: np.ndarray, sample_rate: int = 48_000) -> str:
    """Save (C, L) audio (float in [-1, 1] or int16 PCM) as 16-bit WAV via the stdlib."""
    if audio.dtype == np.int16:
        pcm = audio.T
    else:
        audio = np.clip(audio, -1.0, 1.0)
        pcm = (audio.T * 32767.0).astype(np.int16)  # (L, C)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(pcm).tobytes())
    return path


def wav_header(n_frames: int, channels: int = 2, sample_rate: int = 48_000, sampwidth: int = 2) -> bytes:
    """44-byte RIFF/PCM header of a WAV stream of known length, byte for
    byte the stdlib `wave` module's: a streamed response knows its sample
    count before the first chunk exists, so it sends a complete header and
    Content-Length up front."""
    data_bytes = n_frames * channels * sampwidth
    byte_rate = sample_rate * channels * sampwidth
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + data_bytes), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, channels * sampwidth,
                             sampwidth * 8),
        b"data", struct.pack("<I", data_bytes),
    ])


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


def save_audio(path_base: str, audio: np.ndarray, sample_rate: int = 48_000, fmt: str = "flac") -> str:
    """Save (C, L) audio (int16 PCM, or float in [-1, 1]) as `path_base` plus
    the format's extension; returns the path written. "wav"/"wav16": 16-bit
    WAV; "wav32": 32-bit float WAV; "flac": the native encoder; any other
    format through ffmpeg, or WAV when ffmpeg is missing."""
    fmt = fmt.lower()
    if fmt in ("wav", "wav16"):
        return save_wav(path_base + ".wav", audio, sample_rate)
    if fmt == "wav32":
        from scipy.io import wavfile

        f32 = audio.T.astype(np.float32)
        if audio.dtype == np.int16:
            f32 = f32 / 32767.0
        wavfile.write(path_base + ".wav", sample_rate, f32)
        return path_base + ".wav"
    if fmt == "flac":
        from acestep_tpu_torch.utils import native_audio

        if audio.dtype == np.int16:
            pcm = np.ascontiguousarray(audio.T)
        else:
            pcm = np.round(np.clip(audio, -1.0, 1.0).T * 32767.0).astype(np.int16)
        with open(path_base + ".flac", "wb") as f:
            f.write(native_audio.flac_encode(pcm, sample_rate))
        return path_base + ".flac"
    ff = _ffmpeg()
    if ff is None:
        return save_wav(path_base + ".wav", audio, sample_rate)
    tmp = path_base + ".tmp.wav"
    save_wav(tmp, audio, sample_rate)
    codec = {"mp3": ["-b:a", "320k"], "opus": ["-b:a", "128k"], "aac": ["-b:a", "256k"]}
    out = f"{path_base}.{fmt}"
    try:
        subprocess.run([ff, "-y", "-loglevel", "error", "-i", tmp, *codec.get(fmt, []), out], check=True)
        os.remove(tmp)
        return out
    except Exception:  # noqa: BLE001 — an encoder ffmpeg lacks: keep the WAV
        os.replace(tmp, path_base + ".wav")
        return path_base + ".wav"


def deterministic_uuid(params: Dict[str, Any]) -> str:
    """Stable UUID from generation params (the key of a saved result)."""
    blob = json.dumps(params, sort_keys=True, default=str).encode()
    return str(uuid.UUID(hashlib.md5(blob).hexdigest()))


def load_audio(path: str, target_sr: int = 48_000) -> np.ndarray:
    """Load an audio file -> (2, L) float32 at target_sr. WAV natively; else ffmpeg."""
    if path.lower().endswith(".wav"):
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        else:
            data = data.astype(np.float32)
        audio = data.T if data.ndim == 2 else data[None]
    elif path.lower().endswith(".flac") and _ffmpeg() is None:
        # The native decoder (the full frame grammar) first; the pure-Python
        # one when it finds the stream malformed, as the JAX package reads.
        from acestep_tpu_torch.utils import flac, native_audio

        with open(path, "rb") as f:
            blob = f.read()
        got = native_audio.flac_decode(blob)
        pcm, sr, bps = got if got is not None else flac.decode(blob)
        audio = pcm.astype(np.float32) / float(1 << (bps - 1))
    else:
        ff = _ffmpeg()
        if ff is None:
            raise RuntimeError(f"ffmpeg required to load {path}")
        proc = subprocess.run(
            [ff, "-loglevel", "error", "-i", path, "-f", "f32le", "-ac", "2", "-ar", str(target_sr), "pipe:1"],
            check=True,
            capture_output=True,
        )
        audio = np.frombuffer(proc.stdout, np.float32).reshape(-1, 2).T
        return to_stereo(audio)
    audio = to_stereo(audio)
    if sr != target_sr:
        audio = resample(audio, sr, target_sr, axis=1).astype(np.float32)
    return audio
