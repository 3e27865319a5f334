"""Host-side audio input: read, resample and write WAV (numpy and scipy).

A copy of the reading half of `acestep_tpu/utils/audio.py` (`load_audio`,
`to_stereo`, `resample`, `save_wav`): WAV through `scipy.io.wavfile`, FLAC
through the pure-Python decoder (`utils/flac.py`) when ffmpeg is missing,
every other format through ffmpeg, which raises when there is none. The JAX
package's native C++ resampler and FLAC codec (`native/`) are not copied yet:
resampling runs through scipy's polyphase filter, as the JAX package does
when its native library is not built.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from math import gcd
from typing import Optional

import numpy as np


def resample(audio: np.ndarray, sr_in: int, sr_out: int, axis: int = -1) -> np.ndarray:
    if sr_in == sr_out:
        return audio
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


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


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
        from acestep_tpu_torch.utils import flac

        with open(path, "rb") as f:
            pcm, sr, bps = flac.decode(f.read())
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
