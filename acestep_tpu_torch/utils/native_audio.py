"""ctypes bindings of the native audio code (`csrc/acestep_audio.cpp`).

Port of `acestep_tpu/utils/native_audio.py`. The source is a copy of the JAX
package's `native/acestep_audio.cpp` (host code, not a CUDA source). At first
use it is built with `g++` and the flags of `native/Makefile` into
`_build/libacestep_audio-<digest>.so`; the digest covers the source, the flags
and the host CPU (`-march=native` code runs only where it was built). The
load is guarded by a lock: the server's threads may be the first callers.

`peak`, `f32_to_i16`, `i16_to_f32`, `flac_encode`, `flac_decode` and
`resample` keep the JAX package's signatures. Unlike the JAX package there is
no numpy fallback: a library that cannot be built raises, so a FLAC request
never turns quietly into something else. `flac_decode` still returns None for
a malformed stream, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from math import gcd
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "acestep_audio.cpp"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

_P = ctypes.POINTER
_SIGNATURES = {
    "as_peak": ([_P(ctypes.c_float), ctypes.c_int64], ctypes.c_float),
    "as_f32_to_i16": ([_P(ctypes.c_float), ctypes.c_int64, ctypes.c_int, ctypes.c_float, _P(ctypes.c_int16)], None),
    "as_i16_to_f32": ([_P(ctypes.c_int16), ctypes.c_int64, ctypes.c_int, _P(ctypes.c_float)], None),
    "as_resample_poly": (
        [_P(ctypes.c_float), ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P(ctypes.c_float)],
        ctypes.c_int64,
    ),
    "as_flac_encode": (
        [_P(ctypes.c_int16), ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P(ctypes.c_uint8), ctypes.c_int64],
        ctypes.c_int64,
    ),
    "as_flac_probe": (
        [_P(ctypes.c_uint8), ctypes.c_int64, _P(ctypes.c_int32), _P(ctypes.c_int32), _P(ctypes.c_int32),
         _P(ctypes.c_int64)],
        ctypes.c_int64,
    ),
    "as_flac_decode": ([_P(ctypes.c_uint8), ctypes.c_int64, _P(ctypes.c_int32)], ctypes.c_int64),
    "as_bf16_chunk_to_i16": (
        [_P(ctypes.c_uint16), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _P(ctypes.c_float),
         _P(ctypes.c_int16), ctypes.c_int64, ctypes.c_int64, ctypes.c_int],
        None,
    ),
}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native audio library (FLAC, resampling) is built with it")
    return cxx


def _host_cpu() -> bytes:
    """What `-march=native` compiles for: the CPU model and its flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        lines = []
    return ("".join(lines) + platform.machine() + platform.processor()).encode()


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"libacestep_audio-{h.hexdigest()[:12]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            r = subprocess.run([_cxx(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise RuntimeError(f"building {so.name} failed (rc {r.returncode}):\n{r.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def available() -> bool:
    """Build and load the library; raises when it cannot be built."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(_P(ctype))


def peak(x: np.ndarray) -> float:
    xf = np.ascontiguousarray(x, np.float32)
    return float(_load().as_peak(_ptr(xf, ctypes.c_float), xf.size))


def f32_to_i16(audio: np.ndarray, target_gain: float = -1.0) -> np.ndarray:
    """(ch, n) float planar -> (n, ch) int16 interleaved, normalised to target_gain."""
    a = np.ascontiguousarray(audio, np.float32)
    ch, n = a.shape
    out = np.empty((n, ch), np.int16)
    _load().as_f32_to_i16(_ptr(a, ctypes.c_float), n, ch, ctypes.c_float(target_gain), _ptr(out, ctypes.c_int16))
    return out


def i16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """(n, ch) int16 interleaved -> (ch, n) float planar."""
    p = np.ascontiguousarray(pcm, np.int16)
    n, ch = p.shape
    out = np.empty((ch, n), np.float32)
    _load().as_i16_to_f32(_ptr(p, ctypes.c_int16), n, ch, _ptr(out, ctypes.c_float))
    return out


def flac_encode(pcm: np.ndarray, sample_rate: int = 48_000) -> bytes:
    """Interleaved int16 (n, ch) -> a complete FLAC stream (lossless; fixed
    predictors and Rice coding)."""
    p = np.ascontiguousarray(pcm, np.int16)
    n, ch = p.shape
    cap = int(n * ch * 2 * 1.2) + 16384
    out = np.empty(cap, np.uint8)
    got = _load().as_flac_encode(_ptr(p, ctypes.c_int16), n, ch, int(sample_rate), _ptr(out, ctypes.c_uint8), cap)
    if got <= 0:
        raise RuntimeError(f"FLAC encode of {n} x {ch} samples failed ({got})")
    return out[:got].tobytes()


def flac_decode(blob: bytes):
    """FLAC stream -> ((channels, samples) int32, sample_rate, bps), or None
    when the stream is malformed."""
    lib = _load()
    data = np.frombuffer(blob, np.uint8)
    ch, sr, bps, total = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    off = lib.as_flac_probe(_ptr(data, ctypes.c_uint8), len(blob), ctypes.byref(ch), ctypes.byref(sr),
                            ctypes.byref(bps), ctypes.byref(total))
    if off < 0 or total.value <= 0 or not (1 <= ch.value <= 8):
        return None
    # STREAMINFO is untrusted: bound the decoded size by the stream's size
    # (constant frames cost ~17 bytes per 4096 x ch samples).
    if total.value * ch.value > max(len(blob), 4096) * 2048:
        return None
    out = np.empty((total.value, ch.value), np.int32)
    got = lib.as_flac_decode(_ptr(data, ctypes.c_uint8), len(blob), _ptr(out, ctypes.c_int32))
    if got != total.value:
        return None
    return out.T, int(sr.value), int(bps.value)


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """(ch, n) planar float resampling (Kaiser-windowed-sinc polyphase).

    The C code writes channel c at ``out + c * out_len`` with
    ``out_len = n * up // down`` (the reduced ratio), so the rows are
    allocated exactly that long. The JAX package's wrapper allocates
    ``ceil(n * sr_out / sr_in) + 8`` columns a row, which shifts every channel
    after the first by those spare columns (ROADMAP C, deviations)."""
    if sr_in == sr_out:
        return audio
    a = np.ascontiguousarray(audio, np.float32)
    ch, n = a.shape
    g = gcd(sr_in, sr_out)
    out_len = n * (sr_out // g) // (sr_in // g)
    out = np.zeros((ch, out_len), np.float32)
    got = _load().as_resample_poly(_ptr(a, ctypes.c_float), n, ch, sr_in, sr_out, _ptr(out, ctypes.c_float))
    if got != out_len:
        raise RuntimeError(f"resample {sr_in} -> {sr_out}: {got} samples a channel, expected {out_len}")
    return out
