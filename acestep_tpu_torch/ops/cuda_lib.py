"""Build and load the port's CUDA kernels (no JAX counterpart).

Each source `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, `_build/lib<name>-<digest>.so`, at first
use, and loaded with `ctypes`. The digest covers the source and every shared
header (`_HEADERS`), so an edited source or header is rebuilt. `build()`
starts one `nvcc` per source, all at once. Nothing here runs at import time.

A C entry point takes pointers and the CUDA stream as `c_void_p` and returns
`cudaGetLastError()` after its launches; `check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (
    "flash_attention", "flash_attention_f32", "oobleck", "oobleck_sm90", "oobleck_generic", "attention_probe",
)
_HEADERS = ("common.cuh", "sm90.cuh", "attention_sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()  # the server's threads may be the first to load a library


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((SRC_DIR / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one `nvcc` per source in parallel.

    Returns {name: seconds} for the sources compiled now. Raises with the
    compiler's output when one fails. `_build/<name>.log` keeps the output
    (register and shared-memory use from `-Xptxas -v`).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        log = open(BUILD_DIR / f"{name}.log", "w")
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp, out, time.time())
    took = {}
    failed = []
    for name, (proc, log, tmp, out, t0) in jobs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.time() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n" + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str, signatures: Dict[str, Tuple[Sequence, object]]) -> ctypes.CDLL:
    """Build (if needed) and load `lib<name>`, declaring each C function's
    argument and return types: ctypes would otherwise pass every pointer as a
    32-bit int."""
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
