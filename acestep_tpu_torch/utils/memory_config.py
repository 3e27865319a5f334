"""Device-memory-driven runtime configuration, as a CUDA memory policy.

Port of `acestep_tpu/utils/memory_config.py`: from the card's memory, derive
the longest duration, the largest batch, the planner size and the decode
chunking a server should accept. The port's server reads `max_batch_size`: a
merged batch holds no more rows (`service/api_server`). `detect_hbm_gb` keeps the
`ACESTEP_MAX_HBM_GB` override (to simulate a smaller card); otherwise it reads
the card's total memory through `torch.cuda`. `get_runtime_memory_config`
returns the JAX package's result for the same memory size: the footprints and
the working-set cost per latent frame below are the JAX package's table,
which has not been measured on a card (`chip_smoke.py` records the serving
phase's own peak memory instead). The decode's own CUDA out-of-memory policy
is the retry ladder of `AceStepHandler.decode_latents`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RuntimeMemoryConfig:
    hbm_gb: float
    max_duration_s: int
    max_batch_size: int
    lm_size: Optional[str]  # "0.6B" | "1.7B" | "4B" | None
    decode_chunk_frames: int
    allow_thinking: bool


# Resident bf16 footprints (GB) of the DiT, the VAE, the text encoder and the
# planner sizes, as the JAX package's table lists them.
_DIT_GB, _VAE_GB, _TEXT_GB = 4.8, 0.25, 1.2
_LM_GB = {"0.6B": 1.2, "1.7B": 3.4, "4B": 8.0}
# Working set of one latent batch-frame (denoise activations and a decode
# chunk), MB, the JAX package's figure.
_MB_PER_FRAME = 1.6


def detect_hbm_gb(device=None) -> float:
    """The card's total memory in GiB, or `ACESTEP_MAX_HBM_GB` when set.
    Raises without a card, as the port's entry points do."""
    env = os.environ.get("ACESTEP_MAX_HBM_GB")
    if env:
        return float(env)
    import torch

    from acestep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("detect_hbm_gb reads a CUDA card's memory; set ACESTEP_MAX_HBM_GB on the CPU")
    return torch.cuda.get_device_properties(dev).total_memory / 1024**3


def get_runtime_memory_config(hbm_gb: Optional[float] = None) -> RuntimeMemoryConfig:
    hbm = hbm_gb if hbm_gb is not None else detect_hbm_gb()
    free = hbm - (_DIT_GB + _VAE_GB + _TEXT_GB)

    lm_size: Optional[str] = None
    for size in ("4B", "1.7B", "0.6B"):
        if free - _LM_GB[size] > 4.0:
            lm_size = size
            break

    working = free - (_LM_GB[lm_size] if lm_size else 0.0)
    frames_capacity = int(working * 1024 / _MB_PER_FRAME)
    if frames_capacity >= 8 * 3000:
        batch, duration = 8, 600
    elif frames_capacity >= 4 * 3000:
        batch, duration = 4, 600
    elif frames_capacity >= 2 * 3000:
        batch, duration = 2, 600
    elif frames_capacity >= 3000:
        batch, duration = 1, 600
    else:
        batch, duration = 1, 240

    chunk = 2048 if working > 6 else 512
    return RuntimeMemoryConfig(
        hbm_gb=hbm,
        max_duration_s=duration,
        max_batch_size=batch,
        lm_size=lm_size,
        decode_chunk_frames=chunk,
        allow_thinking=lm_size is not None,
    )
