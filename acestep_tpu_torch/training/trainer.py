"""Adapter files of the LoRA trainer.

Port of `acestep_tpu/training/trainer.py`, for now only `load_adapter`: the
reader of the `adapter.npz` that the JAX trainer's `save_checkpoint` writes
(one array per factor under ``"{path}|{a|b|w1|w2a|w2b}"``, plus ``__meta__``,
a JSON string with rank, alpha, adapter_type and step). The trainer itself
(steps, datasets, checkpoints) comes with the training slice (ROADMAP A.9).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch


def load_adapter(path: str, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(adapter {path: {factor: tensor}}, meta) from an adapter.npz, the
    tensors on `device` (the CPU by default) in the file's dtypes."""
    lora: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        for k in z.files:
            if k == "__meta__":
                continue
            p, f = k.rsplit("|", 1)
            lora.setdefault(p, {})[f] = torch.from_numpy(np.array(z[k])).to(device)
    return lora, meta
