"""Device choice for the port's entry points (no JAX counterpart).

Entry points run on the card unless the caller asks for the CPU. Without a
card and without an explicit `device="cpu"` they raise: there is no silent
CPU run.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
