"""One process-wide guard for sections that must compute in strict fp32.

No JAX counterpart: JAX fixes the precision of each operation, so it holds no
such state. PyTorch reads two process-global flags instead:
`torch.backends.cudnn.allow_tf32` (True by default: cuDNN runs fp32
convolutions in TF32) and `torch.backends.cuda.matmul.allow_tf32`. A section
that flips them and restores the caller's values on exit is not safe beside
another thread doing the same: the two save/restore pairs interleave, and one
can restore the other's value in the middle of the other's section.

`strict_fp32()` is the one guard every fp32-strict section shares (the VAE
encode, the training forward and backward): a module-level lock and a depth
counter. The entry that takes the depth from 0 to 1 saves both flags and sets
them False; the exit that takes it from 1 to 0 restores them. In between both
flags stay False, whichever thread enters or leaves. Code that computes in
bf16 does not read the flags, so it computes the same inside and outside a
strict section.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

_lock = threading.Lock()
_depth = 0
_saved: Optional[Tuple[bool, bool]] = None


@contextlib.contextmanager
def strict_fp32() -> Iterator[None]:
    """TF32 off for cuDNN and cuBLAS for the block, shared across threads."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _saved
                _saved = None
