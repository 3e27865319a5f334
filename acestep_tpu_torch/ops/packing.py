"""Sequence packing: concatenate two masked sequences, valid tokens first.

Port of `acestep_tpu/ops/packing.py` (reference `pack_sequences`): a stable
descending sort on the mask gathers valid tokens to the front; the new mask is
a prefix mask of the total valid length.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pack_sequences(
    hidden1: torch.Tensor,  # (B, L1, D)
    hidden2: torch.Tensor,  # (B, L2, D)
    mask1: torch.Tensor,  # (B, L1)
    mask2: torch.Tensor,  # (B, L2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    hidden = torch.cat([hidden1, hidden2], dim=1)
    mask = torch.cat([mask1, mask2], dim=1).to(torch.int64)
    l = hidden.shape[1]
    pos = torch.arange(l, dtype=torch.int64, device=hidden.device)[None, :]
    # Unique integer keys make the sort stable: valid first, then by position.
    key = (1 - mask) * l + pos
    order = torch.argsort(key, dim=1)
    packed = torch.gather(hidden, 1, order[..., None].expand(-1, -1, hidden.shape[2]))
    lengths = mask.sum(dim=1, keepdim=True)
    new_mask = (pos < lengths).to(mask1.dtype)
    return packed, new_mask
