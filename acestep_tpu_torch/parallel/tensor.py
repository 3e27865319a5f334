"""A request's DiT split over a mesh: tensor parallelism over the tp ranks,
sequence parallelism over the sp ranks (ROADMAP A.11b).

The JAX package states shardings and lets GSPMD partition the denoise; the
port writes each exchange out (`parallel.mesh.Mesh.reduce_sum`,
`gather_tensors`), and `Shards` is the DiT's view of them for one request.

- **tp.** The decoder's q/k/v/gate/up kernels hold this rank's output
  columns and o/down its input rows (`mesh.shard_params_tp`), so attention
  runs on local heads and the MLP on local features; each rowwise product's
  fp32 partial is summed over the tp ranks before its one rounding
  (`ops.basic.linear_rowwise`).
- **sp.** Each sp rank takes a contiguous slice of the latent-time axis when
  the length divides by sp·patch_size (`Shards.for_length`; otherwise every
  sp rank computes the whole sequence, as JAX leaves an axis that does not
  divide). The patchify conv and its transpose have kernel = stride =
  patch_size, so they need no halo. Full-attention layers gather K and V of
  the whole sequence; sliding layers extend the modulated hidden state by
  `window` rows on each side (`halo_edges`, `halo_extend`), computed with
  global rope positions and a key mask that hides rows past the sequence's
  ends (`halo_rows`, `halo_mask`), and keep the middle rows. APG's norms
  over time sum their squares over the sp ranks (`Shards.sp_sum`).

The halo functions take already-gathered tensors, so the tests run them in
one process.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


class Shards:
    """This rank's share of one request's DiT on `mesh` (a `parallel.mesh.Mesh`):
    `tp` heads / features, and `sp` slices of the latent-time axis (1 when the
    request is not split over time)."""

    def __init__(self, mesh, *, split_time: bool = True):
        self.mesh = mesh
        self.tp = mesh.shape["tp"]
        self.sp = mesh.shape["sp"] if split_time else 1
        self.sp_rank = mesh.coord["sp"] if self.sp > 1 else 0

    def for_length(self, t: int, patch_size: int) -> "Shards":
        """The shards of a request of `t` latent frames: its time axis splits
        only when t divides by sp·patch_size (then no rank pads)."""
        if self.sp > 1 and t % (self.sp * patch_size):
            return Shards(self.mesh, split_time=False)
        return self

    def frames(self, t: int) -> slice:
        """This rank's latent frames of a request of `t`."""
        k = t // self.sp
        return slice(self.sp_rank * k, (self.sp_rank + 1) * k)

    @property
    def tp_sum(self):
        """The fp32 sum over the tp ranks (in place), or None at tp = 1."""
        if self.tp == 1:
            return None
        return lambda x: self.mesh.reduce_sum(x, "tp")

    def tp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every tp rank's x along `dim` (heads in their global order)."""
        if self.tp == 1:
            return x
        return torch.cat(self.mesh.gather_tensors(x, "tp"), dim=dim)

    def sp_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence of x's time axis `dim`, contiguous."""
        return torch.cat(self.mesh.gather_tensors(x, "sp"), dim=dim)

    def sp_list(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.mesh.gather_tensors(x, "sp")

    def sp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the sp ranks (in place; fp32)."""
        return self.mesh.reduce_sum(x, "sp")


def halo_edges(x: torch.Tensor, window: int) -> torch.Tensor:
    """What a rank sends for the sliding layers' halo: its first and last
    r = min(window, L_local) rows of x (B, L_local, ...), one tensor."""
    r = min(window, x.shape[1])
    return torch.cat([x[:, :r], x[:, x.shape[1] - r:]], dim=1)


def halo_extend(x: torch.Tensor, edges: Sequence[torch.Tensor], rank: int, window: int) -> torch.Tensor:
    """x (B, L_local, ...) with `window` rows of the whole sequence before and
    after it, zeros past the sequence's ends: (B, L_local + 2·window, ...).
    `edges` is every sp rank's `halo_edges`, in rank order. Where a slice is
    shorter than the window, each edge is that rank's whole slice, and the
    halo reaches as many ranks as the window does."""
    l, n = x.shape[1], len(edges)
    r = min(window, l)
    heads = [e[:, :r] for e in edges]
    if r == l:
        before = torch.cat(heads[:rank], dim=1)[:, -window:] if rank else x[:, :0]
        after = torch.cat(heads[rank + 1:], dim=1)[:, :window] if rank + 1 < n else x[:, :0]
    else:
        before = edges[rank - 1][:, r:] if rank else x[:, :0]
        after = heads[rank + 1] if rank + 1 < n else x[:, :0]
    pad = [0, 0] * (x.dim() - 2)
    before = F.pad(before, pad + [window - before.shape[1], 0])
    after = F.pad(after, pad + [0, window - after.shape[1]])
    return torch.cat([before, x, after], dim=1)


def halo_rows(start: int, l: int, window: int, total: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extended rows of a slice starting at `start`: their global
    positions clamped into [0, total) (to index rope tables) and whether each
    lies inside the sequence."""
    pos = torch.arange(start - window, start + l + window, device=device)
    inside = (pos >= 0) & (pos < total)
    return pos.clamp(0, total - 1), inside


def halo_mask(kv_mask: Optional[torch.Tensor], inside: torch.Tensor, start: int, window: int,
              batch: int) -> torch.Tensor:
    """The key mask (B, L_local + 2·window) of the extended rows: the whole
    sequence's mask (B, L) where it is given, and nothing past the ends."""
    ext = inside.to(torch.int32)[None].expand(batch, -1)
    if kv_mask is None:
        return ext
    whole = F.pad(kv_mask.to(torch.int32), (window, window))
    return whole[:, start:start + ext.shape[1]] * ext
