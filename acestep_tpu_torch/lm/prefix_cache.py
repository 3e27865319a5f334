"""Prefill dedup and cross-request KV reuse for the planner LM.

Port of `acestep_tpu/lm/prefix_cache.py`:

1. **Intra-batch dedup**: identical prompt rows (per sample and per CFG
   branch) prefill once; their KV rows are gathered back to the full batch.
2. **Cross-request reuse**: an LRU of full-prompt KV rows keyed by the exact
   token prefix, the padded bucket, the cache capacity and the dtype, so a
   regeneration (same caption, new seed) skips its prefill.

The returned cache is a fresh tensor gathered from the rows: the decode loop
writes into it in place, so it never aliases a stored entry, and stored
entries are copies. Disable with ACESTEP_TPU_LM_PREFIX_CACHE=0.

Under tensor parallelism the entries hold this rank's KV heads (the weights'
share, `qwen3.kv_heads`); every rank of the line makes the same calls, so
their hits and misses agree. Splitting the planner clears the cache.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from acestep_tpu_torch.models import qwen3


def enabled() -> bool:
    return os.environ.get("ACESTEP_TPU_LM_PREFIX_CACHE", "1") != "0"


class PrefillCache:
    """LRU of per-row prefill results (KV rows + last-token logits)."""

    def __init__(self, max_bytes: int = 512 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._lru: "OrderedDict[Tuple, Dict[str, Any]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.dedup_rows_saved = 0

    @staticmethod
    def _entry_bytes(e: Dict[str, Any]) -> int:
        return int(e["k"].numel() * e["k"].element_size() * 2)

    def _evict(self) -> None:
        while self._bytes > self.max_bytes and self._lru:
            _, e = self._lru.popitem(last=False)
            self._bytes -= self._entry_bytes(e)

    def clear(self) -> None:
        self._lru.clear()
        self._bytes = 0

    def stats(self) -> Dict[str, int]:
        total = self.hits + self.misses
        return {
            "entries": len(self._lru),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 3) if total else 0.0,
            "dedup_rows_saved": self.dedup_rows_saved,
        }

    def prefill(
        self,
        params,
        cfg,
        ids: np.ndarray,  # (R, L) right-padded to a bucket
        mask: np.ndarray,  # (R, L)
        total_len: int,  # KV capacity (bucket + generation budget)
        dtype: torch.dtype,
        device,
        tp_sum: Optional[Callable] = None,
    ) -> Tuple[torch.Tensor, qwen3.KVCache]:
        """`KVCache.create` + `qwen3.prefill` with dedup and reuse.

        Returns (logits (R, V), a cache with R batch rows).
        """
        r, l = ids.shape
        valid = mask.sum(axis=1).astype(np.int64)

        # Order-preserving unique rows.
        row_keys: List[Tuple] = []
        uniq_index: Dict[Tuple, int] = {}
        inv = np.zeros(r, np.int64)
        uniq_rows: List[int] = []
        for i in range(r):
            key = (l, total_len, str(dtype), ids[i, : valid[i]].tobytes())
            row_keys.append(key)
            if key not in uniq_index:
                uniq_index[key] = len(uniq_rows)
                uniq_rows.append(i)
            inv[i] = uniq_index[key]
        self.dedup_rows_saved += r - len(uniq_rows)

        rows: Dict[int, Dict[str, Any]] = {}
        miss_rows: List[int] = []
        for ui, i in enumerate(uniq_rows):
            e = self._lru.get(row_keys[i])
            if e is not None:
                self._lru.move_to_end(row_keys[i])
                rows[ui] = e
                self.hits += 1
            else:
                miss_rows.append(ui)
                self.misses += 1

        if miss_rows:
            sub_ids = np.stack([ids[uniq_rows[ui]] for ui in miss_rows])
            sub_mask = np.stack([mask[uniq_rows[ui]] for ui in miss_rows])
            cache = qwen3.KVCache.create(cfg, len(miss_rows), total_len, dtype, device, qwen3.kv_heads(params, cfg))
            logits, cache = qwen3.prefill(
                params, cfg, torch.as_tensor(sub_ids, device=device),
                torch.as_tensor(sub_mask, device=device), cache, tp_sum,
            )
            for mi, ui in enumerate(miss_rows):
                e = {
                    "k": cache.k[:, mi : mi + 1].clone(),
                    "v": cache.v[:, mi : mi + 1].clone(),
                    "logits": logits[mi],
                }
                rows[ui] = e
                key = row_keys[uniq_rows[ui]]
                if key not in self._lru:
                    self._bytes += self._entry_bytes(e)
                self._lru[key] = e
                self._lru.move_to_end(key)
            self._evict()

        order = [rows[ui] for ui in range(len(uniq_rows))]
        inv_dev = torch.as_tensor(inv, device=device)
        k_full = torch.cat([e["k"] for e in order], dim=1).index_select(1, inv_dev)
        v_full = torch.cat([e["v"] for e in order], dim=1).index_select(1, inv_dev)
        logits = torch.stack([e["logits"] for e in order]).index_select(0, inv_dev)
        length = torch.tensor(int(valid.max()), dtype=torch.int32, device=device)
        return logits, qwen3.KVCache(k_full, v_full, length)
