"""Serving-side LoRA lifecycle: load, unload, toggle, scale.

Port of `acestep_tpu/pipeline/lora_manager.py`. The JAX serving decoder
keeps its layers stacked by parity, so `apply_lora_stacked` there regroups
the per-layer factors into stacked tensors (zeros for a layer the adapter
lacks) and applies each target's deltas as one batched einsum in fp32. The
port keeps its layers as a per-layer list (`params.py`), so there is nothing
to regroup: each adapted kernel gets its own product, with the stacked
path's rounding points (A and B upcast to fp32, the product cast to the
kernel's dtype, times the scale in that dtype, added in that dtype). A layer
the adapter lacks would add a zero delta there, which changes nothing, so it
is left out. Paths outside ``layers/`` take the product in the factors'
dtype, as in JAX.

Under tensor parallelism (`LoRARegistry.tp`) the decoder holds this rank's
slice of each kernel (`parallel.mesh.shard_params_tp`), and the factors are
cut by the same plan: B's columns for a colwise target, A's rows for a
rowwise one. Each element of A @ B is the same sum either way, so a merged
shard equals the shard of the merged kernel.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from acestep_tpu_torch.parallel.mesh import _tp_spec_for, tp_slice
from acestep_tpu_torch.training.lora import add_delta, get_path, set_path

_LAYER_RE = re.compile(r"^layers/(\d+)/(.+)$")


def apply_lora_layers(
    decoder_params: Dict[str, Any],
    lora: Dict[str, Dict[str, torch.Tensor]],
    *,
    alpha: float,
    rank: int,
    scale: float = 1.0,
    tp: Tuple[int, int] = (0, 1),
) -> Dict[str, Any]:
    """The decoder with one adapter's factors applied (see the module
    docstring for the rounding points); `tp` = (index, count) cuts the
    factors to the decoder's tensor-parallel slice."""
    s = scale * (alpha / rank)
    out = decoder_params
    for path, ab in lora.items():
        parts = path.split("/")
        kern = get_path(out, parts)
        a, b = ab["a"].to(kern.device), ab["b"].to(kern.device)
        spec = _tp_spec_for("/" + path, 2)
        if spec:  # (None, "tp"): B's columns; ("tp", None): A's rows
            a = tp_slice(a, (spec[0], None), *tp)
            b = tp_slice(b, (None, spec[1]), *tp)
        delta = a.float() @ b.float() if _LAYER_RE.match(path) else a @ b
        out = set_path(out, parts, add_delta(kern, delta, s))
    return out


class LoRARegistry:
    """Named adapters with enable and scale state; the effective decoder is
    rebuilt lazily. Adapters are loaded onto `device`."""

    def __init__(self, device=None):
        self.device = device
        self.tp: Tuple[int, int] = (0, 1)  # this rank's tensor-parallel (index, count)
        self._adapters: Dict[str, Dict[str, Any]] = {}
        self._dirty = True
        self._cache: Optional[Dict[str, Any]] = None
        self._cache_base: Optional[Dict[str, Any]] = None

    def load(self, name: str, path: str) -> Dict[str, Any]:
        from acestep_tpu_torch.training.trainer import load_adapter

        lora, meta = load_adapter(path, self.device)
        self._adapters[name] = {"lora": lora, "meta": meta, "enabled": True, "scale": 1.0, "path": path}
        self._dirty = True
        return meta

    def unload(self, name: str) -> bool:
        removed = self._adapters.pop(name, None) is not None
        self._dirty = True
        return removed

    def toggle(self, name: str, enabled: Optional[bool] = None) -> bool:
        a = self._adapters[name]
        a["enabled"] = (not a["enabled"]) if enabled is None else enabled
        self._dirty = True
        return a["enabled"]

    def set_scale(self, name: str, scale: float) -> None:
        self._adapters[name]["scale"] = float(scale)
        self._dirty = True

    def status(self) -> Dict[str, Any]:
        return {
            name: {"enabled": a["enabled"], "scale": a["scale"], "meta": a["meta"], "path": a["path"]}
            for name, a in self._adapters.items()
        }

    def invalidate_cache(self) -> None:
        """Drop the merged decoder and its pin on the base decoder, so that a
        reinitialise frees the old weights at once."""
        self._cache = None
        self._cache_base = None

    def effective_decoder(self, base_decoder: Dict[str, Any]) -> Dict[str, Any]:
        """The base decoder with every enabled adapter applied, in load
        order. Cached until an adapter changes or the base decoder does; the
        key is the base tree itself, compared with `is` (an `id()` could be
        reused by a new tree after the old one is freed). JAX's also takes
        the layer count, which sizes its stacked groups; the list layout
        needs none."""
        if not self._dirty and self._cache is not None and self._cache_base is base_decoder:
            return self._cache
        self._cache_base = base_decoder
        out = base_decoder
        for a in self._adapters.values():
            if not a["enabled"]:
                continue
            meta = a["meta"]
            out = apply_lora_layers(out, a["lora"], alpha=float(meta.get("alpha", 32.0)),
                                    rank=int(meta.get("rank", 32)), scale=a["scale"], tp=self.tp)
        self._cache = out
        self._dirty = False
        return out
