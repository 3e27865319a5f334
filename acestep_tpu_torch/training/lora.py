"""LoRA and LoKr adapters over the port's parameter trees.

Port of `acestep_tpu/training/lora.py`. An adapter is a flat dict
``{path: {"a": (in, r), "b": (r, out)}}`` (LoKr: ``{"w1", "w2a", "w2b"}``)
keyed by the JAX package's path names (``layers/3/self_attn/q_proj/kernel``).
The port's trees keep those names, kernels as (in, out) and layers as a
per-layer list, so an adapter's paths index the port's tree unchanged.

`apply_lora` returns a new tree whose targeted kernels are
``W + scale·(alpha/rank)·A@B``; untouched subtrees are shared, not copied.
The rounding points are JAX's: the product in the factors' dtype, cast to the
kernel's dtype, times the scale rounded to that dtype, added in that dtype.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence, Union

import torch

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _walk_paths(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_paths(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_paths(v, f"{path}/{i}")
    else:
        yield path, tree


def _generator(seed: Union[int, torch.Generator]) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device="cpu").manual_seed(int(seed))


def _targets(base_params: Any, targets: Sequence[str]):
    pattern = re.compile(r"(" + "|".join(targets) + r")/kernel$")
    for path, leaf in _walk_paths(base_params):
        if pattern.search(path) and getattr(leaf, "ndim", 0) == 2:
            yield path, leaf


def init_lora_params(
    seed: Union[int, torch.Generator],
    base_params: Any,
    *,
    rank: int = 32,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """A/B factors for every targeted 2-D kernel of `base_params`, drawn on
    the CPU from `seed` (an int or a `torch.Generator`) and placed on each
    kernel's device: A gaussian / rank, B zero, so the adapted model starts
    equal to the base."""
    gen = _generator(seed)
    lora: Dict[str, Any] = {}
    for path, leaf in _targets(base_params, targets):
        d_in, d_out = leaf.shape
        a = torch.randn((d_in, rank), generator=gen, dtype=torch.float32).to(dtype) * (1.0 / rank)
        lora[path] = {"a": a.to(leaf.device), "b": torch.zeros((rank, d_out), dtype=dtype, device=leaf.device)}
    return lora


def get_path(tree: Any, parts: List[str]) -> Any:
    node = tree
    for p in parts:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    return node


def set_path(tree: Any, parts: List[str], value: Any) -> Any:
    """A copy of `tree` with the leaf at `parts` replaced; only the nodes on
    the path are copied."""
    head = parts[0]
    if isinstance(tree, dict):
        new = dict(tree)
        new[head] = value if len(parts) == 1 else set_path(tree[head], parts[1:], value)
        return new
    idx = int(head)
    new_list = list(tree)
    new_list[idx] = value if len(parts) == 1 else set_path(tree[idx], parts[1:], value)
    return new_list


def add_delta(kernel: torch.Tensor, delta: torch.Tensor, scale: float) -> torch.Tensor:
    """kernel + cast(delta)·scale, each step rounded to the kernel's dtype."""
    s = torch.tensor(scale, dtype=kernel.dtype, device=kernel.device)
    return kernel + delta.to(kernel.dtype) * s


def apply_lora(base_params: Any, lora: Dict[str, Any], *, alpha: float = 32.0, rank: int = 32,
               scale: float = 1.0) -> Any:
    """Overlay: kernel <- kernel + scale·(alpha/rank)·A@B."""
    s = scale * (alpha / rank)
    out = base_params
    for path, ab in lora.items():
        parts = path.split("/")
        node = get_path(base_params, parts)
        delta = ab["a"].to(node.device) @ ab["b"].to(node.device)
        out = set_path(out, parts, add_delta(node, delta, s))
    return out


def merge_lora(base_params: Any, lora: Dict[str, Any], **kw) -> Any:
    """Merged weights, for serving without the adapter."""
    return apply_lora(base_params, lora, **kw)


# ---------------------------------------------------------------------------
# LoKr: Kronecker-product adapters. Delta = scale·(W1 ⊗ W2) with W1 (a1, b1)
# small and W2 (a2, b2) = (in/a1, out/b1), W2 = W2a @ W2b low rank.
# ---------------------------------------------------------------------------


def _kron_factors(dim: int, max_factor: int = 8) -> int:
    """Largest divisor of `dim` that is <= max_factor."""
    best = 1
    for f in range(2, max_factor + 1):
        if dim % f == 0:
            best = f
    return best


def init_lokr_params(
    seed: Union[int, torch.Generator],
    base_params: Any,
    *,
    rank: int = 8,
    factor: int = 8,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """LoKr factors for each targeted kernel: {"w1": (a1, b1), "w2a": (a2, r),
    "w2b": (r, b2)} with a1·a2 = in, b1·b2 = out; w2b zero, so the adapted
    model starts equal to the base."""
    gen = _generator(seed)
    lokr: Dict[str, Any] = {}
    for path, leaf in _targets(base_params, targets):
        d_in, d_out = leaf.shape
        a1, b1 = _kron_factors(d_in, factor), _kron_factors(d_out, factor)
        a2, b2 = d_in // a1, d_out // b1
        w1 = torch.randn((a1, b1), generator=gen, dtype=torch.float32).to(dtype) * 0.1
        w2a = torch.randn((a2, rank), generator=gen, dtype=torch.float32).to(dtype) * (1.0 / rank)
        lokr[path] = {"w1": w1.to(leaf.device), "w2a": w2a.to(leaf.device),
                      "w2b": torch.zeros((rank, b2), dtype=dtype, device=leaf.device)}
    return lokr


def apply_lokr(base_params: Any, lokr: Dict[str, Any], *, scale: float = 1.0) -> Any:
    """Overlay: kernel <- kernel + scale·kron(w1, w2a@w2b)."""
    out = base_params
    for path, fac in lokr.items():
        parts = path.split("/")
        node = get_path(base_params, parts)
        w2 = fac["w2a"].to(node.device) @ fac["w2b"].to(node.device)
        out = set_path(out, parts, add_delta(node, torch.kron(fac["w1"].to(node.device), w2), scale))
    return out
