"""Gradient-sensitivity estimation: ranks the decoder's attention projections.

Port of `acestep_tpu/training/estimate.py` (Side-Step's `estimate` mode): run
the trainer's flow-matching loss over a few preprocessed batches, take the
gradient of every decoder attention projection (layers.*.{self,cross}_attn.
{q,k,v,o}_proj), sum each module's gradient norm over the batches, and return
the top k, by module or by layer: the guide to which modules to adapt.

The gradient is taken only over those projections: they become fresh autograd
leaves placed into the decoder tree, and the rest of the tree stays frozen.
The port's decoder layers are a per-layer list, so only the unstacked layout
exists here (JAX's stacked {"sliding", "full"} layout is a serving layout the
port does not have). The draws come from a `torch.Generator` seeded with
`seed`, or from `draws=` (one dict a batch), as in the trainer. TF32 is off
for the forward and the backward (`utils/precision.strict_fp32`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

from acestep_tpu_torch.config import AceStepConfig
from acestep_tpu_torch.training.lora import _walk_paths, set_path
from acestep_tpu_torch.training.train_step import Draws, value_and_grad
from acestep_tpu_torch.training.trainer import (
    LoRAConfig,
    TrainingConfig,
    decoder_flow_matching_loss,
    step_draws,
    to_device_batch,
)
from acestep_tpu_torch.utils.precision import strict_fp32

ATTN_BLOCKS = ("self_attn", "cross_attn")
ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")


def _target_leaves(decoder: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Every parameter under layers.*.{self,cross}_attn.{q,k,v,o}_proj."""
    out = {}
    for path, leaf in _walk_paths(decoder):
        parts = path.split("/")
        if len(parts) >= 3 and parts[-2] in ATTN_PROJS and parts[-3] in ATTN_BLOCKS and parts[0] == "layers":
            out[path] = leaf
    return out


def _module_name(path: str) -> str:
    parts = path.split("/")
    return f"layers.{int(parts[1])}.{parts[-3]}.{parts[-2]}"


def run_estimation(
    params: Dict[str, Any],
    cfg: AceStepConfig,
    batches: Iterable[Dict[str, Any]],
    *,
    num_batches: int = 10,
    top_k: int = 16,
    granularity: str = "module",
    cfg_ratio: float = 0.0,
    seed: int = 0,
    draws: Optional[Iterable[Draws]] = None,
) -> List[Dict[str, Any]]:
    """Per-module gradient norms summed over `num_batches` batches of the
    `PreprocessedDataset.batches` format. Returns
    ``[{"module": name, "sensitivity": float}, ...]``, highest first."""
    if granularity not in ("module", "layer"):
        raise ValueError(f"granularity must be 'module' or 'layer', got {granularity!r}")
    decoder = params["decoder"]
    null_emb = params["null_condition_emb"]
    trainable = _target_leaves(decoder)
    if not trainable:
        return []
    lcfg = LoRAConfig()
    tcfg = TrainingConfig(cfg_ratio=cfg_ratio)
    gen = torch.Generator().manual_seed(seed)
    draw_iter = None if draws is None else iter(draws)

    accum: Dict[str, float] = {}
    done = 0
    for batch in batches:
        if done >= num_batches:
            break
        tb = to_device_batch(batch, null_emb.device)
        d = next(draw_iter) if draw_iter is not None else step_draws(gen, tb["target_latents"].shape, tcfg)

        def loss(tr: Dict[str, torch.Tensor]) -> torch.Tensor:
            dec = decoder
            for p, leaf in tr.items():
                dec = set_path(dec, p.split("/"), leaf)
            return decoder_flow_matching_loss({}, dec, null_emb, cfg, lcfg, tcfg, tb, draws=d)

        with strict_fp32():
            _, grads = value_and_grad(loss, trainable)
        paths = sorted(grads)
        norms = torch.stack([torch.linalg.norm(grads[p].float().reshape(-1)) for p in paths]).tolist()
        for path, n in zip(paths, norms):
            name = _module_name(path)
            if granularity == "layer":
                name = ".".join(name.split(".")[:2])  # layers.{i}
            accum[name] = accum.get(name, 0.0) + float(n)
        done += 1

    ranked = sorted(accum.items(), key=lambda kv: kv[1], reverse=True)
    return [{"module": m, "sensitivity": s} for m, s in ranked[:top_k]]
