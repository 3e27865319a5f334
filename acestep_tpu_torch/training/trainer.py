"""LoRA / LoKr trainer over preprocessed tensors, and its adapter files.

Port of `acestep_tpu/training/trainer.py` (the "Side-Step"-corrected
trainer): continuous logit-normal timesteps (or the v1 discrete draw), CFG
condition dropout, optax's clip + AdamW chain on a warmup-cosine schedule
(`training/optim`), gradient accumulation through `MultiSteps`, the
non-finite skip with its count, `metrics.jsonl`, periodic checkpoints with
resume, the `adapter.npz` export and `export_merged`. Decoder only: the
conditions come precomputed from the dataset, so a step is one decoder
forward and backward.

Numbers as in the JAX package: the dataset's batches are fp32 and go in as
they are, so the decoder runs in fp32 over its (bf16) weights cast up by
`linear`, and its attention takes kernel 1's fp32 route on the card
(`ops.attention.FlashAttention`, whose backward recomputes the einsum path).
TF32 is off for the forward and the backward (`utils/precision.strict_fp32`,
the guard the VAE encode shares, so a run beside serving stays fp32).

The parameter tree's decoder layers are already a per-layer list in the port,
so the JAX package's `unstack_decoder_params` (serving stacks layers for
`scan`) has no counterpart: the trainer takes the handler's `params` as they
are.

Differences from the JAX trainer, by design:
- the draws come from a `torch.Generator` (`seed` for the factors' init,
  `seed + 1` for the steps, re-seeded on every `train` call as JAX re-keys),
  and `train(draws=...)` takes them from the caller instead;
- resume state is `torch.save`d to `checkpoints/step_N.pt` (the factors, the
  whole optimizer state, the step), where JAX uses orbax;
- `adapter.npz` keeps JAX's layout (``"{path}|{factor}"`` arrays plus
  ``__meta__``, a JSON string with rank, alpha, adapter_type and step), so
  the serving registry and JAX's `load_adapter` read it.

As in the JAX trainer, a non-finite step keeps the factors, but the optimizer
takes its update with zeroed gradients (its counts advance and its moments
decay), and the step counts in `nonfinite_steps`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from acestep_tpu_torch.config import AceStepConfig
from acestep_tpu_torch.training.lora import apply_lokr, apply_lora, init_lokr_params, init_lora_params, merge_lora
from acestep_tpu_torch.training.optim import apply_updates, make_optimizer, tree_map
from acestep_tpu_torch.training.train_step import (
    Draws,
    all_finite,
    flow_matching_terms,
    sample_draws,
    value_and_grad,
)
from acestep_tpu_torch.utils.precision import strict_fp32


@dataclasses.dataclass
class LoRAConfig:
    rank: int = 32
    alpha: float = 32.0
    adapter_type: str = "lora"  # "lora" | "lokr"
    lokr_factor: int = 8
    targets: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass
class TrainingConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    warmup_steps: int = 50
    max_steps: int = 1000
    batch_size: int = 1
    cfg_ratio: float = 0.15
    timestep_mu: float = -0.4
    timestep_sigma: float = 1.0
    # "sidestep": continuous logit-normal; "v1_discrete": uniform over the
    # 8-value turbo shift-3 schedule, the v1 trainer's draw.
    timestep_sampling: str = "sidestep"
    checkpoint_every: int = 200
    gradient_accumulation_steps: int = 1
    log_every: int = 10
    seed: int = 0
    output_dir: str = "./lora_output"
    resume_from: Optional[str] = None

    def __post_init__(self):
        # A misspelled mode must not train silently with the wrong timestep
        # distribution.
        if self.timestep_sampling not in ("sidestep", "v1_discrete"):
            raise ValueError(
                f"timestep_sampling must be 'sidestep' or 'v1_discrete', got {self.timestep_sampling!r}"
            )


def step_draws(gen: torch.Generator, shape, tcfg: TrainingConfig) -> Draws:
    return sample_draws(gen, shape, discrete=tcfg.timestep_sampling == "v1_discrete",
                        mu=tcfg.timestep_mu, sigma=tcfg.timestep_sigma)


def decoder_flow_matching_loss(
    lora_params: Dict[str, Any],
    base_decoder: Dict[str, Any],
    null_condition_emb: torch.Tensor,
    cfg: AceStepConfig,
    lcfg: LoRAConfig,
    tcfg: TrainingConfig,
    batch: Dict[str, torch.Tensor],
    gen: Optional[torch.Generator] = None,
    *,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """Decoder-only flow-matching MSE with the adapter applied. batch:
    target_latents (B, T, 64), context_latents (B, T, 128), attention_mask
    (B, T), encoder_hidden_states (B, L, D), encoder_attention_mask (B, L).
    The draws come from `gen`, or from `draws`."""
    x0 = batch["target_latents"]
    if lcfg.adapter_type == "lokr":
        decoder = apply_lokr(base_decoder, lora_params)
    else:
        decoder = apply_lora(base_decoder, lora_params, alpha=lcfg.alpha, rank=lcfg.rank)
    if draws is None:
        draws = step_draws(gen, x0.shape, tcfg)
    return flow_matching_terms(decoder, null_condition_emb, cfg, x0, batch["encoder_hidden_states"],
                               batch["encoder_attention_mask"], batch["context_latents"],
                               batch["attention_mask"], draws, tcfg.cfg_ratio)


def to_device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A dataset batch (numpy, fp32 / int32) as tensors on `device`, dtypes kept."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


class LoRATrainer:
    """Generator-style trainer: `train` yields (step, loss, message) per step."""

    def __init__(
        self,
        base_params: Dict[str, Any],
        model_config: AceStepConfig,
        lora_config: Optional[LoRAConfig] = None,
        training_config: Optional[TrainingConfig] = None,
    ):
        self.base = base_params
        self.cfg = model_config
        self.lcfg = lora_config or LoRAConfig()
        self.tcfg = training_config or TrainingConfig()
        self.device = base_params["null_condition_emb"].device
        self.nonfinite_steps = 0

        seed = torch.Generator().manual_seed(self.tcfg.seed)
        if self.lcfg.adapter_type == "lokr":
            self.lora = init_lokr_params(seed, base_params["decoder"], rank=self.lcfg.rank,
                                         factor=self.lcfg.lokr_factor, targets=self.lcfg.targets)
        else:
            self.lora = init_lora_params(seed, base_params["decoder"], rank=self.lcfg.rank,
                                         targets=self.lcfg.targets)
        # Gradient accumulation: MultiSteps applies an update every k micro-batches.
        self.tx = make_optimizer(
            self.tcfg.learning_rate, weight_decay=self.tcfg.weight_decay, max_grad_norm=self.tcfg.max_grad_norm,
            warmup_steps=self.tcfg.warmup_steps, total_steps=self.tcfg.max_steps,
            every_k=self.tcfg.gradient_accumulation_steps,
        )
        self.opt_state = self.tx.init(self.lora)
        self.step = 0

    def train_step(self, batch: Dict[str, torch.Tensor], draws: Draws) -> Tuple[torch.Tensor, bool]:
        """One micro-step on a device batch: (loss, finite)."""

        def loss_fn(lora):
            return decoder_flow_matching_loss(lora, self.base["decoder"], self.base["null_condition_emb"],
                                              self.cfg, self.lcfg, self.tcfg, batch, draws=draws)

        with strict_fp32():
            loss, grads = value_and_grad(loss_fn, self.lora)
        finite = bool(all_finite(loss, grads))
        if not finite:
            grads = tree_map(torch.zeros_like, grads)
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.lora)
        if finite:
            self.lora = apply_updates(self.lora, updates)
        return loss, finite

    def train(self, batches: Iterable[Dict[str, np.ndarray]], draws: Optional[Iterable[Draws]] = None):
        """Yields (step, loss, message) per step; `loss` is None for a
        non-finite step. `draws` (one dict a step) replaces the generator's."""
        os.makedirs(self.tcfg.output_dir, exist_ok=True)
        metrics_path = os.path.join(self.tcfg.output_dir, "metrics.jsonl")
        if self.tcfg.resume_from:
            self.load_checkpoint(self.tcfg.resume_from)
        gen = torch.Generator().manual_seed(self.tcfg.seed + 1)
        draw_iter: Optional[Iterator[Draws]] = None if draws is None else iter(draws)

        with open(metrics_path, "a") as metrics_f:
            for batch in batches:
                if self.step >= self.tcfg.max_steps:
                    break
                tb = to_device_batch(batch, self.device)
                d = next(draw_iter) if draw_iter is not None else step_draws(gen, tb["target_latents"].shape,
                                                                             self.tcfg)
                loss, finite = self.train_step(tb, d)
                self.step += 1
                loss_f = float(loss)
                if not finite:
                    self.nonfinite_steps += 1
                if not math.isfinite(loss_f):
                    # json.dumps would write a bare NaN token, which is not
                    # JSON; the step is counted in nonfinite_steps.
                    loss_f = None
                msg = f"step {self.step} loss {loss_f if loss_f is None else f'{loss_f:.4f}'}"
                if self.step % self.tcfg.log_every == 0:
                    metrics_f.write(json.dumps({
                        "step": self.step, "loss": loss_f, "time": time.time(),
                        "nonfinite_steps": self.nonfinite_steps,
                    }) + "\n")
                    metrics_f.flush()
                if self.step % self.tcfg.checkpoint_every == 0:
                    self.save_checkpoint()
                    msg += " [checkpoint]"
                yield self.step, loss_f, msg
        self.save_checkpoint()

    # ------------------------------------------------------------------
    # Checkpoints and resume
    # ------------------------------------------------------------------

    def _ckpt_dir(self) -> str:
        return os.path.join(os.path.abspath(self.tcfg.output_dir), "checkpoints")

    def save_checkpoint(self) -> str:
        """`checkpoints/step_N.pt` (factors, optimizer state, step) and the
        serving export `adapter.npz`; returns the checkpoint's path."""
        os.makedirs(self._ckpt_dir(), exist_ok=True)
        path = os.path.join(self._ckpt_dir(), f"step_{self.step}.pt")
        tmp = path + ".tmp"
        torch.save({"lora": self.lora, "opt_state": self.opt_state, "step": self.step}, tmp)
        os.replace(tmp, path)
        np.savez(
            os.path.join(self.tcfg.output_dir, "adapter.npz"),
            **{f"{p}|{f}": v.detach().cpu().numpy() for p, ab in self.lora.items() for f, v in ab.items()},
            __meta__=np.asarray(json.dumps({"rank": self.lcfg.rank, "alpha": self.lcfg.alpha,
                                            "adapter_type": self.lcfg.adapter_type, "step": self.step})),
        )
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore the factors, the optimizer state and the step of a
        `save_checkpoint` file onto the trainer's device."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.lora = state["lora"]
        # The optimizer's counters live on the CPU.
        self.opt_state = _counters_to_cpu(state["opt_state"])
        self.step = int(state["step"])

    def export_merged(self) -> Dict[str, Any]:
        """The base parameters with the adapter merged into the decoder (for
        serving without the adapter)."""
        merged = dict(self.base)
        if self.lcfg.adapter_type == "lokr":
            merged["decoder"] = apply_lokr(self.base["decoder"], self.lora)
        else:
            merged["decoder"] = merge_lora(self.base["decoder"], self.lora, alpha=self.lcfg.alpha,
                                           rank=self.lcfg.rank)
        return merged


def _counters_to_cpu(tree: Any) -> Any:
    return tree_map(lambda t: t.cpu() if t.dtype == torch.int32 and t.dim() == 0 else t, tree)


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
