"""Flow-matching training step (full-parameter and LoRA variants).

Port of `acestep_tpu/training/train_step.py`. The loss is the reference
training forward's: logit-normal timesteps t = sigmoid(σ·N(0,1) + μ) (the
Side-Step corrected sampling), or the v1 trainer's uniform draw over the
turbo shift-3 schedule; CFG condition dropout to the null embedding;
xt = t·noise + (1 - t)·x0; MSE on v = noise - x0 under the latent mask.

The draws (t, noise, the dropout's uniforms) come from an explicit
`torch.Generator` on the CPU, in that order, and move to the batch's device;
JAX's come from a key split three ways, so the two packages draw different
numbers. Every loss takes `draws=` ({"t": (B,), "noise": (B, T, 64) fp32,
"u": (B,)}) in place of the generator, which is how the tests feed both
packages the same numbers.

`make_train_step` differentiates with `torch.autograd.grad` over fresh leaves
that require grad (the caller's tensors are not touched) and updates with
`training/optim`'s optax chain. The non-finite guard: when the loss or any
gradient is not finite, the parameters and the whole optimizer state keep
their old values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from acestep_tpu_torch.config import AceStepConfig
from acestep_tpu_torch.models import dit
from acestep_tpu_torch.training.lora import apply_lora
from acestep_tpu_torch.training.optim import AdamWChain, apply_updates, make_optimizer, tree_leaves, tree_map
from acestep_tpu_torch.utils.precision import strict_fp32

Draws = Dict[str, torch.Tensor]


def sample_timesteps(gen: torch.Generator, batch_size: int, mu: float = -0.4, sigma: float = 1.0) -> torch.Tensor:
    """Continuous logit-normal timesteps (Side-Step corrected sampling), fp32."""
    return torch.sigmoid(torch.randn((batch_size,), generator=gen, dtype=torch.float32) * sigma + mu)


def sample_discrete_timesteps(gen: torch.Generator, batch_size: int) -> torch.Tensor:
    """The v1 trainer's draw: uniform over the turbo shift-3 inference
    schedule (`SHIFT_TIMESTEPS[3.0]`, 8 values). Adapters trained under v1 saw
    only these values."""
    schedule = torch.tensor(dit.SHIFT_TIMESTEPS[3.0], dtype=torch.float32)
    return schedule[torch.randint(0, schedule.shape[0], (batch_size,), generator=gen)]


def sample_draws(gen: torch.Generator, shape, *, discrete: bool = False, mu: float = -0.4,
                 sigma: float = 1.0) -> Draws:
    """One step's draws for a batch of latents of `shape` (B, T, C): t, noise,
    and the uniforms of the CFG dropout, in that order."""
    b = shape[0]
    t = sample_discrete_timesteps(gen, b) if discrete else sample_timesteps(gen, b, mu, sigma)
    noise = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    u = torch.rand((b,), generator=gen, dtype=torch.float32)
    return {"t": t, "noise": noise, "u": u}


def flow_matching_terms(
    decoder: Dict[str, Any],
    null_condition_emb: torch.Tensor,
    cfg: AceStepConfig,
    x0: torch.Tensor,
    enc: torch.Tensor,
    enc_mask: Optional[torch.Tensor],
    context_latents: torch.Tensor,
    latent_mask: Optional[torch.Tensor],
    draws: Draws,
    cfg_ratio: float,
) -> torch.Tensor:
    """The loss once the condition is ready: CFG dropout of whole rows to the
    null embedding, the noised latents in x0's dtype, the decoder's velocity,
    the masked MSE in fp32 (mean over every element without a mask)."""
    dev = x0.device
    drop = (draws["u"].to(dev) < cfg_ratio)[:, None, None]
    enc = torch.where(drop, null_condition_emb.to(enc.dtype).expand(enc.shape), enc)
    t = draws["t"].to(dev, torch.float32)
    noise = draws["noise"].to(dev, torch.float32).to(x0.dtype)
    t_ = t[:, None, None].to(x0.dtype)
    xt = t_ * noise + (1.0 - t_) * x0

    cross_kvs = dit.precompute_cross_kv(decoder, cfg, enc)
    v_pred = dit.dit_forward(decoder, cfg, xt, t, t, context_latents, cross_kvs,
                             encoder_mask=enc_mask, latent_mask=latent_mask)
    err = (v_pred.float() - (noise - x0).float()) ** 2
    if latent_mask is None:
        return err.mean()
    m = latent_mask.float()[:, :, None]
    return (err * m).sum() / torch.clamp(m.sum() * err.shape[-1], min=1.0)


def flow_matching_loss(
    params: Dict[str, Any],
    cfg: AceStepConfig,
    batch: Dict[str, torch.Tensor],
    gen: Optional[torch.Generator] = None,
    *,
    cfg_ratio: float = 0.15,
    max_refs: int = 1,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """Training loss for one batch, the condition encoders included.

    batch keys: target_latents (B, T, 64), src_latents, chunk_masks
    (B, T, 64), attention_mask (B, T), text_hidden_states /
    text_attention_mask, lyric_hidden_states / lyric_attention_mask,
    refer_packed / refer_order_mask, is_covers, silence_latent (1, T, 64).
    """
    x0 = batch["target_latents"]
    if draws is None:
        draws = sample_draws(gen, x0.shape, mu=cfg.timestep_mu, sigma=cfg.timestep_sigma)
    enc, enc_mask, context_latents = dit.prepare_condition(
        params, cfg,
        text_hidden_states=batch["text_hidden_states"], text_attention_mask=batch["text_attention_mask"],
        lyric_hidden_states=batch["lyric_hidden_states"], lyric_attention_mask=batch["lyric_attention_mask"],
        refer_packed=batch["refer_packed"], refer_order_mask=batch["refer_order_mask"],
        src_latents=batch["src_latents"], chunk_masks=batch["chunk_masks"], is_covers=batch["is_covers"],
        silence_latent=batch["silence_latent"], max_refs=max_refs,
    )
    return flow_matching_terms(params["decoder"], params["null_condition_emb"], cfg, x0, enc, enc_mask,
                               context_latents, batch.get("attention_mask"), draws, cfg_ratio)


def leaves_requiring_grad(tree: Any) -> Any:
    """A copy of `tree` whose leaves are new autograd leaves (detached)."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def value_and_grad(loss_fn: Callable[[Any], torch.Tensor], trainable: Any) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of `loss_fn(trainable)`; a leaf the loss does not reach
    gets zeros, as `jax.grad` gives."""
    leaves_tree = leaves_requiring_grad(trainable)
    loss = loss_fn(leaves_tree)
    flat = tree_leaves(leaves_tree)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), leaves_tree)


def all_finite(loss: torch.Tensor, grads: Any) -> torch.Tensor:
    """One bool on the device: the loss and every gradient are finite."""
    ok = torch.isfinite(loss)
    for g in tree_leaves(grads):
        ok = ok & torch.isfinite(g).all()
    return ok


@dataclasses.dataclass
class TrainState:
    params: Any  # the trainable tree (full params or LoRA factors)
    opt_state: Any
    step: int = 0


def create_train_state(
    trainable: Any,
    *,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    warmup_steps: int = 10,
    total_steps: int = 1000,
) -> Tuple[TrainState, AdamWChain]:
    tx = make_optimizer(learning_rate, weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                        warmup_steps=warmup_steps, total_steps=total_steps)
    return TrainState(trainable, tx.init(trainable)), tx


def make_train_step(
    cfg: AceStepConfig,
    tx,
    *,
    lora_base: Optional[Any] = None,
    lora_alpha: float = 32.0,
    lora_rank: int = 32,
    cfg_ratio: float = 0.15,
) -> Callable:
    """Build ``step(params, opt_state, batch, gen=None, *, draws=None) ->
    (new_params, new_opt_state, loss, finite)``.

    Full-parameter mode (`lora_base` None): the trainable tree is the whole
    model. LoRA mode: it is a factor dict keyed by paths of the whole model
    tree `lora_base` (`init_lora_params(seed, lora_base)`), overlaid on it by
    `apply_lora` inside the loss, as in the JAX package.
    """

    def step(state_params, opt_state, batch, gen=None, *, draws=None):
        def loss_fn(trainable):
            if lora_base is not None:
                params = apply_lora(lora_base, trainable, alpha=lora_alpha, rank=lora_rank)
            else:
                params = trainable
            return flow_matching_loss(params, cfg, batch, gen, cfg_ratio=cfg_ratio, draws=draws)

        with strict_fp32():
            loss, grads = value_and_grad(loss_fn, state_params)
        finite = bool(all_finite(loss, grads))
        if not finite:
            return state_params, opt_state, loss, False
        updates, new_opt = tx.update(grads, opt_state, state_params)
        return apply_updates(state_params, updates), new_opt, loss, True

    return step
