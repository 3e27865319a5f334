"""The trainer's optimizer: optax's chain, written on tensors.

Counterpart of the optax chain that `acestep_tpu/training/trainer.py:158-175`
and `train_step.py:125-140` build:

    chain(clip_by_global_norm(max_norm),
          adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1)),
                weight_decay=wd))
    [wrapped in MultiSteps(every_k) for gradient accumulation]

with optax's formulas (`optax/_src/alias.py`, `transforms/_clipping.py`,
`transforms/_accumulation.py`, `schedules/_schedule.py`), not `torch.optim`:
torch's clip divides by ``norm + 1e-6`` and `LambdaLR` counts steps from
another point. The rules kept:

- the schedule is evaluated at the update count *before* it increments, so
  the first update has learning rate 0;
- `clip_by_global_norm` passes g through if ``‖g‖ < max_norm``, else
  ``g / ‖g‖ * max_norm``;
- AdamW: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction at count + 1,
  then ``+ weight_decay * param`` on every leaf, then ``* -lr``;
- `MultiSteps`: the Welford mean ``acc + (g - acc) / (mini_step + 1)``; the
  inner update runs on the mean only when ``mini_step == k - 1`` (optax runs
  it every mini-step and keeps its result only then), and the caller gets
  zeros in between.

A tree is a nest of dicts and lists with tensors at the leaves (the trainer's
factor dict ``{path: {"a", "b"}}``, or a whole parameter tree); dict leaves go
in sorted key order, as `jax.tree.leaves` takes them. The state is one plain
dict of tensors, so `torch.save` writes it as it is. The counters are int32
tensors on the CPU, so no step waits on the card to read them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves, in `tree_leaves` order (dicts come back sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _count(n: int = 0) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Callable[[int], torch.Tensor]:
    """optax's schedule of the same name: a linear warmup from `init_value`
    to `peak_value` over `warmup_steps`, then cosine decay to `end_value` at
    `decay_steps` (warmup included); fp32, as optax computes it."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps}, {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> torch.Tensor:
        if count < warmup_steps:  # linear_schedule = polynomial_schedule(power=1)
            c = torch.tensor(min(max(count, 0), warmup_steps), dtype=torch.float32)
            frac = 1 - c / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = torch.tensor(min(float(count - warmup_steps), cos_steps), dtype=torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in tree_leaves(tree)))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


class AdamWChain:
    """clip_by_global_norm(max_grad_norm) then adamw on the warmup-cosine
    schedule. State: {"adam": {"count", "mu", "nu"}, "schedule": {"count"}};
    the clip and the decay have none."""

    def __init__(self, learning_rate: float, *, weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 warmup_steps: int = 10, total_steps: int = 1000, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps,
                                                     max(total_steps, warmup_steps + 1))
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"adam": {"count": _count(), "mu": tree_map(torch.zeros_like, params),
                         "nu": tree_map(torch.zeros_like, params)},
                "schedule": {"count": _count()}}

    def update(self, grads: Tree, state: Dict[str, Any], params: Tree) -> Tuple[Tree, Dict[str, Any]]:
        b1, b2 = self.b1, self.b2
        g_norm = global_norm(grads)
        keep = g_norm < self.max_grad_norm
        grads = tree_map(lambda t: torch.where(keep, t, (t / g_norm.to(t.dtype)) * self.max_grad_norm), grads)

        adam = state["adam"]
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, adam["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, adam["nu"])
        count = adam["count"] + 1
        sched_count = state["schedule"]["count"]
        # Scalars in fp32 on the host, moved to the leaves' device once.
        dev = tree_leaves(grads)[0].device
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** count.float()).to(dev)
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** count.float()).to(dev)
        step_size = (-1 * self.schedule(int(sched_count))).to(dev)
        updates = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2 + 0.0) + self.eps), mu, nu)
        updates = tree_map(lambda u, p: u + self.weight_decay * p, updates, params)
        updates = tree_map(lambda u: step_size * u, updates)
        return updates, {"adam": {"count": count, "mu": mu, "nu": nu}, "schedule": {"count": sched_count + 1}}


class MultiSteps:
    """optax.MultiSteps(opt, every_k_schedule=k) with the mean of the
    gradients. State: {"mini_step", "gradient_step", "inner", "acc_grads"}."""

    def __init__(self, opt: AdamWChain, every_k_schedule: int):
        self.inner, self.k = opt, int(every_k_schedule)

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"mini_step": _count(), "gradient_step": _count(), "inner": self.inner.init(params),
                "acc_grads": tree_map(torch.zeros_like, params)}

    def update(self, grads: Tree, state: Dict[str, Any], params: Tree) -> Tuple[Tree, Dict[str, Any]]:
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / (int(n) + 1), grads, state["acc_grads"])
        emit = int(n) == self.k - 1
        if emit:
            updates, inner = self.inner.update(acc, state["inner"], params)
            acc = tree_map(torch.zeros_like, acc)
        else:
            updates, inner = tree_map(torch.zeros_like, grads), state["inner"]
        return updates, {"mini_step": (n + 1) % self.k, "gradient_step": state["gradient_step"] + int(emit),
                         "inner": inner, "acc_grads": acc}


def make_optimizer(learning_rate: float, *, weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                   warmup_steps: int = 10, total_steps: int = 1000, every_k: int = 1):
    """The trainer's chain, in MultiSteps when `every_k` > 1."""
    opt = AdamWChain(learning_rate, weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                     warmup_steps=warmup_steps, total_steps=total_steps)
    return MultiSteps(opt, every_k) if every_k > 1 else opt
