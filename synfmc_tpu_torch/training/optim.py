"""Optimizer: global-norm clip, then AdamW with a constant, linear or cosine
learning-rate schedule after an optional linear warmup.

The update of synfmc_tpu/training/optim.py's
``optax.chain(clip_by_global_norm, adamw(schedule))``: betas (0.9, 0.999),
eps 1e-8, decoupled weight decay 1e-2 on every tensor, the schedule read at
the update count (0 for the first update), and the clip scaling only when
the global norm reaches the limit.  The AdamW update itself is
``torch.optim.AdamW`` on fp32 tensors.

Under ZeRO-1 (``mesh.fsdp`` > 1) the tensors are this rank's: the rows it
owns of each split tensor and the replicated ones whole.  AdamW is
elementwise, so it runs unchanged on them; the clip's global norm sums the
split tensors' squares over the fsdp line (one all-reduce) and counts each
replicated tensor once.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, Optional, Sequence

import torch

from synfmc_tpu_torch.parallel.collectives import all_reduce_


def make_lr_schedule(learning_rate: float, scheduler: str = "constant", warmup_steps: int = 0,
                     total_steps: int = 0) -> Callable[[int], float]:
    """optax's schedules as a function of the update count."""
    if scheduler not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown lr scheduler {scheduler!r}")
    span = max(total_steps - warmup_steps, 1)

    def base(count: int) -> float:
        frac = min(count, span) / span
        if scheduler == "linear":
            return learning_rate * (1.0 - frac)
        if scheduler == "cosine":
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))
        return learning_rate

    def schedule(count: int) -> float:
        if warmup_steps <= 0:
            return base(count)
        if count < warmup_steps:
            return learning_rate * count / warmup_steps
        return base(count - warmup_steps)

    return schedule


class ClipAdamW:
    """Global-norm clip then AdamW on a list of fp32 tensors."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2,
                 max_grad_norm: float = 1.0, split: Optional[Sequence[bool]] = None,
                 norm_group=None):
        """``split`` marks the tensors that are one rank's rows of a tensor
        split over ``norm_group`` (the fsdp line); without it every tensor
        is whole."""
        self.params = list(params)
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("ClipAdamW updates fp32 tensors (the masters of bf16 weights)")
        self.split = None if split is None else list(split)
        if self.split is not None and len(self.split) != len(self.params):
            raise ValueError(f"split marks {len(self.split)} tensors, want {len(self.params)}")
        self.norm_group = norm_group
        self.schedule, self.max_grad_norm = schedule, max_grad_norm
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=betas, eps=eps,
                                       weight_decay=weight_decay)
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (fp32, one per tensor), which leaves each
        tensor's ``grad`` at its clipped gradient; returns the global norm
        before the clip."""
        norm = self.global_norm(grads)
        clip = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                           self.max_grad_norm / norm)
        for p, g in zip(self.params, grads):
            p.grad = g * clip
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient: over the fsdp line, the split
        tensors' squares summed over its ranks, the replicated ones' once."""
        norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
        if self.split is None:
            return torch.linalg.vector_norm(norms)
        mask = torch.tensor(self.split, device=norms.device)
        squares = norms.square()
        split = torch.where(mask, squares, torch.zeros_like(squares)).sum()
        all_reduce_([split], self.norm_group, average=False)
        return torch.sqrt(split + torch.where(mask, torch.zeros_like(squares), squares).sum())

    def moments(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Each tensor's AdamW moments (``exp_avg``, ``exp_avg_sq``; zeros
        before the first update), in the order of ``params``."""
        state = self.adamw.state
        pick = lambda p, key: state[p][key] if p in state else torch.zeros_like(p)
        return ([pick(p, "exp_avg") for p in self.params],
                [pick(p, "exp_avg_sq") for p in self.params])

    def load_moments(self, count: int, exp_avg, exp_avg_sq) -> None:
        """Restore the update count and the moments, as ``torch.optim.AdamW``
        keeps them (its ``step`` a float32 scalar on the CPU)."""
        for p, m, v in zip(self.params, exp_avg, exp_avg_sq, strict=True):
            self.adamw.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": m.to(device=p.device, dtype=p.dtype).clone(),
                "exp_avg_sq": v.to(device=p.device, dtype=p.dtype).clone(),
            }
        self.count = count


def make_optimizer(learning_rate: float, adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                   adam_weight_decay: float = 1e-2, adam_epsilon: float = 1e-8,
                   max_grad_norm: float = 1.0, lr_scheduler: str = "constant",
                   lr_warmup_steps: int = 0,
                   max_train_steps: int = 0) -> Callable[[Iterable[torch.Tensor]], ClipAdamW]:
    """A factory that builds the optimizer over a list of fp32 tensors
    (``split`` and ``norm_group`` by keyword, for a ZeRO-1 layout)."""
    schedule = make_lr_schedule(learning_rate, lr_scheduler, lr_warmup_steps, max_train_steps)
    return functools.partial(ClipAdamW, schedule=schedule, betas=(adam_beta1, adam_beta2),
                             eps=adam_epsilon, weight_decay=adam_weight_decay,
                             max_grad_norm=max_grad_norm)
