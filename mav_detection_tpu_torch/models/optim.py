"""The trainers' optimizers: the ``optax`` chains of
``mav_detection_tpu.cli.train`` in PyTorch.

RAFT trains with ``chain(clip_by_global_norm(1.0), adamw(sched,
weight_decay=1e-5))``, SkyUNet and TinyYOLO with ``chain(clip_by_global_norm
(1.0), adam(sched))``, ``sched = warmup_cosine_decay_schedule(0.0, peak,
warmup_steps, decay_steps=steps)``. Three details decide the parameters:

* **The clip.** optax scales every gradient by ``max_norm / norm`` when the
  global norm reaches ``max_norm`` (``t / norm * max_norm``); PyTorch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6`` and is not used.
* **The schedule's count.** optax evaluates the schedule at the update count
  *before* it increments: the first update runs at ``schedule(0)``, which is
  ``init_value`` = 0.0. ``TrainOptimizer.step`` sets the learning rate from
  its own count, then counts.
* **The update.** ``torch.optim.Adam`` / ``AdamW`` (eps 1e-8, no amsgrad)
  compute optax's ``scale_by_adam`` update: bias-corrected moments, ``eps``
  outside the square root. AdamW's decoupled decay ``p * (1 - lr * wd)``
  before the step equals optax's ``- lr * (adam + wd * p)``, on every leaf
  (``tests/test_torch_train.py`` holds five updates against optax).

The learning rate is a Python float computed from an integer count, so a
step makes no host look.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int) -> Schedule:
    """optax's linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps`` (at least 1), then cosine decay to 0 at ``decay_steps``
    (which counts the warmup), in float32 as optax computes it. Raises
    optax's error where the decay would have no steps."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got"
            f" decay_steps={decay_steps - warmup_steps}.")
    f32 = np.float32
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(f32(count - warmup_steps), cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / cos_steps, dtype=f32))
        return float(f32(peak_value) * cosine)

    return schedule


def train_schedule(peak_lr: float, steps: int, warmup_cap: int) -> Schedule:
    """The trainers' schedule: warmup ``min(warmup_cap, steps // 10 + 1)``
    (200 for RAFT, 100 for the others), decay over ``steps``."""
    return warmup_cosine_decay_schedule(
        0.0, peak_lr, warmup_steps=min(warmup_cap, steps // 10 + 1),
        decay_steps=steps)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm is
    ``max_norm`` or more, every gradient becomes ``g / norm * max_norm``;
    below it ``g / 1 * 1``, which is ``g`` exactly. A handful of launches
    (foreach norms, one divide and one multiply over the list), no look
    from the host. Returns the norm, on the gradients' device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


MAX_GRAD_NORM = 1.0     # every trainer's clip_by_global_norm


class TrainOptimizer:
    """``chain(clip_by_global_norm(1.0), adam[w](schedule))`` over a model's
    parameters. ``weight_decay`` None is optax's ``adam``, a number its
    ``adamw``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 weight_decay: Optional[float] = None) -> None:
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.count = 0
        lr0 = schedule(0)
        if weight_decay is None:
            self.opt: torch.optim.Optimizer = torch.optim.Adam(
                self.params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
        else:
            self.opt = torch.optim.AdamW(self.params, lr=lr0, betas=(0.9, 0.999),
                                         eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the parameters' ``.grad`` (a missing one is 0, as
        optax sees a leaf the loss does not reach)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        clip_by_global_norm_(grads, MAX_GRAD_NORM)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
