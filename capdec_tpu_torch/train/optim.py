"""Optimizer: AdamW + linear warmup, with parameter freezing (port of
capdec_tpu/train/optim.py).

Reference contract (train.py:326-330): transformers.AdamW (eps 1e-6,
weight_decay 0, bias correction) at lr 2e-5 with
get_linear_schedule_with_warmup(5000, epochs * steps_per_epoch).

`torch.optim.AdamW` under a `LambdaLR` of the warmup schedule carries
optax's `adamw` arithmetic: both take lr(0) = 0 on the first update.
Freezing (`only_prefix`) gives the frozen parameters `requires_grad=False`
(caption_model.set_trainable) and keeps them out of the optimizer, so
they receive no update at all, the effect of optax's `set_to_zero`.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


def linear_warmup_lr_py(lr: float, warmup_steps: int, total_steps: int,
                        step: int) -> float:
    """HF get_linear_schedule_with_warmup: ramp 0 -> lr over warmup, then
    linear decay to 0 at total_steps (clipped to [0, lr])."""
    if step < warmup_steps:
        frac = step / max(1.0, warmup_steps)
    else:
        frac = (total_steps - step) / max(1.0, total_steps - warmup_steps)
    return lr * min(max(frac, 0.0), 1.0)


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int):
    """The schedule as a function of the step (the optax schedule's
    counterpart); `LambdaLR` takes it with lr 1.0 as its multiplier."""
    return lambda step: linear_warmup_lr_py(lr, warmup_steps, total_steps,
                                            step)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   warmup_steps: int, total_steps: int,
                   weight_decay: float = 0.0,
                   grad_clip_norm: Optional[float] = None
                   ) -> Tuple[torch.optim.AdamW, LambdaLR]:
    """AdamW (betas 0.9/0.999, eps 1e-6) over the trainable `params`,
    and its warmup schedule. `grad_clip_norm` rides in the parameter
    group; `apply_updates` clips by it before each update (optax's
    `clip_by_global_norm` in front of `adamw`)."""
    group = {"params": [p for p in params if p.requires_grad],
             "grad_clip_norm": grad_clip_norm}
    opt = torch.optim.AdamW([group], lr=lr, betas=(0.9, 0.999), eps=1e-6,
                            weight_decay=weight_decay)
    sched = LambdaLR(opt, linear_warmup_schedule(1.0, warmup_steps,
                                                 total_steps))
    return opt, sched


def grad_clip_norm(params: List[torch.nn.Parameter],
                   max_norm: float) -> torch.Tensor:
    """optax's clip_by_global_norm on the gradients, in place: g if the
    global norm is below max_norm, else (g / norm) * max_norm. (torch's
    clip_grad_norm_ adds 1e-6 to the norm: another function.) Returns
    the norm; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt()
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def apply_updates(opt: torch.optim.Optimizer, sched: LambdaLR) -> None:
    """One optimizer update from the gradients the backward left: clip
    (if the group asks), AdamW at the scheduled lr, advance the schedule,
    drop the gradients."""
    for group in opt.param_groups:
        if group.get("grad_clip_norm"):
            grad_clip_norm(group["params"], group["grad_clip_norm"])
    opt.step()
    sched.step()
    opt.zero_grad(set_to_none=True)
