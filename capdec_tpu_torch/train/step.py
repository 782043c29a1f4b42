"""The train step: noise -> forward -> sliced CE -> backward -> AdamW (port
of capdec_tpu/train/step.py).

The JAX package compiles the step into one XLA program with donated
buffers; here it runs eagerly and updates the train state in place. The
state is a dict {model, optimizer, scheduler, step}. The step's noise is
a pure function of (base seed, global step), the counterpart of
`fold_in(key, step)`: a resumed run draws the same noise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..models import caption_model
from ..ops import noise as noise_ops
from . import optim as optim_lib


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    variance: float = 0.0
    uniform_noise: bool = False
    dont_norm: bool = False
    # Optional [1, D] modality offset (train.py:332-334).
    modality_offset: Optional[Any] = None


def noise_seed(seed: int, step: int) -> int:
    """The seed of global step `step`'s noise under base seed `seed`."""
    return (int(seed) << 32) + int(step)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _batch(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """{tokens int64, mask f32, prefix f32} on `device` (numpy or torch)."""
    return {"tokens": torch.as_tensor(batch["tokens"], device=device).long(),
            "mask": torch.as_tensor(batch["mask"], device=device).float(),
            "prefix": torch.as_tensor(batch["prefix"],
                                      device=device).float()}


def make_train_step(cfg: caption_model.CaptionModelConfig,
                    noise_cfg: NoiseConfig) -> Callable:
    """Returns step(state, batch, seed, draws=None) -> (state, loss).

    batch is {tokens [B, T], mask [B, K+T], prefix [B, D]} (numpy or
    torch); the state is updated in place and returned, with the loss as
    a 0-d tensor on the device (no host sync). The noise comes from a
    generator seeded with noise_seed(seed, state["step"]), or from
    `draws` ({"normal": ..., "uniform": ...}, see ops/noise.py) when
    given."""
    def step_fn(state, batch, seed: int, draws=None):
        model = state["model"]
        b = _batch(batch, _device(model))
        offset = noise_cfg.modality_offset
        if offset is not None:
            offset = torch.as_tensor(offset, device=b["prefix"].device,
                                     dtype=torch.float32)
        gen = None
        if draws is None and noise_cfg.variance != 0.0:
            gen = torch.Generator(device=b["prefix"].device)
            gen.manual_seed(noise_seed(seed, state["step"]))
        prefix = noise_ops.noise_injection(
            b["prefix"], variance=noise_cfg.variance,
            modality_offset=offset, uniform_noise=noise_cfg.uniform_noise,
            dont_norm=noise_cfg.dont_norm, generator=gen, **(draws or {}))
        # the fused loss: the LM head runs only over the scored slice
        loss = caption_model.loss_forward(model, cfg, b["tokens"], prefix,
                                          b["mask"])
        loss.backward()
        optim_lib.apply_updates(state["optimizer"], state["scheduler"])
        state["step"] += 1
        return state, loss.detach()

    return step_fn


def make_train_multi_step(cfg: caption_model.CaptionModelConfig,
                          noise_cfg: NoiseConfig) -> Callable:
    """K sequential optimizer steps in one call: multi(state, batches,
    seed) -> (state, losses [K]) where every entry of `batches` is
    stacked [K, ...]. K single steps in a loop, identical by construction
    (each step's noise is seeded by the running step counter)."""
    single = make_train_step(cfg, noise_cfg)

    def multi(state, batches, seed: int):
        losses = []
        for k in range(len(batches["tokens"])):
            state, loss = single(state, {n: v[k] for n, v in batches.items()},
                                 seed)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi


def make_eval_step(cfg: caption_model.CaptionModelConfig) -> Callable:
    """Validation loss, no noise (reference train.py:372-389):
    eval_fn(model, batch) -> 0-d loss tensor."""
    @torch.no_grad()
    def eval_fn(model, batch):
        b = _batch(batch, _device(model))
        return caption_model.loss_forward(model, cfg, b["tokens"],
                                          b["prefix"], b["mask"])

    return eval_fn


def init_train_state(model: caption_model.ClipCaptionModel,
                     optimizer: torch.optim.Optimizer,
                     scheduler) -> Dict[str, Any]:
    return {"model": model, "optimizer": optimizer, "scheduler": scheduler,
            "step": 0}
