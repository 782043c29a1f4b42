"""Checkpoint IO (port of capdec_tpu/utils/checkpoint.py).

Checkpoints are plain torch state_dicts in the reference's key layout
(`gpt.*` + `clip_project.*`), which is exactly the port's module tree, so
a reference `.pt` loads with `load_state_dict(strict=True)`. Naming as
the reference's (train.py:359-371): `{prefix}-{epoch:03d}.pt` per epoch,
`{prefix}_latest.pt` mid-epoch.
"""
from __future__ import annotations

import os
import re
from typing import Dict

import torch

from ..models import caption_model

# Causal-mask buffers older transformers versions saved beside GPT-2's
# weights (`transformer.h.{i}.attn.bias` / `.attn.masked_bias`); they are
# not parameters.
_MASK_BUFFER = re.compile(r"\.attn\.(masked_)?bias$")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a `.pt` state_dict, on the CPU (weights only: no code
    in the file runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not _MASK_BUFFER.search(k)}


def load_caption_checkpoint(path: str,
                            cfg: caption_model.CaptionModelConfig,
                            device=None) -> caption_model.ClipCaptionModel:
    """The caption model of a reference-layout checkpoint, strictly."""
    return caption_model.params_from_torch_state_dict(
        load_state_dict(path), cfg, device)


def save_state_dict(sd: Dict[str, torch.Tensor], path: str) -> None:
    """torch.save a state_dict as CPU tensors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)


def save_caption_checkpoint(model: caption_model.ClipCaptionModel,
                            cfg: caption_model.CaptionModelConfig,
                            path: str) -> None:
    """The model's weights as a reference-layout `.pt` (float32)."""
    save_state_dict(caption_model.params_to_torch_state_dict(model, cfg),
                    path)


def epoch_checkpoint_path(out_dir: str, prefix: str, epoch: int) -> str:
    return os.path.join(out_dir, f"{prefix}-{epoch:03d}.pt")


def latest_checkpoint_path(out_dir: str, prefix: str) -> str:
    return os.path.join(out_dir, f"{prefix}_latest.pt")
