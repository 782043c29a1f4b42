"""The CapDec caption model in PyTorch (port of capdec_tpu/models/caption_model.py).

`ClipCaptionModel` holds `gpt` (GPT-2) and `clip_project` (the mapper),
so its `state_dict` keys are the reference checkpoint's `gpt.*` +
`clip_project.*` layout. This slice ports inference: `map_prefix` and the
weight loaders. Loss and training come in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from . import gpt2, mappers


@dataclasses.dataclass(frozen=True)
class CaptionModelConfig:
    prefix_length: int = 40
    clip_length: int = 40
    prefix_size: int = 640           # 640 for RN50x4, 512 for ViT-B/32
    num_layers: int = 8
    mapping_type: str = "transformer"
    gpt2: gpt2.GPT2Config = dataclasses.field(default_factory=gpt2.GPT2Config)

    @property
    def mapper(self) -> mappers.MapperConfig:
        return mappers.MapperConfig(
            mapping_type=self.mapping_type,
            dim_clip=self.prefix_size,
            dim_embedding=self.gpt2.n_embd,
            prefix_length=self.prefix_length,
            clip_length=self.clip_length,
            num_layers=self.num_layers,
        )


class ClipCaptionModel(nn.Module):
    def __init__(self, cfg: CaptionModelConfig, device=None):
        super().__init__()
        self.gpt = gpt2.GPT2LMHeadModel(cfg.gpt2, device=device)
        self.clip_project = mappers.build_mapper(cfg.mapper, device)


def init_params(cfg: CaptionModelConfig, generator: torch.Generator,
                device=None) -> ClipCaptionModel:
    """A caption model with random weights drawn from `generator` (a
    generator of `device`)."""
    model = ClipCaptionModel(cfg, device)
    gpt2.init_params(model.gpt, cfg.gpt2, generator)
    mappers.init_params(model.clip_project, generator)
    return model


@torch.no_grad()
def map_prefix(model: ClipCaptionModel, cfg: CaptionModelConfig,
               prefix: torch.Tensor) -> torch.Tensor:
    """CLIP embedding [B, prefix_size] -> prefix embeddings [B, K, 768]."""
    return model.clip_project(prefix)


def params_from_torch_state_dict(sd: Dict[str, Any], cfg: CaptionModelConfig,
                                 device=None) -> ClipCaptionModel:
    """Load a reference CapDec checkpoint (keys `gpt.*` + `clip_project.*`)
    strictly. A tied `gpt.lm_head.weight` may be absent."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    sd.setdefault("gpt.lm_head.weight", sd["gpt.transformer.wte.weight"])
    model = ClipCaptionModel(cfg, device)
    model.load_state_dict(sd, strict=True)
    return model


def config_from_torch_state_dict(sd: Dict[str, Any],
                                 compute_dtype: torch.dtype = torch.float32,
                                 **overrides) -> CaptionModelConfig:
    """Infer the caption-model architecture from checkpoint shapes (the
    reference stores no config beside its `.pt`). The mapper's
    num_heads / mlp_ratio stay at the reference's fixed 8 / 2.0."""
    def shape(key):
        return tuple(sd[key].shape)

    gcfg = gpt2.config_from_torch_state_dict(sd, prefix="gpt.",
                                             compute_dtype=compute_dtype)
    d_emb = gcfg.n_embd
    if "clip_project.transformer.layers.0.norm1.weight" in sd:
        base = "clip_project.transformer.layers."
        seg = base.count(".")
        out_dim, prefix_size = shape("clip_project.linear.weight")
        cfg = CaptionModelConfig(
            prefix_length=shape("clip_project.prefix_const")[0],
            clip_length=out_dim // d_emb, prefix_size=prefix_size,
            num_layers=len({k.split(".")[seg] for k in sd
                            if k.startswith(base)}),
            mapping_type="transformer", gpt2=gcfg)
    elif "clip_project.model.0.weight" in sd:
        idx = sorted(int(k.split(".")[2]) for k in sd
                     if k.startswith("clip_project.model.")
                     and k.endswith(".weight"))
        prefix_length = shape(f"clip_project.model.{idx[-1]}.weight")[0] // d_emb
        cfg = CaptionModelConfig(
            prefix_length=prefix_length, clip_length=prefix_length,
            prefix_size=shape(f"clip_project.model.{idx[0]}.weight")[1],
            num_layers=len(idx), mapping_type="mlp", gpt2=gcfg)
    else:
        raise NotImplementedError(
            "only the transformer and mlp mappers are ported yet "
            "(ROADMAP.md Queue 1, item 2: mappers)")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def params_from_jax_numpy(tree: Dict[str, Any], cfg: CaptionModelConfig,
                          device=None) -> ClipCaptionModel:
    """Load the port's caption model from the JAX package's parameter
    pytree ({"gpt": ..., "clip_project": ...}) given as numpy arrays."""
    sd = {"gpt." + k: v for k, v in
          gpt2.state_dict_from_jax_numpy(tree["gpt"]).items()}
    sd.update(mappers.state_dict_from_jax_numpy(
        tree["clip_project"], cfg.mapper, prefix="clip_project."))
    return params_from_torch_state_dict(sd, cfg, device)
