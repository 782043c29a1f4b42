"""The CapDec caption model in PyTorch (port of capdec_tpu/models/caption_model.py).

`ClipCaptionModel` holds `gpt` (GPT-2) and `clip_project` (the mapper),
so its `state_dict` keys are the reference checkpoint's `gpt.*` +
`clip_project.*` layout.

Forward contract (reference train.py:251-260):
    embedding_cat = concat(mapper(prefix_clip) -> [B,K,768],
                           wte(tokens)        -> [B,T,768])
    logits = gpt2(inputs_embeds=embedding_cat, attention_mask=mask)

Loss contract (train.py:349-350): cross-entropy of logits[:, K-1:-1]
against `tokens` with ignore_index=0 (padded positions hold token 0).
`map_prefix` is the serving path's (no gradients); `forward` and
`loss_forward` run with gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import gpt2, mappers


@dataclasses.dataclass(frozen=True)
class CaptionModelConfig:
    prefix_length: int = 40
    clip_length: int = 40
    prefix_size: int = 640           # 640 for RN50x4, 512 for ViT-B/32
    num_layers: int = 8
    mapping_type: str = "transformer"
    only_prefix: bool = False        # freeze GPT-2; train the mapper only
    # Chunked, recomputed CE (loss_forward): the LM head and CE run in row
    # chunks of this size under torch.utils.checkpoint, so the [B, T, V]
    # f32 logits never exist at once; backward recomputes each chunk's
    # logits. 0 = single shot.
    ce_chunk_rows: int = 0
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


def _embeds(model: ClipCaptionModel, cfg: CaptionModelConfig,
            tokens: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
    """[mapper(prefix) | wte(tokens)]: [B, K + T, D], with gradients."""
    tok = gpt2.embed_tokens(model.gpt, tokens)
    pre = model.clip_project(prefix).to(tok.dtype)
    return torch.cat([pre, tok], dim=1)


def forward(model: ClipCaptionModel, cfg: CaptionModelConfig,
            tokens: torch.Tensor, prefix: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward: f32 logits [B, K+T, V]."""
    return gpt2.forward(model.gpt, cfg.gpt2,
                        _embeds(model, cfg, tokens, prefix), mask)


def loss_fn(logits: torch.Tensor, tokens: torch.Tensor,
            prefix_length: int) -> torch.Tensor:
    """Masked-mean CE over logits[:, K-1:-1] vs tokens, ignore_index=0."""
    shifted = logits[:, prefix_length - 1:-1].float()
    logp = torch.log_softmax(shifted, dim=-1)
    nll = -logp.gather(-1, tokens[..., None])[..., 0]
    valid = (tokens != 0).float()
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def loss_forward(model: ClipCaptionModel, cfg: CaptionModelConfig,
                 tokens: torch.Tensor, prefix: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """forward + loss_fn fused: the masked-mean loss of `loss_sums`."""
    s, v = loss_sums(model, cfg, tokens, prefix, mask)
    return s / v.clamp_min(1.0)


def loss_sums(model: ClipCaptionModel, cfg: CaptionModelConfig,
              tokens: torch.Tensor, prefix: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked nll, valid-token count) of the batch, with
    gradients through the sum: the loss is their quotient. A dp rank
    divides its sum by the count summed over dp, so that the ranks'
    gradients add up to the global masked mean's.

    The LM head runs only over the scored slice.

    The loss scores only the T positions K-1..K+T-2, so the hidden states
    are sliced before ln_f and the tied head (half the 50k-wide product
    at K = T = 40), and the CE is logsumexp minus the gathered logit, in
    f32, summed over valid tokens and divided by max(valid, 1): the same
    math as `loss_fn(forward(...))`. With `cfg.ce_chunk_rows` = C < B the
    rows run in chunks of C (the last one ragged when C does not divide
    B) under torch.utils.checkpoint: one chunk's logits exist at a time,
    in the forward and in the backward. `loss_forward` returns
    sum / max(count, 1)."""
    K = cfg.prefix_length
    hidden = gpt2.forward_hidden(model.gpt, cfg.gpt2,
                                 _embeds(model, cfg, tokens, prefix), mask)
    scored = hidden[:, K - 1:-1]

    def nll_sums(hid, toks):
        """(sum of the masked nll, valid count) of rows hid/toks."""
        logits = gpt2.final_logits(model.gpt, cfg.gpt2, hid)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, toks[..., None])[..., 0]
        valid = (toks != 0).float()
        return ((lse - picked) * valid).sum(), valid.sum()

    B, C = tokens.shape[0], cfg.ce_chunk_rows
    if C and B > C:
        s = v = torch.zeros((), device=hidden.device)
        for i in range(0, B, C):
            cs, cv = checkpoint(nll_sums, scored[i:i + C], tokens[i:i + C],
                                use_reentrant=False)
            s, v = s + cs, v + cv
    else:
        s, v = nll_sums(scored, tokens)
    return s, v.detach()


def trainable_mask(model: ClipCaptionModel,
                   cfg: CaptionModelConfig) -> Dict[str, bool]:
    """Parameter name -> whether it trains. only_prefix mirrors
    `ClipCaptionPrefix` (train.py:276-284): GPT-2 is frozen and only the
    mapper trains."""
    return {name: not (cfg.only_prefix and name.startswith("gpt."))
            for name, _ in model.named_parameters()}


def set_trainable(model: ClipCaptionModel,
                  cfg: CaptionModelConfig) -> List[nn.Parameter]:
    """Set `requires_grad` from `trainable_mask` (frozen parameters take
    no gradient at all) and return the trainable parameters."""
    mask = trainable_mask(model, cfg)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return params


def params_to_torch_state_dict(model: ClipCaptionModel,
                               cfg: CaptionModelConfig
                               ) -> Dict[str, torch.Tensor]:
    """The reference checkpoint layout (`gpt.*`, tied `gpt.lm_head.weight`
    included, + `clip_project.*`) as float32 CPU tensors."""
    out = gpt2.params_to_torch_state_dict(model.gpt, prefix="gpt.")
    out.update(mappers.mapper_to_torch_state_dict(
        model.clip_project, cfg.mapper, prefix="clip_project."))
    return out


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
    reference stores no config beside its `.pt`), as
    capdec_tpu/models/caption_model.py:173-230 does. The mapper's
    num_heads / mlp_ratio stay at the reference's fixed 8 / 2.0; a
    transformer_decoder encoder of another width than 512 is refused."""
    def shape(key):
        return tuple(sd[key].shape)

    gcfg = gpt2.config_from_torch_state_dict(sd, prefix="gpt.",
                                             compute_dtype=compute_dtype)
    d_emb = gcfg.n_embd

    def n_layers(base):
        seg = base.count(".")
        return len({k.split(".")[seg] for k in sd if k.startswith(base)})

    if "clip_project.transformer.layers.0.norm1.weight" in sd:
        mapping_type = "transformer"
        prefix_length = shape("clip_project.prefix_const")[0]
        out_dim, prefix_size = shape("clip_project.linear.weight")
        clip_length = out_dim // d_emb
        num_layers = n_layers("clip_project.transformer.layers.")
    elif "clip_project.ref_encoder.layers.0.norm1.weight" in sd:
        mapping_type = "transformer_decoder"
        prefix_length = shape("clip_project.prefix_const")[0]
        dim_ref = shape("clip_project.ref_encoder.layers.0.norm1.weight")[0]
        if dim_ref != mappers.MapperConfig.enc_dec_dim_ref:
            # the config cannot carry another encoder width (the reference
            # hardcodes 512 too); going on would mis-load the weights
            raise ValueError(
                f"transformer_decoder checkpoint has encoder width "
                f"{dim_ref}, but only "
                f"{mappers.MapperConfig.enc_dec_dim_ref} is supported")
        out_dim, prefix_size = shape("clip_project.linear.weight")
        clip_length = out_dim // dim_ref
        num_layers = n_layers("clip_project.ref_encoder.layers.")
    else:
        # Sequential MLP: `model.*` (mlp) or `mlp.model.*` (mapping_network)
        mapping_network = "clip_project.mlp.model.0.weight" in sd
        base = ("clip_project.mlp.model." if mapping_network
                else "clip_project.model.")
        mapping_type = "mapping_network" if mapping_network else "mlp"
        idx = sorted(int(k[len(base):].split(".")[0]) for k in sd
                     if k.startswith(base) and k.endswith(".weight"))
        prefix_size = shape(f"{base}{idx[0]}.weight")[1]
        prefix_length = shape(f"{base}{idx[-1]}.weight")[0] // d_emb
        clip_length = prefix_length
        num_layers = len(idx)
    cfg = CaptionModelConfig(
        prefix_length=prefix_length, clip_length=clip_length,
        prefix_size=prefix_size, num_layers=num_layers,
        mapping_type=mapping_type, gpt2=gcfg)
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
