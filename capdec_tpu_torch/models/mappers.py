"""CLIP -> GPT-2 prefix mappers in PyTorch (port of capdec_tpu/models/mappers.py).

All four mapper types run with gradients:
  * `mlp`                 — Tanh MLP, sizes (prefix_size, 768*K/2, 768*K)
  * `transformer`         — TransformerMapper (alias `transformer_encoder`):
                            linear -> clip_length pseudo tokens, concat a
                            learned prefix_const, a pre-LN self-attention
                            stack (8 heads, mlp_ratio 2.0), keep the last
                            prefix_length slots.
  * `transformer_decoder` — TransformerEncoderDecoder: linear ->
                            clip_length reference tokens of width
                            enc_dec_dim_ref (512), a self-attention encoder
                            over them, then interleaved (cross, self)
                            layers over prefix_const at the GPT-2 width.
  * `mapping_network`     — 7-linear LeakyReLU(0.01) MLP, sizes
                            [dim_clip]*7 + [K*768].

Module and parameter names are the reference checkpoint's `clip_project.*`
layout (`linear`, `prefix_const`, `transformer.layers.{i}.norm1`,
`attn.to_queries`, `attn.to_keys_values`, `attn.project`, `mlp.fc1/fc2`;
`ref_encoder.layers.{i}` and `prefix_decoder.layers.{2i|2i+1}` for the
encoder-decoder; `model.{0,2}` for the MLP, `mlp.model.{2i}` for the
mapping network), with torch `nn.Linear` weights stored [out, in]. The
JAX package stores its matrices [in, out]; `params_from_jax_numpy`
transposes.

Quirks kept from the reference: self-attention takes its keys/values from
the layer-NORMED stream, the same tensor as its queries; in the
encoder-decoder, the cross layers take the RAW encoder output as keys and
values, and the self layers the RAW residual stream (only the queries are
normed).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    mapping_type: str = "transformer"  # mlp|transformer|transformer_encoder|transformer_decoder|mapping_network
    dim_clip: int = 640                # CLIP embedding dim (640 RN50x4 / 512 ViT-B/32)
    dim_embedding: int = 768           # GPT-2 embedding dim
    prefix_length: int = 40            # K — number of GPT-2 prefix slots produced
    clip_length: int = 40              # pseudo-token count from the CLIP embedding
    num_layers: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    enc_dec_dim_ref: int = 512         # encoder width of the enc-dec variant

    def canonical_type(self) -> str:
        t = self.mapping_type
        return "transformer" if t == "transformer_encoder" else t


class _MHA(nn.Module):
    """Fused-KV multi-head attention without q/kv bias: queries of width
    `dim` over references of width `dim_ref` (default `dim`)."""

    def __init__(self, dim: int, num_heads: int, dim_ref: int = 0,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.to_queries = nn.Linear(dim, dim, bias=False, device=device)
        self.to_keys_values = nn.Linear(dim_ref or dim, 2 * dim, bias=False,
                                        device=device)
        self.project = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        M = y.shape[1]
        hd = C // self.num_heads
        q = self.to_queries(x).reshape(B, N, self.num_heads, hd)
        k, v = self.to_keys_values(y).split(C, dim=-1)
        k = k.reshape(B, M, self.num_heads, hd)
        v = v.reshape(B, M, self.num_heads, hd)
        scores = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd ** -0.5
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(B, N, C)
        return self.project(out)


class _MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class _Layer(nn.Module):
    """Pre-LN block: x += attn(norm1(x), ref); x += mlp(norm2(x)), where
    ref is norm1(x) (self-attention) or the raw `y` it is given (the
    encoder-decoder's cross and self layers)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dim_ref: int = 0, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = _MHA(dim, num_heads, dim_ref, device)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.mlp = _MlpBlock(dim, int(dim * mlp_ratio), device)

    def forward(self, x, y=None):
        h = self.norm1(x)
        x = x + self.attn(h, h if y is None else y)
        return x + self.mlp(self.norm2(x))


class _Stack(nn.Module):
    """`num_layers` self-attention layers of width `dim`."""

    def __init__(self, cfg: MapperConfig, dim: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            _Layer(dim, cfg.num_heads, cfg.mlp_ratio, device=device)
            for _ in range(cfg.num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _DecoderStack(nn.Module):
    """The reference `enc_dec` schedule: layer 2i cross-attends to the
    encoder output, layer 2i+1 self-attends with the raw stream as keys
    and values."""

    def __init__(self, cfg: MapperConfig, device=None):
        super().__init__()
        D, R = cfg.dim_embedding, cfg.enc_dec_dim_ref
        self.layers = nn.ModuleList(
            _Layer(D, cfg.num_heads, cfg.mlp_ratio, R if i % 2 == 0 else 0,
                   device)
            for i in range(2 * cfg.num_layers))

    def forward(self, x, ref):
        for i in range(0, len(self.layers), 2):
            x = self.layers[i](x, ref)
            x = self.layers[i + 1](x, x)
        return x


class TransformerMapper(nn.Module):
    def __init__(self, cfg: MapperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, K, C = cfg.dim_embedding, cfg.prefix_length, cfg.clip_length
        self.linear = nn.Linear(cfg.dim_clip, C * D, device=device)
        self.prefix_const = nn.Parameter(torch.zeros(K, D, device=device))
        self.transformer = _Stack(cfg, D, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = x.shape[0]
        D, K, C = cfg.dim_embedding, cfg.prefix_length, cfg.clip_length
        h = self.linear(x).reshape(B, C, D)
        const = self.prefix_const[None].expand(B, K, D)
        h = self.transformer(torch.cat([h, const], dim=1))
        return h[:, C:]


class TransformerDecoderMapper(nn.Module):
    """TransformerEncoderDecoder: the encoder runs over clip_length
    reference tokens of width enc_dec_dim_ref; the decoder over
    prefix_const returns all prefix_length slots."""

    def __init__(self, cfg: MapperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, K, C = cfg.dim_embedding, cfg.prefix_length, cfg.clip_length
        R = cfg.enc_dec_dim_ref
        self.linear = nn.Linear(cfg.dim_clip, C * R, device=device)
        self.prefix_const = nn.Parameter(torch.zeros(K, D, device=device))
        self.ref_encoder = _Stack(cfg, R, device)
        self.prefix_decoder = _DecoderStack(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = x.shape[0]
        ref = self.linear(x).reshape(B, cfg.clip_length, cfg.enc_dec_dim_ref)
        ref = self.ref_encoder(ref)
        const = self.prefix_const[None].expand(B, cfg.prefix_length,
                                               cfg.dim_embedding)
        return self.prefix_decoder(const, ref)


def _sequential(sizes, act, device):
    """nn.Sequential of linears over `sizes`, `act()` between them."""
    mods = []
    for i in range(len(sizes) - 1):
        if i:
            mods.append(act())
        mods.append(nn.Linear(sizes[i], sizes[i + 1], device=device))
    return nn.Sequential(*mods)


class MLPMapper(nn.Module):
    def __init__(self, cfg: MapperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, K = cfg.dim_embedding, cfg.prefix_length
        self.model = _sequential((cfg.dim_clip, (D * K) // 2, D * K),
                                 nn.Tanh, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return self.model(x).reshape(x.shape[0], cfg.prefix_length,
                                     cfg.dim_embedding)


class _LeakyMLP(nn.Module):
    """The reference's MLP module under `mlp.` (gpt2_prefix.py:129-136)."""

    def __init__(self, sizes, device=None):
        super().__init__()
        self.model = _sequential(sizes, lambda: nn.LeakyReLU(0.01), device)

    def forward(self, x):
        return self.model(x)


class MappingNetwork(nn.Module):
    def __init__(self, cfg: MapperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mlp = _LeakyMLP([cfg.dim_clip] * 7
                             + [cfg.prefix_length * cfg.dim_embedding],
                             device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return self.mlp(x).reshape(x.shape[0], cfg.prefix_length,
                                   cfg.dim_embedding)


_MAPPERS = {"transformer": TransformerMapper, "mlp": MLPMapper,
            "transformer_decoder": TransformerDecoderMapper,
            "mapping_network": MappingNetwork}


def build_mapper(cfg: MapperConfig, device=None) -> nn.Module:
    t = cfg.canonical_type()
    if t not in _MAPPERS:
        raise ValueError(f"unknown mapping_type: {cfg.mapping_type}")
    return _MAPPERS[t](cfg, device)


@torch.no_grad()
def init_params(mapper: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in place from `generator`: torch nn.Linear's
    kaiming-uniform bounds (as the JAX reference draws them), unit
    layernorms, normal prefix_const."""
    for m in mapper.modules():
        if isinstance(m, nn.Linear):
            bound = (1.0 / m.in_features) ** 0.5
            for p, b in ((m.weight, bound * 3 ** 0.5), (m.bias, bound)):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=generator,
                                        device=p.device) * 2 - 1) * b)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    const = getattr(mapper, "prefix_const", None)
    if const is not None:
        const.copy_(torch.randn(const.shape, generator=generator,
                                device=const.device))
    return mapper


def mapper_to_torch_state_dict(mapper: nn.Module, cfg: MapperConfig,
                               prefix: str = "clip_project."
                               ) -> Dict[str, torch.Tensor]:
    """The reference key layout (under `prefix`) of a mapper's weights as
    float32 CPU tensors (the JAX `mapper_to_torch_state_dict`,
    mappers.py:364)."""
    return {prefix + k: v.detach().to("cpu", torch.float32)
            for k, v in mapper.state_dict().items()}


def _stacked_layers(out: Dict[str, Any], base: str, L: Dict[str, Any],
                    i: int) -> None:
    """Layer i of a JAX stack `L` (leading layer axis, matrices
    [in, out]) under the reference keys `base`*."""
    at = lambda a: np.asarray(a)[i]
    out[base + "norm1.weight"] = at(L["norm1"]["scale"])
    out[base + "norm1.bias"] = at(L["norm1"]["bias"])
    out[base + "attn.to_queries.weight"] = at(L["attn"]["wq"]).T
    out[base + "attn.to_keys_values.weight"] = at(L["attn"]["wkv"]).T
    out[base + "attn.project.weight"] = at(L["attn"]["proj"]["w"]).T
    out[base + "attn.project.bias"] = at(L["attn"]["proj"]["b"])
    out[base + "norm2.weight"] = at(L["norm2"]["scale"])
    out[base + "norm2.bias"] = at(L["norm2"]["bias"])
    out[base + "mlp.fc1.weight"] = at(L["mlp"]["fc1"]["w"]).T
    out[base + "mlp.fc1.bias"] = at(L["mlp"]["fc1"]["b"])
    out[base + "mlp.fc2.weight"] = at(L["mlp"]["fc2"]["w"]).T
    out[base + "mlp.fc2.bias"] = at(L["mlp"]["fc2"]["b"])


def state_dict_from_jax_numpy(tree: Dict[str, Any], cfg: MapperConfig,
                              prefix: str = "") -> Dict[str, np.ndarray]:
    """Reference key layout of a JAX mapper pytree given as numpy arrays
    (transformer layers stacked on a leading axis, matrices [in, out])."""
    t = cfg.canonical_type()
    out: Dict[str, Any] = {}
    if t in ("mlp", "mapping_network"):
        base = "model" if t == "mlp" else "mlp.model"
        for j, p in enumerate(tree["layers"]):
            out[f"{prefix}{base}.{2 * j}.weight"] = np.asarray(p["w"]).T
            out[f"{prefix}{base}.{2 * j}.bias"] = p["b"]
    elif t in ("transformer", "transformer_decoder"):
        out[f"{prefix}linear.weight"] = np.asarray(tree["linear"]["w"]).T
        out[f"{prefix}linear.bias"] = tree["linear"]["b"]
        out[f"{prefix}prefix_const"] = tree["prefix_const"]
        for i in range(cfg.num_layers):
            if t == "transformer":
                _stacked_layers(out, f"{prefix}transformer.layers.{i}.",
                                tree["layers"], i)
                continue
            _stacked_layers(out, f"{prefix}ref_encoder.layers.{i}.",
                            tree["encoder"], i)
            _stacked_layers(out, f"{prefix}prefix_decoder.layers.{2 * i}.",
                            tree["dec_cross"], i)
            _stacked_layers(out,
                            f"{prefix}prefix_decoder.layers.{2 * i + 1}.",
                            tree["dec_self"], i)
    else:
        raise ValueError(f"unknown mapping_type: {cfg.mapping_type}")
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in out.items()}


def params_from_jax_numpy(tree: Dict[str, Any], cfg: MapperConfig,
                          device=None) -> nn.Module:
    """Load the port's mapper from the JAX package's mapper pytree."""
    mapper = build_mapper(cfg, device)
    mapper.load_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax_numpy(tree, cfg).items()},
        strict=True)
    return mapper
