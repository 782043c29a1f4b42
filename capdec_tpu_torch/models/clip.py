"""CLIP encoders (text, ViT, modified ResNet) in PyTorch (port of
capdec_tpu/models/clip.py).

The reference leans on the OpenAI `clip` package for embedding extraction
(embeddings_generator.py:3,49) and inference-time image encoding
(predictions_runner.py:157-161); here the towers are the port's own
modules, batched on the card.

Supported backbones (reference choices, embeddings_generator.py:113):
RN50, RN101, RN50x4, ViT-B/32. Module and parameter names are OpenAI's
(`transformer.resblocks.{i}.attn.in_proj_weight`, `visual.conv1.weight`,
`visual.layer1.0.downsample.0.weight`, ...), so `load_state_dict` reads an
OpenAI CLIP state dict with no renaming. Inference-only: batch norm always
runs in its eval form, from the running statistics.

Numerics follow the JAX package (capdec_tpu/models/clip.py:99-290): layer
norm in float32, quick_gelu, a -1e9 causal bias added to float32 scores,
softmax in float32, the EOT feature at the first argmax of the tokens,
average pools where torchvision would stride. One difference, after
OpenAI's `ModifiedResNet.conv1`: the stride-2 stem conv pads 1 and 1; the
JAX package's "SAME" pads 0 and 1 on an even input (ROADMAP.md Queue 3,
F2). Images arrive NHWC float32 (CLIP-normalised, as `data/image_ops`
gives them); the towers permute them once to NCHW (a channels_last view).
"""
from __future__ import annotations

import dataclasses
import re
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    image_resolution: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPResNetConfig:
    layers: Tuple[int, ...] = (4, 6, 10, 6)
    width: int = 80
    image_resolution: int = 288
    embed_dim: int = 640

    @property
    def heads(self) -> int:
        return self.width * 32 // 64


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    text: CLIPTextConfig
    vision: Any  # CLIPViTConfig | CLIPResNetConfig

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision, CLIPResNetConfig)


MODEL_CONFIGS: Dict[str, CLIPConfig] = {
    "ViT-B/32": CLIPConfig(
        "ViT-B/32",
        CLIPTextConfig(width=512, heads=8, layers=12, embed_dim=512),
        CLIPViTConfig(224, 32, 768, 12, 12, 512)),
    "RN50": CLIPConfig(
        "RN50",
        CLIPTextConfig(width=512, heads=8, layers=12, embed_dim=1024),
        CLIPResNetConfig((3, 4, 6, 3), 64, 224, 1024)),
    "RN101": CLIPConfig(
        "RN101",
        CLIPTextConfig(width=512, heads=8, layers=12, embed_dim=512),
        CLIPResNetConfig((3, 4, 23, 3), 64, 224, 512)),
    "RN50x4": CLIPConfig(
        "RN50x4",
        CLIPTextConfig(width=640, heads=10, layers=12, embed_dim=640),
        CLIPResNetConfig((4, 6, 10, 6), 80, 288, 640)),
}


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """Layer norm computed in float32, cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm in its eval form, from the running statistics, whatever
    the module's mode: the towers are inference-only."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, H, Tq, hd], k/v [B, H, T, hd]: float32 scores scaled after the
    product, `bias` added, float32 softmax, probabilities in v's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


class MultiheadAttention(nn.Module):
    """The parameters of `nn.MultiheadAttention` (`in_proj_weight`,
    `in_proj_bias`, `out_proj`), computed as the JAX package does."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, W = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(B, T, 3, self.heads, W // self.heads).permute(
            2, 0, 3, 1, 4)
        out = _attention(q, k, v, bias)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, W))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, device)
        self.ln_1 = LayerNorm(width, device=device)
        self.mlp = nn.ModuleDict(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width, device=device)),
            ("c_proj", nn.Linear(4 * width, width, device=device))]))
        self.ln_2 = LayerNorm(width, device=device)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias)
        h = self.mlp["c_fc"](self.ln_2(x))
        return x + self.mlp["c_proj"](quick_gelu(h))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, device)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        bias = None
        if causal:
            T = x.shape[1]
            bias = torch.full((T, T), -1e9, device=x.device).triu(1)
        for blk in self.resblocks:
            x = blk(x, bias)
        return x


# ---------------------------------------------------------------------------
# Image towers
# ---------------------------------------------------------------------------


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPViTConfig, device=None):
        super().__init__()
        W, P = cfg.width, cfg.patch_size
        n_pos = (cfg.image_resolution // P) ** 2 + 1
        self.conv1 = nn.Conv2d(3, W, P, stride=P, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.empty(W, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(n_pos, W, device=device))
        self.ln_pre = LayerNorm(W, device=device)
        self.transformer = Transformer(W, cfg.layers, cfg.heads, device)
        self.ln_post = LayerNorm(W, device=device)
        self.proj = nn.Parameter(torch.empty(W, cfg.embed_dim, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] (CLIP-normalised) -> [B, embed_dim]."""
        x = self.conv1(images.permute(0, 3, 1, 2))  # [B, W, g, g]
        x = x.flatten(2).transpose(1, 2)            # [B, g*g, W]
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x), causal=False)
        return self.ln_post(x[:, 0]) @ self.proj


class Bottleneck(nn.Module):
    """CLIP's anti-aliased Bottleneck: stride-1 convs with an average pool
    where torchvision would stride (openai CLIP model.py Bottleneck). The
    downsample branch is OpenAI's `Sequential` of ("-1" pool, "0" conv,
    "1" batch norm)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 device=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = BatchNorm2d(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False,
                               device=device)
        self.bn2 = BatchNorm2d(planes, device=device)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False, device=device)
        self.bn3 = BatchNorm2d(out, device=device)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(inplanes, out, 1, bias=False, device=device)),
                ("1", BatchNorm2d(out, device=device))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The mean token queries every position (+ positional embedding)."""

    def __init__(self, spacial_dim: int, embed_dim: int, heads: int,
                 output_dim: int, device=None):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim, device=device))
        self.k_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.q_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.v_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.c_proj = nn.Linear(embed_dim, output_dim, device=device)
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> [B, output_dim]."""
        x = x.flatten(2).transpose(1, 2)  # [B, H*W, C], row-major positions
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding
        B, T, C = x.shape
        hd = C // self.heads
        q = self.q_proj(x[:, :1]).view(B, 1, self.heads, hd).transpose(1, 2)
        k = self.k_proj(x).view(B, T, self.heads, hd).transpose(1, 2)
        v = self.v_proj(x).view(B, T, self.heads, hd).transpose(1, 2)
        out = _attention(q, k, v, None)
        return self.c_proj(out.transpose(1, 2).reshape(B, C))


class ModifiedResNet(nn.Module):
    """OpenAI CLIP's ResNet: a 3-conv stem with an average pool,
    anti-aliased bottlenecks, and an attention pool in place of the
    global average pool."""

    def __init__(self, cfg: CLIPResNetConfig, device=None):
        super().__init__()
        W = cfg.width
        self.conv1 = nn.Conv2d(3, W // 2, 3, stride=2, padding=1, bias=False,
                               device=device)
        self.bn1 = BatchNorm2d(W // 2, device=device)
        self.conv2 = nn.Conv2d(W // 2, W // 2, 3, padding=1, bias=False,
                               device=device)
        self.bn2 = BatchNorm2d(W // 2, device=device)
        self.conv3 = nn.Conv2d(W // 2, W, 3, padding=1, bias=False,
                               device=device)
        self.bn3 = BatchNorm2d(W, device=device)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = W
        for stage, n_blocks in enumerate(cfg.layers):
            planes = W * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = [Bottleneck(inplanes, planes, stride, device)]
            inplanes = planes * Bottleneck.expansion
            blocks += [Bottleneck(inplanes, planes, device=device)
                       for _ in range(1, n_blocks)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, W * 32,
                                        cfg.heads, cfg.embed_dim, device)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> [B, width, H/4, W/4]: three conv/bn/relu, the
        first at stride 2, then a 2x2 average pool."""
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x)))
        return self.avgpool(x)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] (CLIP-normalised) -> [B, embed_dim]."""
        x = self.stem(images.permute(0, 3, 1, 2))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


class CLIP(nn.Module):
    """The text tower's parameters at the top level and the image tower
    under `visual`, as in OpenAI's CLIP (no `logit_scale`: captioning never
    compares the two towers' outputs)."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        t = cfg.text
        self.token_embedding = nn.Embedding(t.vocab_size, t.width,
                                            device=device)
        self.positional_embedding = nn.Parameter(
            torch.empty(t.context_length, t.width, device=device))
        self.transformer = Transformer(t.width, t.layers, t.heads, device)
        self.ln_final = LayerNorm(t.width, device=device)
        self.text_projection = nn.Parameter(
            torch.empty(t.width, t.embed_dim, device=device))
        self.visual = (ModifiedResNet(cfg.vision, device) if cfg.is_resnet
                       else VisionTransformer(cfg.vision, device))

    @torch.no_grad()
    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] int -> float32 [B, embed_dim], unnormalised (the
        reference's `clip_model.encode_text`)."""
        tokens = tokens.long()
        x = self.token_embedding(tokens) \
            + self.positional_embedding[:tokens.shape[1]]
        x = self.ln_final(self.transformer(x, causal=True))
        # the feature at the EOT token, the highest id of each row
        feats = x[torch.arange(x.shape[0], device=x.device),
                  tokens.argmax(dim=-1)]
        return (feats @ self.text_projection).float()

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] CLIP-normalised -> float32 [B, embed_dim]."""
        dtype = self.text_projection.dtype
        return self.visual(images.to(dtype)).float()


# ---------------------------------------------------------------------------
# Random init (JAX's scales, capdec_tpu/models/clip.py:571-707)
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_params(model: CLIP, generator: torch.Generator) -> CLIP:
    """Random weights in place, drawn from `generator` (a generator of the
    model's device) at the JAX package's scales: normal(0.02) matrices,
    zero biases and unit layer norms in the transformers; ResNet convs and
    attention-pool linears normal(fan_in ** -0.5), identity batch norms."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)

    def init_transformer(tr):
        for blk in tr.resblocks:
            normal_(blk.attn.in_proj_weight, 0.02)
            normal_(blk.attn.out_proj.weight, 0.02)
            normal_(blk.mlp["c_fc"].weight, 0.02)
            normal_(blk.mlp["c_proj"].weight, 0.02)
            for p in (blk.attn.in_proj_bias, blk.attn.out_proj.bias,
                      blk.mlp["c_fc"].bias, blk.mlp["c_proj"].bias):
                p.zero_()

    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()  # unit scale, zero bias (and mean 0, var 1)
    normal_(model.token_embedding.weight, 0.02)
    normal_(model.positional_embedding, 0.01)
    init_transformer(model.transformer)
    normal_(model.text_projection, 0.02)
    v = model.visual
    if isinstance(v, VisionTransformer):
        normal_(v.conv1.weight, 0.02)
        normal_(v.class_embedding, 0.02)
        normal_(v.positional_embedding, 0.01)
        init_transformer(v.transformer)
        normal_(v.proj, 0.02)
        return model
    for m in v.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, (m.weight[0].numel()) ** -0.5)
    C = v.attnpool.positional_embedding.shape[1]
    normal_(v.attnpool.positional_embedding, C ** -0.5)
    for lin in (v.attnpool.q_proj, v.attnpool.k_proj, v.attnpool.v_proj,
                v.attnpool.c_proj):
        normal_(lin.weight, lin.in_features ** -0.5)
        lin.bias.zero_()
    return model


def build_model(cfg: CLIPConfig, generator: torch.Generator,
                device=None) -> CLIP:
    """A CLIP model of `cfg` with random weights from `generator`."""
    return init_params(CLIP(cfg, device).eval(), generator)


# ---------------------------------------------------------------------------
# OpenAI checkpoints (capdec_tpu/models/clip.py:347-570)
# ---------------------------------------------------------------------------

# Keys of an OpenAI archive that no tower reads (`clip.model.build_model`
# drops the first three; captioning never uses the logit scale).
_UNUSED_KEYS = ("input_resolution", "context_length", "vocab_size",
                "logit_scale")
# The JAX package writes a bottleneck's downsample conv under
# `downsample.1` and its batch norm under `downsample.2`; OpenAI's
# `Sequential` names them "0" and "1" (ROADMAP.md Queue 3, F3).
_JAX_DOWNSAMPLE = re.compile(r"(\.downsample\.)([12])(\.)")


def _openai_layout(sd: Dict[str, Any]) -> Dict[str, Any]:
    """`sd` with the keys no tower reads dropped and the JAX package's
    downsample indices renamed to OpenAI's."""
    jax_layout = any(".downsample.2." in k for k in sd)
    out = {}
    for k, v in sd.items():
        if k in _UNUSED_KEYS:
            continue
        if jax_layout:
            k = _JAX_DOWNSAMPLE.sub(
                lambda m: f"{m[1]}{int(m[2]) - 1}{m[3]}", k)
        out[k] = v
    return out


def config_from_openai_state_dict(sd, name: str = "custom") -> CLIPConfig:
    """Infer the architecture from checkpoint shapes, by the rules of
    OpenAI's `clip.model.build_model` (the reference loads checkpoints
    through `clip.load`, which never takes an explicit config)."""
    def shape(k):
        return tuple(sd[k].shape)

    def n_blocks(prefix):
        seg = prefix.count(".") + 1
        return len({k.split(".")[seg] for k in sd
                    if k.startswith(prefix + ".")})

    embed_dim = shape("text_projection")[1]
    text = CLIPTextConfig(
        vocab_size=shape("token_embedding.weight")[0],
        context_length=shape("positional_embedding")[0],
        width=shape("ln_final.weight")[0],
        heads=shape("ln_final.weight")[0] // 64,
        layers=n_blocks("transformer.resblocks"),
        embed_dim=embed_dim)
    if "visual.proj" in sd:  # ViT tower
        patch = shape("visual.conv1.weight")[-1]
        grid = int(round((shape("visual.positional_embedding")[0] - 1)
                         ** 0.5))
        vision = CLIPViTConfig(
            image_resolution=patch * grid, patch_size=patch,
            width=shape("visual.conv1.weight")[0],
            layers=n_blocks("visual.transformer.resblocks"),
            heads=shape("visual.conv1.weight")[0] // 64,
            embed_dim=embed_dim)
    else:  # modified-ResNet tower
        layers = tuple(n_blocks(f"visual.layer{b}") for b in (1, 2, 3, 4))
        out_hw = int(round((shape("visual.attnpool.positional_embedding")[0]
                            - 1) ** 0.5))
        vision = CLIPResNetConfig(
            layers=layers, width=shape("visual.layer1.0.conv1.weight")[0],
            image_resolution=out_hw * 32, embed_dim=embed_dim)
    return CLIPConfig(name, text, vision)


def params_from_openai_state_dict(sd: Dict[str, Any], cfg: CLIPConfig,
                                  dtype=torch.float32, device=None) -> CLIP:
    """A CLIP model holding an OpenAI-layout state dict (torch tensors or
    numpy arrays, any float dtype), loaded strictly and cast to `dtype`.
    The JAX package's downsample keys are read too."""
    sd = {k: torch.as_tensor(v) for k, v in _openai_layout(sd).items()}
    model = CLIP(cfg, device).eval()
    model.load_state_dict(sd, strict=True)
    return model.to(dtype)


def load_openai_checkpoint(path: str, model_name: Optional[str] = None,
                           dtype=torch.float32, device=None
                           ) -> Tuple[CLIP, CLIPConfig]:
    """Load an OpenAI CLIP `.pt` (a TorchScript archive, as OpenAI ships
    them, or a plain state dict) as a `dtype` model on `device` (fp16
    values are cast). The architecture is inferred from the checkpoint
    (like the reference's `clip.load`); `model_name` labels the config,
    and a zoo name whose config differs from the checkpoint's is refused."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
    cfg = config_from_openai_state_dict(sd, model_name or "custom")
    if model_name in MODEL_CONFIGS and cfg != MODEL_CONFIGS[model_name]:
        raise ValueError(
            f"checkpoint architecture {cfg} does not match the requested "
            f"{model_name}; pass the right --is_rn / model name")
    return params_from_openai_state_dict(sd, cfg, dtype, device), cfg


def params_to_openai_state_dict(model: CLIP) -> Dict[str, np.ndarray]:
    """The model's weights in OpenAI's layout as float32 numpy arrays
    (batch norms without their unused `num_batches_tracked`)."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def save_openai_checkpoint(model: CLIP, path: str) -> None:
    """Write the model as a plain OpenAI-layout state dict in fp16, as
    OpenAI ships its weights."""
    torch.save({k: torch.from_numpy(v).half()
                for k, v in params_to_openai_state_dict(model).items()}, path)


# ---------------------------------------------------------------------------
# Weights from the JAX package
# ---------------------------------------------------------------------------


def _layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a pytree whose leaves are stacked on a leading axis."""
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in stacked.items()}


def state_dict_from_jax_numpy(tree: Dict[str, Any],
                              cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """OpenAI layout of the JAX package's CLIP pytree given as numpy arrays
    ({"text": ..., "visual": ...}; linears [in, out] -> [out, in], convs
    HWIO -> OIHW, stacked resblocks -> one entry per layer)."""
    out: Dict[str, np.ndarray] = {}

    def put_lin(name, p):
        out[f"{name}.weight"] = np.asarray(p["w"]).T
        out[f"{name}.bias"] = np.asarray(p["b"])

    def put_norm(name, p):
        out[f"{name}.weight"] = np.asarray(p["scale"])
        out[f"{name}.bias"] = np.asarray(p["bias"])
        if "mean" in p:
            out[f"{name}.running_mean"] = np.asarray(p["mean"])
            out[f"{name}.running_var"] = np.asarray(p["var"])

    def put_conv(name, w):
        out[f"{name}.weight"] = np.asarray(w).transpose(3, 2, 0, 1)

    def put_resblocks(base, stacked, n):
        for i in range(n):
            blk = _layer(stacked, i)
            b = f"{base}.{i}"
            put_norm(f"{b}.ln_1", blk["ln_1"])
            out[f"{b}.attn.in_proj_weight"] = blk["attn"]["in_proj"]["w"].T
            out[f"{b}.attn.in_proj_bias"] = blk["attn"]["in_proj"]["b"]
            put_lin(f"{b}.attn.out_proj", blk["attn"]["out_proj"])
            put_norm(f"{b}.ln_2", blk["ln_2"])
            put_lin(f"{b}.mlp.c_fc", blk["mlp"]["c_fc"])
            put_lin(f"{b}.mlp.c_proj", blk["mlp"]["c_proj"])

    t = tree["text"]
    out["token_embedding.weight"] = np.asarray(t["token_embedding"])
    out["positional_embedding"] = np.asarray(t["positional_embedding"])
    put_resblocks("transformer.resblocks", t["resblocks"], cfg.text.layers)
    put_norm("ln_final", t["ln_final"])
    out["text_projection"] = np.asarray(t["text_projection"])

    v = tree["visual"]
    if cfg.is_resnet:
        for i in (1, 2, 3):
            put_conv(f"visual.conv{i}", v[f"conv{i}"])
            put_norm(f"visual.bn{i}", v[f"bn{i}"])
        for stage in range(4):
            for j, blk in enumerate(v[f"layer{stage + 1}"]):
                b = f"visual.layer{stage + 1}.{j}"
                for c in (1, 2, 3):
                    put_conv(f"{b}.conv{c}", blk[f"conv{c}"])
                    put_norm(f"{b}.bn{c}", blk[f"bn{c}"])
                if "downsample" in blk:
                    put_conv(f"{b}.downsample.0", blk["downsample"]["conv"])
                    put_norm(f"{b}.downsample.1", blk["downsample"]["bn"])
        out["visual.attnpool.positional_embedding"] = np.asarray(
            v["attnpool"]["positional_embedding"])
        for n in ("q_proj", "k_proj", "v_proj", "c_proj"):
            put_lin(f"visual.attnpool.{n}", v["attnpool"][n])
    else:
        put_conv("visual.conv1", v["conv1"])
        out["visual.class_embedding"] = np.asarray(v["class_embedding"])
        out["visual.positional_embedding"] = np.asarray(
            v["positional_embedding"])
        put_norm("visual.ln_pre", v["ln_pre"])
        put_resblocks("visual.transformer.resblocks", v["resblocks"],
                      cfg.vision.layers)
        put_norm("visual.ln_post", v["ln_post"])
        out["visual.proj"] = np.asarray(v["proj"])
    return {k: np.ascontiguousarray(a, dtype=np.float32)
            for k, a in out.items()}


def params_from_jax_numpy(tree: Dict[str, Any], cfg: CLIPConfig,
                          device=None) -> CLIP:
    """Load the port's CLIP from the JAX package's parameter pytree
    ({"text": ..., "visual": ...}) given as numpy arrays."""
    return params_from_openai_state_dict(state_dict_from_jax_numpy(tree, cfg),
                                         cfg, device=device)
