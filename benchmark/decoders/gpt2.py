"""GPT-2 124M (HuggingFace `GPT2LMHeadModel`, tied LM head) as the
benchmark's decoder: the model object's `gpt2` key. Binds the plain
reference (reference/model.py), the frozen matmul counts
(roofline/decode_model.py, roofline/train_model.py) and the program's
adapter (`capdec_tpu_torch.models.gpt2`, imported where it is used)."""
from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference import model as _ref
from benchmark.roofline import decode_model as _decode_model
from benchmark.roofline import train_model as _train_model

layout = _ref.layout
caption_logits = _ref.caption_logits
beam_search = _ref.beam_search
Precision = _ref.Precision
caption_flops = _decode_model.caption_flops
train_step_flops = _train_model.train_step_flops


def hidden(model_cfg: Dict) -> int:
    return model_cfg["gpt2"]["n_embd"]


def vocab(model_cfg: Dict) -> int:
    return model_cfg["gpt2"]["vocab_size"]


def lm_head_shape(model_cfg: Dict) -> Tuple[int, int]:
    """(D, V) of the tied LM head's product."""
    return hidden(model_cfg), vocab(model_cfg)


def decode_attention_shape(model_cfg: Dict) -> int:
    """The width of K2's K/V rows: every head of a layer, n_embd."""
    return hidden(model_cfg)


def model_config(model_cfg: Dict, precision: str, only_prefix: bool = False):
    """The program's CaptionModelConfig."""
    import torch
    from capdec_tpu_torch.models import caption_model, gpt2
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    g, m = model_cfg["gpt2"], model_cfg["mapper"]
    return caption_model.CaptionModelConfig(
        prefix_length=m["prefix_length"],
        clip_length=m.get("clip_length", m["prefix_length"]),
        prefix_size=m["prefix_size"],
        num_layers=m.get("num_layers", 2),
        mapping_type=m["type"],
        only_prefix=only_prefix,
        gpt2=gpt2.GPT2Config(
            vocab_size=g["vocab_size"], n_positions=g["n_positions"],
            n_embd=g["n_embd"], n_layer=g["n_layer"], n_head=g["n_head"],
            layer_norm_epsilon=g["layer_norm_epsilon"],
            compute_dtype=dtypes[precision]))


def load_model(sd, mcfg, device):
    """The program's model from a reference-layout state dict."""
    from capdec_tpu_torch.models import caption_model
    return caption_model.params_from_torch_state_dict(sd, mcfg, device)


def _decode_step(*a, **k):
    return a[5] if len(a) > 5 else k.get("step")


def spans():
    from capdec_tpu_torch.models import gpt2
    return [(gpt2, "prefill", "prefill", None),
            (gpt2, "decode_step", "decode_step", _decode_step)]
