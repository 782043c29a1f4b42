"""The text model of Kimi-VL-A3B-Instruct (a DeepSeek-V3 block: latent
attention, routed and shared experts, an untied head) as the benchmark's
decoder: the model object's `mla_moe` key. Binds the plain reference
(reference/mla_moe.py), the frozen matmul count
(roofline/mla_moe_model.py) and the program's adapter
(`capdec_tpu_torch.models.mla_moe`, imported where it is used). It has no
K2 and no training step."""
from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference import mla_moe as _ref
from benchmark.roofline import mla_moe_model as _model

layout = _ref.layout
caption_logits = _ref.caption_logits
beam_search = _ref.beam_search
Precision = _ref.Precision
caption_flops = _model.caption_flops
# the decoder has no K2 (its decode attention is K16: mla_attention_roofline)
decode_attention_shape = None


def hidden(model_cfg: Dict) -> int:
    return model_cfg["mla_moe"]["hidden_size"]


def vocab(model_cfg: Dict) -> int:
    return model_cfg["mla_moe"]["vocab_size"]


def lm_head_shape(model_cfg: Dict) -> Tuple[int, int]:
    """(D, V) of the untied LM head's product."""
    return hidden(model_cfg), vocab(model_cfg)


def train_step_flops(model_cfg: Dict, batch: int, tokens: int) -> float:
    raise NotImplementedError("the MLA-MoE decoder is served, not trained, "
                              "by the benchmark")


# settings of the published config that the program implements as they
# are and no other way
_FIXED = {"q_lora_rank": None, "scoring_func": "sigmoid",
          "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
          "rope_scaling": None, "attention_bias": False, "hidden_act": "silu",
          "tie_word_embeddings": False, "moe_layer_freq": 1}


def model_config(model_cfg: Dict, precision: str, only_prefix: bool = False):
    """The program's CaptionModelConfig with the MLA-MoE decoder."""
    import torch
    from capdec_tpu_torch.models import caption_model, mla_moe
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    c, m = model_cfg["mla_moe"], model_cfg["mapper"]
    for key, want in _FIXED.items():
        if c.get(key, want) != want:
            raise ValueError(f"the MLA-MoE decoder takes {key} {want!r}, "
                             f"got {c[key]!r}")
    keys = {f.name for f in __import__("dataclasses").fields(
        mla_moe.MLAMoEConfig)} - {"compute_dtype", "kv_norm_eps",
                                  "rope_positions"}
    return caption_model.CaptionModelConfig(
        prefix_length=m["prefix_length"],
        clip_length=m.get("clip_length", m["prefix_length"]),
        prefix_size=m["prefix_size"],
        num_layers=m.get("num_layers", 2),
        mapping_type=m["type"],
        only_prefix=only_prefix,
        mla_moe=mla_moe.MLAMoEConfig(
            **{k: c[k] for k in keys}, compute_dtype=dtypes[precision]))


def load_model(sd, mcfg, device):
    """The program's model from a reference-layout state dict: the decoder
    holds the state dict's tensors (no copy), the mapper f32 copies."""
    from capdec_tpu_torch.models import caption_model
    return caption_model.params_from_torch_state_dict(sd, mcfg, device)


def _decode_step(*a, **k):
    return a[5] if len(a) > 5 else k.get("step")


def spans():
    from capdec_tpu_torch.models import mla_moe
    return [(mla_moe, "prefill", "prefill", None),
            (mla_moe, "decode_step", "decode_step", _decode_step)]
