"""The system under test: `capdec_tpu_torch`, built from a configuration
file and the benchmark's state dict through the program's own loader.
This is the one module of the benchmark that imports the program."""
from __future__ import annotations

from typing import Dict

import torch

from capdec_tpu_torch import serve as serve_lib
from capdec_tpu_torch.decode import BeamConfig
from capdec_tpu_torch.models import caption_model, gpt2

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def model_config(cfg: Dict, precision: str,
                 only_prefix: bool = False) -> caption_model.CaptionModelConfig:
    """The program's CaptionModelConfig of a configuration file."""
    g, m = cfg["model"]["gpt2"], cfg["model"]["mapper"]
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
            compute_dtype=DTYPES[precision]))


def load_model(sd: Dict[str, torch.Tensor],
               mcfg: caption_model.CaptionModelConfig, device):
    """The program's model from a reference-layout state dict."""
    return caption_model.params_from_torch_state_dict(sd, mcfg, device)


class IdTokenizer:
    """Detokenizes a caption as its token ids joined by commas, so that
    the benchmark reads back exactly the tokens the server chose (the
    repository carries no GPT-2 vocabulary)."""

    def decode(self, ids) -> str:
        return ",".join(map(str, ids.tolist()))

    @staticmethod
    def parse(text: str):
        return [int(t) for t in text.split(",")] if text else []


def caption_server(model, mcfg, decode: Dict, traffic: Dict, device):
    """A CaptionServer with the configuration's decoding (`decode`) and
    the mix's batching."""
    cfg = serve_lib.ServeConfig(
        batch_size=traffic["batch_size"], max_wait_s=traffic["max_wait_s"],
        beam=True, max_queue=traffic["max_queue"],
        beam_config=BeamConfig(beam_size=decode["beam_size"],
                               entry_length=decode["entry_length"],
                               stop_token=decode["stop_token"]))
    return serve_lib.CaptionServer(model, mcfg, IdTokenizer(), cfg,
                                   device=device)
