"""The system under test: `capdec_tpu_torch`, built from a configuration
file and the benchmark's state dict through the program's own loader,
which the configuration's decoder (decoders/<key>.py) names, and served
by the program's CaptionServer."""
from __future__ import annotations

from typing import Dict

import torch

from capdec_tpu_torch import serve as serve_lib
from capdec_tpu_torch.decode import BeamConfig

from benchmark import decoders


def model_config(cfg: Dict, precision: str, only_prefix: bool = False):
    """The program's CaptionModelConfig of a configuration file, by its
    decoder (decoders/<key>.py)."""
    return decoders.of(cfg["model"]).model_config(cfg["model"], precision,
                                                  only_prefix)


def load_model(cfg: Dict, sd: Dict[str, torch.Tensor], mcfg, device):
    """The program's model of configuration file `cfg` from a
    reference-layout state dict."""
    return decoders.of(cfg["model"]).load_model(sd, mcfg, device)


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
