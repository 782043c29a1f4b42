"""A configuration's decoder, found by name.

The configuration file's `model` object holds `mapper` and one other key,
which names the language model behind the mapper; `of(model_cfg)` returns
the module `benchmark/decoders/<key>.py`. A decoder module binds, for
the rest of the benchmark, everything that depends on the language
model:

  layout(model_cfg)            (key, shape, init) of every tensor of the
                               reference-layout state dict
  hidden(model_cfg)            the width of the mapper's output
  vocab(model_cfg)             the vocabulary's size
  caption_logits, beam_search, Precision
                               the plain reference (float32; Precision
                               "fp8" for the control)
  model_config(model_cfg, precision, only_prefix=False), load_model(sd,
  mcfg, device)                the program's configuration and model
  spans()                      (owner, attribute, span name, meta) of the
                               program functions a traced serving run
                               wraps, one of them named `decode_step`
                               (meta: its decode step)
  caption_flops(model_cfg, beam_size, entry_length),
  train_step_flops(model_cfg, batch, tokens)
                               frozen matmul counts for the MFUs
  lm_head_shape(model_cfg)     (D, V) of K1's product
  decode_attention_shape       a function giving the K/V row width of K2,
                               or None where the decoder has no K2

So a new decoder is a new file here (with its reference), and no file
that reads a decoder changes.
"""
from __future__ import annotations

import importlib
from typing import Dict


def key(model_cfg: Dict) -> str:
    """The one key of `model_cfg` other than `mapper`."""
    keys = [k for k in model_cfg if k != "mapper"]
    if len(keys) != 1:
        raise ValueError(f"a configuration's model holds `mapper` and one "
                         f"decoder; found {sorted(model_cfg)}")
    return keys[0]


def of(model_cfg: Dict):
    """The decoder module of the configuration's `model` object."""
    return importlib.import_module(f"benchmark.decoders.{key(model_cfg)}")
