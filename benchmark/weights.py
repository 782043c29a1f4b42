"""Random weights of a configuration, made on the device from the seed.

The benchmark makes one reference-layout state dict (`gpt.*`,
`clip_project.*`), hands it to the program's loader and, after the window,
makes it again for the reference: the same seed on the same device gives
the same tensors. Two large draws make every tensor: one standard normal
for the normal ones, one uniform for the mapper's linears (weights
within +-sqrt(3 / fan_in), unit variance, biases within +-1 / sqrt(fan_in));
each tensor is a view of a slice, scaled. The scales of the normal tensors are
the configuration file's `weights` (see the file's `assumed` for why they
are wider than GPT-2's initialisation).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import model as ref_model

UNIFORM = ("linear", "linear_bias")


def _fan_in(shapes: Dict[str, tuple], key: str, kind: str) -> int:
    w = key if kind == "linear" else key[:-len("bias")] + "weight"
    return shapes[w][-1]


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration file `cfg`'s random weights for `seed`, float32
    on `device`."""
    spec = ref_model.layout(cfg["model"])
    scales = cfg["weights"]
    shapes = {k: s for k, s, _ in spec}
    n_normal = sum(math.prod(s) for _, s, kind in spec
                   if kind not in UNIFORM + ("one", "zero"))
    n_uniform = sum(math.prod(s) for _, s, kind in spec if kind in UNIFORM)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    sd, i, j = {}, 0, 0
    for key, shape, kind in spec:
        n = math.prod(shape)
        if kind == "one":
            sd[key] = torch.ones(shape, device=device)
        elif kind == "zero":
            sd[key] = torch.zeros(shape, device=device)
        elif kind in UNIFORM:
            bound = _fan_in(shapes, key, kind) ** -0.5
            if kind == "linear":
                bound *= math.sqrt(3.0)
            sd[key] = uniform[j:j + n].view(shape).mul_(2).sub_(1).mul_(bound)
            j += n
        else:
            sd[key] = normal[i:i + n].view(shape).mul_(float(scales[kind]))
            i += n
    return sd
