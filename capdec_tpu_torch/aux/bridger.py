"""Supervised embedding bridger: image->text CLIP-space mapper (port of
capdec_tpu/aux/bridger.py).

The reference's bridger (others/supervised_embedding_bridger.py): an
8-linear-layer MLP (LeakyReLU, identity-initialised square matrices)
trained with MSE to map image embeddings into text-embedding space, used
at inference through predict's `--modality_bridger`
(predictions_runner.py:183-184, 225-227).

Trained with `torch.optim.SGD(lr 1e-3, momentum 0.9)`, the update of
`optax.sgd(..., momentum=0.9)`, over the batches of the same numpy
permutation from `seed` as the JAX package; 100 epochs, batch 128
(reference :129-181). The weights save and load as a state_dict under
`mlp.model.{2i}.*`, so the reference's `weights_modality_mapper.pt`
files load too.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

DEFAULT_WEIGHTS_PATH = "others/weights_modality_mapper.pt"


class Bridger(nn.Module):
    """`num_layers` square linears of width `dim` with LeakyReLU(0.01)
    between them, identity-initialised (reference nn.init.eye_, :87-108):
    a no-op on inputs whose every layer's output is non-negative."""

    def __init__(self, dim: int = 640, num_layers: int = 8, device=None):
        super().__init__()
        mods = []
        for i in range(num_layers):
            if i:
                mods.append(nn.LeakyReLU(0.01))
            mods.append(nn.Linear(dim, dim, device=device))
        self.mlp = nn.Module()
        self.mlp.model = nn.Sequential(*mods)
        with torch.no_grad():
            for m in self.mlp.model:
                if isinstance(m, nn.Linear):
                    m.weight.copy_(torch.eye(dim, device=device))
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp.model(x)


def _l2norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def train_bridger(image_embeddings: np.ndarray, text_embeddings: np.ndarray,
                  dim: int = 640, num_layers: int = 8, epochs: int = 100,
                  batch_size: int = 128, lr: float = 1e-3,
                  momentum: float = 0.9, normalize: bool = True,
                  seed: int = 0, log_every: int = 20,
                  device=None) -> Bridger:
    """Train a bridger on paired embeddings; whole batches only, in the
    order of `np.random.default_rng(seed)`'s permutations."""
    x = np.asarray(image_embeddings, np.float32)
    y = np.asarray(text_embeddings, np.float32)
    if normalize:
        x, y = _l2norm(x), _l2norm(y)
    model = Bridger(dim, num_layers, device)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)
    xt, yt = (torch.as_tensor(a, device=device) for a in (x, y))
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        losses = []
        for s in range(0, n - batch_size + 1, batch_size):
            idx = order[s:s + batch_size]
            opt.zero_grad(set_to_none=True)
            loss = torch.mean(torch.square(model(xt[idx]) - yt[idx]))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if epoch % log_every == 0 or epoch == epochs - 1:
            mse = float(torch.stack(losses).mean()) if losses else float("nan")
            print(f"bridger epoch {epoch}: mse={mse:.6f}", flush=True)
    return model


def bridger_from_state_dict(sd: Dict[str, Any], device=None) -> Bridger:
    """A bridger from `mlp.model.{2i}.weight/bias` keys (as many layers as
    the file holds)."""
    n = 0
    while f"mlp.model.{2 * n}.weight" in sd:
        n += 1
    if n == 0:
        raise ValueError("no mlp.model.0.weight: not a bridger state_dict")
    model = Bridger(sd["mlp.model.0.weight"].shape[0], n, device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


def save_bridger(model: Bridger, path: str) -> None:
    from ..utils.checkpoint import save_state_dict
    save_state_dict(model.state_dict(), path)


def load_bridger_fn(dim: int = 640, path: str = DEFAULT_WEIGHTS_PATH,
                    device=None):
    """Inference hook mirroring get_map_to_text_space_using_modality_bridger
    (reference others/supervised_embedding_bridger.py:21-30): numpy
    [B, dim] in, numpy out, run on `device`. The width comes from the
    file; `dim` is kept for the JAX package's signature."""
    from ..utils.checkpoint import load_state_dict
    model = bridger_from_state_dict(load_state_dict(path), device).eval()

    @torch.no_grad()
    def fn(x):
        t = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return model(t).cpu().numpy()

    return fn


def main(argv=None):
    import argparse
    from ..utils.torch_setup import resolve_device
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True,
                   help="embedding pickle with paired image+text embeddings")
    p.add_argument("--out", default=DEFAULT_WEIGHTS_PATH)
    p.add_argument("--dim", type=int, default=640)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the CPU)")
    args = p.parse_args(argv)
    with open(args.data, "rb") as f:
        data = pickle.load(f)

    def to_np(v):
        return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
                else np.asarray(v, np.float32))

    model = train_bridger(to_np(data["clip_embedding"]),
                          to_np(data["clip_embedding_text_dave"]),
                          dim=args.dim, epochs=args.epochs,
                          device=resolve_device(args.device))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_bridger(model, args.out)
    print(f"saved bridger to {args.out}", flush=True)


if __name__ == "__main__":
    main()
