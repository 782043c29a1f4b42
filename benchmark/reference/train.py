"""The plain reference of the training step: CapDec's train.py step
(noise -> mapper -> GPT-2 -> masked cross-entropy -> backward -> AdamW
under the linear warmup) in float32 with TF32 off, on the state dict and
the batches the benchmark makes.

The noise is drawn as the configuration states it: the L2-normalised
embedding plus a standard normal times sqrt(variance), normalised again,
the normal drawn by `torch.randn` from a generator of the device seeded
(base << 32) + step, the rule by which the program draws it too; so both
sides get the same draws from the seed.

`run_steps` takes the first steps from the seed's weights; `step_from`
takes one step from a state the program reached in its window (its
weights and AdamW moments), so that a step of the window is checked too.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from . import model as ref_model


def warmup_lambda(warmup_steps: int, total_steps: int) -> Callable:
    """HF get_linear_schedule_with_warmup's multiplier of the lr."""
    def f(step: int) -> float:
        if step < warmup_steps:
            frac = step / max(1.0, warmup_steps)
        else:
            frac = (total_steps - step) / max(1.0, total_steps - warmup_steps)
        return min(max(frac, 0.0), 1.0)
    return f


def loss(params: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
         prefix: torch.Tensor, p: ref_model.Precision) -> torch.Tensor:
    """Masked-mean next-token cross-entropy of the captions given the
    (noised) prefix embeddings."""
    K = cfg["mapper"]["prefix_length"]
    tokens, mask = batch["tokens"], batch["mask"]
    pre = ref_model.map_prefix(params, cfg, prefix, p)
    tok = params["gpt.transformer.wte.weight"][tokens]
    h = ref_model.gpt2_hidden(params, cfg, torch.cat([pre, tok], 1), mask, p)
    logits = ref_model.logits(params, h[:, K - 1:-1], p)
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, tokens[..., None])[..., 0]
    valid = (tokens != 0).float()
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def noised(prefix: torch.Tensor, variance: float, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=prefix.device)
    gen.manual_seed(seed)
    x = ref_model.l2_normalize(prefix)
    normal = torch.randn(x.shape, generator=gen, device=x.device,
                         dtype=x.dtype)
    return ref_model.l2_normalize(x + normal * math.sqrt(variance))


def leaves(named: Iterable[Tuple[str, torch.Tensor]]
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The leaves the check compares: every tensor by its name, but each
    attention's c_attn bias as its three thirds (`[q]`, `[k]`, `[v]`),
    since a key's bias has a gradient of nought under softmax while the
    query's and value's have not."""
    for n, t in named:
        if n.endswith("attn.c_attn.bias"):
            yield from ((f"{n}[{part}]", third)
                        for part, third in zip("qkv", t.chunk(3)))
        else:
            yield n, t


def norms(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, float]:
    return {n: float(t.norm()) for n, t in leaves(named)}


def _optimizer(params: Dict[str, torch.Tensor], lr: float
               ) -> torch.optim.AdamW:
    return torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.999),
                             eps=1e-6, weight_decay=0.0)


def run_steps(sd: Dict[str, torch.Tensor], cfg: Dict, traffic: Dict,
              batches: List[Dict], noise_base: int,
              precision: str = "f32") -> Dict:
    """The reference's own first steps from `sd` over `batches`: each
    step's loss, every leaf's first gradient norm and its change after
    the last step."""
    ref_model.disable_tf32()
    p = ref_model.Precision(precision)
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = _optimizer(params, traffic["lr"])
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, warmup_lambda(traffic["warmup_steps"], traffic["total_steps"]))
    losses: List[float] = []
    grad_norms: Optional[Dict[str, float]] = None
    for k, batch in enumerate(batches):
        prefix = noised(batch["prefix"], traffic["noise_variance"],
                        (noise_base << 32) + k)
        value = loss(params, cfg, batch, prefix, p)
        value.backward()
        losses.append(float(value.detach()))
        if k == 0:
            grad_norms = norms((n, t.grad) for n, t in params.items())
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
    change = norms((n, t.detach() - start[n]) for n, t in params.items())
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}


def step_from(state: Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]],
              cfg: Dict, traffic: Dict, batch: Dict, noise_base: int,
              k: int, precision: str = "f32") -> Dict:
    """Step k (k updates already taken) from a given state {name:
    (weights, AdamW's first moment, its second moment)}: its loss,
    every leaf's gradient norm and the norm of its change."""
    ref_model.disable_tf32()
    p = ref_model.Precision(precision)
    params = {n: w.clone().requires_grad_(True) for n, (w, _, _) in
              state.items()}
    lr = traffic["lr"] * warmup_lambda(traffic["warmup_steps"],
                                       traffic["total_steps"])(k)
    opt = _optimizer(params, lr)
    for n, t in params.items():
        _, m, v = state[n]
        opt.state[t] = {"step": torch.tensor(float(k)),
                        "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
    prefix = noised(batch["prefix"], traffic["noise_variance"],
                    (noise_base << 32) + k)
    value = loss(params, cfg, batch, prefix, p)
    value.backward()
    grad_norms = norms((n, t.grad) for n, t in params.items())
    opt.step()
    change = norms((n, t.detach() - state[n][0]) for n, t in params.items())
    return {"loss": [float(value.detach())], "grad_norm": grad_norms,
            "change_norm": change}
