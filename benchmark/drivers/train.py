"""Training: the program's train step (`train.step.make_train_step` over
`init_train_state`, as `train/loop.py` drives it) on batches made on the
host from the seed.

Batch k is `np.random.default_rng([seed, 1, k])`'s: caption lengths drawn
from `caption_tokens`, token ids from 1 .. vocab - 1 and 0 (padding)
after, the mask of `train/loop.py`'s datasets (prefix ones, then the
token mask), and a standard-normal CLIP embedding a row. Set-up builds
the one train state and drives it through the first `check_steps` steps
(they are the warm-up), keeping what the check compares: each step's
loss, the first gradient as the optimizer holds it after one step (AdamW's
first moment over 1 - beta1), and every parameter's change after the
last of them. The window then drives the same state on, batch after
batch, for `--seconds`; the step begun once that time has passed is its
last, and ends it with a synchronise: train_samples_per_s is every
sample stepped over the window's length. Before that last step the state
is copied on the device (weights and AdamW's moments), so that the check
can follow that step of the window too.

Mix parameters: batch_size, tokens, caption_tokens, noise_variance, lr,
warmup_steps, total_steps, check_steps, trace_after_s, trace_steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common, port, tracing, weights
from benchmark.checks import train as train_check
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

from capdec_tpu_torch.models import caption_model
from capdec_tpu_torch.train import optim as optim_lib
from capdec_tpu_torch.train import step as step_lib


def make_batch(seed: int, k: int, tr, cfg) -> dict:
    """Batch k of the run (numpy, as the program's data loader gives)."""
    m = cfg["model"]
    B, T = tr["batch_size"], tr["tokens"]
    K, V = m["mapper"]["prefix_length"], m["gpt2"]["vocab_size"]
    rng = np.random.default_rng([int(seed), 1, int(k)])
    lo, hi = tr["caption_tokens"]
    lens = rng.integers(lo, hi + 1, size=B)
    tokens = rng.integers(1, V, size=(B, T)).astype(np.int64)
    tok_mask = (np.arange(T)[None, :] < lens[:, None])
    tokens = np.where(tok_mask, tokens, 0)
    mask = np.concatenate([np.ones((B, K), np.float32),
                           tok_mask.astype(np.float32)], axis=1)
    prefix = rng.standard_normal((B, m["mapper"]["prefix_size"]),
                                 dtype=np.float32)
    return {"tokens": tokens, "mask": mask, "prefix": prefix}


def noise_base(seed: int) -> int:
    """The base seed the program's noise is drawn under (its per-step
    seed is base << 32 | step, which must fit 64 bits)."""
    return int(seed) & 0x7FFFFFFF


def build_state(run, sd):
    tr, cfg = run.traffic, run.cfg
    mcfg = port.model_config(cfg, cfg["train_precision"])
    model = port.load_model(sd, mcfg, run.device)
    opt, sched = optim_lib.make_optimizer(
        caption_model.set_trainable(model, mcfg), tr["lr"],
        tr["warmup_steps"], tr["total_steps"])
    state = step_lib.init_train_state(model, opt, sched)
    step_fn = step_lib.make_train_step(
        mcfg, step_lib.NoiseConfig(variance=tr["noise_variance"]))
    return state, step_fn


def trained(run, model):
    """The program's trained parameters by their reference-layout names."""
    keys = {k for k, _, _ in ref_model.layout(run.cfg["model"])}
    return [(n, p) for n, p in model.named_parameters()
            if p.requires_grad and n in keys]


def first_steps(run, state, step_fn):
    """Drive the state through the check's steps; return their readings
    (per leaf of reference/train.py's `leaves`: the first gradient's
    norm and the change's norm)."""
    model, opt = state["model"], state["optimizer"]
    named = trained(run, model)
    start = {n: p.detach().clone() for n, p in named}
    beta1 = opt.param_groups[0]["betas"][0]
    losses, grad_norms = [], None
    for k in range(run.traffic["check_steps"]):
        batch = make_batch(run.seed, k, run.traffic, run.cfg)
        state, loss = step_fn(state, batch, noise_base(run.seed))
        losses.append(float(loss))
        if k == 0:
            # a leaf the optimizer holds no moment for got no gradient
            grad_norms = ref_train.norms(
                (n, opt.state[p]["exp_avg"] / (1 - beta1)
                 if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p))
                for n, p in named)
    change = ref_train.norms((n, p.detach() - start[n]) for n, p in named)
    del start
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}


def snapshot(run, state):
    """The state a step starts from: {name: (weights, AdamW's first
    moment, its second moment)}, copies on the device."""
    opt = state["optimizer"]
    return {n: (p.detach().clone(), opt.state[p]["exp_avg"].clone(),
                opt.state[p]["exp_avg_sq"].clone())
            for n, p in trained(run, state["model"])}


def step_readings(run, state, before, loss):
    """The readings of the step taken from `before` to `state`: the
    gradient as AdamW's first moment took it in, (m - beta1 m_before) /
    (1 - beta1), and the change of each leaf."""
    opt = state["optimizer"]
    beta1 = opt.param_groups[0]["betas"][0]
    named = trained(run, state["model"])
    grad = ref_train.norms(
        (n, (opt.state[p]["exp_avg"] - beta1 * before[n][1]) / (1 - beta1))
        for n, p in named)
    change = ref_train.norms((n, p.detach() - before[n][0])
                             for n, p in named)
    return {"loss": [float(loss)], "grad_norm": grad, "change_norm": change}


def run(run):
    tr = run.traffic
    sd = weights.state_dict(run.cfg, run.seed, run.device)
    state, step_fn = build_state(run, sd)
    del sd
    readings = first_steps(run, state, step_fn)
    sync = (lambda: torch.cuda.synchronize(run.device)) \
        if run.device.type == "cuda" else (lambda: None)
    sync()
    traced = None
    if run.trace:
        run.spans.wrap(step_lib, "loss_and_grads", "forward_backward")
        run.spans.wrap(optim_lib, "apply_updates", "optimizer")
        traced = tracing.Slice(run.spans, run.device)
    seed = noise_base(run.seed)
    k = tr["check_steps"]
    trace_from = trace_to = None
    t_setup = time.perf_counter()
    t0 = time.perf_counter()
    while True:
        # the step begun once the window's time has passed is its last,
        # and the one the check follows: its state is copied first
        last = time.perf_counter() - t0 >= run.seconds
        if traced is not None:
            if trace_from is None and time.perf_counter() - t0 >= tr["trace_after_s"]:
                trace_from, trace_to = k, k + tr["trace_steps"]
                traced.start()
            elif k == trace_to:
                traced.stop()
        tb = time.time_ns()
        batch = make_batch(run.seed, k, tr, run.cfg)
        if traced is not None:
            run.spans.mark("batch_build", tb, time.time_ns())
            ts = time.time_ns()
        before = snapshot(run, state) if last else None
        state, loss = step_fn(state, batch, seed)
        if traced is not None:
            run.spans.mark("train_step", ts, time.time_ns())
        k += 1
        if last:
            break
    sync()
    t_end = time.perf_counter()
    if traced is not None:
        if traced.prof is not None and not traced.t1_ns:
            traced.stop()
        run.spans.restore()
    steps = k - tr["check_steps"]
    mem = common.device_info(run.device)
    window_step = {"k": k - 1, "before": before,
                   "readings": step_readings(run, state, before, loss)}
    del state
    return {
        "setup_end": t_setup,
        "e2e": {"train_samples_per_s": steps * tr["batch_size"] / (t_end - t0)},
        "attempted": steps,
        "missing": 0,
        "readings": readings,
        "window_step": window_step,
        "window_s": t_end - t0,
        "device": mem,
        "counters": {"steps_in_window": steps,
                     "traced_steps": (trace_to - trace_from)
                     if trace_from is not None else 0},
        "trace": traced.result() if traced is not None and traced.t1_ns
        else None,
        "check": train_check.check,
    }
