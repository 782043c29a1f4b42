"""The check of a training run.

Set-up drove the program's train state through its first steps and kept
their readings, and the window copied the state before its last step and
kept that step's readings. After the window the plain reference
(reference/train.py) runs the same first steps from the same weights,
batches and noise, and the window's last step from the copied state with
that step's batch and noise. Per leaf (reference/train.py's `leaves`:
each attention's c_attn bias split into its q, k and v thirds), a gap is
|the program's norm - the reference's| over the larger of the
reference's norm of that leaf and of the median leaf. Compared, each
against its limit in limits/<cell>.json:

  grad_norm_gap       the first step's gradient, the worst leaf
  change_worst_gap    each leaf's change over the first steps, the worst
                      leaf of those whose reference gradient is not
                      nought to rounding (at least a thousandth of the
                      median leaf's: a leaf with none, as a key's bias
                      under softmax, moves under AdamW by round-off
                      alone)
  window_grad_gap     the window's last step's gradient, the worst leaf
  window_change_gap   that step's change, the worst leaf, by the same
                      rule on that step's reference gradient

Reported and not compared: the median leaf's change gap and the loss's
relative gap (PERF.md gives their readings).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict

from benchmark import weights
from benchmark.reference import train as ref_train


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves
              ) -> Dict[str, float]:
    floor = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor) for n in leaves}


def compare(prog: Dict, ref: Dict) -> Dict:
    """The gaps between the program's readings of some steps and the
    reference's of the same steps."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                      ref["loss"]))
    leaves = sorted(ref["grad_norm"])
    med = statistics.median(ref["grad_norm"][n] for n in leaves)
    moving = [n for n in leaves if ref["grad_norm"][n] >= 1e-3 * med]
    grad = leaf_gaps(prog["grad_norm"], ref["grad_norm"], leaves)
    change = leaf_gaps(prog["change_norm"], ref["change_norm"], moving)
    worst = max(change, key=change.get)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "grad_worst_leaf": max(grad, key=grad.get),
            "change_worst_gap": change[worst], "change_worst_leaf": worst,
            "change_median_gap": statistics.median(change.values()),
            "leaves": len(leaves), "leaves_left_out": len(leaves) - len(moving),
            "left_out": sorted(set(leaves) - set(moving))[:6]}


def reference_readings(run, precision: str = "f32") -> Dict:
    """The reference's own first steps from the seed's weights."""
    from benchmark.drivers import train as driver
    sd = weights.state_dict(run.cfg, run.seed, run.device)
    return ref_train.run_steps(sd, run.cfg["model"], run.traffic,
                               [batch_tensors(run, k) for k in
                                range(run.traffic["check_steps"])],
                               driver.noise_base(run.seed), precision)


def window_reference(run, window_step: Dict, precision: str = "f32") -> Dict:
    """The reference's step from the state the window's last step began
    from."""
    from benchmark.drivers import train as driver
    k = window_step["k"]
    return ref_train.step_from(window_step["before"], run.cfg["model"],
                               run.traffic, batch_tensors(run, k),
                               driver.noise_base(run.seed), k, precision)


def batch_tensors(run, k: int) -> Dict:
    import torch
    from benchmark.drivers import train as driver
    b = driver.make_batch(run.seed, k, run.traffic, run.cfg)
    return {n: torch.as_tensor(v, device=run.device) for n, v in b.items()}


def numbers(first: Dict, window: Dict) -> Dict:
    """Every number of the check, compared or reported, from the two
    comparisons."""
    return {"grad_norm_gap": first["grad_gap"],
            "change_worst_gap": first["change_worst_gap"],
            "change_median_gap": first["change_median_gap"],
            "loss_gap": first["loss_gap"],
            "window_grad_gap": window["grad_gap"],
            "window_change_gap": window["change_worst_gap"],
            "window_change_median_gap": window["change_median_gap"],
            "window_loss_gap": window["loss_gap"]}


def check(run, result: Dict, limits: Dict) -> Dict:
    t0 = time.perf_counter()
    ws = result["window_step"]
    first = compare(result["readings"], reference_readings(run))
    window = compare(ws["readings"], window_reference(run, ws))
    got = numbers(first, window)
    checks = {n: {"value": got[n], "limit": limits[n]["limit"]}
              for n in limits if "limit" in limits[n]}
    info = {n: v for n, v in got.items() if n not in checks}
    info.update(window_step=ws["k"],
                change_worst_leaf=first["change_worst_leaf"],
                window_change_worst_leaf=window["change_worst_leaf"],
                window_grad_worst_leaf=window["grad_worst_leaf"],
                leaves=first["leaves"], left_out=first["left_out"],
                window_left_out=window["left_out"])
    return {"checks": checks, **info,
            "reference_s": time.perf_counter() - t0}
