"""The readings a cell's limits are set from, on the chip at the cell's
own size, many seeds in one process (the benchmark's runs do not do this).

    python3 benchmark/tools/readings.py --workload W --seeds A,B,... \
        --out OUT.jsonl [--seconds 4] [--fault-seeds 3]

For each seed it runs the cell's driver for a short window at the
cell's load and reads every number of the cell's check:

  serving   `program`: the served sample's numbers (serving.check);
            `control`: the reference put in the program's place, its
            own beam search in fp8 (the precision below the
            configuration's bf16) over the same requests, judged by the
            same check; and, on the first `--fault-seeds` seeds, the
            program with a fault planted: `fault_token` (one token of
            every caption altered where the server selects it),
            `fault_cache_unchanged` (the decode step's slot write leaves
            the cache as it was), `fault_greedy` (greedy decoding in the beam's place),
            `fault_worst_beam` (each image's lowest-ranked beam served)
  training  `program`: the check's numbers; `control`: the reference in
            fp8 in the program's place, for the first steps and for the
            window's last step (from the same state); faults:
            `fault_half_batch` (half of every batch left out, the mean
            taken over the rest, in every step) and, in the window's
            steps only, `fault_half_batch_window`,
            `fault_state_unchanged_window` (the optimizer step leaves
            the weights and moments as they were) and
            `fault_stale_batch_window` (each step trains on the batch
            before its own)
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _with(owner, attr, value, fn):
    orig = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        return fn()
    finally:
        setattr(owner, attr, orig)


# --------------------------------------------------------------------------
# Faults, each as (owner, attribute, replacement)
# --------------------------------------------------------------------------

def serve_faults(V: int):
    import torch
    import capdec_tpu_torch.serve as serve_lib
    from capdec_tpu_torch.decode import ToppConfig
    from capdec_tpu_torch.ops import cache_reorder
    select = serve_lib.beam_top_select

    def altered(tokens, seq_lengths, order):
        t, ln = select(tokens, seq_lengths, order)
        t = t.clone()
        t[:, 3] = (t[:, 3] + 1) % V
        return t, ln

    def worst(tokens, seq_lengths, order):
        return select(tokens, seq_lengths, order.flip(1))

    def greedy(model, cfg, prefix, bc):
        toks, lens = serve_lib.greedy_topp_search(
            model, cfg, prefix, ToppConfig(entry_length=bc.entry_length,
                                           stop_token=bc.stop_token,
                                           extra_stop_token=bc.stop_token))
        order = torch.zeros_like(lens)[:, None]
        return toks[:, None], lens[:, None], lens[:, None].float(), order

    return {"fault_token": (serve_lib, "beam_top_select", altered),
            "fault_cache_unchanged": (cache_reorder, "write_gen_slot_chunk",
                                      lambda *a, **k: None),
            "fault_greedy": (serve_lib, "beam_search", greedy),
            "fault_worst_beam": (serve_lib, "beam_top_select", worst)}


def train_faults(check_steps: int):
    """The faults of a training cell; `from_step` is the first step they
    touch (0: every step; check_steps: the window's alone)."""
    from capdec_tpu_torch.train import optim as optim_lib
    from capdec_tpu_torch.train import step as step_lib
    grads, apply = step_lib.loss_and_grads, optim_lib.apply_updates

    def half(from_step):
        def f(state, cfg, noise_cfg, batch, seed, draws=None, mesh=None):
            if state["step"] >= from_step:
                B = len(batch["tokens"]) // 2
                batch = {k: v[:B] for k, v in batch.items()}
            return grads(state, cfg, noise_cfg, batch, seed, draws, mesh)
        return f

    def stale(from_step):
        prev = {}

        def f(state, cfg, noise_cfg, batch, seed, draws=None, mesh=None):
            use = prev.get("batch", batch) if state["step"] >= from_step \
                else batch
            prev["batch"] = batch
            return grads(state, cfg, noise_cfg, use, seed, draws, mesh)
        return f

    def unchanged(from_step):
        def f(opt, sched, tp=None):
            if sched.last_epoch < from_step:
                return apply(opt, sched, tp)
            opt.zero_grad(set_to_none=True)
            sched.step()
        return f

    w = check_steps
    return {"fault_half_batch": (step_lib, "loss_and_grads", half(0)),
            "fault_half_batch_window": (step_lib, "loss_and_grads", half(w)),
            "fault_state_unchanged_window": (optim_lib, "apply_updates",
                                             unchanged(w)),
            "fault_stale_batch_window": (step_lib, "loss_and_grads",
                                         stale(w))}


# --------------------------------------------------------------------------
# Readings
# --------------------------------------------------------------------------

def _numbers(checked):
    return {n: c["value"] for n, c in checked["checks"].items()}


def serve_readings(run, drv, limits, faults: bool = True) -> dict:
    from benchmark import port, serving
    res = drv.run(run)
    checked = serving.check(run, res, limits)
    rec = {"program": _numbers(checked), "program_gaps": checked["score_gaps"],
           "sampled": checked["sampled"], "e2e": res["e2e"]}
    served = {r: port.IdTokenizer.parse(t) for r, t in res["served"].items()}
    rids = serving.sample_ids(run.seed, served, run.traffic["check_requests"])
    caps, _ = serving.reference_beams(run, rids, "fp8")
    ctrl = serving.check(run, {"served": {r: ",".join(map(str, c))
                                          for r, c in zip(rids, caps)},
                               "missing": 0}, limits)
    rec["control"] = _numbers(ctrl)
    rec["control_gaps"] = ctrl["score_gaps"]
    if faults:
        V = run.cfg["model"]["gpt2"]["vocab_size"]
        for name, (owner, attr, value) in serve_faults(V).items():
            res_f = _with(owner, attr, value, lambda: drv.run(run))
            checked = serving.check(run, res_f, limits)
            rec[name] = _numbers(checked)
            rec[name + "_gaps"] = checked["score_gaps"]
    return rec


def train_readings(run, drv, limits, faults: bool = True) -> dict:
    """The check's numbers (compared or reported) of the program, of the
    control and of the faults, each through the check a run makes."""
    import torch
    from benchmark.checks import train as check

    def numbers(checked):
        out = _numbers(checked)
        out.update({n: v for n, v in checked.items()
                    if n not in ("checks", "before")})
        return out

    res = drv.run(run)
    ws = res["window_step"]
    control = {"readings": check.reference_readings(run, "fp8"),
               "window_step": dict(ws, readings=check.window_reference(
                   run, ws, "fp8"))}
    rec = {"control": numbers(check.check(run, control, limits)),
           "program": numbers(check.check(run, res, limits)),
           "window_step": ws["k"], "e2e": res["e2e"]}
    del res, control, ws
    torch.cuda.empty_cache()
    if faults:
        for name, (owner, attr, value) in train_faults(
                run.traffic["check_steps"]).items():
            res_f = _with(owner, attr, value, lambda: drv.run(run))
            rec[name] = numbers(check.check(run, res_f, limits))
            del res_f
            torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", required=True)
    p.add_argument("--fault-seeds", type=int, default=3,
                   help="the faults are planted on the first this many seeds")
    p.add_argument("--precision", default=None,
                   help="run the program in this precision (f32: a witness "
                        "beside the configuration's)")
    args = p.parse_args(argv)
    import torch
    from benchmark import common, tracing
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_run", ROOT / "benchmark" / "run.py")
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)
    bench = common.benchmark()
    wl = common.by_name(bench["workloads"], args.workload, "workload")
    cfg = common.config_file(bench, wl["config"])
    if args.precision:
        cfg = dict(cfg, serve_precision=args.precision,
                   train_precision=args.precision)
    traffic = common.traffic_file(wl["traffic"])
    limits = common.limits_file(args.workload)
    drv = common.driver(traffic["driver"])
    dev = torch.device("cuda", 0)
    out = Path(ROOT / args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = run_mod.Run(args.workload, cfg, traffic, seed, args.seconds,
                          False, dev, tracing.Spans())
        t0 = time.perf_counter()
        if traffic["driver"] == "train":
            rec = train_readings(run, drv, limits, i < args.fault_seeds)
        else:
            rec = serve_readings(run, drv, limits, i < args.fault_seeds)
        rec.update(workload=args.workload, seed=seed,
                   wall_s=time.perf_counter() - t0)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
