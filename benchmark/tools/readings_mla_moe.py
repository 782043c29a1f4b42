"""The readings the limits of a cell of the MLA-MoE decoder are set from:
tools/readings.py's serving readings (the program, the fp8 control, and
the faults on the first `--fault-seeds` seeds) with this decoder's
faults in place of GPT-2's:

  fault_token             one token of every caption altered where the
                          server selects it
  fault_cache_unchanged   the decode step's latent slot write (K3) skipped
  fault_rope_dropped      K16's scores without the rope part (q_pe zero)
  fault_top5_routing      the router takes one expert fewer than
                          num_experts_per_tok
  fault_expert_shifted    inside the grouped products, each expert's rows
                          multiplied by the next expert's weights (as an
                          offset table off by one expert would)
  fault_expert_skipped    inside the grouped products, expert 0's rows
                          left with no output (its products skipped)
  fault_worst_beam        each image's lowest-ranked beam served

    python3 benchmark/tools/readings_mla_moe.py --workload W --seeds A,B \
        --out OUT.jsonl [--seconds 4] [--fault-seeds 3] [--faults A,B]

`--faults` plants only the faults it names (default: all of them).
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.tools import readings  # noqa: E402

_serve_faults = readings.serve_faults   # GPT-2's table, before ours


def faults(V: int):
    import torch
    from capdec_tpu_torch.ops import mla_attention, moe
    base = _serve_faults(V)
    attend, route = mla_attention.mla_decode_attention, moe.route
    products = moe.expert_products

    def no_rope(q_lat, q_pe, *a, **k):
        return attend(q_lat, torch.zeros_like(q_pe), *a, **k)

    def fewer(logits, bias, k, norm, scaling):
        return route(logits, bias, k - 1, norm, scaling)

    def shifted(x, w_gate_up, w_down, offs, kernels=True):
        return products(x, w_gate_up.roll(-1, 0), w_down.roll(-1, 0), offs,
                        kernels)

    def skipped(x, w_gate_up, w_down, offs, kernels=True):
        y = products(x, w_gate_up, w_down, offs, kernels)
        first = torch.arange(y.shape[0], device=y.device) < offs[0]
        return y.masked_fill(first[:, None], 0)

    # the wrappers count their launches on the module's name, which the
    # fault then holds
    no_rope.launches = fewer.launches = 0
    shifted.launches = skipped.launches = 0
    return {"fault_token": base["fault_token"],
            "fault_cache_unchanged": base["fault_cache_unchanged"],
            "fault_rope_dropped": (mla_attention, "mla_decode_attention",
                                   no_rope),
            "fault_top5_routing": (moe, "route", fewer),
            "fault_expert_shifted": (moe, "expert_products", shifted),
            "fault_expert_skipped": (moe, "expert_products", skipped),
            "fault_worst_beam": base["fault_worst_beam"]}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--faults", default=None)
    args, rest = p.parse_known_args(argv)
    chosen = args.faults.split(",") if args.faults else None

    def table(V: int):
        every = faults(V)
        unknown = set(chosen or ()) - set(every)
        if unknown:
            raise SystemExit(f"no such fault: {', '.join(sorted(unknown))}")
        return {n: f for n, f in every.items() if chosen is None or n in chosen}

    readings.serve_faults = table
    return readings.main(rest)


if __name__ == "__main__":
    sys.exit(main())
