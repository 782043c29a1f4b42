"""Data-parallel training: drivers/train.py's run on `dp` cards at once.

Rank 0 runs in run.py's process on card 0; ranks 1 .. dp - 1 are child
processes (`python3 -m benchmark.drivers.train_dp`), each on its own card,
started first so that their imports overlap rank 0's set-up. The ranks
join one NCCL world (gloo on the CPU) through the program's
`parallel/mesh.init_distributed` at `tcp://127.0.0.1:<free port>`, and
the program's dp x 1 mesh over it. Every rank is given the global batch
(batch_size x dp rows: drivers/train.py's batch k of the seed) and keeps
its own dp rows, the program's dp rule (train/step.py), so the ranks run
drivers/train.py's `train` in lockstep: the same first steps, the same
window and the same last step. Which step is the window's last, rank 0
alone decides, by its clock: at each step's start it sends the others
that word over a gloo group beside the world.

Rank 0 times the window: the rate (`samples_per_s`) is the global batch of
every step in it over its length; train_peak_memory_gb is the program's
peak on the fullest card. A traced run profiles rank 0's card alone,
so the per-layer metrics read rank 0's slice. Once the window has closed
each rank compares its weights with rank 0's leaf by leaf (reference/
train.py's leaves): `ranks_apart` is the number of leaves on which any
rank's differ. The ranks' peaks are gathered (the result's is the
fullest card's), the world is ended and the children are waited for.
The check (checks/train.py) then follows rank 0's first steps and its
window's last step with the float32 reference on the global batch on one
card, and adds `ranks_apart`.

No child outlives the run: on a return rank 0 waits for each; on an
exception it kills them; a child asks the kernel to kill it when rank 0
dies; and a watchdog of rank 0 ends the run when a child fails first
(rank 0 would wait for it in a collective).

Mix parameters: those of drivers/train.py, batch_size being a rank's,
and dp, the number of ranks (and cards).
"""
from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import torch
import torch.distributed as dist

from benchmark import common, tracing
from benchmark.checks import train as train_check
from benchmark.drivers import train as train_lib
from benchmark.reference import train as ref_train

from capdec_tpu_torch.parallel import mesh as mesh_lib

# The module a child runs (`python3 -m`); the readings and the tests
# start children through another that plants a fault first.
CHILD_MODULE = "benchmark.drivers.train_dp"
# A collective that waits longer than this raises instead of hanging.
COLLECTIVE_TIMEOUT_S = 300.0
# How long rank 0 waits for a child to end once the world has ended.
CHILD_EXIT_S = 60.0


def global_traffic(traffic):
    return dict(traffic, batch_size=traffic["batch_size"] * traffic["dp"])


def global_run(run, device=None):
    """The run with the mix's global batch (what every rank steps on, and
    what the check and the reference take), on `device` if given."""
    g = copy.copy(run)
    g.traffic = global_traffic(run.traffic)
    g.device = device or run.device
    return g


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent(parent: int) -> None:
    """In a child: be killed when the parent dies, or end now if it has
    died already (before the request was made)."""
    import ctypes
    import signal
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)     # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(3)


def ranks_apart(run, state) -> int:
    """The leaves on which any rank's trained weights differ from rank
    0's (bit for bit); collective."""
    named = train_lib.trained(run, state["model"])
    leaves = list(ref_train.leaves((n, p.detach()) for n, p in named))
    apart = torch.zeros(len(leaves), dtype=torch.int32, device=run.device)
    for i, (_, t) in enumerate(leaves):
        mine = t.contiguous()
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        apart[i] = int(not torch.equal(mine, theirs))
    dist.all_reduce(apart)
    return int((apart > 0).sum())


def rank_run(run, rank: int, world: int, init_method: str):
    """One rank's run: join the world, train in lockstep, compare the
    weights, gather the peaks and end the world. `run` holds the mix's
    per-rank traffic; rank r takes card r."""
    device = torch.device("cuda", rank) if run.device.type == "cuda" \
        else run.device
    t0 = time.perf_counter()
    mesh_lib.init_distributed(device, init_method=init_method, rank=rank,
                              world_size=world,
                              timeout_s=COLLECTIVE_TIMEOUT_S)
    mesh = mesh_lib.make_mesh(dp=world, tp=1, device=device)
    words = dist.new_group(backend="gloo")
    joined = time.perf_counter()
    g = global_run(run, device)

    def stop(elapsed):
        word = torch.tensor([int(rank == 0 and elapsed >= run.seconds)],
                            dtype=torch.int32)
        dist.broadcast(word, 0, group=words)
        return bool(word.item())

    res = train_lib.train(g, mesh, stop,
                          lambda state: {"ranks_apart": ranks_apart(g, state)})
    peaks = [None] * world
    dist.all_gather_object(peaks, (res["device"]["memory_peak_bytes"],
                                   res["e2e"]["train_peak_memory_gb"]),
                           group=words)
    res["device"] = dict(res["device"], count=world,
                         memory_peak_bytes=max(p[0] for p in peaks))
    res["e2e"] = dict(res["e2e"],
                      train_peak_memory_gb=max(p[1] for p in peaks))
    # set-up's parts on this rank: joining the world (the children's
    # imports), then the weights, the state and the first steps
    res["counters"].update(join_s=joined - t0,
                           state_s=res["setup_end"] - joined)
    dist.destroy_process_group()
    return res


class _Watchdog(threading.Thread):
    """Ends the run when a child fails while the ranks still work."""

    def __init__(self, procs):
        super().__init__(daemon=True)
        self.procs = procs
        self.done = threading.Event()

    def run(self):
        while not self.done.wait(0.5):
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    print(f"rank {r} ended with code {p.returncode}: the "
                          f"run ends", file=sys.stderr, flush=True)
                    _kill(self.procs)
                    os._exit(3)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _spawn(run, world: int, init_method: str):
    procs = []
    for rank in range(1, world):
        spec = {"workload": run.workload, "cfg": run.cfg,
                "traffic": run.traffic, "seed": run.seed,
                "seconds": run.seconds, "device": run.device.type,
                "rank": rank, "world": world, "init": init_method,
                "parent": os.getpid()}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", CHILD_MODULE, json.dumps(spec)],
            cwd=common.ROOT, stdout=subprocess.DEVNULL))
    return procs


def run(run):
    world = run.traffic["dp"]
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = _spawn(run, world, init_method)
    watchdog = _Watchdog(procs)
    watchdog.start()
    try:
        res = rank_run(run, 0, world, init_method)
        watchdog.done.set()
        for p in procs:
            p.wait(timeout=CHILD_EXIT_S)
    except BaseException:
        watchdog.done.set()      # before it could take a kill for a failure
        _kill(procs)
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"ranks ended with codes {bad}")
    res["check"] = check
    return res


def check(run, result, limits):
    """checks/train.py's check of rank 0 on the global batch, and
    `ranks_apart`."""
    out = train_check.check(global_run(run), result,
                            {n: v for n, v in limits.items()
                             if n != "ranks_apart"})
    out["checks"]["ranks_apart"] = {"value": float(result["ranks_apart"]),
                                    "limit": limits["ranks_apart"]["limit"]}
    return out


def main(argv=None) -> int:
    """A child: rank `rank` of the world, on its own card."""
    spec = json.loads((argv or sys.argv[1:])[0])
    _die_with_parent(spec["parent"])
    torch.set_num_threads(1)
    run = types.SimpleNamespace(
        workload=spec["workload"], cfg=spec["cfg"], traffic=spec["traffic"],
        seed=spec["seed"], seconds=spec["seconds"], trace=False,
        device=torch.device(spec["device"]), spans=tracing.Spans())
    rank_run(run, spec["rank"], spec["world"], spec["init"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
