"""Run cells of the benchmark, each run its own process, one after
another, and keep every result line.

    python3 benchmark/tools/runs.py --out OUT.jsonl \
        WORKLOAD:SEED:SECONDS:TRACE [...]

Each run is `python3 benchmark/run.py ...` from the checkout's root; the
file gets one JSON object a run: the arguments, the exit code, the wall
time, the result line (or null), the processes that hold a card after
it (`nvidia-smi`; none should) and the end of standard error. A line
per run is printed too, with the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card(query: str = "name,power.limit") -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def apps() -> str:
    """The processes that hold a card (none should, once a run ended)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,process_name",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("runs", nargs="+")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print("card:", card(), flush=True)
    with open(out, "a") as f:
        for spec in args.runs:
            w, seed, secs, trace = spec.split(":")
            cmd = [sys.executable, "benchmark/run.py", "--workload", w,
                   "--seed", seed, "--seconds", secs, "--trace", trace]
            before = card(CLOCKS)
            t0 = time.perf_counter()
            try:
                r = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                   text=True, timeout=args.timeout)
                rc, so, se = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, so, se = 124, e.stdout or "", e.stderr or ""
                so = so if isinstance(so, str) else so.decode()
                se = se if isinstance(se, str) else se.decode()
            wall = time.perf_counter() - t0
            line = so.strip().splitlines()[-1] if so.strip() else ""
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = None
            rec = {"spec": spec, "rc": rc, "wall_s": wall, "result": res,
                   "card_before": before, "card_after": card(CLOCKS),
                   "apps_after": apps(), "stderr_tail": se[-3000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if res is None:
                print(f"{spec} rc {rc} wall {wall:.1f} NO RESULT\n{se[-2500:]}",
                      flush=True)
                continue
            m = {k: round(v["value"], 5) for k, v in res["metrics"].items()}
            c = {k: round(v["value"], 5) for k, v in res["checks"].items()}
            print(f"{spec} rc {rc} wall {wall:.1f} correct {res['correct']} "
                  f"att {res['attempted']} fail {res['failed']} {m} checks {c} "
                  f"mem {res['device'].get('memory_peak_bytes')} "
                  f"busy {res['device'].get('busy_s')} win "
                  f"{res['device'].get('window_s')} apps after "
                  f"{rec['apps_after'] or 'none'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
