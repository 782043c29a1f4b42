"""Official METEOR / SPICE jar adapters (the reference's documented chain;
the port's own copy of capdec_tpu/eval/jar_metrics.py).

The reference scores predictions through the external pycocoevalcap repo
(reference README.md:74-78), whose METEOR is the meteor-1.5 jar (WordNet
synonymy + paraphrase stages) and whose SPICE is a Java scene-graph
pipeline. Neither matcher is faithfully reproducible in pure Python, so
the in-repo chain (eval/metrics.py) ships an exact+stem METEOR variant
and no SPICE — both documented. This module closes the remaining gap in
any environment where the user supplies the jars: it speaks the jars'
OWN wire protocols, so the numbers are the official ones, not a
re-implementation.

Protocols (public, from the jars' documented CLI contracts):

* meteor-1.5: `java -jar meteor-*.jar - - -stdio -l en -norm`; one
  `SCORE ||| ref1 ||| ref2 ... ||| candidate` line per segment returns a
  stats line, then a single `EVAL ||| stats ||| stats ...` line returns
  one score line per segment followed by the aggregate score line.
* spice: `java -jar spice-*.jar input.json -cache DIR -out OUT -subset
  -silent` where input.json is `[{"image_id", "test", "refs": [...]}]`
  and OUT is `[{"image_id", "scores": {"All": {"f": ...}, ...}}]`.

Both adapters take an explicit `cmd` override so the full protocol is
testable without a JVM (tests/test_jar_metrics.py drives them against
Python stand-ins that implement the same wire contracts;
tests/test_torch_scoring.py runs its cases on this copy).
"""
from __future__ import annotations

import json
import os
import queue
import subprocess
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


def _corpus(predictions: List[dict], gt_metrics_format: dict
            ) -> Tuple[List[int], Dict[int, str], Dict[int, List[str]]]:
    """Shared candidate/reference extraction (same selection rules as
    eval.metrics.score_predictions: first prediction per image, images
    present in both)."""
    refs: Dict[int, List[str]] = defaultdict(list)
    for a in gt_metrics_format["annotations"]:
        refs[int(a["image_id"])].append(a["caption"])
    cands: Dict[int, str] = {}
    for p in predictions:
        img = int(p["image_id"])
        if img in refs and img not in cands:
            cands[img] = p["caption"]
    ids = sorted(cands)
    return ids, cands, {i: refs[i] for i in ids}


def _clean(text: str) -> str:
    """The stdio protocol's field separator is ' ||| ' and its record
    separator is newline; both must never appear inside a segment."""
    return text.replace("|||", " ").replace("\n", " ").replace("\r", " ")


def meteor_jar_score(predictions: List[dict], gt_metrics_format: dict,
                     jar: Optional[str] = None,
                     cmd: Optional[Sequence[str]] = None,
                     java: str = "java", mem: str = "2G",
                     timeout: float = 1800.0) -> Dict[str, object]:
    """Score through the official meteor-1.5 jar's -stdio protocol.

    Pass `jar` (path to meteor-*.jar; needs the data/paraphrase-en.gz
    next to it, as shipped) or a full `cmd` override. Returns
    {"METEOR": aggregate, "per_image": {id: score},
     "METEOR_variant": "meteor-1.5-jar"}.
    """
    if cmd is None:
        if jar is None:
            raise ValueError("meteor_jar_score needs `jar` or `cmd`")
        cmd = [java, "-Xmx" + mem, "-jar", os.path.abspath(jar),
               "-", "-", "-stdio", "-l", "en", "-norm"]
    ids, cands, refs = _corpus(predictions, gt_metrics_format)
    if not ids:
        return {"METEOR": 0.0, "per_image": {},
                "METEOR_variant": "meteor-1.5-jar"}

    proc = subprocess.Popen(
        list(cmd), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, bufsize=1,
        cwd=os.path.dirname(os.path.abspath(jar)) if jar else None)
    # A wedged jar must not hang the scorer: stdout is drained by a
    # daemon thread and every readline goes through a shared deadline
    # (`timeout` bounds the WHOLE exchange, matching its docstring).
    lines: "queue.Queue[Optional[str]]" = queue.Queue()
    t = threading.Thread(
        target=lambda: ([lines.put(ln) for ln in proc.stdout],
                        lines.put(None)),
        daemon=True)
    t.start()
    deadline = time.monotonic() + timeout

    def readline() -> str:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            proc.kill()
            raise TimeoutError(
                f"METEOR jar produced no output within timeout={timeout}s")
        if line is None:  # EOF: jar crashed mid-protocol
            raise ValueError("METEOR jar closed stdout mid-protocol")
        return line.strip()

    try:
        stats: List[str] = []
        for i in ids:
            # SCORE lines are small and the protocol is lockstep (a reply
            # is read before the next write), so these writes cannot
            # outrun the pipe buffer; no deadline needed here.
            fields = [_clean(r) for r in refs[i]] + [_clean(cands[i])]
            proc.stdin.write("SCORE ||| " + " ||| ".join(fields) + "\n")
            proc.stdin.flush()
            stats.append(readline())
        # The one EVAL line carries every stats vector (~100 B/image) and
        # easily exceeds the ~64 KB pipe buffer, so a wedged jar that
        # stops draining stdin would block this write forever — push it
        # through a daemon thread bounded by the shared deadline.
        eval_line = "EVAL ||| " + " ||| ".join(stats) + "\n"
        wt = threading.Thread(
            target=lambda: (proc.stdin.write(eval_line),
                            proc.stdin.flush()),
            daemon=True)
        wt.start()
        wt.join(timeout=max(0.0, deadline - time.monotonic()))
        if wt.is_alive():
            proc.kill()
            raise TimeoutError(
                f"METEOR jar stopped reading stdin (EVAL write blocked "
                f"past timeout={timeout}s)")
        per_image = {i: float(readline()) for i in ids}
        aggregate = float(readline())
    finally:
        try:
            proc.stdin.close()
        except OSError:  # pragma: no cover - already-dead pipe
            pass
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
    return {"METEOR": aggregate, "per_image": per_image,
            "METEOR_variant": "meteor-1.5-jar"}


def spice_jar_score(predictions: List[dict], gt_metrics_format: dict,
                    jar: Optional[str] = None,
                    cmd: Optional[Sequence[str]] = None,
                    java: str = "java", mem: str = "8G",
                    cache_dir: Optional[str] = None,
                    timeout: float = 3600.0) -> Dict[str, object]:
    """Score through the official SPICE jar (scene-graph tuple F1).

    Pass `jar` (path to spice-*.jar with its lib/ directory alongside,
    as shipped) or a full `cmd` override — the override receives the
    input path appended plus the same `-cache/-out/-subset/-silent`
    flags, so a stand-in sees the exact production argv shape. Returns
    {"SPICE": mean All-F, "per_image": {id: f},
     "SPICE_breakdown": {category: mean f}}.
    """
    ids, cands, refs = _corpus(predictions, gt_metrics_format)
    if not ids:
        return {"SPICE": 0.0, "per_image": {}, "SPICE_breakdown": {}}

    with tempfile.TemporaryDirectory(prefix="spice_") as tmp:
        in_path = os.path.join(tmp, "spice_input.json")
        out_path = os.path.join(tmp, "spice_output.json")
        cache = cache_dir or os.path.join(tmp, "cache")
        os.makedirs(cache, exist_ok=True)
        with open(in_path, "w") as f:
            json.dump([{"image_id": i, "test": cands[i], "refs": refs[i]}
                       for i in ids], f)
        if cmd is None:
            if jar is None:
                raise ValueError("spice_jar_score needs `jar` or `cmd`")
            base = [java, "-Xmx" + mem, "-jar", os.path.abspath(jar)]
        else:
            base = list(cmd)
        subprocess.run(
            base + [in_path, "-cache", cache, "-out", out_path,
                    "-subset", "-silent"],
            check=True, timeout=timeout, stdout=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.abspath(jar)) if jar else None)
        with open(out_path) as f:
            results = json.load(f)

    per_image: Dict[int, float] = {}
    sums: Dict[str, List[float]] = defaultdict(list)
    for item in results:
        scores = item["scores"]
        per_image[int(item["image_id"])] = float(scores["All"]["f"])
        for cat, vals in scores.items():
            f_val = float(vals["f"])
            if f_val == f_val:  # SPICE emits NaN for empty categories
                sums[cat].append(f_val)
    breakdown = {cat: sum(v) / len(v) for cat, v in sums.items() if v}
    return {"SPICE": breakdown.get("All", 0.0), "per_image": per_image,
            "SPICE_breakdown": breakdown}
