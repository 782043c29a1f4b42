"""Optional pycocoevalcap parity adapter (the port's own copy of
capdec_tpu/eval/pycoco_adapter.py).

The in-repo metric chain (eval/metrics.py) re-implements the COCO caption
metrics from their algorithms; its oracles in tests/test_metrics.py are
nltk (BLEU/PTB/Porter) plus an independently re-derived CIDEr-D. This
module closes the remaining gap: in any environment where the REAL
pycocoevalcap package (reference README.md:74-78 points to it) is
importable, `compare_on_fixtures()` scores the same corpus through both
chains and reports the deltas — tests/test_metrics_pycoco_adapter.py
asserts <=1e-4 agreement for BLEU/ROUGE_L/CIDEr whenever the package is
present, and skips otherwise (it is not installed in the zero-egress
build container). The fixture JSONs ship in tests/fixtures/ so a
weights-bearing round runs this with zero setup.

METEOR/SPICE are excluded here by design: pycocoevalcap's METEOR jar
uses WordNet synonym + paraphrase stages the in-repo variant
intentionally omits (eval/metrics.py module docstring), and SPICE is a
Java pipeline. For those, eval/jar_metrics.py drives the official jars
directly over their own wire protocols when the user supplies them.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

COMPARED_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr")

_FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "fixtures")


def pycocoevalcap_available() -> bool:
    try:
        import pycocoevalcap  # noqa: F401
        return True
    except Exception:
        return False


def score_with_pycocoevalcap(predictions: List[dict],
                             gt_metrics_format: dict) -> Dict[str, float]:
    """Score through the real pycocoevalcap chain (PTBTokenizer + Bleu +
    Rouge + Cider), mirroring its COCOEvalCap driver without needing the
    pycocotools COCO object."""
    from pycocoevalcap.bleu.bleu import Bleu
    from pycocoevalcap.cider.cider import Cider
    from pycocoevalcap.rouge.rouge import Rouge
    from pycocoevalcap.tokenizer.ptbtokenizer import PTBTokenizer

    gts = {}
    for a in gt_metrics_format["annotations"]:
        gts.setdefault(int(a["image_id"]), []).append(
            {"caption": a["caption"]})
    res = {}
    for p in predictions:
        img = int(p["image_id"])
        if img in gts and img not in res:
            res[img] = [{"caption": p["caption"]}]
    gts = {k: v for k, v in gts.items() if k in res}

    tok = PTBTokenizer()
    gts_t = tok.tokenize(gts)
    res_t = tok.tokenize(res)

    out: Dict[str, float] = {}
    bleu_score, _ = Bleu(4).compute_score(gts_t, res_t)
    for i, s in enumerate(bleu_score):
        out[f"Bleu_{i + 1}"] = float(s)
    out["ROUGE_L"] = float(Rouge().compute_score(gts_t, res_t)[0])
    out["CIDEr"] = float(Cider().compute_score(gts_t, res_t)[0])
    out["num_images"] = float(len(res))
    return out


def load_fixtures() -> Tuple[List[dict], dict]:
    with open(os.path.join(_FIXTURE_DIR, "parity_predictions.json")) as f:
        predictions = json.load(f)
    with open(os.path.join(_FIXTURE_DIR,
                           "parity_gt_metrics_format.json")) as f:
        gt = json.load(f)
    return predictions, gt


def compare_on_fixtures() -> Dict[str, Dict[str, float]]:
    """Score the shipped fixture corpus through both chains.

    Returns {"ours": {...}, "pycoco": {...}, "delta": {metric: abs diff}}.
    Raises ImportError when pycocoevalcap is absent."""
    from .metrics import score_predictions

    predictions, gt = load_fixtures()
    ours = score_predictions(predictions, gt)
    theirs = score_with_pycocoevalcap(predictions, gt)
    delta = {k: abs(ours[k] - theirs[k]) for k in COMPARED_KEYS}
    return {"ours": ours, "pycoco": theirs, "delta": delta}


def main() -> int:  # pragma: no cover - exercised in weights-bearing envs
    """CLI: print the comparison, exit nonzero when any compared metric
    differs by more than 1e-4 (usable as a gate in scripts)."""
    report = compare_on_fixtures()
    print(json.dumps(report, indent=1))
    return int(any(d > 1e-4 for d in report["delta"].values()))


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
