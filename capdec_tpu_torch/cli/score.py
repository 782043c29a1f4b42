"""Metric-scoring CLI: predictions JSON + ground truth -> scores (the
port's own copy of capdec_tpu/cli/score.py).

The reference delegates this step to the EXTERNAL pycocoevalcap repo
(README.md:74-78: clone it, point it at the prediction JSON). Here the
whole chain is first-party:

  python -m capdec_tpu_torch.cli.score \
      --predictions preds.json --gt test_metrics_format.json

prints one JSON object with Bleu_1..4, METEOR (exact+stem variant),
ROUGE_L and CIDEr (CIDEr-D), from `eval/metrics.py` (PTB tokenizer +
Porter stemmer included, pycocoevalcap-algorithm parity oracle-tested).

--pycoco additionally routes the same corpus through the REAL
pycocoevalcap package when it is importable (eval/pycoco_adapter.py)
and reports both sets side by side — use in weights-bearing
environments to cross-check the in-repo chain.

Inputs: `--predictions` is the runner's output `[{"caption",
"image_id"}]` (predictions_runner.py:301); `--gt` is the parser's
`*_metrics_format.json` ({"images":[{"id"}],"annotations":[...]},
parse_karpathy.py:33-37).
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictions", required=True,
                   help="prediction JSON [{'caption','image_id'}]")
    p.add_argument("--gt", required=True,
                   help="reference *_metrics_format.json")
    p.add_argument("--out", default="",
                   help="also write the scores JSON here")
    p.add_argument("--pycoco", action="store_true", default=False,
                   help="cross-check through pycocoevalcap if installed")
    p.add_argument("--meteor_synonyms", default="",
                   help="synset file (one synset per line) enabling "
                        "METEOR's synonym matcher stage; the output's "
                        "METEOR_variant tag records whether it ran")
    p.add_argument("--meteor_paraphrases", default="",
                   help="paraphrase table (`phrase ||| phrase` per line, "
                        "Meteor-1.5 3-field lines accepted) enabling "
                        "METEOR's paraphrase matcher stage; recorded in "
                        "METEOR_variant")
    p.add_argument("--meteor_jar", default="",
                   help="path to the official meteor-1.5 jar: adds a "
                        "METEOR_jar score through its -stdio protocol "
                        "(the reference's documented chain, "
                        "README.md:74-78; needs java)")
    p.add_argument("--spice_jar", default="",
                   help="path to the official SPICE jar: adds SPICE + "
                        "SPICE_breakdown through its JSON protocol "
                        "(needs java)")
    return p


def main(argv=None):
    from ..eval import metrics

    args = build_parser().parse_args(argv)
    with open(args.predictions) as f:
        preds = json.load(f)
    with open(args.gt) as f:
        gt = json.load(f)
    synonyms = (metrics.load_synonyms(args.meteor_synonyms)
                if args.meteor_synonyms else None)
    paraphrases = (metrics.load_paraphrases(args.meteor_paraphrases)
                   if args.meteor_paraphrases else None)
    scores = metrics.score_predictions(preds, gt, meteor_synonyms=synonyms,
                                       meteor_paraphrases=paraphrases)
    result = {k: v if isinstance(v, str) else round(float(v), 6)
              for k, v in scores.items()}
    if args.meteor_jar:
        from ..eval import jar_metrics
        m = jar_metrics.meteor_jar_score(preds, gt, jar=args.meteor_jar)
        result["METEOR_jar"] = round(float(m["METEOR"]), 6)
    if args.spice_jar:
        from ..eval import jar_metrics
        s = jar_metrics.spice_jar_score(preds, gt, jar=args.spice_jar)
        result["SPICE"] = round(float(s["SPICE"]), 6)
        result["SPICE_breakdown"] = {k: round(float(v), 6)
                                     for k, v in s["SPICE_breakdown"].items()}
    if args.pycoco:
        from ..eval import pycoco_adapter
        if pycoco_adapter.pycocoevalcap_available():
            py = pycoco_adapter.score_with_pycocoevalcap(preds, gt)
            result["pycocoevalcap"] = {k: round(float(v), 6)
                                       for k, v in py.items()}
        else:
            result["pycocoevalcap"] = "not installed"
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
