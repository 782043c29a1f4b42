"""Corpus-parsing CLI: raw corpora -> annotation JSONs (the port's own
copy of capdec_tpu/cli/parse_corpus.py).

Counterpart of the reference's three standalone parser scripts
(parse_karpathy.py; others/hp_to_coco_format.py;
others/parse_sheikspeare.py) behind one command:

  # Karpathy split -> {train,test,val}.json + *_metrics_format.json
  python -m capdec_tpu_torch.cli.parse_corpus karpathy \
      --karpathy_json dataset_coco.json --out_dir annotations/

  # open text (Harry-Potter style: Page-line strip, 4-20-word filter)
  python -m capdec_tpu_torch.cli.parse_corpus open_text \
      --text corpus.txt --out annotations/hp.json

  # line-per-sentence corpora (Shakespeare style)
  python -m capdec_tpu_torch.cli.parse_corpus lines \
      --text corpus.txt --out annotations/shakespeare.json

Output records are {"image_id", "caption", "id"} exactly as the
reference emits (parse_karpathy.py:23, hp_to_coco_format.py:30); the
open-text/line modes use synthetic image_id = line index.
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)

    k = sub.add_parser("karpathy", help="Karpathy-split COCO/Flickr JSON")
    k.add_argument("--karpathy_json", required=True)
    k.add_argument("--out_dir", required=True)

    o = sub.add_parser("open_text", help="free-text corpus -> sentences")
    o.add_argument("--text", required=True)
    o.add_argument("--out", required=True)
    o.add_argument("--min_words", type=int, default=4)
    o.add_argument("--max_words", type=int, default=20)
    o.add_argument("--keep_page_lines", action="store_true", default=False)

    l = sub.add_parser("lines", help="line-per-sentence corpus")
    l.add_argument("--text", required=True)
    l.add_argument("--out", required=True)
    l.add_argument("--strip_chars", type=int, default=1)
    l.add_argument("--drop_tail", type=int, default=2)
    return p


def main(argv=None):
    from ..data import parsers

    args = build_parser().parse_args(argv)
    if args.mode == "karpathy":
        splits = parsers.parse_karpathy_split(args.karpathy_json,
                                              args.out_dir, write=True)
        counts = {k: len(v) for k, v in splits.items()}
        print(json.dumps({"out_dir": args.out_dir, "captions": counts}))
        return
    with open(args.text) as f:
        text = f.read()
    if args.mode == "open_text":
        records = parsers.parse_open_text(
            text, min_words=args.min_words, max_words=args.max_words,
            strip_page_lines=not args.keep_page_lines)
    else:
        records = parsers.parse_line_corpus(
            text, strip_chars=args.strip_chars, drop_tail=args.drop_tail)
    parsers.write_annotations(records, args.out)
    print(json.dumps({"out": args.out, "captions": len(records)}))


if __name__ == "__main__":
    sys.exit(main())
