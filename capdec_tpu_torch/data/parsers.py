"""Offline corpus parsers: raw datasets → annotation JSON (the port's own
copy of capdec_tpu/data/parsers.py).

Behavioral re-creations of the reference's data-prep layer (SURVEY.md C2/C3):
  * Karpathy-split COCO JSON → per-split flat caption lists, with
    `restval` folded into train (parse_karpathy.py:9-49), plus the
    pycocoevalcap ground-truth `_metrics_format.json` companion
  * Harry-Potter-style plain text → sentence records (hp_to_coco_format.py:
    strip "Page" lines, regex clean, split on '.', keep 4–20 word sentences)
  * line-per-sentence corpora (parse_sheikspeare.py)

Output record schema everywhere: {"image_id": int, "caption": str, "id": int}.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List


def image_id_from_filename(filename: str) -> int:
    """COCO_val2014_000000391895.jpg -> 391895 (parse_karpathy.py:10-11)."""
    return int(filename.split(".")[0].split("_")[-1])


def parse_karpathy_split(karpathy_json_path: str, out_dir: str,
                         write: bool = True) -> Dict[str, List[dict]]:
    """Karpathy split → {'train','test','val'} caption lists (+ files)."""
    with open(karpathy_json_path) as f:
        data = json.load(f)
    splits: Dict[str, List[dict]] = {"train": [], "test": [], "val": []}
    alias = {"train": "train", "restval": "train", "test": "test", "val": "val"}
    for img in data["images"]:
        image_id = image_id_from_filename(img["filename"])
        bucket = splits[alias[img["split"]]]
        for sent in img["sentences"]:
            bucket.append({"image_id": image_id, "caption": sent["raw"],
                           "id": int(sent["sentid"])})
    if write:
        os.makedirs(out_dir, exist_ok=True)
        for name, annos in splits.items():
            with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                json.dump(annos, f)
            metrics = {"images": [{"id": int(a["image_id"])} for a in annos],
                       "annotations": annos}
            with open(os.path.join(out_dir, f"{name}_metrics_format.json"), "w") as f:
                json.dump(metrics, f)
    return splits


def parse_open_text(text: str, min_words: int = 4, max_words: int = 20,
                    strip_page_lines: bool = True) -> List[dict]:
    """Open-corpus sentence extraction (hp_to_coco_format.py:7-36)."""
    lines = text.splitlines()
    if strip_page_lines:
        lines = [l for l in lines if not l.startswith("Page")]
    joined = " ".join(" " + l for l in lines)
    cleaned = re.sub('[^A-Za-z"" .]+', "", joined)
    sentences = [s for s in cleaned.split(".")
                 if max_words > len(s.split(" ")) > min_words]
    return [{"image_id": i, "caption": s, "id": i}
            for i, s in enumerate(sentences)]


def parse_line_corpus(text: str, strip_chars: int = 1,
                      drop_tail: int = 2) -> List[dict]:
    """Line-per-sentence corpora (parse_sheikspeare.py:6-23): strip the
    leading quote and trailing quote+newline, drop commas."""
    lines = text.splitlines(keepends=True)
    sents = [l[strip_chars:len(l) - drop_tail].replace(",", "") for l in lines]
    return [{"image_id": i, "caption": s, "id": i} for i, s in enumerate(sents)]


def write_annotations(records: List[dict], out_path: str) -> None:
    with open(out_path, "w") as f:
        json.dump(records, f)


# ---------------------------------------------------------------------------
# Gender-debias caption editing (reference embeddings_generator.py:18-45)
# ---------------------------------------------------------------------------

# first row masculine, second feminine; columns are matched forms.
GENDER_TERMS_MAP = [
    ['boy', 'brother', 'dad', 'husband', 'man', 'groom', 'male', 'guy',
     'men', 'males', 'boys', 'guys', 'dads', 'dude', 'policeman',
     'policemen', 'boyfriend', 'father', 'son', 'fireman', 'he', 'actor',
     'gentleman', 'mans', 'his', 'actors'],
    ['girl', 'sister', 'mom', 'wife', 'woman', 'bride', 'female', 'lady',
     'women', 'girls', 'ladies', 'females', 'moms', 'actress', 'nun',
     'policewoman', 'girlfriend', 'mother', 'daughter', 'fire woman',
     'she', 'actress', 'lady', 'women', 'her', 'actresses'],
]
GENDER_TERMS = GENDER_TERMS_MAP[0] + GENDER_TERMS_MAP[1]
_ALL = set(GENDER_TERMS)
_MEN = set(GENDER_TERMS_MAP[0])
_WOMEN = set(GENDER_TERMS_MAP[1])


def caption_has_gender_term(caption: str, gender_mode: int = 0) -> bool:
    """gender_mode: 0 both, 1 masculine only, 2 feminine only."""
    words = set(caption.lower().split(" "))
    target = (_ALL, _MEN, _WOMEN)[gender_mode]
    return len(words & target) > 0


def change_gender_randomly(caption: str, rng) -> str:
    """Flip each gendered word to a uniformly random gender, preserving the
    form column (embeddings_generator.py:36-45)."""
    words = caption.lower().split(" ")
    for i, w in enumerate(words):
        if w in _ALL:
            form = GENDER_TERMS.index(w) % len(GENDER_TERMS_MAP[0])
            words[i] = GENDER_TERMS_MAP[int(rng.integers(0, 2))][form]
    return " ".join(words)
