#!/usr/bin/env bash
# Zoo-parity one-shot on the PyTorch port (counterpart of
# scripts/zoo_parity.sh): decode a REFERENCE zoo checkpoint through
# capdec_tpu_torch on the COCO Karpathy test split and gate on the
# published CapDec numbers: a single command a weights-bearing environment
# runs unmodified; exits nonzero on regression. It runs on the CUDA card;
# DEVICE=cpu runs it on the CPU (the kernels' plain versions).
#
# Required environment:
#   $ZOO_CKPT        reference CapDec checkpoint .pt (noise 0.016 zoo entry,
#                    reference notebook cell 7 / README.md:80-82)
#   $KARPATHY_JSON   Karpathy-split dataset_coco.json
#   $COCO_IMAGES     COCO images root (containing val2014/)
#   $CLIP_CKPT       OpenAI CLIP RN50x4.pt
#   $GPT2_DIR        dir with GPT-2 vocab.json + merges.txt
# Optional:
#   $MIN_CIDER (default 0.88)  $MIN_B4 (default 0.25)   gates ~96% of
#   the paper's COCO-test CIDEr 91.8 / B@4 26.4 (BASELINE.md), leaving
#   headroom for decode-tie and preprocessing jitter.
#   $DEVICE          torch device for predict (default: the CUDA card)
set -euo pipefail

# --dry-run: fabricate tiny shape-valid stand-ins for every artifact and
# run the IDENTICAL command chain below on them (random weights, gates
# disabled), so that the script cannot rot where the real zoo artifacts
# don't exist. Exercised by tests/test_torch_recipes.py.
EXTRA_PREDICT_FLAGS=${EXTRA_PREDICT_FLAGS:-}
if [ "${1:-}" = "--dry-run" ]; then
    OUT=${OUT:-$(mktemp -d)/zoo_dryrun}
    FIX="$OUT/fixtures"
    python "$(dirname "$0")/torch_make_zoo_dryrun_fixtures.py" "$FIX"
    export ZOO_CKPT="$FIX/capdec_tiny.pt"
    export KARPATHY_JSON="$FIX/karpathy/dataset_coco.json"
    export COCO_IMAGES="$FIX/images"
    export CLIP_CKPT="$FIX/clip_tiny.pt"
    export GPT2_DIR="$FIX/gpt2_vocab"
    export CAPDEC_DATA_ROOT="$OUT/data"
    # gates off: random weights caption garbage; the chain is the test.
    MIN_CIDER=-1
    MIN_B4=-1
    # tiny checkpoint => infer the architecture from its shapes
    EXTRA_PREDICT_FLAGS="--infer_model_config --batch_size 4"
fi
DEVICE_FLAGS=${DEVICE:+--device $DEVICE}

export CAPDEC_DATA_ROOT=${CAPDEC_DATA_ROOT:-./data}
export CAPDEC_GPT2_VOCAB_DIR=$GPT2_DIR
MIN_CIDER=${MIN_CIDER:-0.88}
MIN_B4=${MIN_B4:-0.25}
OUT=${OUT:-zoo_parity_out}

# 1. Karpathy split -> annotations; build the mode-0 eval inputs: one
#    record per test image (decode once per image) + the metrics-format
#    ground truth with ALL references. Karpathy test images live in
#    val2014, which mode 0's registry expects at $CAPDEC_DATA_ROOT/coco.
mkdir -p "$CAPDEC_DATA_ROOT/coco"
[ -e "$CAPDEC_DATA_ROOT/coco/val2014" ] || \
    ln -s "$COCO_IMAGES/val2014" "$CAPDEC_DATA_ROOT/coco/val2014"
python - <<PY
import json
from capdec_tpu_torch.data.parsers import parse_karpathy_split
splits = parse_karpathy_split("$KARPATHY_JSON",
                              "$CAPDEC_DATA_ROOT/coco/annotations")
seen, single = set(), []
for rec in splits["test"]:
    if rec["image_id"] not in seen:
        seen.add(rec["image_id"])
        single.append(rec)
with open("$CAPDEC_DATA_ROOT/coco/annotations/"
          "single_caption_per_sample_val.json", "w") as f:
    json.dump(single, f)
print(f"{len(single)} test images to decode")
PY

# 2. decode the reference checkpoint on the test split + score in-process
#    (predict loads reference .pt state_dicts directly,
#    utils/checkpoint.load_caption_checkpoint)
python -m capdec_tpu_torch.cli.predict \
    --checkpoint "$ZOO_CKPT" --dataset_mode 0 \
    --clip_checkpoint "$CLIP_CKPT" \
    --out "$OUT/zoo_predictions.json" \
    --score_gt "$CAPDEC_DATA_ROOT/coco/annotations/test_metrics_format.json" \
    $EXTRA_PREDICT_FLAGS $DEVICE_FLAGS

# 3. gate against the published numbers
python - <<PY
import glob, json, sys
scores_path = sorted(glob.glob("$OUT/*_scores.json"))[-1]
s = json.load(open(scores_path))
cider, b4 = s["CIDEr"], s["Bleu_4"]
print(f"zoo parity: CIDEr={cider:.4f} (gate {$MIN_CIDER}) "
      f"B@4={b4:.4f} (gate {$MIN_B4})  [{scores_path}]")
ok = cider >= $MIN_CIDER and b4 >= $MIN_B4
print("PARITY OK" if ok else "PARITY REGRESSION")
sys.exit(0 if ok else 1)
PY
