#!/usr/bin/env bash
# End-to-end COCO text-only captioning recipe on the PyTorch port
# (counterpart of scripts/coco_recipe.sh; reference README.md:26-78
# workflow). It runs on the CUDA card; DEVICE=cpu runs it on the CPU.
# Requires the external artifacts:
#   $KARPATHY_JSON   Karpathy-split dataset_coco.json
#   $CLIP_CKPT       OpenAI CLIP RN50x4.pt
#   $GPT2_DIR        dir with GPT-2 vocab.json, merges.txt and a torch
#                    state_dict (pytorch_model.bin)
# and, as the reference's data preparation leaves them, the COCO preset's
# validation pickle ($CAPDEC_DATA_ROOT/coco/
# COCO_val_set_single_cap_per_sample_with_text.pkl) and dataset_mode 0's
# records (coco/annotations/single_caption_per_sample_val.json) with the
# images in coco/val2014.
set -euo pipefail
export CAPDEC_DATA_ROOT=${CAPDEC_DATA_ROOT:-./data}
export CAPDEC_GPT2_VOCAB_DIR=$GPT2_DIR
export CAPDEC_CLIP_BPE_PATH=${CAPDEC_CLIP_BPE_PATH:-bpe_simple_vocab_16e6.txt.gz}
DEVICE_FLAGS=${DEVICE:+--device $DEVICE}

# 1. Karpathy split -> annotation JSONs (+ metrics-format ground truth)
python - <<PY
from capdec_tpu_torch.data.parsers import parse_karpathy_split
parse_karpathy_split("$KARPATHY_JSON", "$CAPDEC_DATA_ROOT/coco/annotations")
PY

# 2. CLIP text embeddings for the train split (batched)
python -m capdec_tpu_torch.cli.embeddings_generator \
    --dataset_mode 0 --clip_model_type RN50x4 --clip_checkpoint "$CLIP_CKPT" \
    --annotations "$CAPDEC_DATA_ROOT/coco/annotations/train.json" \
    --out "$CAPDEC_DATA_ROOT/coco/oscar_split_RN50x4_train_with_text_embeddings.pkl" \
    $DEVICE_FLAGS

# 3. text-only training with noise injection (paper: sigma^2 = 0.016)
python -m capdec_tpu_torch.cli.train --data COCO --out_dir ckpt_coco \
    --noise_variance 0.016 --only_prefix --bf16 \
    --gpt2_weights "$GPT2_DIR/pytorch_model.bin" $DEVICE_FLAGS

# 4. caption the test split + score BLEU/ROUGE-L/CIDEr in-process
python -m capdec_tpu_torch.cli.predict \
    --checkpoint ckpt_coco/coco_prefix-009.pt --dataset_mode 0 \
    --clip_checkpoint "$CLIP_CKPT" \
    --score_gt "$CAPDEC_DATA_ROOT/coco/annotations/test_metrics_format.json" \
    $DEVICE_FLAGS
