"""Full-width stand-ins for the external artifacts of
scripts/torch_coco_recipe.sh and scripts/torch_zoo_parity.sh, so that the
recipes run end to end on the CUDA card without the Karpathy JSON, OpenAI
CLIP or GPT-2 files (their numbers then measure the chain, not caption
quality: the weights are random).

Writes under OUT_DIR, and prints `export` lines for the recipes'
environment:
  * chip_smoke.py's clip inputs (clip_inputs): a Karpathy JSON with 128
    test images as JPEG files of eight sizes, 128 val and 600 train
    captions, a synthetic CLIP BPE, and RN50x4 / ViT-B/32 OpenAI-layout
    fp16 checkpoints from the port's random init at seed 0;
  * gpt2/pytorch_model.bin: GPT-2 124M from the port's random init at seed
    0 in the HF key layout, and gpt2/vocab.json + merges.txt: a
    GPT-2-sized byte-level vocab (torch_make_zoo_dryrun_fixtures.py's
    byte_vocab);
  * what the reference's data preparation leaves beside the recipe's
    outputs: the Karpathy annotations, dataset_mode 0's records (one per
    test image) and the COCO preset's validation pickle (the val captions
    through RN50x4's text tower).

Usage: eval "$(python scripts/torch_recipe_standins.py OUT_DIR)"
       (then run the recipe with OUT_DIR as the working directory and the
       repository on PYTHONPATH)
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_dir: str) -> None:
    import torch

    import chip_smoke
    from torch_make_zoo_dryrun_fixtures import byte_vocab
    from capdec_tpu_torch.cli import embeddings_generator
    from capdec_tpu_torch.data.parsers import parse_karpathy_split
    from capdec_tpu_torch.models import gpt2
    from capdec_tpu_torch.utils import checkpoint as ckpt_lib

    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ins = chip_smoke.clip_inputs(out_dir, np.random.RandomState(2))
    gdir = os.path.join(out_dir, "gpt2")
    cfg = gpt2.GPT2Config()
    byte_vocab(gdir, cfg.vocab_size)
    model = gpt2.GPT2LMHeadModel(cfg)
    gpt2.init_params(model, cfg, torch.Generator().manual_seed(0))
    ckpt_lib.save_state_dict(gpt2.params_to_torch_state_dict(model),
                             os.path.join(gdir, "pytorch_model.bin"))
    ann = os.path.join(ins["root"], "coco", "annotations")
    splits = parse_karpathy_split(ins["karpathy"], ann)
    with open(os.path.join(ann, "single_caption_per_sample_val.json"),
              "w") as f:
        json.dump(splits["test"], f)
    env = dict(KARPATHY_JSON=ins["karpathy"], CLIP_CKPT=ins["ckpts"]["RN50x4"],
               GPT2_DIR=gdir, CAPDEC_DATA_ROOT=ins["root"],
               CAPDEC_CLIP_BPE_PATH=ins["bpe"],
               COCO_IMAGES=os.path.dirname(ins["images"]))
    os.environ.update(CAPDEC_CLIP_BPE_PATH=ins["bpe"])
    with open(os.devnull, "w") as devnull:
        stdout, sys.stdout = sys.stdout, devnull
        try:
            embeddings_generator.main([
                "--clip_checkpoint", ins["ckpts"]["RN50x4"],
                "--clip_model_type", "RN50x4",
                "--annotations", os.path.join(ann, "val.json"),
                "--out", os.path.join(
                    ins["root"], "coco",
                    "COCO_val_set_single_cap_per_sample_with_text.pkl")])
        finally:
            sys.stdout = stdout
    for k, v in env.items():
        print(f"export {k}={v}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "recipe_standins")
