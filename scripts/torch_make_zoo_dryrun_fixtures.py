"""Fabricate tiny synthetic artifacts for `torch_zoo_parity.sh --dry-run`
(the PyTorch port's counterpart of scripts/make_zoo_dryrun_fixtures.py).

A weights-bearing environment runs torch_zoo_parity.sh against the real zoo
(reference notebook cell 7 checkpoints, OpenAI RN50x4.pt, Karpathy JSON,
COCO images). Without those the script could silently rot, so this
generator writes shape-valid stand-ins for every required artifact, in the
same formats at tiny sizes, with the port's own writers, so that the FULL
command chain (Karpathy parse -> predict with --clip_checkpoint ->
in-process scoring -> gate) runs end to end on random weights:

  * `clip_tiny.pt`      OpenAI-layout CLIP state_dict (modified-ResNet
                        tower) in fp16, as OpenAI ships its weights
                        (models/clip.py save_openai_checkpoint); the CLI
                        infers its architecture from shapes, exactly like
                        `clip.load`.
  * `capdec_tiny.pt`    reference-layout caption checkpoint (`gpt.*` +
                        `clip_project.*`, utils/checkpoint.py
                        save_caption_checkpoint); predict loads it with
                        --infer_model_config.
  * `karpathy/dataset_coco.json`  Karpathy-split format (images[].sentences)
  * `images/val2014/COCO_val2014_*.jpg`  tiny real JPEGs
  * `gpt2_vocab/vocab.json|merges.txt`   byte-level BPE pair so the real
                        GPT2Tokenizer code path runs (decoded text is
                        garbage on random weights; the gates are disabled
                        in the dry run, only the chain is being validated).

Usage: python scripts/torch_make_zoo_dryrun_fixtures.py OUT_DIR
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_clip_checkpoint(path: str) -> None:
    import torch
    from capdec_tpu_torch.models import clip as clip_lib

    cfg = clip_lib.CLIPConfig(
        "tiny-rn-dryrun",
        clip_lib.CLIPTextConfig(vocab_size=512, context_length=77, width=64,
                                heads=1, layers=2, embed_dim=64),
        clip_lib.CLIPResNetConfig(layers=(1, 1, 1, 1), width=8,
                                  image_resolution=64, embed_dim=64))
    model = clip_lib.build_model(cfg, torch.Generator().manual_seed(0))
    clip_lib.save_openai_checkpoint(model, path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    # the loader must recover the exact architecture from shapes alone
    assert clip_lib.config_from_openai_state_dict(sd, cfg.name) == cfg


def tiny_caption_checkpoint(path: str) -> None:
    import torch
    from capdec_tpu_torch.models import caption_model, gpt2
    from capdec_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = caption_model.CaptionModelConfig(
        prefix_length=8, clip_length=8, prefix_size=64, num_layers=2,
        mapping_type="transformer",
        gpt2=gpt2.GPT2Config(vocab_size=1000, n_positions=128, n_embd=64,
                             n_layer=2, n_head=1))
    model = caption_model.init_params(cfg, torch.Generator().manual_seed(2))
    ckpt_lib.save_caption_checkpoint(model, cfg, path)
    sd = ckpt_lib.load_state_dict(path)
    # predict's --infer_model_config must recover this architecture
    inferred = caption_model.config_from_torch_state_dict(sd)
    assert inferred == cfg, f"inferred {inferred}\nexpected {cfg}"


def karpathy_and_images(out_dir: str, n_test: int = 4) -> None:
    from PIL import Image

    img_dir = os.path.join(out_dir, "images", "val2014")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    images = []
    sentid = 0
    for i in range(1, n_test + 3):  # extra train/val entries
        split = "test" if i <= n_test else ("train" if i == n_test + 1
                                            else "val")
        fname = f"COCO_val2014_{i:012d}.jpg"
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            os.path.join(img_dir, fname))
        sents = []
        for j in range(2):
            sents.append({"raw": f"a synthetic caption {i} variant {j}.",
                          "sentid": sentid})
            sentid += 1
        images.append({"filename": fname, "split": split,
                       "sentences": sents})
    os.makedirs(os.path.join(out_dir, "karpathy"), exist_ok=True)
    with open(os.path.join(out_dir, "karpathy", "dataset_coco.json"),
              "w") as f:
        json.dump({"images": images}, f)


def byte_vocab(out_dir: str, size: int = 257) -> None:
    """A degenerate-but-valid GPT-2 BPE pair of `size` ids and no merges:
    the 256 byte tokens, then two-byte tokens, and <|endoftext|> last;
    exercises the real tokenizer loader/decoder. At GPT-2's 50257 every
    id a full-width model emits decodes."""
    from capdec_tpu_torch.utils.tokenizer import _bytes_to_unicode

    os.makedirs(out_dir, exist_ok=True)
    chars = [_bytes_to_unicode()[b] for b in range(256)]
    vocab = {ch: b for b, ch in enumerate(chars)}
    for i in range(size - 257):
        vocab[chars[i // 256 % 256] + chars[i % 256]] = 256 + i
    vocab["<|endoftext|>"] = size - 1
    with open(os.path.join(out_dir, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


def main(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tiny_clip_checkpoint(os.path.join(out_dir, "clip_tiny.pt"))
    tiny_caption_checkpoint(os.path.join(out_dir, "capdec_tiny.pt"))
    karpathy_and_images(out_dir)
    byte_vocab(os.path.join(out_dir, "gpt2_vocab"))
    print(f"dry-run fixtures written to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "zoo_dryrun_fixtures")
