"""Embedding-extraction CLI (port of capdec_tpu/cli/embeddings_generator.py):
the reference `embeddings_generator.py` surface (:112-115) on the port's
batched pipeline, plus `--device`.

    python -m capdec_tpu_torch.cli.embeddings_generator \\
        --clip_checkpoint RN50x4.pt --annotations train.json \\
        --out train.pkl [--add_text_embedding 0 --images_path imgs/] \\
        [--device cpu]

Dataset-mode table (reference :118-183): 0 COCO-train, 0.5 COCO-val,
1/1.5 Flickr30k train/val, 2 humor, 3 romantic, 4 factual, 6 HarryPotter,
7 news, 8 COCO-snowboarding, 9 Shakespeare; modes 6/7/8/9 are text-only
corpora (`NoImgs`). Paths root at CAPDEC_DATA_ROOT.

Requires an OpenAI CLIP checkpoint (`--clip_checkpoint`) and, for text,
the CLIP BPE vocab (CAPDEC_CLIP_BPE_PATH). Runs on the card unless
`--device` names another.
"""
from __future__ import annotations

import argparse
import os
import sys


def mode_table(root: str, clip_model_name: str, add_text: bool,
               gender_mode: int):
    """mode -> (out_path, annotations_path, images_path)."""
    c = clip_model_name
    return {
        0.0: (f"./data/coco/verified_split_COCO_train_set"
              + ("_with_text_not_norm.pkl" if add_text else ".pkl"),
              f"{root}/coco/annotations/train.json", f"{root}/coco/train2014/"),
        0.5: (f"./data/coco/COCO_val_set_single_cap_per_sample"
              + ("_with_text_not_norm.pkl" if add_text else ".pkl"),
              f"{root}/coco/annotations/single_caption_per_sample_val.json",
              f"{root}/coco/val2014/"),
        1.0: (f"./data/flicker30_{c}_train"
              + ("_with_text_embeddings_not_norm.pkl" if add_text else ".pkl"),
              f"{root}/flicker30/dataset_flickr30k_correct_format.jsontrain",
              f"{root}/flicker30/flickr30k_images/"),
        1.5: (f"./data/flicker30_{c}_validation"
              + ("_with_text_embeddings.pkl" if add_text else ".pkl"),
              f"{root}/flicker30/dataset_flickr30k_correct_format.jsonvalidation",
              f"{root}/flicker30/flickr30k_images/"),
        2.0: (f"./data/styleHumor_{c}_train"
              + ("_with_text_embeddings_not_norm.pkl" if add_text else ".pkl"),
              f"{root}/flicker8kforStyle/postprocessed_style_data/humor_train.json",
              f"{root}/flicker8kforStyle/Images/"),
        3.0: (f"./data/styleRoman_{c}_train"
              + ("_with_text_embeddings_not_norm.pkl" if add_text else ".pkl"),
              f"{root}/flicker8kforStyle/postprocessed_style_data/roman_train.json",
              f"{root}/flicker8kforStyle/Images/"),
        4.0: (f"./data/styleFactual_{c}_train"
              + ("_with_text_embeddings.pkl" if add_text else ".pkl"),
              f"{root}/flicker8kforStyle/postprocessed_style_data/factual_train.json",
              f"{root}/flicker8kforStyle/Images/"),
        6.0: ("./data/hp_train.pkl", "parssed_harryPotterBooks.json", "NoImgs"),
        7.0: ("./data/parsed_news_train.pkl", "parssed_news_data.json", "NoImgs"),
        8.0: (f"./data/BALANCED_parsed_coco_snowboarding_split_train_MODEis{gender_mode}.pkl",
              f"{root}/coco_snowboarding_annnotations/my_coco_snowboarding_train.json",
              "NoImgs"),
        9.0: ("./data/shkspr_train.pkl", "parssed_sheikspir_alllines_111k.json",
              "NoImgs"),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--clip_model_type', default="RN50x4",
                   choices=('RN50', 'RN101', 'RN50x4', 'ViT-B/32'))
    p.add_argument('--dataset_mode', type=float, default=0.0)
    p.add_argument('--fix_gender_imbalance_mode', type=int, default=0,
                   help='0 off, 1 both genders, 2 men only, 3 women only')
    p.add_argument('--clip_checkpoint', required=True,
                   help='path to the OpenAI CLIP .pt checkpoint')
    p.add_argument('--add_text_embedding', type=int, default=1)
    p.add_argument('--annotations', default='',
                   help='override annotations JSON path')
    p.add_argument('--out', default='', help='override output pickle path')
    p.add_argument('--images_path', default='', help='override image root')
    p.add_argument('--batch_size', type=int, default=256)
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from ..data import embeddings as emb_lib
    from ..models import clip as clip_lib
    from ..utils.clip_tokenizer import CLIPTokenizer
    from ..utils.torch_setup import resolve_device

    root = os.environ.get('CAPDEC_DATA_ROOT', './data')
    clip_model_name = args.clip_model_type.replace('/', '_')
    add_text = bool(args.add_text_embedding)
    table = mode_table(root, clip_model_name, add_text,
                       args.fix_gender_imbalance_mode)
    if args.dataset_mode not in table and not args.annotations:
        sys.exit(f"unknown dataset_mode {args.dataset_mode}")
    out_path, annotations_path, images_path = table.get(
        args.dataset_mode, ("", "", "NoImgs"))
    out_path = args.out or out_path
    annotations_path = args.annotations or annotations_path
    images_path = args.images_path or images_path
    print(f'out_path is {out_path} fix gender imbalance is '
          f'{args.fix_gender_imbalance_mode}', flush=True)

    device = resolve_device(args.device)
    clip_model, clip_cfg = clip_lib.load_openai_checkpoint(
        args.clip_checkpoint, args.clip_model_type, device=device)
    tokenizer = CLIPTokenizer() if add_text else None

    emb_lib.generate_embeddings(
        annotations_path, out_path, clip_model, clip_cfg, tokenizer,
        add_text_embedding=add_text, images_path=images_path,
        fix_gender_imbalance=args.fix_gender_imbalance_mode,
        batch_size=args.batch_size, device=device)
    print('Done', flush=True)


if __name__ == '__main__':
    main()
