"""Prediction/eval CLI (port of capdec_tpu/cli/predict.py): the reference
`predictions_runner.py` flag surface (:424-441) on the port's batched
runner, plus `--device`.

    python -m capdec_tpu_torch.cli.predict --checkpoint c.pt \\
        (--embeddings_pickle e.pkl | --clip_checkpoint RN50x4.pt) \\
        [--infer_model_config] [--int8_kv] [--no_beam] \\
        [--score_gt gt.json] [--device cpu]

Dataset modes (reference :427): 0 coco val, 1 flickr30, 2 humor, 3
romantic, 4 factual, 5 coco val text-only, 6 coco train, 7/8 snowboard /
news variants. GT JSON and image roots come from a registry rooted at
CAPDEC_DATA_ROOT instead of the reference's hardcoded cluster paths.
Embeddings come from `--embeddings_pickle`, or from the image files (or,
with `--text_autoencoder` / dataset_mode 5, the captions) through the
CLIP towers of `--clip_checkpoint`: RN50x4 or ViT-B/32 by `--is_rn`, or
the checkpoint's own architecture under `--infer_model_config`. `--mesh`
waits for parallelism (it raises).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

import numpy as np


def dataset_registry(root: str):
    coco = f"{root}/coco"
    style = f"{root}/flicker8kforStyle"
    return {
        0: (f"{coco}/annotations/single_caption_per_sample_val.json",
            f"{coco}/val2014"),
        1: (f"{root}/flicker30/dataset_flickr30k_correct_format.jsonvalidation",
            f"{root}/flicker30/flickr30k_images"),
        2: (f"{style}/postprocessed_style_data/humor_test.json", f"{style}/Images"),
        3: (f"{style}/postprocessed_style_data/roman_test.json", f"{style}/Images"),
        4: (f"{style}/postprocessed_style_data/factual_test.json", f"{style}/Images"),
        5: (f"{coco}/annotations/val.json", None),
        6: (f"{coco}/annotations/train.json", f"{coco}/train2014"),
        7: (f"{root}/coco_snowboarding_annnotations/my_coco_snowboarding_test.json",
            f"{coco}/val2014"),
        8: (f"{root}/combinedNwes_on_cocoVal.json", f"{coco}/val2014"),
    }


def image_path_fn_for_mode(mode: int, images_root: str):
    if mode in (0, 7, 8):
        return lambda d: f"{images_root}/COCO_val2014_{int(d['image_id']):012d}.jpg"
    if mode == 6:
        return lambda d: f"{images_root}/COCO_train2014_{int(d['image_id']):012d}.jpg"
    return lambda d: f"{images_root}/{d['filename']}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--checkpoint', default='./checkpoints/coco_prefix-009.pt')
    p.add_argument('--out', default='')
    p.add_argument('--dataset_mode', type=int, default=0)
    p.add_argument('--modality_bridger', action='store_true', default=False)
    p.add_argument('--beam', action='store_true', default=True)
    p.add_argument('--no_beam', dest='beam', action='store_false')
    p.add_argument('--is_rn', action='store_true', default=True)
    p.add_argument('--not_rn', dest='is_rn', action='store_false')
    p.add_argument('--dont_normalize_prefix', action='store_true', default=False)
    p.add_argument('--text_autoencoder', action='store_true', default=False)
    p.add_argument('--ablation_dist', action='store_true', default=False,
                   help='paraphrase-distance stats (use with dataset_mode 5)')
    p.add_argument('--ablation_image_dist', action='store_true', default=False,
                   help='image-text embedding L2 gap stat')
    p.add_argument('--add_modality_offset', action='store_true', default=False)
    p.add_argument('--modality_offset_path', default='others/CLIP_embeddings_centers_info.pkl')
    p.add_argument('--prefix_length', type=int, default=40)
    p.add_argument('--num_layers', type=int, default=8)
    p.add_argument('--prefix_length_clip', type=int, default=40)
    p.add_argument('--mapping_type', type=str, default='transformer_encoder',
                   help='mlp/transformer_encoder/transformer_decoder/mapping_network')
    p.add_argument('--clip_checkpoint', default='',
                   help='path to the OpenAI CLIP .pt (required for image/text encode)')
    p.add_argument('--embeddings_pickle', default='',
                   help='use precomputed CLIP embeddings from this pickle instead of encoding')
    p.add_argument('--batch_size', type=int, default=32)
    p.add_argument('--score_gt', default='',
                   help='optional *_metrics_format.json to score predictions in-process')
    p.add_argument('--mesh', default='',
                   help="shard eval batches over a device mesh (not ported "
                        "yet, raises)")
    p.add_argument('--bf16', action='store_true', default=True)
    p.add_argument('--no_bf16', dest='bf16', action='store_false')
    p.add_argument('--int8_kv', action='store_true', default=False,
                   help='opt-in int8 KV cache for beam decode (captions are '
                        'not token-identical to the bf16 path)')
    p.add_argument('--infer_model_config', action='store_true', default=False,
                   help='infer the caption-model architecture from checkpoint '
                        'shapes instead of the flags (the reference hardcodes '
                        'flags that must match by convention, '
                        'predictions_runner.py:436-460)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    return p


def main(argv=None):
    import torch

    from ..decode import BeamConfig
    from ..eval import predictions as pred_lib
    from ..models import caption_model, clip as clip_lib, gpt2
    from ..utils import checkpoint as ckpt_lib
    from ..utils.tokenizer import load_tokenizer
    from ..utils.torch_setup import resolve_device

    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            '--mesh is not ported yet (ROADMAP.md Queue 1, parallelism)')
    if not (args.embeddings_pickle or args.clip_checkpoint):
        sys.exit("--clip_checkpoint or --embeddings_pickle required")
    device = resolve_device(args.device)
    print(f'beam search = {args.beam}', flush=True)
    if args.text_autoencoder:
        args.dataset_mode = 5

    root = os.environ.get('CAPDEC_DATA_ROOT', './data')
    reg = dataset_registry(root)
    if args.dataset_mode not in reg:
        sys.exit("Wrong dataset mode")
    gt_path, images_root = reg[args.dataset_mode]
    with open(gt_path) as f:
        data = json.load(f)
    print(f'loaded data: {len(data)} records; sample: {data[0]}', flush=True)

    name = os.path.basename(args.checkpoint).split(".")[0] + (
        'add_modality_offset' if args.add_modality_offset else '')
    ckpt_dir = os.path.dirname(args.checkpoint)
    out_path = args.out or os.path.join(ckpt_dir, f"{name}.json")
    print(f'out_path = {out_path}, dataset_mode = {args.dataset_mode}', flush=True)
    out_dir = os.path.dirname(out_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'commandline_args.txt'), 'w') as f:
        json.dump(vars(args), f, indent=2)

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.infer_model_config:
        sd = ckpt_lib.load_state_dict(args.checkpoint)
        model_cfg = caption_model.config_from_torch_state_dict(
            sd, compute_dtype=compute_dtype)
        print(f'inferred model config: {model_cfg}', flush=True)
        # n_head is not recoverable from the fused c_attn shape; inference
        # assumes head_dim 64 (true for every released GPT-2 size)
        print(f'  (n_head={model_cfg.gpt2.n_head} assumes head_dim 64; '
              f'pass an explicit config if your checkpoint differs)',
              flush=True)
        model = caption_model.params_from_torch_state_dict(sd, model_cfg,
                                                           device)
        prefix_dim = model_cfg.prefix_size
    else:
        prefix_dim = [512, 640][args.is_rn]
        model_cfg = caption_model.CaptionModelConfig(
            prefix_length=args.prefix_length, clip_length=args.prefix_length_clip,
            prefix_size=prefix_dim, num_layers=args.num_layers,
            mapping_type=args.mapping_type,
            gpt2=gpt2.GPT2Config(compute_dtype=compute_dtype))
        model = ckpt_lib.load_caption_checkpoint(args.checkpoint, model_cfg,
                                                 device)
    print(args.checkpoint, flush=True)
    print(f'modality_offset={args.add_modality_offset}', flush=True)

    offset = None
    if args.add_modality_offset:
        with open(args.modality_offset_path, 'rb') as f:
            off = pickle.load(f)['offset_to_add_in_inference']
        offset = np.asarray(off.detach().cpu().float().numpy()
                            if hasattr(off, 'detach') else off, np.float32)

    bridger_fn = None
    if args.modality_bridger:
        from ..aux.bridger import load_bridger_fn
        bridger_fn = load_bridger_fn(prefix_dim, device=device)

    tokenizer = load_tokenizer()

    # embedding source
    record_filter = None
    if args.embeddings_pickle:
        with open(args.embeddings_pickle, 'rb') as f:
            all_data = pickle.load(f)
        emb = all_data['clip_embedding']
        if hasattr(emb, 'numpy'):
            emb = emb.float().numpy()
        embed_fn = pred_lib.make_pickle_embed_fn(np.asarray(emb, np.float32))
    else:
        # with shape-inferred model config, infer the CLIP arch too
        model_name = (None if args.infer_model_config
                      else "RN50x4" if args.is_rn else "ViT-B/32")
        clip_model, clip_cfg = clip_lib.load_openai_checkpoint(
            args.clip_checkpoint, model_name, device=device)
        if args.text_autoencoder or args.dataset_mode == 5:
            from ..utils.clip_tokenizer import CLIPTokenizer
            embed_fn = pred_lib.make_text_embed_fn(
                clip_model, clip_cfg, CLIPTokenizer(), device=device)
        else:
            path_fn = image_path_fn_for_mode(args.dataset_mode, images_root)
            embed_fn = pred_lib.make_image_embed_fn(
                clip_model, clip_cfg, path_fn, device=device)
            record_filter = lambda d: os.path.isfile(path_fn(d))

    text_embed_fn = None
    if (args.ablation_image_dist and args.clip_checkpoint
            and not args.embeddings_pickle):
        from ..utils.clip_tokenizer import CLIPTokenizer
        text_embed_fn = pred_lib.make_text_embed_fn(
            clip_model, clip_cfg, CLIPTokenizer(), device=device)

    bc = BeamConfig()
    if args.int8_kv:
        # beam only: the flag leaves greedy exact (as the JAX CLI does)
        bc = dataclasses.replace(bc, kv_cache_int8=True, fused_attention=True)
    pcfg = pred_lib.PredictConfig(
        beam=args.beam, batch_size=args.batch_size, beam_config=bc,
        dont_normalize_prefix=args.dont_normalize_prefix,
        add_modality_offset=args.add_modality_offset, modality_offset=offset,
        text_autoencoder=args.text_autoencoder,
        ablation_dist=args.ablation_dist,
        ablation_image_dist=args.ablation_image_dist,
        text_embed_fn=text_embed_fn, record_filter=record_filter)
    results = pred_lib.run_predictions(data, embed_fn, model, model_cfg,
                                       tokenizer, pcfg, out_path=out_path,
                                       bridger_fn=bridger_fn, device=device)

    if args.score_gt:
        from ..eval import metrics
        with open(args.score_gt) as f:
            gt = json.load(f)
        scores = metrics.score_predictions(results, gt)
        print(json.dumps(scores, indent=2), flush=True)
        with open(os.path.join(out_dir, f"{name}_scores.json"), 'w') as f:
            json.dump(scores, f, indent=2)
    return results


if __name__ == '__main__':
    main()
