"""Training CLI (port of capdec_tpu/cli/train.py): the reference's public
flag surface (reference train.py:396-417, README.md:48-71) on the
PyTorch port.

    python -m capdec_tpu_torch.cli.train --data clip_embedding.pkl \\
        --out_dir ./checkpoints [--only_prefix] [--bf16] [--device cpu]

Differences from the reference, by design:
  * dataset path presets (COCO/FLICKR) live in a registry overridable via
    CAPDEC_DATA_ROOT instead of hardcoded cluster paths
  * checkpoints are reference-compatible `.pt` state_dicts
  * `--device` picks the device (the card unless told otherwise)
  * `--mesh dp,tp` opts into data and Megatron tensor parallelism over
    dp * tp processes, one per device, started by torchrun (one process
    alone is a world of 1); rank 0 writes the outputs:

    torchrun --nproc_per_node 4 -m capdec_tpu_torch.cli.train \
        --data c.pkl --out_dir o --mesh 2,2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data', default='clip_embedding.pkl',
                   help='path to clip embeddings of captions generated by the embeddings generator (or COCO/FLICKR preset)')
    p.add_argument('--val_pt', default='', help='path to clip embeddings of validation set')
    p.add_argument('--pretrain_weights', default='', help='path to pretrained weights; trains from scratch if empty')
    p.add_argument('--out_dir', default='./checkpoints', help='path to output directory')
    p.add_argument('--add_modality_offset', action='store_true', default=False,
                   help='train with the precalculated modality offset pickle')
    p.add_argument('--modality_offset_path', default='others/CLIP_embeddings_centers_info.pkl')
    p.add_argument('--prefix', default='coco_prefix', help='prefix for saved filenames')
    p.add_argument('--noise_variance', type=float, default=0.0, help='noise variance')
    p.add_argument('--uniform_noise', action='store_true', default=False,
                   help='use uniform-ball noise instead of gaussian')
    p.add_argument('--dont_norm', action='store_true', default=False,
                   help='dont normalize CLIP embeddings')
    p.add_argument('--lr', type=float, default=2e-5, help='learning rate')
    p.add_argument('--epochs', type=int, default=10, help='number of epochs')
    p.add_argument('--save_every', type=int, default=1, help='save every n epochs')
    p.add_argument('--prefix_length', type=int, default=40, help='prefix length')
    p.add_argument('--prefix_length_clip', type=int, default=40, help='prefix length for clip')
    p.add_argument('--bs', type=int, default=34, help='batch size')
    p.add_argument('--only_prefix', action='store_true', default=False,
                   help='train only the mapper; GPT-2 frozen')
    p.add_argument('--mapping_type', type=str, default='transformer',
                   choices=('mlp', 'transformer', 'transformer_encoder',
                            'transformer_decoder', 'mapping_network'),
                   help='mlp/transformer/transformer_encoder/transformer_decoder/mapping_network')
    p.add_argument('--num_layers', type=int, default=8, help='mapper layers')
    p.add_argument('--is_not_rn', action='store_true', default=False,
                   help='CLIP backbone: False for RN50x4 (640-d), True for ViT (512-d)')
    p.add_argument('--use_image_embedding_as_clipcap', action='store_true', default=False,
                   help='train on image embeddings instead of text embeddings')
    p.add_argument('--resume', action='store_true', default=False,
                   help='resume exactly (weights + optimizer moments + '
                        'schedule + step) from the newest full train state '
                        'in out_dir; unlike --pretrain_weights, the LR '
                        'schedule and data order continue where they left '
                        'off')
    p.add_argument('--mesh', default='', help="device mesh as 'dp,tp' (e.g. '4,2'); empty = single device")
    p.add_argument('--steps_per_dispatch', type=int, default=1,
                   help='optimizer steps per call (identical to single '
                        'steps)')
    p.add_argument('--max_steps', type=int, default=0,
                   help='stop after this many global steps (0 = run all '
                        'epochs); the full train state is saved on the way '
                        'out, so a bounded run + --resume equals one '
                        'uninterrupted run')
    p.add_argument('--gpt2_weights', default='',
                   help='path to a HF GPT-2 state_dict .pt/.bin to initialize the LM (else random init)')
    p.add_argument('--bf16', action='store_true', default=False, help='bfloat16 matmuls')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help='torch device (default: the CUDA card; "cpu" runs '
                        'on the CPU)')
    return p


def apply_presets(args: argparse.Namespace) -> argparse.Namespace:
    """COCO/FLICKR magic presets (reference train.py:418-442) with paths
    rooted at CAPDEC_DATA_ROOT (default ./data)."""
    root = os.environ.get('CAPDEC_DATA_ROOT', './data')
    if args.data == 'COCO':
        args.bs = 30
        args.data = f'{root}/coco/oscar_split_RN50x4_train_with_text_embeddings.pkl'
        args.val_pt = ('' if args.use_image_embedding_as_clipcap
                       else f'{root}/coco/COCO_val_set_single_cap_per_sample_with_text.pkl')
        if args.dont_norm:
            args.data = f'{root}/coco/verified_split_COCO_train_set_with_text_not_norm.pkl'
            args.val_pt = ''
    elif args.data == 'FLICKR':
        args.bs = 16
        if args.use_image_embedding_as_clipcap:
            args.data = f'{root}/flicker30_RN50x4_train.pkl'
            args.val_pt = ''
        else:
            args.data = f'{root}/flicker30_RN50x4_train_with_text_embeddings.pkl'
            args.val_pt = f'{root}/flicker30_RN50x4_validation_with_text_embeddings.pkl'
        if args.dont_norm:
            if args.use_image_embedding_as_clipcap:
                sys.exit('NONORM is not supported yet with use_image_embedding_as_clipcap')
            args.data = f'{root}/flicker30_RN50x4_train_with_text_embeddings_not_norm.pkl'
            args.val_pt = ''
    return args


def load_modality_offset(path: str) -> Optional[np.ndarray]:
    with open(path, 'rb') as f:
        centers = pickle.load(f)
    off = centers['offset_to_add_in_training']
    if hasattr(off, 'detach'):
        off = off.detach().cpu().float().numpy()
    return np.asarray(off, dtype=np.float32)


def main(argv=None):
    args = apply_presets(build_parser().parse_args(argv))
    if not args.mesh:
        return _train(args, None)
    from ..parallel import mesh as mesh_lib
    dp, tp = (int(x) for x in args.mesh.split(','))
    with mesh_lib.cli_mesh(dp=dp, tp=tp, device=args.device) as mesh:
        return _train(args, mesh)


def _train(args, mesh):
    """The CLI's body, under `mesh` (None: one process, no group)."""
    import torch

    from ..data import dataset as data_lib
    from ..models import caption_model, gpt2
    from ..train import loop as loop_lib
    from ..train import step as step_lib
    from ..utils import checkpoint as ckpt_lib
    from ..utils.tokenizer import load_tokenizer
    from ..utils.torch_setup import resolve_device

    device = mesh.device if mesh else resolve_device(args.device)
    prefix_dim = 640 if not args.is_not_rn else 512

    tokenizer = load_tokenizer()
    dataset = data_lib.load_caption_dataset(
        args.data, args.prefix_length, tokenizer,
        normalize_prefix=not args.dont_norm,
        use_image_embedding=args.use_image_embedding_as_clipcap)
    val_ds = None
    if args.val_pt:
        val_ds = data_lib.load_caption_dataset(
            args.val_pt, args.prefix_length, tokenizer,
            normalize_prefix=not args.dont_norm,
            use_image_embedding=args.use_image_embedding_as_clipcap)

    model_cfg = caption_model.CaptionModelConfig(
        prefix_length=args.prefix_length, clip_length=args.prefix_length_clip,
        prefix_size=prefix_dim, num_layers=args.num_layers,
        mapping_type=args.mapping_type, only_prefix=args.only_prefix,
        gpt2=gpt2.GPT2Config(
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32))
    print("Train only prefix" if args.only_prefix else "Train both prefix and GPT",
          flush=True)

    model = None
    if args.pretrain_weights:
        model = ckpt_lib.load_caption_checkpoint(args.pretrain_weights,
                                                 model_cfg, device)
    elif args.gpt2_weights:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = caption_model.init_params(model_cfg, gen, device=device)
        sd = ckpt_lib.load_state_dict(args.gpt2_weights)
        model.gpt.load_state_dict(
            gpt2.params_from_torch_state_dict(sd, model_cfg.gpt2).state_dict())

    offset = (load_modality_offset(args.modality_offset_path)
              if args.add_modality_offset else None)
    print(f'modality_offset={args.add_modality_offset}', flush=True)
    noise_cfg = step_lib.NoiseConfig(
        variance=args.noise_variance, uniform_noise=args.uniform_noise,
        dont_norm=args.dont_norm, modality_offset=offset)

    os.makedirs(args.out_dir, exist_ok=True)
    if mesh is None or mesh.is_main:
        with open(f'{args.out_dir}/train_commandline_args.txt', 'w') as f:
            json.dump(dict(vars(args)), f, indent=2)
        print(f'args saved to file {args.out_dir}/train_commandline_args.txt', flush=True)

    loop_cfg = loop_lib.TrainLoopConfig(
        epochs=args.epochs, batch_size=args.bs, lr=args.lr,
        save_every=args.save_every, out_dir=args.out_dir, prefix=args.prefix,
        seed=args.seed, resume=args.resume,
        steps_per_dispatch=args.steps_per_dispatch,
        max_steps=args.max_steps or None)
    return loop_lib.train(model_cfg, loop_cfg, dataset, noise_cfg,
                          val_ds=val_ds, params=model, mesh=mesh,
                          device=device)


if __name__ == '__main__':
    main()
