"""Qualitative prefix-inspection CLI (port of
capdec_tpu/cli/inspect_prefixes.py; reference gpt2_prefix_eval.py main).

Loads a checkpoint and an embedding pickle, filters chosen image ids, and
prints GT caption, nearest-vocab prefix readout, and beam/greedy captions.

    python -m capdec_tpu_torch.cli.inspect_prefixes --checkpoint c.pt \\
        --data d.pkl [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--data', required=True, help='embedding pickle')
    p.add_argument('--prefix_length', type=int, default=10)
    p.add_argument('--prefix_length_clip', type=int, default=10)
    p.add_argument('--mapping_type', default='mlp')
    p.add_argument('--num_layers', type=int, default=8)
    p.add_argument('--is_rn', action='store_true', default=True)
    p.add_argument('--image_ids', default='19906,320200,341061,400728,444467',
                   help='comma-separated ids to inspect (reference defaults)')
    p.add_argument('--max_items', type=int, default=10)
    p.add_argument('--no_beam', dest='beam', action='store_false', default=True)
    p.add_argument('--device', default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)

    from ..data import dataset as data_lib
    from ..eval import prefix_tools
    from ..models import caption_model
    from ..utils import checkpoint as ckpt_lib
    from ..utils.tokenizer import load_tokenizer
    from ..utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    cfg = caption_model.CaptionModelConfig(
        prefix_length=args.prefix_length, clip_length=args.prefix_length_clip,
        prefix_size=[512, 640][args.is_rn], num_layers=args.num_layers,
        mapping_type=args.mapping_type)
    model = ckpt_lib.load_caption_checkpoint(args.checkpoint, cfg, device)
    tokenizer = load_tokenizer()
    ds = data_lib.load_caption_dataset(args.data, args.prefix_length,
                                       tokenizer)
    ids = [s.strip() for s in args.image_ids.split(',') if s.strip()]
    return prefix_tools.inspect_samples(model, cfg, ds, tokenizer, ids,
                                        use_beam=args.beam,
                                        max_items=args.max_items)


if __name__ == '__main__':
    main()
