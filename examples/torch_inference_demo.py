"""Single-image captioning demo on the PyTorch port (counterpart of
examples/inference_demo.py, the script form of the reference's Colab
notebook others/CapDec_inference.ipynb): load a CapDec checkpoint (e.g. one
of the published noise-sweep zoo, σ² ∈ {0, 1e-4, 1e-3, 0.015, 0.1, 2.5}),
CLIP-encode an image, and decode a caption with beam search and greedy.
It runs on the CUDA card unless given `--device cpu`.

The image goes through the same steps as one record of the predict CLI's
image route (preprocessing, the image tower, the L2 norm on the host, the
mapper, the decoder's weights cast once), so that beam 0 is the caption
`python -m capdec_tpu_torch.cli.predict --batch_size 1` writes for it.

Usage:
    python examples/torch_inference_demo.py --image cat.jpg \
        --checkpoint coco_prefix-009.pt --clip_checkpoint RN50x4.pt
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--clip_checkpoint", required=True)
    p.add_argument("--clip_model", default="RN50x4",
                   choices=("RN50", "RN101", "RN50x4", "ViT-B/32"))
    p.add_argument("--prefix_length", type=int, default=40)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--mapping_type", default="transformer_encoder")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    return p


def load(args) -> dict:
    """CLIP, the caption model (loaded strictly, bf16 products), the
    decoder's weights in the compute dtype and the tokenizer."""
    import torch

    from capdec_tpu_torch.decode.beam import cast_params_for_decode
    from capdec_tpu_torch.models import caption_model, clip as clip_lib, gpt2
    from capdec_tpu_torch.utils import checkpoint as ckpt_lib
    from capdec_tpu_torch.utils.tokenizer import load_tokenizer
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    clip_model, clip_cfg = clip_lib.load_openai_checkpoint(
        args.clip_checkpoint, args.clip_model, device=device)
    model_cfg = caption_model.CaptionModelConfig(
        prefix_length=args.prefix_length, clip_length=args.prefix_length,
        prefix_size=clip_cfg.text.embed_dim, num_layers=args.num_layers,
        mapping_type=args.mapping_type,
        gpt2=gpt2.GPT2Config(compute_dtype=torch.bfloat16))
    model = ckpt_lib.load_caption_checkpoint(args.checkpoint, model_cfg,
                                             device).eval()
    return dict(device=device, clip=clip_model, clip_cfg=clip_cfg,
                model=model, model_cfg=model_cfg,
                gpt=cast_params_for_decode(model.gpt, model_cfg.gpt2),
                tokenizer=load_tokenizer())


def image_embedding(m: dict, image: str) -> np.ndarray:
    """The image's L2-normalised CLIP embedding [1, E] (float32)."""
    from capdec_tpu_torch.data.embeddings import image_encoder
    from capdec_tpu_torch.data.image_ops import load_and_preprocess

    img = load_and_preprocess(image, m["clip_cfg"].vision.image_resolution)
    embed = image_encoder(m["clip"], m["device"])(img[None])
    embed = embed / np.maximum(np.linalg.norm(embed, axis=-1, keepdims=True),
                               1e-12)
    return embed.astype(np.float32)


def prefix_embeds(m: dict, image: str):
    """The image's GPT-2 prefix embeddings [1, K, D]."""
    import torch

    from capdec_tpu_torch.models import caption_model

    return caption_model.map_prefix(
        m["model"], m["model_cfg"],
        torch.from_numpy(image_embedding(m, image)).to(m["device"]))


def beam_captions(m: dict, prefix, beam_size: int):
    """The image's beams in ranked order (reference `generate_beam`)."""
    from capdec_tpu_torch.decode import BeamConfig, beam_search, beam_texts
    toks, lens, _, order = beam_search(m["gpt"], m["model_cfg"].gpt2, prefix,
                                       BeamConfig(beam_size=beam_size))
    return beam_texts(m["tokenizer"], toks, lens, order)[0]


def greedy_caption(m: dict, prefix) -> str:
    """The greedy/top-p caption (reference `generate2`)."""
    from capdec_tpu_torch.decode import greedy_topp_search, topp_texts
    gt, gl = greedy_topp_search(m["gpt"], m["model_cfg"].gpt2, prefix)
    return topp_texts(m["tokenizer"], gt, gl)[0]


def main(argv=None):
    args = build_parser().parse_args(argv)
    m = load(args)
    prefix = prefix_embeds(m, args.image)
    beams = beam_captions(m, prefix, args.beam_size)
    greedy = greedy_caption(m, prefix)

    print(f"beam ({args.beam_size}):")
    for i, b in enumerate(beams):
        print(f"  {i}: {b}")
    print(f"greedy/top-p: {greedy}")


if __name__ == "__main__":
    main()
