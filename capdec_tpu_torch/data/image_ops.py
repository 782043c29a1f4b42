"""Host-side image preprocessing matching CLIP's eval transform (the
port's own copy of capdec_tpu/data/image_ops.py).

Replicates openai/CLIP `_transform`: resize shorter side to n_px (bicubic),
center crop n_px, RGB, scale to [0,1], normalize with CLIP mean/std.
Implemented with PIL + numpy (no torchvision dependency); outputs NHWC
float32, the layout the port's CLIP towers take.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_pil(img, n_px: int) -> np.ndarray:
    """PIL image → [n_px, n_px, 3] float32, CLIP-normalized."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = n_px / min(w, h)
    new_w, new_h = round(w * scale), round(h * scale)
    img = img.resize((new_w, new_h), Image.BICUBIC)
    # torchvision CenterCrop rounds the crop origin; floor division would
    # be off by one pixel for odd size differences.
    left = int(round((new_w - n_px) / 2.0))
    top = int(round((new_h - n_px) / 2.0))
    img = img.crop((left, top, left + n_px, top + n_px))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def load_and_preprocess(path: str, n_px: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return preprocess_pil(img, n_px)


def preprocess_batch(paths: Sequence[str], n_px: int) -> np.ndarray:
    return np.stack([load_and_preprocess(p, n_px) for p in paths])
