"""Config persistence: save/load a run's configuration and reload models
(port of capdec_tpu/utils/config_io.py, on the port's models).

Reference parity (train.py:287-314): `save_config` dumps the arg namespace
to `{out_dir}/{prefix}.json`; `load_model` reconstructs the model from that
JSON plus `{prefix}{-epoch:03d|_latest}.pt`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple, Union


def save_config(config: Dict[str, Any], out_dir: str, prefix: str) -> str:
    path = os.path.join(out_dir, f"{prefix}.json")
    os.makedirs(out_dir, exist_ok=True)
    serializable = {k: v for k, v in config.items()
                    if isinstance(v, (int, float, str, bool, list, type(None)))}
    with open(path, "w") as f:
        json.dump(serializable, f)
    return path


def load_config(config_path: str) -> Dict[str, Any]:
    with open(config_path) as f:
        return json.load(f)


def model_config_from_args(args: Dict[str, Any]):
    """Build a CaptionModelConfig from a saved CLI-arg dict."""
    from ..models import caption_model, gpt2
    prefix_dim = args.get("prefix_size") or (
        640 if not args.get("is_not_rn", False) else 512)
    return caption_model.CaptionModelConfig(
        prefix_length=args.get("prefix_length", 40),
        clip_length=args.get("prefix_length_clip", 40),
        prefix_size=prefix_dim,
        num_layers=args.get("num_layers", 8),
        mapping_type=args.get("mapping_type", "transformer"),
        only_prefix=args.get("only_prefix", False),
        gpt2=gpt2.GPT2Config())


def load_model(config_path: str,
               epoch_or_latest: Union[str, int] = "_latest",
               device=None) -> Tuple[Any, Any]:
    """Reconstruct (model, model_cfg) from a saved config JSON + weights
    (reference train.py:296-314 contract, including the `-{epoch:03d}`
    naming); the model is None when its `.pt` is missing."""
    from . import checkpoint as ckpt_lib

    config = load_config(config_path)
    if isinstance(epoch_or_latest, int):
        suffix = f"-{epoch_or_latest:03d}"
    else:
        suffix = epoch_or_latest
    model_path = os.path.join(config.get("out_dir", "."),
                              f"{config.get('prefix', 'coco_prefix')}{suffix}.pt")
    cfg = model_config_from_args(config)
    if os.path.isfile(model_path):
        print(f"loading model from {model_path}", flush=True)
        model = ckpt_lib.load_caption_checkpoint(model_path, cfg, device)
    else:
        print(f"{model_path} is not exist", flush=True)
        model = None
    return model, cfg
