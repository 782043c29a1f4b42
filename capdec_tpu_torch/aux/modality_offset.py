"""Modality-offset calculator (reference others/modality_offset_calculator.py).

From paired image/text CLIP embeddings: L2-normalize each modality, take
per-modality means over the first `num_pairs` rows, and derive
    offset_to_add_in_training  = center_image - center_text
    offset_to_add_in_inference = center_text - center_image
written to a pickle with the reference's exact key names (consumed at
train.py:332-334 and predictions_runner.py:165-166).

The port's own copy of capdec_tpu/aux/modality_offset.py (no JAX in it).
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np


def _norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def compute_centers(image_embeddings: np.ndarray, text_embeddings: np.ndarray,
                    num_pairs: int = 20000) -> Dict[str, np.ndarray]:
    img = _norm(np.asarray(image_embeddings[:num_pairs], np.float32))
    txt = _norm(np.asarray(text_embeddings[:num_pairs], np.float32))
    center_image = img.mean(axis=0, keepdims=True)
    center_text = txt.mean(axis=0, keepdims=True)
    diff = txt - img
    stats = {
        "offset_l2": float(np.linalg.norm(diff.mean(axis=0))),
        "offset_abs_mean": float(np.abs(diff).mean()),
        "offset_std_l2": float(np.linalg.norm(diff.std(axis=0))),
    }
    print(f"Offset analysis: L2 norm={stats['offset_l2']:.2f}, "
          f"Mean={stats['offset_abs_mean']:.2f}", flush=True)
    return {
        "center_text": center_text,
        "center_image": center_image,
        "offset_to_add_in_training": center_image - center_text,
        "offset_to_add_in_inference": center_text - center_image,
        "stats": stats,
    }


def compute_centers_from_pickle(data_path: str, num_pairs: int = 20000):
    with open(data_path, "rb") as f:
        data = pickle.load(f)

    def to_np(x):
        return (x.detach().cpu().float().numpy() if hasattr(x, "detach")
                else np.asarray(x, np.float32))

    return compute_centers(to_np(data["clip_embedding"]),
                           to_np(data["clip_embedding_text_dave"]), num_pairs)


def save_centers(centers: Dict[str, np.ndarray], out_path: str) -> None:
    payload = {k: v for k, v in centers.items() if k != "stats"}
    with open(out_path, "wb") as f:
        pickle.dump(payload, f)
    print(f"norm of diff = "
          f"{np.linalg.norm(payload['offset_to_add_in_inference']):.4f}")
    print("saved centers info to pickle successfully", flush=True)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True,
                   help="embedding pickle with paired image+text embeddings")
    p.add_argument("--out", default="CLIP_embeddings_centers_info.pkl")
    p.add_argument("--num_pairs", type=int, default=20000)
    args = p.parse_args(argv)
    save_centers(compute_centers_from_pickle(args.data, args.num_pairs),
                 args.out)


if __name__ == "__main__":
    main()
