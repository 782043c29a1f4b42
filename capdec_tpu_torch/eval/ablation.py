"""Ablation distance metrics (reference predictions_runner.py:32-95,
236-251, 294-340).

Given, per image, the (mapper-space, CLIP-space) embedding pairs of its ~5
paraphrase captions, computes the paper's review statistics: pairwise
normalized L1/L2 distances in mapper and CLIP space, distances to the
per-image centroid, max per-entry L1, and the image↔text embedding L2 gap.

The port's own copy of capdec_tpu/eval/ablation.py (no JAX in it).
"""
from __future__ import annotations

import pickle
from itertools import combinations
from typing import Dict, Optional

import numpy as np


def count_ready(embeddings_dict: Dict, group_size: int = 5) -> int:
    return sum(1 for v in embeddings_dict.values()
               if v is not None and len(v) == group_size)


def calc_distances(embeddings_dict: Dict,
                   out_file: Optional[str] = "embeddings_distances.pkl",
                   group_size: int = 5) -> Dict[str, float]:
    """embeddings_dict: {img_id: [(mapper_vec, clip_vec), ...]}.

    Returns the summary statistics and optionally dumps the raw distance
    lists (reference pickle keys preserved).
    """
    distances, distances_l2 = [], []
    distances_clip, distances_l2_clip = [], []
    max_distances_l1, maxoutof5 = [], []
    dist_l2_center, max_l1_center = [], []

    for img_id, group in embeddings_dict.items():
        pairs = list(combinations(range(len(group)), 2))
        if not pairs:
            continue
        d1 = d2 = c1 = c2 = ml1 = 0.0
        per_pair_l2 = []
        dim_m = dim_c = 1
        for i, j in pairs:
            mi, ci = group[i]
            mj, cj = group[j]
            d1 += float(np.linalg.norm(mi - mj, ord=1))
            d2 += float(np.linalg.norm(mi - mj, ord=2))
            c1 += float(np.linalg.norm(ci - cj, ord=1))
            c2 += float(np.linalg.norm(ci - cj, ord=2))
            ml1 += float(np.abs(ci - cj).max())
            dim_m, dim_c = mi.shape[0], ci.shape[0]
            per_pair_l2.append(float(np.linalg.norm(ci - cj, ord=2))
                               / dim_c ** 0.5)
        n = len(pairs)
        if n == group_size * (group_size - 1) // 2:
            distances.append(d1 / (dim_m * n))
            distances_l2.append(d2 / (dim_m * n))
            distances_clip.append(c1 / (dim_c * n))
            distances_l2_clip.append(c2 / (dim_c * n))
            max_distances_l1.append(ml1 / n)
            maxoutof5.append(max(per_pair_l2))
        clip_vecs = np.asarray([g[1] for g in group])
        center = clip_vecs.mean(axis=0)
        dist_l2_center.append(
            float(np.linalg.norm(clip_vecs - center, ord=2, axis=1).mean()))
        max_l1_center.append(
            float(np.abs(clip_vecs - center).max(axis=1).mean()))

    def stat(name, values):
        arr = np.asarray(values) if values else np.asarray([0.0])
        print(f"\n{name}: {arr.mean():.6f}, STD: {arr.std():.6f}", flush=True)
        return float(arr.mean())

    summary = {
        "l1_mapper": stat("Average normalised L1 between annotations of same "
                          "image MAPPER", distances),
        "l2_mapper": stat("Average normalised L2 between annotations of same "
                          "image MAPPER", distances_l2),
        "l1_clip": stat("Average normalised L1 between annotations of same "
                        "image CLIP", distances_clip),
        "l2_clip": stat("Average normalised L2 between annotations of same "
                        "image CLIP", distances_l2_clip),
        "l2_center_clip": stat("Mean L2 to center CLIP", dist_l2_center),
        "max_l1_center_clip": stat("Max per-entry L1 to center CLIP",
                                   max_l1_center),
        "max_l1_clip": stat("Max per-entry L1 CLIP", max_distances_l1),
        "max_l2_of_group": stat("Max of pairwise L2 CLIP", maxoutof5),
    }
    if out_file:
        with open(out_file, "wb") as f:
            pickle.dump({"distances_clip": distances_clip,
                         "distances_l2_clip": distances_l2_clip,
                         "max_distances_l1": max_distances_l1}, f)
        print(f"Saved distances to {out_file}", flush=True)
    return summary


class ImageTextGapTracker:
    """Running image↔text embedding L2 gap (`--ablation_image_dist`,
    reference :240-247)."""

    def __init__(self):
        self.counter = 0
        self.l2_sum = 0.0

    def update(self, image_embed: np.ndarray, text_embed: np.ndarray):
        def norm(v):
            v = v.reshape(-1)
            return v / max(float(np.linalg.norm(v)), 1e-12)
        self.l2_sum += float(np.linalg.norm(norm(text_embed) - norm(image_embed)))
        self.counter += 1

    @property
    def mean_gap(self) -> float:
        return self.l2_sum / max(1, self.counter)

    def report(self):
        print(f"\nL2 between images and texts embeddings: {self.mean_gap}",
              flush=True)
