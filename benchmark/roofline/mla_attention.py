"""K16, `ops/mla_attention.py` mla_decode_attention: one layer's absorbed
latent attention of B = N x R beam rows at decode step `step`, H query
heads a row over the image's K prefix latent rows (shared by its R
beams), the row's `step` generated rows and the step's own. Kernel
`mla_decode_attention`, one call a layer.

Bytes, each read once and the output written once: the prefix latent
once per image, the generated rows of each beam row, the step's latent
rows, the queries [B, H, Dl + Dr] and the output [H, B, Dl], bf16.
Operations: 2 x rows x H x slots x (Dl + Dr + Dl), the scores over the
latent and rope values and the values over the latent."""
from __future__ import annotations

KERNELS = ("mla_decode_attention",)


def flops(N: int, R: int, K: int, step: int, H: int = 16, Dl: int = 512,
          Dr: int = 64) -> float:
    return 2.0 * N * R * H * (K + step + 1) * (Dl + Dr + Dl)


def nbytes(N: int, R: int, K: int, step: int, H: int = 16, Dl: int = 512,
           Dr: int = 64, itemsize: int = 2) -> float:
    B = N * R
    rows = N * K + B * step + B
    return (rows * (Dl + Dr) + B * H * (Dl + Dr) + B * H * Dl) * itemsize
