"""Channel mixes on (C, H, W) tensors.

Counterpart of libplacebo_tpu/ops/color.py, cut to `mat_pointwise`:
unrolled per-channel multiply-adds with float32 weights and zero
weights skipped, rounding as core/fastmath.py says."""
from __future__ import annotations


import numpy as np
import torch

from ..core.fastmath import mix

__all__ = ["mat_pointwise"]


def mat_pointwise(img, mat, bias=None):
    """out[c] = sum_k mat[c, k] * img[k] (+ bias[c]) as unrolled
    multiply-adds; `mat` is a host (C, K) array, zero weights skipped."""
    mat = np.asarray(mat, dtype=np.float64)
    chans = []
    for c in range(mat.shape[0]):
        ks = [k for k in range(mat.shape[1]) if float(mat[c, k]) != 0.0]
        b = float(bias[c]) if bias is not None else 0.0
        if not ks:
            acc = torch.zeros_like(img[..., 0, :, :])
            chans.append(acc + b if b else acc)
            continue
        chans.append(mix([img[..., k, :, :] for k in ks],
                         [float(mat[c, k]) for k in ks], b))
    return torch.stack(chans, dim=-3)
