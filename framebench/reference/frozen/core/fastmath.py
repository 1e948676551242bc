"""Arithmetic helpers that pin the rounding of the device math.

Counterpart of libplacebo_tpu/core/fastmath.py.  There, divisions go
through `fdiv`, exact outside the TPU kernel; here every division
between tensors is a true IEEE divide, and the approximate-reciprocal
mode (a TPU instruction) does not exist.

Two more rules fix where the port rounds, so that the CPU path, the
plain versions on the card and the hand-written kernels agree with each
other and with the reference package's XLA lowering:

* a division by a host constant is a multiply by its float32
  reciprocal (`rcp`) — what XLA emits for `x / c`, and what PyTorch's
  CUDA division does with a Python scalar divisor anyway;
* a multiply feeding an add is one fused multiply-add (`fma`) where
  XLA's LLVM backend contracts it: `x*y + z`, `x*y - z` and `z - x*y`
  fuse the product (the left operand's product when both are products)
  — except in the separable scaler's tap sums, which stay unfused
  (`tap_sum`), as XLA leaves them.
  On PyTorch this is `torch.add(c, a, alpha=w)` / `torch.addcmul`, which
  round once on the CPU and the GPU; the kernels call fmaf() and are
  built with -fmad=false so that nothing else contracts.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["rcp", "f32_mul", "fma", "mix", "sqrt"]


def rcp(c: float) -> float:
    """float32 reciprocal of a host constant (as a Python float)."""
    return float(np.float32(1.0) / np.float32(c))


def f32_mul(a: float, b: float) -> float:
    """float32 product of two host constants (XLA's folding of c1·c2)."""
    return float(np.float32(a) * np.float32(b))


def fma(a, b, c):
    """a*b + c rounded once; a is a tensor, b and c tensors or floats."""
    if not torch.is_tensor(c):
        c = torch.full_like(a, c)
    if torch.is_tensor(b):
        return torch.addcmul(c, a, b)
    return torch.add(c, a, alpha=b)


def mix(xs, ws, b: float = 0.0):
    """sum_k ws[k] * xs[k] (+ b), in order, with the contraction rule:
    the first two products fuse the first — unless the first weight is
    negative and the second positive, where the backend's `y - x*c`
    form fuses the second — and every later product fuses into the
    running sum; a weight of 1.0 is no product (XLA drops it).
    `ws` are host floats, none of them zero."""
    acc, pend = None, None        # pend = (x, w): a product not yet rounded
    for x, w in zip(xs, ws):
        if acc is None and pend is None:
            if w == 1.0:
                acc = x
            else:
                pend = (x, w)
            continue
        if pend is not None:
            if w == 1.0:
                acc = fma(pend[0], pend[1], x)
            elif pend[1] < 0.0 < w:
                acc = fma(x, w, pend[0] * pend[1])
            else:
                acc = fma(pend[0], pend[1], x * w)
            pend = None
        elif w == 1.0:
            acc = acc + x
        else:
            acc = fma(x, w, acc)
    if b:
        return fma(pend[0], pend[1], b) if pend is not None else acc + b
    return pend[0] * pend[1] if pend is not None else acc


def sqrt(x):
    """Correctly rounded square root on every device (PyTorch's
    vectorized CPU sqrt is not: ~0.6% of results are 1 ulp off)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
