"""The comparison that decides `correct`: the outputs the measured window
produced, for a sample of its frames drawn from the seed and its last
frame, against the plain reference (`reference/chain.py`) given the same
integer planes and the same history of frames (which sets the delayed
peak state each frame applies).

Run after the window has closed and the program's state is freed; the
reference computes on the same device in float32 with TF32 off."""
from __future__ import annotations

import torch

from framebench.reference import chain as ref

# the numbers a cell's limits may hold, in the order they are printed
NUMBERS = ("max_code_diff", "share_over_1", "share_differing",
           "mean_abs_code_diff", "max_row_mean_abs_diff")
# numbers that are a largest value over the frames, not a mean
_MAXIMA = ("max_code_diff", "max_row_mean_abs_diff")


def reference_outputs(config: dict, source, history, positions, device,
                      precision: str = "float32"):
    """{position in history: the reference's code planes} for
    `positions`, with the peak state worked out over `history` (the keys
    of every frame the renderer saw, in order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ch = ref.Chain(config, config["source_frame"], source.w, source.h,
                   device, precision=precision)
    wanted = {history[p] for p in positions}
    linear, meas = {}, {}
    # one measurement a distinct frame; the reference measures its own
    # image, so the control's states follow its own precision too
    for key in sorted(set(history)):
        img = ch.linear(source.frames[key])
        meas[key] = ref.measure_peak(img)
        if key in wanted:
            linear[key] = img
    states = ref.peak_states(meas, history, positions)
    return {pos: ch.tail(linear[history[pos]], states[pos])
            for pos in positions}


def program_planes(config: dict, out):
    """The program's output as code planes: a rendered [0, 1] frame
    quantized to the display's depth, or the encoder's integer planes
    as they were downloaded."""
    if isinstance(out, torch.Tensor):
        return [ref.codes(out, config["target"]["bit_depth"])]
    return [p.double() for p in out]


def compare(config: dict, program: dict, reference: dict) -> dict:
    """The numbers over every compared frame: the largest of the maxima,
    and the shares and mean taken over all their values."""
    tot = {k: 0.0 for k in NUMBERS}
    n = 0
    for pos, out in program.items():
        r = reference[pos]
        c = ref.compare(program_planes(config, out), r)
        m = sum(p.numel() for p in r)
        for k in NUMBERS:
            tot[k] = max(tot[k], c[k]) if k in _MAXIMA else tot[k] + c[k] * m
        n += m
    for k in NUMBERS:
        if k not in _MAXIMA:
            tot[k] /= max(n, 1)
    return tot


def judge(numbers: dict, limits: dict) -> bool:
    """Every number a limit holds is within it."""
    return all(numbers[k] <= v for k, v in limits.items())
