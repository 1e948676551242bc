"""The stages of the reference chain that have a closed form, written
from their standards and from libplacebo's definitions (not from the
program): normalization, the bilinear chroma merge at the frame's
siting, the YCbCr matrices, the PQ, sRGB and BT.1886 curves, the EWA
and separable scalers as direct sums over their taps, libplacebo's peak
measurement, the blue-noise dither's quantization and the 4:2:0 box
downsample.

Every function takes and returns float32 tensors on the caller's device
((C, H, W) images, or (1, H, W) planes); the filter weights are worked
out in float64 and applied in float32.
"""
from __future__ import annotations

import math

import torch

SDR_WHITE = 203.0           # nits, libplacebo's PL_COLOR_SDR_WHITE
PQ_MAX_NITS = 10000.0

# SMPTE ST 2084
_M1 = 2610.0 / 16384
_M2 = 2523.0 / 4096 * 128
_C1 = 3424.0 / 4096
_C2 = 2413.0 / 4096 * 32
_C3 = 2392.0 / 4096 * 32

# luma weights (Kr, Kb) of the YCbCr systems
KR_KB = {"bt2020nc": (0.2627, 0.0593), "bt709": (0.2126, 0.0722)}


# ---------------------------------------------------------------------------
# the source planes
# ---------------------------------------------------------------------------

def normalize(codes, depth: int, device):
    """Integer codes (H, W) -> a (1, H, W) float32 plane in [0, 1]."""
    t = torch.as_tensor(codes).to(device=device, dtype=torch.int32)
    return t.to(torch.float32)[None] / float((1 << depth) - 1)


def _linear_axis(plane, axis: int, n_out: int, first: float):
    """Linear interpolation along `axis`: output sample j reads the
    input at index position first + j / 2 (a 2x upsample), the edge
    samples repeated beyond the plane."""
    n_in = plane.shape[axis]
    pos = first + torch.arange(n_out, dtype=torch.float64) / 2.0
    k0 = torch.floor(pos)
    f = (pos - k0).to(torch.float32).to(plane.device)
    i0 = k0.long().clamp(0, n_in - 1).to(plane.device)
    i1 = (k0.long() + 1).clamp(0, n_in - 1).to(plane.device)
    a = plane.index_select(axis, i0)
    b = plane.index_select(axis, i1)
    shape = [1] * plane.dim()
    shape[axis] = n_out
    f = f.reshape(shape)
    return a * (1.0 - f) + b * f


def merge_chroma(chroma, height: int, width: int, siting):
    """A 4:2:0 chroma plane (1, h, w) bilinearly upsampled to the luma
    grid (1, height, width).  `siting` is the chroma sample's offset
    from the centre of its 2x2 luma block, in luma pixels (left siting:
    (-0.5, 0)).  Chroma sample k sits at luma position 2k + 1 + offset
    (pixel centres at +0.5), so luma pixel j reads chroma index
    (j - 0.5 - offset) / 2."""
    dx, dy = siting
    out = _linear_axis(chroma, 1, height, (-0.5 - dy) / 2.0)
    return _linear_axis(out, 2, width, (-0.5 - dx) / 2.0)


def ycbcr_to_rgb(img, system: str, depth: int):
    """Limited-range Y'CbCr (normalized codes) -> full-range R'G'B'
    (ITU-R BT.709 / BT.2020 non-constant luminance): Y' from codes
    16..235 and chroma from 16..240, scaled by 2^(depth - 8)."""
    kr, kb = KR_KB[system]
    kg = 1.0 - kr - kb
    imax = float((1 << depth) - 1)
    s = float(1 << (depth - 8))
    y = (img[0] * imax - 16.0 * s) / (219.0 * s)
    cb = (img[1] * imax - 128.0 * s) / (224.0 * s)
    cr = (img[2] * imax - 128.0 * s) / (224.0 * s)
    r = y + 2.0 * (1.0 - kr) * cr
    b = y + 2.0 * (1.0 - kb) * cb
    g = (y - kr * r - kb * b) / kg
    return torch.stack([r, g, b])


def rgb_to_ycbcr(img, system: str, depth: int):
    """Full-range R'G'B' -> limited-range Y'CbCr as normalized codes (the
    inverse of `ycbcr_to_rgb`)."""
    kr, kb = KR_KB[system]
    kg = 1.0 - kr - kb
    r, g, b = img[0], img[1], img[2]
    y = kr * r + kg * g + kb * b
    cb = (b - y) / (2.0 * (1.0 - kb))
    cr = (r - y) / (2.0 * (1.0 - kr))
    imax = float((1 << depth) - 1)
    s = float(1 << (depth - 8))
    return torch.stack([(16.0 * s + 219.0 * s * y) / imax,
                        (128.0 * s + 224.0 * s * cb) / imax,
                        (128.0 * s + 224.0 * s * cr) / imax])


# ---------------------------------------------------------------------------
# transfer curves; linear light is relative to SDR white (1.0 = 203 nits)
# ---------------------------------------------------------------------------

def pq_to_nits(e):
    """ST 2084 EOTF: signal in [0, 1] -> nits."""
    p = torch.clamp(e, 0.0, 1.0) ** (1.0 / _M2)
    y = torch.clamp_min(p - _C1, 0.0) / (_C2 - _C3 * p)
    return PQ_MAX_NITS * y ** (1.0 / _M1)


def nits_to_pq(nits):
    """ST 2084 inverse EOTF: nits -> signal in [0, 1]."""
    y = torch.clamp(nits / PQ_MAX_NITS, 0.0, 1.0) ** _M1
    return ((_C1 + _C2 * y) / (1.0 + _C3 * y)) ** _M2


def pq_linearize(img):
    """PQ signal -> linear light relative to SDR white."""
    return pq_to_nits(img) / SDR_WHITE


def srgb_delinearize(img, black: float, white: float):
    """Linear light -> the IEC 61966-2-1 sRGB signal on a display whose
    black and white are `black` and `white` (relative to SDR white):
    the light is first rescaled to the display's range."""
    x = torch.clamp_min((img - black) / (white - black), 0.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * x ** (1.0 / 2.4) - 0.055)


def bt1886_delinearize(img, black: float, white: float):
    """Linear light -> the signal of ITU-R BT.1886's EOTF
    L = a * max(V + b, 0)^2.4 for a display with white Lw and black Lb,
    a = (Lw^(1/2.4) - Lb^(1/2.4))^2.4, b = Lb^(1/2.4) / (Lw^(1/2.4) -
    Lb^(1/2.4)), solved for V."""
    lw, lb = white ** (1 / 2.4), black ** (1 / 2.4)
    a = (lw - lb) ** 2.4
    b = lb / (lw - lb)
    return (torch.clamp_min(img, 0.0) / a) ** (1 / 2.4) - b


# ---------------------------------------------------------------------------
# scalers
# ---------------------------------------------------------------------------

def jinc(x):
    """2 J1(pi x) / (pi x), 1 at 0 (float64)."""
    px = math.pi * x
    safe = torch.where(x.abs() < 1e-8, torch.ones_like(px), px)
    return torch.where(x.abs() < 1e-8, torch.ones_like(x),
                       2.0 * torch.special.bessel_j1(safe) / safe)


JINC_ZERO1 = 1.2196698912665045
JINC_ZERO3 = 3.2383154841662362


def ewa_lanczos(d):
    """libplacebo's ewa_lanczos at distance d (float64): jinc windowed
    by jinc stretched so that its first zero falls on the radius (the
    third zero of jinc)."""
    w = jinc(d) * jinc(d * (JINC_ZERO1 / JINC_ZERO3))
    return torch.where(d.abs() <= JINC_ZERO3, w, torch.zeros_like(w))


def hermite(d):
    """The Hermite cubic (B = 0, C = 0), radius 1 (float64)."""
    x = d.abs()
    return torch.where(x < 1.0, (2.0 * x - 3.0) * x * x + 1.0,
                       torch.zeros_like(x))


def cutoff_radius(kernel, radius: float, cutoff: float) -> float:
    """libplacebo's effective radius of a kernel (pl_filter_generate):
    scanning x upwards in steps of 0.01, the last place where the weight
    crosses into [-cutoff, cutoff], found by the secant between the two
    samples around it; the radius itself if it never does."""
    xs = torch.arange(0.0, radius + 2e-2, 1e-2, dtype=torch.float64)
    fs = kernel(xs)
    r = radius
    for i in range(1, len(xs)):
        a, b = float(fs[i - 1]), float(fs[i])
        if (a > cutoff >= b) or (a < -cutoff <= b):
            x0, x1 = float(xs[i - 1]), float(xs[i])
            r = min(x1 - b * (x1 - x0) / (b - a) if b != a else x1, radius)
    return r


def ewa(img, dst_h: int, dst_w: int):
    """Elliptical weighted average (ewa_lanczos) of (C, H, W) onto
    (C, dst_h, dst_w): each output pixel is the weighted mean of every
    source pixel within the kernel's effective radius (libplacebo's
    cutoff 1e-3) of its position, the source's edge pixels repeated
    beyond it, weights from the distance in source pixels (an upscale:
    the kernel is not widened)."""
    C, H, W = img.shape
    if dst_h < H or dst_w < W:
        raise ValueError("ewa: only upscaling is implemented")
    kernel = ewa_lanczos
    r_cut = cutoff_radius(kernel, JINC_ZERO3, 1e-3)
    reach = int(math.ceil(r_cut))
    f64 = dict(dtype=torch.float64, device=img.device)
    cy = (torch.arange(dst_h, **f64) + 0.5) * H / dst_h - 0.5
    cx = (torch.arange(dst_w, **f64) + 0.5) * W / dst_w - 0.5
    by, bx = torch.floor(cy), torch.floor(cx)
    num = torch.zeros((C, dst_h, dst_w), dtype=torch.float32,
                      device=img.device)
    den = torch.zeros((dst_h, dst_w), dtype=torch.float32,
                      device=img.device)
    for oy in range(-reach + 1, reach + 1):
        ry = by + oy
        iy = ry.long().clamp(0, H - 1)
        rows = img.index_select(1, iy)
        dy2 = ((ry - cy) ** 2)[:, None]
        for ox in range(-reach + 1, reach + 1):
            rx = bx + ox
            d = torch.sqrt(dy2 + ((rx - cx) ** 2)[None, :])
            w = torch.where(d <= r_cut, kernel(d), torch.zeros_like(d))
            if not bool((w != 0).any()):
                continue
            w = w.to(torch.float32)
            ix = rx.long().clamp(0, W - 1)
            num += rows.index_select(2, ix) * w
            den += w
    return num / den


def _scale_axis(img, axis: int, n_out: int, kernel, radius: float):
    """A separable filter pass along `axis`: output j is the weighted
    mean of the source samples within radius * f of its position
    (j + 0.5) * f - 0.5, f = max(1, n_in / n_out), weights
    kernel(distance / f), the edge samples repeated."""
    n_in = img.shape[axis]
    f = max(1.0, n_in / n_out)
    c = (torch.arange(n_out, dtype=torch.float64) + 0.5) * n_in / n_out - 0.5
    reach = int(math.ceil(radius * f))
    base = torch.floor(c)
    terms = []
    for o in range(-reach + 1, reach + 1):
        pos = base + o
        terms.append((pos, kernel((pos - c) / f)))
    total = sum(w for _, w in terms)
    shape = [1] * img.dim()
    shape[axis] = n_out
    out = None
    for pos, w in terms:
        if not bool((w != 0).any()):
            continue
        idx = pos.long().clamp(0, n_in - 1).to(img.device)
        wt = (w / total).to(torch.float32).to(img.device).reshape(shape)
        part = img.index_select(axis, idx) * wt
        out = part if out is None else out + part
    return out


def hermite_scale(img, dst_h: int, dst_w: int):
    """(C, H, W) -> (C, dst_h, dst_w) by the separable Hermite filter,
    rows first then columns."""
    out = _scale_axis(img, 1, dst_h, hermite, 1.0)
    return _scale_axis(out, 2, dst_w, hermite, 1.0)


# ---------------------------------------------------------------------------
# peak measurement (libplacebo's pl_shader_detect_peak)
# ---------------------------------------------------------------------------

def measure_peak(img_linear, black_cutoff: float):
    """(avg, max, share of tiles with a pixel above the cutoff) of a
    linear frame, in PQ: each pixel's brightest component as a PQ
    signal; a tile's mean over its pixels above `black_cutoff`; the mean
    of those tile means; the frame's largest PQ value.  None where no
    pixel is above the cutoff."""
    tile = 16
    pq = nits_to_pq(torch.clamp_min(img_linear.amax(dim=0), 0.0)
                    * SDR_WHITE)
    H, W = pq.shape
    th, tw = -(-H // tile), -(-W // tile)
    pad = (0, tw * tile - W, 0, th * tile - H)
    act = torch.nn.functional.pad((pq > black_cutoff).float(), pad)
    val = torch.nn.functional.pad(pq, pad) * act
    act = act.reshape(th, tile, tw, tile).sum(dim=(1, 3))
    val = val.reshape(th, tile, tw, tile).sum(dim=(1, 3))
    lit = act > 0
    n = int(lit.sum())
    if n == 0:
        return None
    avg = (val[lit] / act[lit]).sum() / n
    return (avg.float().cpu(), pq.max().float().cpu(),
            torch.tensor(n / float(th * tw)))


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

def dither(img, bits: int, bias):
    """Quantize [0, 1] values to `bits` with an ordered bias in [0, 1)
    tiled over the frame: floor(x * (2^bits - 1) + bias) / (2^bits -
    1)."""
    scale = float((1 << bits) - 1)
    return torch.floor(img * scale + bias) / scale


def tile(matrix, height: int, width: int):
    """A square matrix repeated over a (height, width) frame."""
    n = matrix.shape[0]
    reps = (-(-height // n), -(-width // n))
    return matrix.repeat(*reps)[:height, :width]


def box_420(plane):
    """A (H, W) plane halved each way by the mean of each 2x2 block."""
    H, W = plane.shape
    return plane.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))
