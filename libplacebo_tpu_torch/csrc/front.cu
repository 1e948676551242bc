// The front: the renderer's chroma merge, decode and PQ linearize as one
// pass from the uploaded planes to the (3, H, W) linear-light frame.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the three
// stages (render/renderer.py's _merge_planes, ops/color.py's
// decode_color and linearize) into the jitted frame step.  Eagerly, each
// of their operations is a launch of its own over the whole frame, ~90
// a frame; here it is one (ops/cuda/front.py plans and launches it).
//
// Per output pixel, for each of the three channels:
// - merge: a plane on the reference grid is read as it is; a plane the
//   merge resamples (the chroma of 4:2:0 or 4:2:2) is sampled as
//   ops/sampling.py's phased separable path samples it: per axis a
//   periodic tap pattern (_phase_plan: P phases, each a first source
//   index and its nonzero taps' offsets and weights), the two passes in
//   resize_separable's order, each tap sum in tap order with every
//   product and sum rounded on its own (core/fastmath.py::tap_sum; a
//   weight of 1 is no product), source indices clamped into the plane
//   as _edge_pad's replicated border reads them;
// - decode: each output row of the decode matrix as ops/color.py's
//   mat_pointwise runs it through core/fastmath.py::mix: its nonzero
//   terms in order, the host's decisions (which weights are 1, whether
//   there is a bias) passed with them, so the same products fuse into
//   the same sums;
// - linearize: clamp_min(0), core/transfer.py::pq_eotf_fast (pq_fast.cuh,
//   the instructions K1 runs) and the product with float32(10000 / 203).
// Built with -fmad=false and without fast-math, with every multiply-add
// the plain chain rounds once an explicit fmaf() and IEEE divides and
// square roots (but sqrt_in_range, equal to sqrtf on the fit's clamped
// range), the kernel equals the plain chain run on the card bit for bit.
//
// Work split.  A block is 128 threads over 128 neighbouring columns and
// kRows rows; a thread plans its column's taps once and then walks down
// its rows, one pixel an iteration.  Every choice that depends on the
// launch (a plane's mode, its phases and taps, a decode row's terms) is
// read from the parameters and is the same for every thread, so it costs
// no divergence; the column phase differs between neighbouring threads
// only in how many taps it sums.
//
// Bound.  A pixel reads its luma once and its chroma texels from cache
// (4 + 2 bytes at 4:2:0 from memory) and writes 12 bytes: ~149 MB at
// 3840x2160, ~45 us at 3.35 TB/s.  The plain chain's operations
// (ops/cuda/front.py::ops_per_pixel) are 183 a pixel at 4:2:0, ~23 us at
// the 67 TFLOP/s FP32 peak.  But the square roots and the divide cost
// more instructions than operations: the kernel is issue-bound
// (chip_smoke.py reads its SASS a pixel).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "pq_fast.cuh"

#if !defined(FR_NPQ) || !defined(FR_MAX_PHASES) || !defined(FR_MAX_TAPS)
#error "build through libplacebo_tpu_torch/ops/cuda/front.py"
#endif

namespace {

constexpr int kPhases = FR_MAX_PHASES, kTaps = FR_MAX_TAPS;
constexpr int kThreads = 128;    // columns a block
constexpr int kRows = 8;         // rows a block

// one axis of a resampled plane: P phases; output o = j * P + p reads
// source indices base[p] + j + off[p][k], k < ntaps[p], with weights
// w[p][k] (the nonzero taps of _phase_plan's phase p, in tap order)
struct FrontAxis {
  int phases;
  int base[kPhases];
  int ntaps[kPhases];
  int off[kPhases][kTaps];
  float w[kPhases][kTaps];
};

// a channel's plane: its size and how the merge takes it (kAsIs: on the
// reference grid; kRowsFirst / kColsFirst: resampled, the pass along H
// or along W first); ax[0] samples rows, ax[1] columns
struct FrontPlane {
  int h, w, mode;
  FrontAxis ax[2];
};
constexpr int kAsIs = 0, kRowsFirst = 1, kColsFirst = 2;

// a decode matrix row as core/fastmath.py::mix runs it: its n nonzero
// terms (channel, float32 weight) in order, `one` the terms whose weight
// is 1 (bit i), and its bias where it has one
struct FrontRow {
  int n, one, has_b;
  int chan[3];
  float w[3];
  float b;
};

struct FrontParams {
  float v[FR_NPQ];     // the PQ fit's coefficients and the scale
  FrontRow row[3];
  FrontPlane plane[3];  // by channel
};
// a kernel's parameters may hold 4096 bytes; the rest of the list is 4
// pointers and 2 ints
static_assert(sizeof(FrontParams) + 4 * 8 + 2 * 4 <= 4096,
              "the front's parameters no longer fit the kernel parameters");

#define FR(name) FR_OFF_##name

__device__ __forceinline__ float term(float x, float w) {
  return w == 1.0f ? x : __fmul_rn(x, w);
}

// an axis's taps at output index o: the clamped source indices and
// their weights; returns how many
__device__ __forceinline__ int axis_taps(const FrontAxis& a, int o, int size,
                                         int idx[kTaps], float w[kTaps]) {
  const int P = a.phases;
  const int j = P == 1 ? o : P == 2 ? o >> 1 : o / P;
  const int p = o - j * P;
  const int n = a.ntaps[p];
#pragma unroll
  for (int k = 0; k < kTaps; k++) {
    idx[k] = min(max(a.base[p] + j + a.off[p][k], 0), size - 1);
    w[k] = a.w[p][k];
  }
  return n;
}

// the tap sum of `n` taps, each read by `at(k)`
template <class F>
__device__ __forceinline__ float tap_sum(int n, const float w[kTaps], F at) {
  float acc = term(at(0), w[0]);
#pragma unroll
  for (int k = 1; k < kTaps; k++)
    if (k < n) acc = __fadd_rn(acc, term(at(k), w[k]));
  return acc;
}

// core/fastmath.py::mix of one decode row over the merged channels
__device__ __forceinline__ float mix_row(const FrontRow& r, const float x[3]) {
  if (r.n == 0) return r.has_b ? __fadd_rn(0.0f, r.b) : 0.0f;
  float acc = 0.0f, px = 0.0f, pw = 0.0f;
  bool have = false, pend = false;
#pragma unroll
  for (int i = 0; i < 3; i++) {
    if (i >= r.n) break;
    // a select, not an indexed load: x stays in registers
    const int ch = r.chan[i];
    const float xi = ch == 0 ? x[0] : ch == 1 ? x[1] : x[2], w = r.w[i];
    const bool one = (r.one >> i) & 1;
    if (!have && !pend) {
      if (one) {
        acc = xi;
        have = true;
      } else {
        px = xi;
        pw = w;
        pend = true;
      }
      continue;
    }
    if (pend) {
      if (one)
        acc = fmaf(px, pw, xi);
      else if (pw < 0.0f && 0.0f < w)
        acc = fmaf(xi, w, __fmul_rn(px, pw));
      else
        acc = fmaf(px, pw, __fmul_rn(xi, w));
      pend = false;
      have = true;
    } else if (one) {
      acc = __fadd_rn(acc, xi);
    } else {
      acc = fmaf(xi, w, acc);
    }
  }
  if (r.has_b) return pend ? fmaf(px, pw, r.b) : __fadd_rn(acc, r.b);
  return pend ? __fmul_rn(px, pw) : acc;
}

// a resampled plane's value at the output row whose taps are (ridx, rw,
// rn) and the column whose taps are (cidx, cw, cn): the two passes in the
// plane's order; `rows` holds each row tap's offset ridx * plane width
__device__ __forceinline__ float sample(const float* __restrict__ s, int mode,
                                        const int rows[kTaps],
                                        const float rw[kTaps], int rn,
                                        const int cidx[kTaps],
                                        const float cw[kTaps], int cn) {
  if (mode == kRowsFirst) {
    // the pass along H first: each needed column's vertical sum, then
    // the horizontal sum of those
    return tap_sum(cn, cw, [&](int k) {
      return tap_sum(rn, rw, [&](int t) { return s[rows[t] + cidx[k]]; });
    });
  }
  return tap_sum(rn, rw, [&](int t) {
    return tap_sum(cn, cw, [&](int k) { return s[rows[t] + cidx[k]]; });
  });
}

// decode and linearize a pixel's merged channels into the output
__device__ __forceinline__ void finish(const FrontParams& prm, const float m[3],
                                       float* __restrict__ out, int at,
                                       int plane_px) {
#pragma unroll
  for (int c = 0; c < 3; c++) {
    const float d = fmaxf(mix_row(prm.row[c], m), 0.0f);
    const float lin =
        pq_eotf_fit<FR(eotf_p), FR_N_EOTF_P, FR(eotf_t), FR_N_EOTF_T,
                    FR(eotf_p_m_c1), FR(pq_c2), FR(pq_c3)>(prm, d);
    out[c * plane_px + at] = __fmul_rn(lin, prm.v[FR(scale)]);
  }
}

// each plane taken as it is or resampled in its own mode; offsets are
// 32-bit (the wrapper refuses a frame of 2^31 pixels or more)
__global__ void __launch_bounds__(kThreads)
    front_kernel(const __grid_constant__ FrontParams prm,
                 const float* __restrict__ p0, const float* __restrict__ p1,
                 const float* __restrict__ p2, float* __restrict__ out,
                 int H, int W) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const int y0 = blockIdx.y * kRows, y1 = min(y0 + kRows, H);
  const int plane_px = H * W;
  const float* src[3] = {p0, p1, p2};
  // each plane's column taps, once a thread
  int cidx[3][kTaps];
  float cw[3][kTaps];
  int cn[3];
#pragma unroll
  for (int c = 0; c < 3; c++) {
    const FrontPlane& pl = prm.plane[c];
    cn[c] = pl.mode == kAsIs ? 0 : axis_taps(pl.ax[1], x, pl.w, cidx[c],
                                             cw[c]);
  }
#pragma unroll 1
  for (int y = y0; y < y1; y++) {
    const int at = y * W + x;
    float m[3];
#pragma unroll
    for (int c = 0; c < 3; c++) {
      const FrontPlane& pl = prm.plane[c];
      if (pl.mode == kAsIs) {
        m[c] = src[c][at];
        continue;
      }
      int rows[kTaps];
      float rw[kTaps];
      const int rn = axis_taps(pl.ax[0], y, pl.h, rows, rw);
#pragma unroll
      for (int t = 0; t < kTaps; t++) rows[t] *= pl.w;
      m[c] = sample(src[c], pl.mode, rows, rw, rn, cidx[c], cw[c], cn[c]);
    }
    finish(prm, m, out, at, plane_px);
  }
}

}  // namespace

// the bytes of FrontParams, for the wrapper's check of its mirror
extern "C" int fr_params_bytes(void) { return (int)sizeof(FrontParams); }

// one launch over a (3, H, W) frame: `params` the host FrontParams (copied
// into the launch's parameters), p0..p2 each channel's contiguous plane,
// `out` the contiguous (3, H, W) float32 result
extern "C" int fr_launch(const void* params, const float* p0, const float* p1,
                         const float* p2, float* out, int H, int W,
                         void* stream) {
  FrontParams prm;
  memcpy(&prm, params, sizeof(prm));
  const dim3 grid((W + kThreads - 1) / kThreads, (H + kRows - 1) / kRows);
  front_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(prm, p0, p1, p2,
                                                           out, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* fr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
