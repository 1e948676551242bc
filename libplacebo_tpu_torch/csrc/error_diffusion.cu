// K2: the error-diffusion wavefront over a sheared column-major image.
//
// Replaces libplacebo_tpu/ops/pallas/error_diffusion.py::
// error_diffusion_pallas (`_kernel_body`).  The input (Wsp, C, Hp) float32
// comes from K3 (csrc/shear.cu): sheared column j holds pixel
// (y, j - s*y) of every row y, so each tap of the diffusion pattern lands
// on a later column and the rows of one column are independent.  Per
// column, for every row:
//   cur  = x[j] + pending[j];  r = rint(cur * scale)
//   err  = valid ? fma(r, -1/scale, cur) : 0   (valid: the pixel is in the image)
//   code = clip(r, 0, scale)                   (int16, or int32 above 15 bits)
//   pending[j + off] = fma(err[y - dy], wgt, pending[j + off])  per tap, in order
//
// What the TPU kernel relied on and this one cannot: a sequential grid
// carrying the pending-error scratch from one grid step to the next.
// Hopper blocks run in no order, so the whole walk lives in one block:
// one block per channel (the channels are independent), 1024 threads
// over the rows, each owning rows t, t+1024, ... (up to 8).  The pending
// errors are a ring of `max_off` rows of Hp floats in shared memory, each
// entry only ever touched by the thread owning its row; with the two
// error rows below, (max_off + 2) * Hp floats: 43 KB for Floyd-Steinberg
// at Hp = 2160, 86 KB for the s = 3 kernels (above 48 KB through the
// dynamic shared-memory attribute).  The errors of a column
// go to a shared buffer; after one barrier each thread *pulls* into its
// own rows the contributions wgt * err[y - dy], in the reference's tap
// order, so every destination sees the same float additions in the same
// order as the reference and there are no write races.  The error buffer
// is doubled (column parity), so one barrier per column suffices: a
// column's buffer is written again two columns later, after every thread
// has passed the next barrier.  Each thread loads its rows of the next
// column into registers before working on the current one, so the
// global load's latency overlaps the column's work.
//
// Numerics.  Built with -fmad=false; the two fused multiply-adds are the
// explicit fmaf() calls where the reference's CPU result shows one
// rounding (ops/cuda/error_diffusion.py::wavefront_plain fuses the same
// two); rintf rounds half to even like jnp.round.  Bit-exact against the
// plain version.
//
// Bound.  Bytes: the function needs each of the frame's pixels read once
// and its code written once (the zeros outside the sheared image change
// no code the unshear keeps): at 3840x2160 that is 99.5 MB of float32 and
// 49.8 MB of int16, ~45 us at 3.35 TB/s.  The kernel itself walks the
// whole sheared frame, Floyd-Steinberg (s = 2) as the port pads it
// (Wsp = 3840 + 2159*2 = 8158, Hp = 2160): 211.5 MB + 105.7 MB.  And the
// walk is a dependency chain of 8158 column steps,
// each with a barrier, a shared-memory round trip and a global load
// (prefetched one column ahead), on 3 SMs: at ~1-3 us a step a 4K frame
// takes ~10-25 ms, far from its byte bound.  Spreading rows over more SMs
// and prefetching further ahead are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K2_MAX_TAPS
#error "build through libplacebo_tpu_torch/ops/cuda/error_diffusion.py"
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 8;       // rows per thread: Hp <= 8192

struct Taps {
  int n;
  int max_off;
  int dy[K2_MAX_TAPS];
  int off[K2_MAX_TAPS];
  float w[K2_MAX_TAPS];
};

template <typename CodeT>
__global__ void __launch_bounds__(kThreads, 1)
k2_wavefront(const float* __restrict__ x, CodeT* __restrict__ codes,
             int Wsp, int C, int Hp, int W, int H, int shift, float scale,
             float inv_scale, Taps taps) {
  extern __shared__ float smem[];
  const int M = taps.max_off;
  float* pend = smem;                // M rings of Hp: column k at k % M
  float* errs = smem + M * Hp;       // 2 buffers of Hp: column parity
  const size_t col = (size_t)C * Hp;
  const float* xc = x + (size_t)blockIdx.x * Hp;
  CodeT* oc = codes + (size_t)blockIdx.x * Hp;

  for (int i = threadIdx.x; i < M * Hp; i += kThreads) pend[i] = 0.0f;
  float xn[kMaxRows];
#pragma unroll
  for (int k = 0; k < kMaxRows; k++) {
    const int y = threadIdx.x + k * kThreads;
    xn[k] = y < Hp ? xc[y] : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < Wsp; j++) {
    float xv[kMaxRows];
#pragma unroll
    for (int k = 0; k < kMaxRows; k++) {
      const int y = threadIdx.x + k * kThreads;
      xv[k] = xn[k];
      if (y < Hp && j + 1 < Wsp) xn[k] = xc[(size_t)(j + 1) * col + y];
    }
    float* e = errs + (j & 1) * Hp;
    float* p0 = pend + (j % M) * Hp;
#pragma unroll
    for (int k = 0; k < kMaxRows; k++) {
      const int y = threadIdx.x + k * kThreads;
      if (y < Hp) {
        const float cur = xv[k] + p0[y];
        const float r = rintf(cur * scale);
        const int start = y * shift;
        const bool valid = j >= start && j < start + W && y < H;
        e[y] = valid ? fmaf(r, -inv_scale, cur) : 0.0f;
        oc[(size_t)j * col + y] = (CodeT)fminf(fmaxf(r, 0.0f), scale);
        p0[y] = 0.0f;      // the slot now holds column j + M
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxRows; k++) {
      const int y = threadIdx.x + k * kThreads;
      if (y < Hp) {
        for (int t = 0; t < taps.n; t++) {
          const int dy = taps.dy[t];
          const float ev = y >= dy ? e[y - dy] : 0.0f;
          float* pd = pend + ((j + taps.off[t]) % M) * Hp + y;
          *pd = fmaf(ev, taps.w[t], *pd);
        }
      }
    }
  }
}

template <typename CodeT>
int launch(const float* x, void* codes, int Wsp, int C, int Hp, int W,
           int H, int shift, float scale, float inv_scale, const Taps& taps,
           cudaStream_t st) {
  const size_t smem = (size_t)(taps.max_off + 2) * Hp * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k2_wavefront<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  k2_wavefront<CodeT><<<C, kThreads, smem, st>>>(
      x, static_cast<CodeT*>(codes), Wsp, C, Hp, W, H, shift, scale,
      inv_scale, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// Taps come as host arrays (dy, sheared column offset >= 1, weight), in
// the reference's order.
extern "C" int k2_wavefront_launch(const float* x, void* codes,
                                   int int32_codes, int Wsp, int C, int Hp,
                                   int W, int H, int shift, int n_taps,
                                   const int* dys, const int* offs,
                                   const float* wgts, float scale,
                                   float inv_scale, void* stream) {
  if (n_taps < 1 || n_taps > K2_MAX_TAPS || Hp > kThreads * kMaxRows)
    return (int)cudaErrorInvalidValue;
  Taps taps{};
  taps.n = n_taps;
  taps.max_off = 1;
  for (int i = 0; i < n_taps; i++) {
    if (offs[i] < 1 || dys[i] < 0 || dys[i] > 2)
      return (int)cudaErrorInvalidValue;
    taps.dy[i] = dys[i];
    taps.off[i] = offs[i];
    taps.w[i] = wgts[i];
    if (offs[i] > taps.max_off) taps.max_off = offs[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (int32_codes)
    return launch<int32_t>(x, codes, Wsp, C, Hp, W, H, shift, scale,
                           inv_scale, taps, st);
  return launch<int16_t>(x, codes, Wsp, C, Hp, W, H, shift, scale,
                         inv_scale, taps, st);
}

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
