// K2: the error-diffusion wavefront over a sheared column-major image,
// as a row-pipelined wavefront over many SMs.
//
// Replaces libplacebo_tpu/ops/pallas/error_diffusion.py::
// error_diffusion_pallas (`_kernel_body`).  The input (Wsp, C, Hp) float32
// comes from K3 (csrc/shear.cu): sheared column j holds pixel
// (y, j - s*y) of every row y, so every tap of the diffusion pattern lands
// on a later column (offset off = dx + dy*s >= 1).  Per column, for
// every row:
//   cur  = x[j] + pending[j];  r = rint(cur * scale)
//   err  = valid ? fma(r, -1/scale, cur) : 0   (valid: the pixel is in the image)
//   code = clip(r, 0, scale)                   (int16, or int32 above 15 bits)
//   pending[j + off] = fma(err[y - dy], wgt, pending[j + off])  per tap, in order
//
// Design.  Row y at column j needs its own errors up to column j - 1 and
// the errors of rows y - 1 and y - 2 (dy <= 2) at column j, nothing else,
// so rows need no barrier: each only has to stay behind the row above.
// - One lane a row, one warp (and block) a band of 32 rows of one
//   channel: C * ceil(Hp / 32) blocks, 204 at 4K.  Lanes past Hp carry
//   zeros through every full-mask shuffle.  Control flow is uniform over
//   the warp (no early exit, predicated stores), so the compiler emits
//   no divergence handling around the shuffles.
// - A lane's pending errors for columns j .. j + max_off - 1 (max_off <=
//   8) live in registers.  The kernel is a template over the pattern with
//   the tap table compiled in (`pattern`), so every tap is one fmaf on a
//   fixed register: no modulo, no shared memory, no local memory.
// - Any other pattern runs on one more instance, `kCustom`, whose taps
//   come with the launch (`CustomTaps`, a __grid_constant__ parameter:
//   the constant bank, uniform over the warp).  Its window is
//   kCustomSlots registers, and each slot takes the taps that land on it,
//   row y's first, then y - 1's and y - 2's (at most one a row), each
//   under a uniform test of the launch's bits: the same fmaf's in the
//   same order as a compiled pattern, at a fixed register each.
// - Rows y - 1 and y - 2 come by __shfl_up_sync.  Lanes 0 and 1 take the
//   last two rows of the band above from a global boundary buffer: 2
//   words a column, a group of kChunk = 16 columns written by the band
//   above as one 128-byte store, a word a lane.  A word is its error's
//   bits inverted, so the zero the wrapper clears the buffer to means
//   "not yet written" and every word carries its own readiness: no flag,
//   no fence, no release/acquire pair (relaxed gpu-scope loads and
//   stores; a NaN is stored canonical, 0x7fffffff, whose inverse is not
//   zero).  A band loads the next group's words a chunk ahead and spins
//   only on words still zero.  Waits go only downward and the buffer holds
//   the full width, so a band never waits on the band below.
// - Bands come from an atomic ticket, not blockIdx: a band waits only on
//   one whose block took its ticket earlier, so it is running or done,
//   whatever order blocks are scheduled in; no cooperative launch.
// - The input goes through a shared-memory ring, [column][32 rows], by
//   cp.async four column groups (64 columns) ahead, 16 bytes a lane where
//   rows are 16-byte aligned: no device-memory latency on the chain.
//   cp.async.wait_group waits only for the lane's own copies and a lane
//   reads rows other lanes copied, so a __syncwarp follows it.  The
//   codes of a chunk are staged in shared memory and stored 16 bytes a
//   lane after the chunk.  The word loads go before the chunk's copies: a
//   load made after them waits behind them.  Every sheared position is
//   written, so the whole code array equals the plain version's.
//
// Why it is exact.  Each lane does its row's arithmetic in the plain
// version's order: cur, r, err, then the window shift, then the taps in
// the reference's order (rows, then columns), each one fmaf into the
// destination's pending value.  A destination (y, j') thus receives its
// contributions in increasing source column (its window shifts one
// column a step) and, within one source column, in tap order: with
// Floyd-Steinberg (y, j+1) gets err_y(j) * 7/16, then err_{y-1}(j) * 3/16.
// The errors crossing a band boundary are the same bits (a float and its
// inverted bits).  Built with -fmad=false; the two fused multiply-adds
// are the explicit fmaf() calls where the reference's CPU result shows
// one rounding (ops/cuda/error_diffusion.py::wavefront_plain fuses the
// same two); rintf rounds half to even like jnp.round.  The code is the
// clipped float, an integer, read from the low bits of its sum with 2^23.
//
// Bound.  Bytes: the function needs each of the frame's pixels read once
// and its code written once (the zeros outside the sheared image change
// no code the unshear keeps): at 3840x2160 that is 99.5 MB of float32 and
// 49.8 MB of int16, ~45 us at 3.35 TB/s.  The walk is a chain of Wsp
// dependent column steps (8158 for Floyd-Steinberg at 4K), each add,
// multiply, round, fused error, shuffle, select and fused tap on one
// lane.  Measured on an H100 (chip_smoke.py `k2_one_band_ms`,
// `k2_fill_us_per_band`; PERF.md, K2 row): ~57 ns a step for one band
// alone, the chunk's copies, stores and word exchange included, and
// ~2.2 us of pipeline fill a band: ~0.62 ms at 4K.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kMaxTaps = 15;        // a 3 x 5 pattern
constexpr int kChunk = 16;          // columns a group, steps a chunk
constexpr int kWords = 2 * kChunk;  // boundary words a chunk, one a lane
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWords <= 32, "a chunk's words fit a warp");
constexpr int kCustom = -1;         // the instance whose taps come at launch
constexpr int kCustomSlots = 16;    // its window: sheared offsets 1 .. 16

struct Pattern {
  int shift;
  int n;
  int dy[kMaxTaps];
  int off[kMaxTaps];                // sheared column offset dx + dy*shift
  float w[kMaxTaps];
};

// `kPatterns` and `constexpr Pattern pattern(int p)`: the taps of
// core/dither.py::ERROR_DIFFUSION_KERNELS, in that order, as
// ops/cuda/error_diffusion.py::taps_for makes them, written by
// tap_table_header there into the build directory at build time.
#include "k2_taps.h"

// A pattern given at launch: its shift, and for each pending slot (the
// sheared column offset slot + 1) the weights of the taps from rows y,
// y - 1 and y - 2 that land there, bit dy of `rows` set where one does.
struct CustomTaps {
  int shift;
  int rows[kCustomSlots];
  float w[kCustomSlots][3];
};

__host__ __device__ constexpr int max_off(const Pattern& t) {
  int m = 1;
  for (int i = 0; i < t.n; i++) m = t.off[i] > m ? t.off[i] : m;
  return m;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Stores under a predicate, not a branch: the warp provably stays
// converged, so its shuffles need no divergence handling.
__device__ __forceinline__ void st_relaxed_if(unsigned* p, unsigned v,
                                              bool q) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0;"
      " @q st.relaxed.gpu.global.b32 [%0], %1; }"
      ::"l"(p), "r"(v), "r"((int)q));
}

__device__ __forceinline__ void store_if(int16_t* p, int16_t v, bool q) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0; @q st.global.b16 [%0], %1; }"
      ::"l"(p), "h"(v), "r"((int)q));
}

__device__ __forceinline__ void store_if(int32_t* p, int32_t v, bool q) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0; @q st.global.b32 [%0], %1; }"
      ::"l"(p), "r"(v), "r"((int)q));
}

// A boundary word: the error's bits inverted (never 0: NaN is stored
// canonical), so a cleared word means "not yet written".
__device__ __forceinline__ unsigned encode(float e) {
  return ~(e == e ? __float_as_uint(e) : 0x7fffffffu);
}

__device__ __forceinline__ float decode(unsigned w) {
  return __uint_as_float(~w);
}

// One tap: the destination's pending value, column j + off, in register
// off - 1 of the (already shifted) window.
template <int P, int I>
__device__ __forceinline__ void add_tap(float* p, float e0, float e1,
                                        float e2) {
  constexpr int dy = pattern(P).dy[I];
  constexpr int slot = pattern(P).off[I] - 1;
  constexpr float w = pattern(P).w[I];
  p[slot] = fmaf(dy == 0 ? e0 : (dy == 1 ? e1 : e2), w, p[slot]);
}

template <int P, int... I>
__device__ __forceinline__ void add_taps(float* p, float e0, float e1,
                                         float e2,
                                         std::integer_sequence<int, I...>) {
  (add_tap<P, I>(p, e0, e1, e2), ...);     // in the reference's tap order
}

// 16 bytes under a predicate.
__device__ __forceinline__ void store16_if(void* p, int4 v, bool q) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %5, 0;"
      " @q st.global.v4.b32 [%0], {%1, %2, %3, %4}; }"
      ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((int)q));
}

// A code from its clipped float value c (an integer in [0, 65535]): the
// low bits of c + 2^23, one add instead of a float-to-int conversion.
__device__ __forceinline__ int16_t code_of(int bits, int16_t) {
  return (int16_t)bits;
}
__device__ __forceinline__ int32_t code_of(int bits, int32_t) {
  return bits & 0x7fffff;
}

// The input ring of one band in shared memory, [column][32 rows]:
// kAhead column groups in flight ahead of the one in use.
constexpr int kXRing = 128;                 // columns, a power of two
constexpr int kAhead = 64 / kChunk;         // column groups in flight
static_assert(kChunk % 4 == 0 && kXRing % kChunk == 0,
              "whole 16-byte copies; groups do not wrap");
static_assert((kAhead + 1) * kChunk <= kXRing,
              "the input ring holds the group in use and those in flight");

// Copy column group g (kChunk columns of the band's 32 rows) into the
// input ring, zeros outside the frame: 16 bytes a lane (4 rows of one
// column) where the rows are 16-byte aligned, else 4 (the lane's row).
// One cp.async group.
__device__ __forceinline__ void fetch_group(float* ring, const float* xb,
                                            const float* x, int g, int Wsp,
                                            size_t col, int rows, bool vec,
                                            int lane) {
  if (vec) {
    const int r0 = 4 * (lane % 8);
    const int n = min(max(rows - r0, 0), 4);
#pragma unroll
    for (int t = 0; t < kChunk / 4; t++) {
      const int j = g * kChunk + lane / 8 + 4 * t;
      const bool in = j < Wsp && n > 0;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   ::"r"((unsigned)__cvta_generic_to_shared(
                         ring + (j & (kXRing - 1)) * 32 + r0)),
                   "l"(in ? xb + (size_t)j * col + r0 : x),
                   "r"(in ? 4 * n : 0));
    }
  } else {
#pragma unroll
    for (int t = 0; t < kChunk; t++) {
      const int j = g * kChunk + t;
      const bool in = j < Wsp && lane < rows;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                   ::"r"((unsigned)__cvta_generic_to_shared(
                         ring + (j & (kXRing - 1)) * 32 + lane)),
                   "l"(in ? xb + (size_t)j * col + lane : x),
                   "r"(in ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;");
}

// One warp a block, one block a band: every branch below is uniform over
// the warp (loop counts and flags from the arguments, a vote), and
// nothing exits early.
template <int P, typename CodeT>
__global__ void __launch_bounds__(32)
k2_wavefront(const float* __restrict__ x, CodeT* __restrict__ codes,
             unsigned* __restrict__ scratch, int Wsp, int C, int Hp, int W,
             int H, float scale, float minus_inv,
             const __grid_constant__ CustomTaps custom) {
  constexpr int M = P == kCustom ? kCustomSlots : max_off(pattern(P));
  const int shift = P == kCustom ? custom.shift : pattern(P).shift;
  constexpr int E = 16 / sizeof(CodeT);     // codes in 16 bytes
  __shared__ __align__(16) float xring[kXRing * 32];
  __shared__ __align__(16) CodeT cbuf[kChunk * 32];
  __shared__ float wbuf[kWords];
  __shared__ int ticket;
  const int lane = threadIdx.x;
  if (lane == 0) ticket = atomicAdd((int*)scratch, 1);
  __syncthreads();
  // channels interleaved: band b of channel c waits on ticket g - C
  const int g = ticket, nb = (Hp + 31) / 32;
  const int c = g % C, band = g / C;
  const int rows = Hp - band * 32;          // the band's rows in the frame
  const bool in_rows = band * 32 + lane < H;
  const int start = (band * 32 + lane) * shift;
  const int nk = (Wsp + kChunk - 1) / kChunk;     // column groups
  const size_t col = (size_t)C * Hp;
  const float* xb = x + (size_t)c * Hp + band * 32;
  CodeT* ob = codes + (size_t)c * Hp + band * 32;
  const bool vec_in = Hp % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_out = Hp % E == 0 && (uintptr_t)codes % 16 == 0;
  // boundary words after the ticket's 128 bytes: band b of channel c
  // writes region c * nb + b, kWords words a group, word `lane` by lane
  // `lane`; the top band reads its own region and ignores it
  const size_t region = (size_t)nk * kWords;
  unsigned* bnd = scratch + 32 + lane % kWords;
  const bool has_up = band > 0;
  const bool publish = band + 1 < nb && lane < kWords;
  const unsigned* up = bnd + ((size_t)c * nb + band - has_up) * region;
  unsigned* down = bnd + ((size_t)c * nb + band) * region;
  const unsigned none = encode(0.0f);     // rows above the image

  for (int gr = 0; gr < kAhead; gr++)
    fetch_group(xring, xb, x, gr, Wsp, col, rows, vec_in, lane);
  unsigned w_next = ld_relaxed(up);
  float p[M];
#pragma unroll
  for (int m = 0; m < M; m++) p[m] = 0.0f;

  for (int k = 0; k < nk; k++) {
    // this group's words were loaded a chunk ago; reload only while one
    // is still unwritten.  The loads go before the input copies: a load
    // made after them waits behind them.
    unsigned w = has_up ? w_next : none;
    w_next = ld_relaxed(up + (size_t)min(k + 1, nk - 1) * kWords);
    while (__any_sync(kFull, w == 0u))
      w = ld_relaxed(up + (size_t)k * kWords);
    fetch_group(xring, xb, x, k + kAhead, Wsp, col, rows, vec_in, lane);
    asm volatile("cp.async.wait_group %0;" ::"n"(kAhead));
    // wait_group covers this lane's own copies; a lane reads rows that
    // other lanes copied, so the warp meets before reading the group
    __syncwarp();
    const float bf = decode(w);
    // the chunk's columns j0 .. j0 + kChunk - 1, and which of them lie in
    // this lane's row of the image (bit i)
    const int j0 = k * kChunk;
    const float* xp = xring + (j0 & (kXRing - 1)) * 32 + lane;
    const int lo_i = min(max(start - j0, 0), kChunk);
    const int hi_i = min(max(start + W - j0, 0), kChunk);
    const unsigned in_image =
        in_rows && hi_i > lo_i ? (1u << hi_i) - (1u << lo_i) : 0u;
    float xn = xp[0];
#pragma unroll
    for (int i = 0; i < kChunk; i++) {
      const float cur = xn + p[0];
      if (i + 1 < kChunk) xn = xp[(i + 1) * 32];
      const float r = rintf(cur * scale);
      const float e0 =
          (in_image >> i) & 1u ? fmaf(r, minus_inv, cur) : 0.0f;
      cbuf[i * 32 + lane] = code_of(
          __float_as_int(fminf(fmaxf(r, 0.0f), scale) + 8388608.0f),
          CodeT());
      // rows y - 1 and y - 2 at this column; lanes 0 and 1 from the band
      // above (its rows 31 and 30)
      const float b1 = __shfl_sync(kFull, bf, 2 * i);
      const float b2 = __shfl_sync(kFull, bf, 2 * i + 1);
      const float u1 = __shfl_up_sync(kFull, e0, 1);
      const float u2 = __shfl_up_sync(kFull, e0, 2);
      const float e1 = lane == 0 ? b1 : u1;
      const float e2 = lane == 0 ? b2 : (lane == 1 ? b1 : u2);
      // for the band below: words 2i, 2i + 1 = rows 31, 30
      if (lane >= 30) wbuf[2 * i + 31 - lane] = e0;
#pragma unroll
      for (int m = 0; m + 1 < M; m++) p[m] = p[m + 1];
      p[M - 1] = 0.0f;
      if constexpr (P == kCustom) {
#pragma unroll
        for (int m = 0; m < M; m++) {
          const int r = custom.rows[m];
          if (r & 1) p[m] = fmaf(e0, custom.w[m][0], p[m]);
          if (r & 2) p[m] = fmaf(e1, custom.w[m][1], p[m]);
          if (r & 4) p[m] = fmaf(e2, custom.w[m][2], p[m]);
        }
      } else {
        add_taps<P>(p, e0, e1, e2,
                    std::make_integer_sequence<int, pattern(P).n>{});
      }
    }
    __syncwarp();
    // publish the group's boundary words, then store its codes
    st_relaxed_if(down + (size_t)k * kWords, encode(wbuf[lane % kWords]),
                  publish);
    if (vec_out) {
      const int r0 = E * (lane % (32 / E));
#pragma unroll
      for (int t = 0; t < kChunk / E; t++) {
        const int i = lane / (32 / E) + E * t;
        store16_if(ob + (size_t)(j0 + i) * col + r0,
                   *reinterpret_cast<const int4*>(cbuf + i * 32 + r0),
                   j0 + i < Wsp && r0 < rows);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; i++)
        store_if(ob + (size_t)(j0 + i) * col + lane, cbuf[i * 32 + lane],
                 j0 + i < Wsp && lane < rows);
    }
    __syncwarp();
  }
}

struct Launch {
  const float* x;
  void* codes;
  unsigned* scratch;
  int Wsp, C, Hp, W, H;
  float scale, minus_inv;
  CustomTaps custom;
  cudaStream_t st;
};

int bands(int C, int Hp) { return C * ((Hp + 31) / 32); }

template <int P, typename CodeT>
int launch(const Launch& a) {
  k2_wavefront<P, CodeT><<<bands(a.C, a.Hp), 32, 0, a.st>>>(
      a.x, static_cast<CodeT*>(a.codes), a.scratch, a.Wsp, a.C, a.Hp, a.W,
      a.H, a.scale, a.minus_inv, a.custom);
  return (int)cudaGetLastError();
}

template <typename CodeT, int... P>
int dispatch(int p, const Launch& a, std::integer_sequence<int, P...>) {
  if (p == kCustom) return launch<kCustom, CodeT>(a);
  int rc = (int)cudaErrorInvalidValue;
  ((p == P ? (rc = launch<P, CodeT>(a), 0) : 0), ...);
  return rc;
}

}  // namespace

// The scratch the wrapper clears before every launch, in 32-bit words
// (the ticket's 128 bytes, then the boundary words), and the grid.
extern "C" void k2_geometry(int Wsp, int C, int Hp, long long* words,
                            int* blocks, int* threads) {
  const long long nchunks = (Wsp + kChunk - 1) / kChunk;
  *words = 32 + (long long)bands(C, Hp) * nchunks * kWords;
  *blocks = bands(C, Hp);
  *threads = 32;
}

// `index` names the pattern in core/dither.py::ERROR_DIFFUSION_KERNELS,
// whose taps the kernel is compiled with, or is -1 for the pattern in
// `custom` (a host CustomTaps, read only for index -1).
extern "C" int k2_wavefront_launch(const float* x, void* codes,
                                   void* scratch, int int32_codes,
                                   int index, int Wsp, int C, int Hp, int W,
                                   int H, float scale, float inv_scale,
                                   const void* custom, void* stream) {
  if (index < kCustom || index >= kPatterns || Wsp < 1 || C < 1 || Hp < 1 ||
      (index == kCustom && custom == nullptr))
    return (int)cudaErrorInvalidValue;
  const Launch a{x, codes, static_cast<unsigned*>(scratch), Wsp, C, Hp, W,
                 H, scale, -inv_scale,
                 index == kCustom ? *static_cast<const CustomTaps*>(custom)
                                  : CustomTaps{},
                 (cudaStream_t)stream};
  const auto all = std::make_integer_sequence<int, kPatterns>{};
  if (int32_codes) return dispatch<int32_t>(index, a, all);
  return dispatch<int16_t>(index, a, all);
}

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
