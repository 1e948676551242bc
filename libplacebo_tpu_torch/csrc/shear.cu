// K3: the error-diffusion shear and unshear, each a tiled relayout.
//
// Replaces libplacebo_tpu/ops/pallas/shear.py::_shear_body (reached
// through shear_to_colmaj / unshear_from_colmaj).  The wavefront
// (csrc/error_diffusion.cu) walks a sheared column-major image
// (Wsp, C, Hp) in which pixel (c, y, x) of the frame sits at column
// x + s*y:
//   forward  out[w, c, y] = img(c, y, w - s*y)  (0 unless 0 <= w-s*y < W, y < H)
//   inverse  img(c, y, x) = in[x + s*y, c, y]   (x < W, y < H)
// The forward reads the frame `img` through element strides (sc, sy,
// sx): the renderer's (C, H, W), contiguous (sx = 1, an instance of its
// own) or any view; the inverse writes a contiguous (C, H, W).  Column
// and row indices are 32-bit (the wrapper checks that the sheared width
// and s*H fit).  The reference's padded column-major (Wp, C, Hp), which
// the JAX-signature entries keep, has its own body (k3_colmaj, below).
//
// Design.  A block owns a 32-row by 128-column rectangle of the sheared
// image.  Row y of it is a run of 128 consecutive pixels of frame row y
// starting at column w0 - s*y, so with sx = 1 both sides are read and
// written contiguously.  Forward: eight warps read the 32 runs, 16
// independent 4-byte loads a lane issued before any is used (16 KB in
// flight a block), into a shared tile [row][129]; then each warp writes
// 16 sheared columns, a lane a row: one 128-byte line a column.  The
// inverse runs the other way round: each warp reads 16 sheared columns,
// a lane a row, loading only the positions that hold a pixel, and the
// warps write the runs.  The row pitch of 129 words keeps both the
// row-wise and the column-wise pass over the tile free of bank
// conflicts.  The tiles partition the sheared image, so every pixel is
// read once and written once, and the tile is 16.5 KB at any shift: no
// dynamic shared memory (k3_colmaj, which overlaps its source columns,
// needs it).  An inverse tile that holds no pixel (the
// sheared image's empty corners) returns at once.  The inverse may fold
// in error diffusion's last step, codes * (1/scale) clamped to [0, 1],
// written as float32:
// one rounded product, as ops/cuda/shear.py::unshear_chw_plain computes
// it (built with -fmad=false all the same).
//
// Bound.  Bytes, as the function needs them: at 3840x2160, s = 2
// (Wsp = 8158), forward reads 99.5 MB of float32 and writes the whole
// sheared frame, 211.5 MB: ~93 us at 3.35 TB/s; inverse reads the 49.8
// MB of int16 codes it keeps and writes 99.5 MB of float32: ~45 us.  No
// arithmetic to speak of.  (chip_smoke.py computes the bound from the
// run's shapes.)

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 32;               // tile rows: one warp's lanes
constexpr int kCols = 128;              // tile columns of the sheared image
constexpr int kWarps = 8;               // 256 threads
constexpr int kPitch = kCols + 1;       // tile row pitch, in elements
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kColsPerWarp = kCols / kWarps;
constexpr int kRuns = kCols / 32;       // a lane's loads or stores a run

struct Frame {                          // a (C, H, W) frame by strides
  long long sc, sy, sx;
};

// The frame's column stride: 1 (the renderer's frame, a compile-time
// unit stride) or f.sx.
template <bool kUnit>
__device__ __forceinline__ long long col(int x, const Frame& f) {
  return kUnit ? (long long)x : (long long)x * f.sx;
}

template <typename T, bool kUnit>
__global__ void __launch_bounds__(kWarps * 32)
k3_shear(const T* __restrict__ in, Frame f, T* __restrict__ out, int C,
         int H, int W, int Hp, int Wsp, int s) {
  __shared__ T tile[kRows * kPitch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * kCols, y0 = blockIdx.y * kRows;
  const int c = blockIdx.z;
  T v[kRowsPerWarp][kRuns];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; r++) {
    const int y = y0 + warp + kWarps * r;
    const int x0 = w0 - s * y + lane;
    const T* row = in + c * f.sc + (long long)min(y, H - 1) * f.sy;
#pragma unroll
    for (int q = 0; q < kRuns; q++) {
      const int x = x0 + 32 * q;
      v[r][q] = y < H && (unsigned)x < (unsigned)W ? row[col<kUnit>(x, f)]
                                                   : T(0);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; r++)
#pragma unroll
    for (int q = 0; q < kRuns; q++)
      tile[(warp + kWarps * r) * kPitch + lane + 32 * q] = v[r][q];
  __syncthreads();
  const int y = y0 + lane;
  if (y >= Hp) return;
  T* o = out + ((size_t)(w0 + warp) * C + c) * Hp + y;
  const size_t step = (size_t)kWarps * C * Hp;      // kWarps columns on
#pragma unroll
  for (int t = 0; t < kColsPerWarp; t++) {
    const int k = warp + kWarps * t;
    if (w0 + k < Wsp) o[t * step] = tile[lane * kPitch + k];
  }
}

// In -> Out: a copy, or for integer codes into float32 the scale and
// clip (`inv_scale` read only then).
template <typename In, typename Out>
__global__ void __launch_bounds__(kWarps * 32)
k3_unshear(const In* __restrict__ in, Out* __restrict__ out, int C, int H,
           int W, int Hp, int Wsp, int s, float inv_scale) {
  constexpr bool kScale = std::is_same<Out, float>::value &&
                          !std::is_same<In, float>::value;
  using TileT = typename std::conditional<std::is_same<In, float>::value,
                                          float, int>::type;
  __shared__ TileT tile[kRows * kPitch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // row tiles first: blocks launched one after the other read the two
  // halves of each 128-byte line of int16 codes
  const int y0 = blockIdx.x * kRows, w0 = blockIdx.y * kCols;
  const int c = blockIdx.z;
  // a tile that holds no pixel of the frame (a corner of the sheared
  // image) has nothing to do: uniform over the block
  if (w0 >= s * min(y0 + kRows - 1, H - 1) + W || w0 + kCols <= s * y0)
    return;
  const int y = y0 + lane;
  const int first = s * y;                     // the column of (y, 0)
  const In* p = in + ((size_t)(w0 + warp) * C + c) * Hp + y;
  const size_t step = (size_t)kWarps * C * Hp;      // kWarps columns on
  TileT v[kColsPerWarp];
#pragma unroll
  for (int t = 0; t < kColsPerWarp; t++) {
    const int j = w0 + warp + kWarps * t;
    const bool kept = y < H && (unsigned)(j - first) < (unsigned)W;
    v[t] = kept ? (TileT)p[t * step] : TileT(0);
  }
#pragma unroll
  for (int t = 0; t < kColsPerWarp; t++)
    tile[lane * kPitch + warp + kWarps * t] = v[t];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; r++) {
    const int yr = y0 + warp + kWarps * r;
    if (yr >= H) break;                        // uniform over the warp
    const int x0 = w0 - s * yr + lane;
    Out* row = out + ((size_t)c * H + yr) * W;
#pragma unroll
    for (int q = 0; q < kRuns; q++) {
      const int x = x0 + 32 * q;
      if ((unsigned)x >= (unsigned)W) continue;
      const TileT e = tile[(warp + kWarps * r) * kPitch + lane + 32 * q];
      if constexpr (kScale)
        row[x] = fminf(fmaxf((float)e * inv_scale, 0.0f), 1.0f);
      else
        row[x] = (Out)e;
    }
  }
}

dim3 grid_of(int Wsp, int rows, int C) {
  return dim3((Wsp + kCols - 1) / kCols, (rows + kRows - 1) / kRows, C);
}

template <typename T>
int shear(const void* in, void* out, Frame f, int C, int H, int W, int Hp,
          int Wsp, int s, cudaStream_t st) {
  auto kern = f.sx == 1 ? k3_shear<T, true> : k3_shear<T, false>;
  kern<<<grid_of(Wsp, Hp, C), kWarps * 32, 0, st>>>(
      static_cast<const T*>(in), f, static_cast<T*>(out), C, H, W, Hp, Wsp,
      s);
  return (int)cudaGetLastError();
}

template <typename In, typename Out>
int unshear(const void* in, void* out, int C, int H, int W, int Hp, int Wsp,
            int s, float inv_scale, cudaStream_t st) {
  const dim3 grid((H + kRows - 1) / kRows, (Wsp + kCols - 1) / kCols, C);
  k3_unshear<In, Out><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const In*>(in), static_cast<Out*>(out), C, H, W, Hp, Wsp,
      s, inv_scale);
  return (int)cudaGetLastError();
}

// The reference's layout: both sides column-major, (w_in, C, Hp) ->
// (w_out, C, Hp), out[w, c, y] = in[w + d*y, c, y] with d = -s (forward:
// 0 unless 0 <= w - s*y < W and y < H) or +s (inverse: 0 unless w < W
// and y < H; every position written, the pad's zeros too).  Memory is
// contiguous along y, so a warp reading one output column's 32 rows
// straight from the source would touch 32 source columns.  Instead a
// block takes 32 rows x 128 output columns and first copies the
// 128 + 31*s source columns they read into shared memory, a warp
// reading 32 rows of one source column (one 128-byte line of float32);
// then each warp writes 32 rows of one output column from the tile.
// Loads and stores coalesce and the [column][row] tile has no bank
// conflicts (the bank is the row).  Neighbouring tiles overlap by 31*s
// source columns, which L2 mostly serves; above s = 3 the float32 tile
// needs more than 48 KB of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
k3_colmaj(const T* __restrict__ in, T* __restrict__ out, int w_in,
          int w_out, int C, int Hp, int d, int W, int H, bool forward) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);     // [span][kRows]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = blockIdx.x * kRows, w0 = blockIdx.y * kCols;
  const int c = blockIdx.z;
  const int span = kCols + (kRows - 1) * (d < 0 ? -d : d);
  // the tile's first source column: min over its rows of w0 + d*y
  const int base = w0 + d * y0 + (d < 0 ? d * (kRows - 1) : 0);
  const int y = y0 + lane;
  for (int k = warp; k < span; k += kWarps) {
    const int src = base + k;
    T v = T(0);
    if (y < Hp && src >= 0 && src < w_in)
      v = in[((size_t)src * C + c) * Hp + y];
    tile[k * kRows + lane] = v;
  }
  __syncthreads();
  if (y >= Hp) return;
  for (int k = warp; k < kCols && w0 + k < w_out; k += kWarps) {
    const int w = w0 + k;
    const int src = w + d * y;
    const bool valid = y < H && (forward ? (src >= 0 && src < W) : w < W);
    out[((size_t)w * C + c) * Hp + y] =
        valid ? tile[(src - base) * kRows + lane] : T(0);
  }
}

template <typename T>
int colmaj(const void* in, void* out, bool forward, int w_in, int w_out,
           int C, int Hp, int s, int W, int H, cudaStream_t st) {
  const size_t smem = (size_t)(kCols + (kRows - 1) * s) * kRows * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k3_colmaj<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Hp + kRows - 1) / kRows, (w_out + kCols - 1) / kCols, C);
  k3_colmaj<T><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const T*>(in), static_cast<T*>(out), w_in, w_out, C, Hp,
      forward ? -s : s, W, H, forward);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 int16, 2 int32.  The frame (C, H, W) at element
// strides (sc, sy, sx); the sheared image (Wsp, C, Hp), contiguous.  The
// wrapper checks that the sheared width holds the sheared frame.
extern "C" int k3_shear_launch(const void* in, void* out, int dtype, int C,
                               int H, int W, int Hp, int Wsp, int s,
                               long long sc, long long sy, long long sx,
                               void* stream) {
  const Frame f{sc, sy, sx};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return shear<float>(in, out, f, C, H, W, Hp, Wsp, s, st);
    case 1: return shear<int16_t>(in, out, f, C, H, W, Hp, Wsp, s, st);
    case 2: return shear<int32_t>(in, out, f, C, H, W, Hp, Wsp, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The inverse: the sheared (Wsp, C, Hp) `in` of type `dtype` into a
// contiguous (C, H, W) frame, of the same type, or with `scale_out`
// float32 codes * inv_scale clamped to [0, 1] (integer codes only).
extern "C" int k3_unshear_launch(const void* in, void* out, int dtype,
                                 int scale_out, int C, int H, int W, int Hp,
                                 int Wsp, int s, float inv_scale,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 2 + (scale_out != 0)) {
    case 0:
      return unshear<float, float>(in, out, C, H, W, Hp, Wsp, s, 0.0f, st);
    case 2:
      return unshear<int16_t, int16_t>(in, out, C, H, W, Hp, Wsp, s, 0.0f,
                                       st);
    case 3:
      return unshear<int16_t, float>(in, out, C, H, W, Hp, Wsp, s,
                                     inv_scale, st);
    case 4:
      return unshear<int32_t, int32_t>(in, out, C, H, W, Hp, Wsp, s, 0.0f,
                                       st);
    case 5:
      return unshear<int32_t, float>(in, out, C, H, W, Hp, Wsp, s,
                                     inv_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The reference's layout, either way (k3_colmaj).  The wrapper checks
// that the source holds every column the mapping reads.
extern "C" int k3_colmaj_launch(const void* in, void* out, int dtype,
                                int forward, int w_in, int w_out, int C,
                                int Hp, int s, int W, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return colmaj<float>(in, out, forward, w_in, w_out, C, Hp, s, W, H,
                           st);
    case 1:
      return colmaj<int16_t>(in, out, forward, w_in, w_out, C, Hp, s, W, H,
                             st);
    case 2:
      return colmaj<int32_t>(in, out, forward, w_in, w_out, C, Hp, s, W, H,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* k3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
