// K3: the error-diffusion shear and unshear, one indexed copy each way.
//
// Replaces libplacebo_tpu/ops/pallas/shear.py::_shear_body (reached
// through shear_to_colmaj / unshear_from_colmaj).  Both directions map a
// column-major (W, C, H) image to and from the sheared layout that the
// wavefront (csrc/error_diffusion.cu) walks:
//   forward  out[w, c, y] = in[w - s*y, c, y]  (0 unless 0 <= w-s*y < W, y < H)
//   inverse  out[w, c, y] = in[w + s*y, c, y]  (0 unless w < W and y < H)
// The TPU kernel decomposes the per-row shift into bit rolls inside VMEM
// because a TPU cannot gather; a GPU thread just computes its source
// address.  Both directions are out[w, c, y] = in[w + d*y, c, y] with
// d = -s (forward) or +s (inverse).  Memory is contiguous along y, and a
// warp that reads 32 rows of one output column straight from memory
// touches 32 source columns, 32 transactions for 128 bytes.  So a block takes a tile of 32 rows x 128 output columns and first
// copies the source columns it needs — 128 + 31*s of them — into shared
// memory, each warp reading 32 consecutive rows of one source column
// (one 128-byte line for f32); then each warp writes 32 consecutive rows
// of one output column from shared memory.  Loads and stores coalesce,
// and the shared-memory tile ([column][row]) is read and written
// without bank conflicts (the bank is the row).  Neighbouring tiles
// overlap by 31*s source columns, which the L2 cache mostly serves.
//
// Bound.  Memory: what the function needs read once and written once.
// At 3840x2160, s = 2, as the port pads (nothing: Wsp = 3840 + 2159*2 =
// 8158): forward reads 99.5 MB of f32 and writes the whole sheared frame,
// 211.5 MB, ~93 us at 3.35 TB/s; inverse reads only the 49.8 MB of int16
// codes it keeps and writes 49.8 MB, ~30 us.  No arithmetic to speak of.
// (chip_smoke.py computes the bound from the run's shapes.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileY = 32;    // rows per tile: one warp's lanes
constexpr int kTileW = 128;   // output columns per tile
constexpr int kWarps = 8;     // 256 threads

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
k3_shear(const T* __restrict__ in, T* __restrict__ out, int w_in, int w_out,
         int C, int Hp, int d, int W, int H, bool forward) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);     // [span][kTileY]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = blockIdx.x * kTileY, w0 = blockIdx.y * kTileW;
  const int c = blockIdx.z;
  const int ad = d < 0 ? -d : d;
  const int span = kTileW + (kTileY - 1) * ad;
  // first source column of the tile: min over its rows of w0 + d*y
  const int base = w0 + d * y0 + (d < 0 ? d * (kTileY - 1) : 0);
  const int y = y0 + lane;
  for (int k = warp; k < span; k += kWarps) {
    const int src = base + k;
    T v = T(0);
    if (y < Hp && src >= 0 && src < w_in)
      v = in[((size_t)src * C + c) * Hp + y];
    tile[k * kTileY + lane] = v;
  }
  __syncthreads();
  if (y >= Hp) return;
  for (int k = warp; k < kTileW && w0 + k < w_out; k += kWarps) {
    const int w = w0 + k;
    const int src = w + d * y;
    const bool valid = y < H && (forward ? (src >= 0 && src < W) : w < W);
    out[((size_t)w * C + c) * Hp + y] =
        valid ? tile[(src - base) * kTileY + lane] : T(0);
  }
}

template <typename T>
int launch(const void* in, void* out, bool forward, int w_in, int w_out,
           int C, int Hp, int s, int W, int H, cudaStream_t st) {
  const size_t smem = (size_t)(kTileW + (kTileY - 1) * s) * kTileY *
                      sizeof(T);
  if (smem > 48 * 1024) {     // s > 3: above the default limit
    cudaError_t err = cudaFuncSetAttribute(
        k3_shear<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Hp + kTileY - 1) / kTileY,
                  (w_out + kTileW - 1) / kTileW, C);
  k3_shear<T><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const T*>(in), static_cast<T*>(out), w_in, w_out, C, Hp,
      forward ? -s : s, W, H, forward);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 int16, 2 int32.  The wrapper checks that the
// source holds every column the mapping reads.
extern "C" int k3_shear_launch(const void* in, void* out, int dtype,
                               int forward, int w_in, int w_out, int C,
                               int Hp, int s, int W, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(in, out, forward, w_in, w_out, C, Hp, s, W, H,
                           st);
    case 1:
      return launch<int16_t>(in, out, forward, w_in, w_out, C, Hp, s, W, H,
                             st);
    case 2:
      return launch<int32_t>(in, out, forward, w_in, w_out, C, Hp, s, W, H,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* k3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
