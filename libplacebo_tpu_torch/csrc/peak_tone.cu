// The colour tail's per-frame scalars: the dynamic tone curve's vector
// and the peak state's temporal finish, each one launch of one block.
//
// Replaces no Pallas kernel.  The JAX package computes these scalars in
// plain jnp (libplacebo_tpu/ops/tone_dynamic.py::tone_params,
// libplacebo_tpu/ops/peak_detect.py::finish_from_packed), which XLA fuses
// into the jitted frame step.  Eager PyTorch launches each of their 0-dim
// operations on its own: ~130 launches a frame with the spline, ~20-30 us
// of host issue apiece, around K1's one.  Two entries take their place:
//
// pt_tone — K1's (TONE_VECTOR_LEN,) tone vector from the applied stats,
//   for each curve of ops/tone_dynamic.py (spline, bt2390, st2094-40,
//   st2094-10, the curve an argument).  With `delayed` it reads the
//   (2,) peak state and applies ops/peak_detect.py::delayed_stats' rule
//   itself (unset -> the metadata peak); else it reads (avg_pq, max_pq).
//   One thread.
// pt_finish — the new (2,) peak state from K1's (G, 8, 128) per-stripe
//   partials and the old state: the 64-bin histogram's sum, the mean of
//   the active stripes' means, the frame max, the percentile with its
//   in-bin interpolation and the IIR update with the scene-cut
//   smoothstep (ops/peak_detect.py::finish_from_partials).  It writes a
//   fresh state and never the old one: the renderer's degradation ladder
//   re-renders a frame from the state it started with.  One block of
//   kThreads.
//
// Bound.  Neither moves enough bytes or operations to count: pt_finish
// reads 268 bytes a stripe (72 KB at 4K), pt_tone 8 bytes, and each runs
// a few hundred scalar operations; what bounds them is one launch's
// latency.  The design keeps each to one launch and the finish to one
// pass over the records.
//
// Numerics.  The plain PyTorch chain (ops/tone_dynamic.py,
// ops/peak_detect.py) is the function, and this file repeats it
// operation for operation as PyTorch runs it on the card, so that the
// tone vectors agree to the last bit and the states but for one sum:
// - built with -fmad=false; a multiply-add rounds once only where the
//   chain calls core/fastmath.fma (torch.add with alpha, torch.addcmul),
//   written __fmaf_rn;
// - a Python float in the chain is a float32 constant computed on the
//   host (ops/cuda/peak_tone.py: TONE_LAYOUT, PEAK_LAYOUT); a division by
//   a host float is already a product with its float32 reciprocal there;
//   `c / t` of a host float by a tensor is torch's reciprocal times c;
//   a division of tensors is IEEE (__fdiv_rn);
// - pow_pos is expf(p * logf(max(x, 1e-36))), as core/transfer.pow_pos;
// - clamps, maxima and minima keep torch's NaN propagation;
// - the stripes' histograms, counts and maxima are exact in any order;
//   the sum of the stripe means is not: the kernel adds them in a fixed
//   order of its own (each thread's stripes in turn, the warp's lanes by
//   shuffles, the warps in turn), torch.sum in ATen's, so the frame
//   average, and the state, may differ from the chain's by a few ulps
//   (tests/test_torch_peak_tone.py states the bound).  The same partials
//   always give the same state.
// The layouts arrive as PT_* macros from the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#if !defined(PT_NTONE) || !defined(PT_NPEAK)
#error "build through libplacebo_tpu_torch/ops/cuda/peak_tone.py"
#endif

struct ToneConsts {
  float v[PT_NTONE];
};
struct PeakConsts {
  float v[PT_NPEAK];
};

#define T(name) kc.v[PT_T_##name]
#define P(name) pc.v[PT_P_##name]

constexpr int kThreads = 512;          // pt_finish's block
constexpr float kNegInf = -__builtin_huge_valf();
constexpr int kBins = PT_HIST_BINS;
constexpr int kGroups = kThreads / kBins;
static_assert(kThreads % kBins == 0, "a bin's stripes split evenly");

// -- torch's elementwise operations on one float ----------------------

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.clamp_min / torch.maximum (NaN in, NaN out)
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float tmin(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return isnan_(x) ? x : fminf(fmaxf(x, lo), hi);
}

// `c / t` for a host float c: torch's reciprocal, then the product
__device__ __forceinline__ float rdiv(float c, float t) {
  return __frcp_rn(t) * c;
}

__device__ __forceinline__ float pow_pos(float x, float p) {
  return expf(p * logf(tmax(x, 1e-36f)));
}

// -- the tone curves' scalars (ops/tone_dynamic.py) --------------------

// core/transfer.py::pq_eotf, the exact curve
__device__ __forceinline__ float pq_eotf(const ToneConsts& kc, float x) {
  x = tclamp(x, 0.0f, 1.0f);
  const float p = pow_pos(x, T(pq_inv_m2));
  const float num = tmax(p - T(pq_c1), 0.0f);
  const float den = __fmaf_rn(T(pq_neg_c3), p, T(pq_c2));
  return pow_pos(__fdiv_rn(num, den), T(pq_inv_m1));
}

__device__ __forceinline__ float nits(const ToneConsts& kc, float pq) {
  return pq_eotf(kc, pq) * 10000.0f;
}

// ops/tone_dynamic.py::_smoothstep: e0 and the reciprocal of
// e1 - e0 + 1e-12 from the host
__device__ __forceinline__ float smoothstep_knee(float e0, float r, float x) {
  const float t = tclamp((x - e0) * r, 0.0f, 1.0f);
  return (t * t) * __fmaf_rn(-2.0f, t, 3.0f);
}

// _pick_knee with src_min = 0: (src_knee, dst_knee)
__device__ __forceinline__ void pick_knee(const ToneConsts& kc, float src_max,
                                          float src_avg, float* src_knee,
                                          float* dst_knee) {
  const float knee_lo = src_max * T(knee_min);
  const float knee_hi = src_max * T(knee_max);
  const float def_knee = src_max * T(knee_def);
  float sk = src_avg > 0.0f ? src_avg : def_knee;
  sk = tmin(tmax(sk, knee_lo), knee_hi);
  const float target = __fdiv_rn(sk, tmax(src_max, 1e-6f));
  const float adapted = __fmaf_rn(T(dst_range), target, T(dst_min));
  const float tuning =
      __fmaf_rn(-smoothstep_knee(T(knee_max), T(ss_max_rcp), target),
                smoothstep_knee(T(knee_min), T(ss_min_rcp), target), 1.0f);
  const float adaptation = __fmaf_rn(T(one_m_adapt), tuning, T(adapt));
  const float dk = __fmaf_rn(adapted - sk, adaptation, sk);
  *src_knee = sk;
  *dst_knee = tclamp(dk, T(dst_knee_min), T(dst_knee_max));
}

__device__ __forceinline__ int spline(const ToneConsts& kc, float src_max,
                                      float src_avg, float* v) {
  float src_pivot, dst_pivot;
  pick_knee(kc, src_max, src_avg, &src_pivot, &dst_pivot);
  float slope = __fdiv_rn(dst_pivot - T(dst_min), tmax(src_pivot, 1e-6f));
  float ratio = __fmaf_rn(T(rcp_dst_max), src_max, -1.0f);
  ratio = tclamp(ratio * T(slope_tuning), T(slope_lo), T(slope_hi));
  slope = pow_pos(slope, ratio * T(one_m_contrast));
  const float in_min = -src_pivot;
  const float in_max = src_max - src_pivot;
  const float out_min = T(dst_min) - dst_pivot;
  const float out_max = T(dst_max) - dst_pivot;
  const float pa = __fdiv_rn(__fmaf_rn(-slope, in_min, out_min),
                             tmax(in_min * in_min, 1e-9f));
  const float t = (in_max * 2.0f) * in_max;
  const float q = __fmaf_rn(slope, in_max, -out_max);
  const float qa = __fdiv_rn(q, tmax(in_max * t, 1e-9f));
  const float qb = __fdiv_rn(q * -3.0f, tmax(t, 1e-9f));
  v[0] = src_max; v[1] = src_pivot; v[2] = dst_pivot; v[3] = pa;
  v[4] = slope; v[5] = qa; v[6] = qb; v[7] = slope;
  return 8;
}

__device__ __forceinline__ int bt2390(const ToneConsts& kc, float src_max,
                                      float* v) {
  const float rng = tmax(src_max, 1e-6f);
  const float min_lum = rdiv(T(dst_min), rng);
  const float max_lum = rdiv(T(dst_max), rng);
  const float ks = __fmaf_rn(T(one_p_offset), max_lum, T(neg_offset));
  const float bp = min_lum > 0.0f
      ? tmin(rdiv(1.0f, tmax(min_lum, 1e-9f)), 4.0f) : 4.0f;
  const float gain_inv = __fmaf_rn(
      __fdiv_rn(min_lum, tmax(max_lum, 1e-9f)),
      pow_pos(tmax(1.0f - max_lum, 0.0f), bp), 1.0f);
  const float gain = max_lum < 1.0f ? rdiv(1.0f, gain_inv) : 1.0f;
  const float one_m_ks = 1.0f - ks;
  v[0] = src_max; v[1] = rng; v[2] = min_lum; v[3] = max_lum; v[4] = ks;
  v[5] = tmax(one_m_ks, 1e-9f); v[6] = bp; v[7] = gain; v[8] = one_m_ks;
  return 9;
}

__device__ __forceinline__ int st2094_40(const ToneConsts& kc, float src_max,
                                         float src_avg, float* v) {
  const float sm = nits(kc, src_max);
  float knee_src, knee_dst;
  pick_knee(kc, src_max, src_avg, &knee_src, &knee_dst);
  const float src_knee = nits(kc, knee_src), dst_knee = nits(kc, knee_dst);
  const float lw = pow_pos(sm, T(inv_gamma));
  const float src_den = tmax(lw - T(lb0), 1e-9f);
  const float kx = tclamp(__fdiv_rn(src_knee, tmax(sm, 1e-9f)), 1e-6f, 1.0f);
  const float ky = tclamp(dst_knee * T(rcp_nits_max), 0.0f, T(ky_hi));
  const float slope = __fdiv_rn(__fdiv_rn(ky, kx) * (1.0f - kx),
                                tmax(1.0f - ky, 1e-9f));
  const float n = tclamp(ceilf(slope), 2.0f, 16.0f);
  const float p1 = tmin(__fdiv_rn(slope, n), 1.0f);
  v[0] = src_max; v[1] = src_den; v[2] = kx; v[3] = tmax(1.0f - kx, 1e-9f);
  v[4] = ky; v[5] = 1.0f - ky; v[6] = n; v[7] = n - 1.0f; v[8] = p1 - 1.0f;
  v[9] = T(lb0); v[10] = T(one_m_lb0); v[11] = T(den01); v[12] = T(lbd);
  v[13] = T(span_d);
  return 14;
}

__device__ __forceinline__ int st2094_10(const ToneConsts& kc, float src_max,
                                         float src_avg, float* v) {
  const float sm = nits(kc, src_max);
  float knee_src, knee_dst;
  pick_knee(kc, src_max, src_avg, &knee_src, &knee_dst);
  const float x2 = nits(kc, knee_src), x3 = sm;
  const float y1 = T(nits_min), y2 = nits(kc, knee_dst), y3 = T(nits_max);
  const float coef1 = ((x2 * x3) * (y2 - y3)) * y1;
  const float coef2 = (__fmaf_rn(y3, x3, -(x2 * y2)) * y1 - (x3 * y3) * y2)
      + (x2 * y2) * y3;
  const float coef3 = (((x3 - x2) * y1) - x3 * y2) + x2 * y3;
  const float k = rdiv(1.0f, (x2 * y2) * x3 - (x3 * y3) * x2);
  v[0] = src_max; v[1] = k * coef1; v[2] = k * coef2; v[3] = k * coef3;
  return 4;
}

__global__ void pt_tone(const float* __restrict__ a,
                        const float* __restrict__ b, int delayed, int curve,
                        ToneConsts kc, float* __restrict__ out) {
  float avg = *a, mx = *b;
  if (delayed) {       // delayed_stats: a = state[0], b = state[1]
    const bool unset = mx == 0.0f;
    avg = unset ? 0.0f : avg;
    mx = unset ? T(src_max_pq) : mx;
  }
  // tone_params: the input peak no lower than the output's
  const float src_max = tmax(mx, T(dst_max));
  float v[PT_VECTOR_LEN];
#pragma unroll
  for (int i = 0; i < PT_VECTOR_LEN; i++) v[i] = 0.0f;
  switch (curve) {
    case 0: spline(kc, src_max, avg, v); break;
    case 1: bt2390(kc, src_max, v); break;
    case 2: st2094_40(kc, src_max, avg, v); break;
    default: st2094_10(kc, src_max, avg, v); break;
  }
#pragma unroll
  for (int i = 0; i < PT_VECTOR_LEN; i++) out[i] = v[i];
}

// -- the peak's finish (ops/peak_detect.py) ----------------------------

// stripe g's where(active, pq_sum / max(count, 1), 0)
__device__ __forceinline__ float stripe_mean(const float* __restrict__ packed,
                                             int g) {
  const float* rec = packed + (size_t)g * PT_REC + PT_ROW1;
  const float s = rec[0], c = rec[1];
  const float m = __fdiv_rn(s, tmax(c, 1.0f));
  return c > 0.0f ? m : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
pt_finish(const float* __restrict__ packed, int G,
          const float* __restrict__ state, PeakConsts pc, int use_pct,
          int scene_cut, float* __restrict__ out) {
  __shared__ float part[kGroups][kBins];
  __shared__ int cnt_w[kThreads / 32];
  __shared__ float max_w[kThreads / 32];
  __shared__ float sum_w[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // the histogram: bin t % 64 over every kGroups-th stripe (integer
  // counts, exact in any order below 2^24)
  {
    const int bin = t % kBins;
    float h = 0.0f;
    for (int g = t / kBins; g < G; g += kGroups)
      h += packed[(size_t)g * PT_REC + bin];
    part[t / kBins][bin] = h;
  }
  // active stripes, the sum of their means and the frame max
  int cnt = 0;
  float mx = kNegInf, sm = 0.0f;
  for (int g = t; g < G; g += kThreads) {
    const float* rec = packed + (size_t)g * PT_REC + PT_ROW1;
    cnt += rec[1] > 0.0f;
    mx = tmax(mx, rec[2]);
    sm = sm + stripe_mean(packed, g);
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    mx = tmax(mx, __shfl_down_sync(0xffffffffu, mx, off));
    sm = sm + __shfl_down_sync(0xffffffffu, sm, off);
  }
  if (lane == 0) {
    cnt_w[warp] = cnt;
    max_w[warp] = mx;
    sum_w[warp] = sm;
  }
  __syncthreads();
  if (t != 0) return;

  float hist[kBins];
  float total = 0.0f;
  for (int b = 0; b < kBins; b++) {
    float h = 0.0f;
    for (int q = 0; q < kGroups; q++) h += part[q][b];
    hist[b] = h;
    total += h;
  }
  int wg = 0;
  float frame_max = kNegInf, sum = 0.0f;
  for (int w = 0; w < kThreads / 32; w++) {
    wg += cnt_w[w];
    frame_max = tmax(frame_max, max_w[w]);
    sum = sum + sum_w[w];
  }
  const float wg_count = (float)wg;
  const float frame_avg = __fdiv_rn(sum, tmax(wg_count, 1.0f));
  const float wg_bias = __fdiv_rn(wg_count, tmax((float)G, 1.0f));

  // _percentile_max
  float max_cur = frame_max;
  if (use_pct) {
    const float target = ceilf(total * P(pct));
    float csum = 0.0f, cl = 0.0f, hb = 0.0f;
    int bin = -1;
    for (int b = 0; b < kBins; b++) {
      csum += hist[b];
      if (bin < 0 && csum >= target) {
        bin = b;
        cl = csum - hist[b];
        hb = hist[b];
      }
    }
    if (bin < 0) {     // argmax of all-false picks bin 0
      bin = 0;
      cl = hist[0] - hist[0];
      hb = hist[0];
    }
    const float ch = (cl + hb) + 1.0f;
    const float pq_low =
        (float)((bin + PT_HIST_BIAS) << PT_HIST_SHIFT) * P(rcp_pq_max);
    const float pq_high0 =
        (float)((bin + 1 + PT_HIST_BIAS) << PT_HIST_SHIFT) * P(rcp_pq_max);
    const float pq_high = ch > total ? frame_max : pq_high0;
    const float ratio = __fdiv_rn(target - cl, tmax(ch - cl, 1.0f));
    const float measured = __fmaf_rn(pq_high - pq_low, ratio, pq_low);
    max_cur = total > 0.0f ? measured : frame_max;
  }
  const bool has_content = wg_count > 0.0f;
  const float avg_cur = has_content ? frame_avg : P(black);
  max_cur = has_content ? max_cur : P(black);

  // _temporal_update
  const float prev_avg = state[0], prev_max = state[1];
  const bool unset = prev_avg == 0.0f;
  const float avg_in = fabsf(avg_cur - prev_avg) < P(eps) ? prev_avg : avg_cur;
  const float max_in = fabsf(max_cur - prev_max) < P(eps) ? prev_max : max_cur;
  float avg_s = __fmaf_rn(P(coeff), avg_in - prev_avg, prev_avg);
  float max_s = __fmaf_rn(P(coeff), max_in - prev_max, prev_max);
  if (scene_cut) {
    const float delta = wg_bias * fabsf(avg_in - prev_avg);
    const float x = tclamp((delta - P(cut_lo)) * P(cut_rcp), 0.0f, 1.0f);
    const float mix = (x * x) * __fmaf_rn(-2.0f, x, 3.0f);
    avg_s = __fmaf_rn(avg_in - avg_s, mix, avg_s);
    max_s = __fmaf_rn(max_in - max_s, mix, max_s);
  }
  out[0] = unset ? avg_cur : avg_s;
  out[1] = unset ? max_cur : max_s;
}

// -- the C interface -----------------------------------------------------

extern "C" int pt_tone_launch(const void* a, const void* b, int delayed,
                              int curve, const float* consts, void* out,
                              void* stream) {
  ToneConsts kc;
  memcpy(kc.v, consts, sizeof(kc.v));
  pt_tone<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, delayed, curve, kc, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int pt_finish_launch(const void* packed, int G, const void* state,
                                const float* consts, int use_pct,
                                int scene_cut, void* out, void* stream) {
  PeakConsts pc;
  memcpy(pc.v, consts, sizeof(pc.v));
  pt_finish<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)packed, G, (const float*)state, pc, use_pct, scene_cut,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
