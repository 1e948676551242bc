// Native host-side film-grain table generation.
//
// C++ counterpart of libplacebo_tpu/core/film_grain.py (which rebuilds
// the CPU half of the reference's src/shaders/film_grain_av1.c). The AR
// filtering is inherently sequential per pixel (each output feeds later
// ones), so Python loops cost ~50 ms per seed; this implementation is
// ~1000x faster, keeping per-frame seed changes off the critical path.
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11).
//
// Bit-exact with the Python implementation (same AV1 spec arithmetic:
// LFSR taps 0/1/3/12, round2 fixed-point rounding, clamping).

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr int GRAIN_WIDTH = 82;
constexpr int GRAIN_HEIGHT = 73;
constexpr int GRAIN_WIDTH_LUT = 64;
constexpr int GRAIN_HEIGHT_LUT = 64;
constexpr int GRAIN_PAD_LUT = 9;
constexpr int SUB_GRAIN_WIDTH = 44;
constexpr int SUB_GRAIN_HEIGHT = 38;
constexpr int SUB_GRAIN_PAD_LUT = 6;

inline int get_random_number(int bits, uint16_t *state) {
    uint16_t r = *state;
    uint16_t bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    *state = (uint16_t)((r >> 1) | (bit << 15));
    return (*state >> (16 - bits)) & ((1 << bits) - 1);
}

inline int round2(int64_t x, int shift) {
    if (!shift) return (int)x;
    return (int)((x + ((int64_t)1 << (shift - 1))) >> shift);
}

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

} // namespace

extern "C" {

// gauss: int16[2048] gaussian sequence (AV1 spec table, passed from py)
// coeffs_y: int8-ish values passed as int32[24]
// out_lut: float[64*64]; out_buf: int16[73*82]
void pl_av1_grain_y(const int16_t *gauss, uint32_t seed, int bits,
                    int grain_scale_shift, int ar_coeff_lag,
                    const int32_t *ar_coeffs_y, int ar_coeff_shift,
                    float *out_lut, int16_t *out_buf) {
    int shift = 12 - bits + grain_scale_shift;
    int center = 128 << (bits - 8);
    int gmin = -center, gmax = (256 << (bits - 8)) - 1 - center;

    uint16_t state = (uint16_t)seed;
    static thread_local int32_t buf[GRAIN_HEIGHT][GRAIN_WIDTH];
    for (int y = 0; y < GRAIN_HEIGHT; y++)
        for (int x = 0; x < GRAIN_WIDTH; x++)
            buf[y][x] = round2(gauss[get_random_number(11, &state)], shift);

    const int ar_pad = 3;
    int lag = ar_coeff_lag;
    if (lag > 0) {
        for (int y = ar_pad; y < GRAIN_HEIGHT; y++) {
            for (int x = ar_pad; x < GRAIN_WIDTH - ar_pad; x++) {
                int64_t sum = 0;
                const int32_t *coeff = ar_coeffs_y;
                for (int dy = -lag; dy <= 0; dy++) {
                    for (int dx = -lag; dx <= lag; dx++) {
                        if (!dx && !dy) break;
                        sum += (int64_t)(*coeff++) * buf[y + dy][x + dx];
                    }
                }
                int grain = buf[y][x] + round2(sum, ar_coeff_shift);
                buf[y][x] = clampi(grain, gmin, gmax);
            }
        }
    }

    float grain_scale = 1.0f / ((1 << bits) - 1);
    for (int y = 0; y < GRAIN_HEIGHT_LUT; y++)
        for (int x = 0; x < GRAIN_WIDTH_LUT; x++)
            out_lut[y * GRAIN_WIDTH_LUT + x] =
                buf[y + GRAIN_PAD_LUT][x + GRAIN_PAD_LUT] * grain_scale;
    for (int y = 0; y < GRAIN_HEIGHT; y++)
        for (int x = 0; x < GRAIN_WIDTH; x++)
            out_buf[y * GRAIN_WIDTH + x] = (int16_t)buf[y][x];
}

// channel: 1 = Cb, 2 = Cr; buf_y from pl_av1_grain_y
// out_lut: float[(64>>sub_y) * (64>>sub_x)]
void pl_av1_grain_uv(const int16_t *gauss, uint32_t seed, int channel,
                     int sub_x, int sub_y, int bits, int grain_scale_shift,
                     int num_points_y, int ar_coeff_lag,
                     const int32_t *ar_coeffs_uv, int ar_coeff_shift,
                     const int16_t *buf_y, float *out_lut) {
    int shift = 12 - bits + grain_scale_shift;
    int center = 128 << (bits - 8);
    int gmin = -center, gmax = (256 << (bits - 8)) - 1 - center;

    uint16_t state = (uint16_t)seed;
    if (channel == 1) state ^= 0xb524;
    else if (channel == 2) state ^= 0x49d8;

    int chromaW = sub_x ? SUB_GRAIN_WIDTH : GRAIN_WIDTH;
    int chromaH = sub_y ? SUB_GRAIN_HEIGHT : GRAIN_HEIGHT;

    static thread_local int32_t buf[GRAIN_HEIGHT][GRAIN_WIDTH];
    std::memset(buf, 0, sizeof(buf));
    for (int y = 0; y < chromaH; y++)
        for (int x = 0; x < chromaW; x++)
            buf[y][x] = round2(gauss[get_random_number(11, &state)], shift);

    const int ar_pad = 3;
    int lag = ar_coeff_lag;
    for (int y = ar_pad; y < chromaH; y++) {
        for (int x = ar_pad; x < chromaW - ar_pad; x++) {
            int64_t sum = 0;
            const int32_t *coeff = ar_coeffs_uv;
            bool done = false;
            for (int dy = -lag; dy <= 0 && !done; dy++) {
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy) {
                        if (num_points_y) {
                            int64_t luma = 0;
                            int lx = ((x - ar_pad) << sub_x) + ar_pad;
                            int ly = ((y - ar_pad) << sub_y) + ar_pad;
                            for (int i = 0; i <= sub_y; i++)
                                for (int j = 0; j <= sub_x; j++)
                                    luma += buf_y[(ly + i) * GRAIN_WIDTH +
                                                  (lx + j)];
                            luma = round2(luma, sub_x + sub_y);
                            sum += luma * (*coeff);
                        }
                        done = true;
                        break;
                    }
                    sum += (int64_t)(*coeff++) * buf[y + dy][x + dx];
                }
            }
            int grain = buf[y][x] + round2(sum, ar_coeff_shift);
            buf[y][x] = clampi(grain, gmin, gmax);
        }
    }

    int lutW = GRAIN_WIDTH_LUT >> sub_x;
    int lutH = GRAIN_HEIGHT_LUT >> sub_y;
    int padX = sub_x ? SUB_GRAIN_PAD_LUT : GRAIN_PAD_LUT;
    int padY = sub_y ? SUB_GRAIN_PAD_LUT : GRAIN_PAD_LUT;
    float grain_scale = 1.0f / ((1 << bits) - 1);
    for (int y = 0; y < lutH; y++)
        for (int x = 0; x < lutW; x++)
            out_lut[y * lutW + x] =
                buf[y + padY][x + padX] * grain_scale;
}

// out: uint32[blocks_h * blocks_w], packed tl<<24 | t<<16 | l<<8 | n
void pl_av1_grain_offsets(uint32_t seed, int blocks_w, int blocks_h,
                          uint32_t *out) {
    for (int y = 0; y < blocks_h; y++) {
        uint16_t state = (uint16_t)seed;
        state ^= (uint16_t)(((y * 37 + 178) & 0xFF) << 8);
        state ^= (uint16_t)((y * 173 + 105) & 0xFF);
        for (int x = 0; x < blocks_w; x++) {
            uint32_t v = (uint32_t)get_random_number(8, &state);
            uint32_t vl = x ? (out[y * blocks_w + x - 1] & 0xFF) : 0;
            uint32_t vt = y ? (out[(y - 1) * blocks_w + x] & 0xFF) : 0;
            uint32_t vtl = (x && y)
                ? (out[(y - 1) * blocks_w + x - 1] & 0xFF) : 0;
            out[y * blocks_w + x] =
                (vtl << 24) | (vt << 16) | (vl << 8) | v;
        }
    }
}

} // extern "C"
