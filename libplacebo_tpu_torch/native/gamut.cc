// Native gamut-mapping 3DLUT generation (host side).
//
// C++ rebuild of the hot path behind core/gamut_mapping.py `generate`
// (reference: pl_gamut_map_generate, src/gamut_mapping.c:412 — the
// reference implements exactly this in native C).  The Python module
// stays the source of truth for semantics; this file re-implements the
// same algorithms scalar-per-entry with the reference's 1-item per-hue
// peak cache (gamut_mapping.c:263,513), which the vectorized numpy
// formulation cannot express.  Grid layout: (Nh, NC, NI, 3), I fastest
// — identical to the Python generate().
//
// Math is double precision to match the numpy implementation; only the
// final store narrows to float32.

#include <cmath>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// PQ constants (ST 2084)
constexpr double M1 = 2610.0 / 16384;
constexpr double M2 = 2523.0 / 4096 * 128;
constexpr double C1 = 3424.0 / 4096;
constexpr double C2 = 2413.0 / 4096 * 32;
constexpr double C3 = 2392.0 / 4096 * 32;

inline double pq_eotf(double x) {
    x = std::min(std::max(x, 0.0), 1.0);
    double p = std::pow(x, 1.0 / M2);
    return std::pow(std::max(p - C1, 0.0) / (C2 - C3 * p), 1.0 / M1);
}

inline double pq_oetf(double y) {
    double p = std::pow(std::max(y, 0.0), M1);
    return std::pow((C1 + C2 * p) / (1.0 + C3 * p), M2);
}

inline double smoothstep(double e0, double e1, double x) {
    double t = (x - e0) / (e1 - e0);
    t = std::min(std::max(t, 0.0), 1.0);
    return t * t * (3.0 - 2.0 * t);
}

// Ebner & Fairchild LMS' <-> IPT (same constants as the Python module)
constexpr double LMS2IPT[9] = {
    0.4000,  0.4000,  0.2000,
    4.4550, -4.8510,  0.3960,
    0.8056,  0.3572, -1.1628,
};
constexpr double IPT2LMS[9] = {
    1.0,  0.0975689,  0.205226,
    1.0, -0.1138760,  0.133217,
    1.0,  0.0326151, -0.676887,
};

inline void mat3(const double m[9], const double v[3], double o[3]) {
    o[0] = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
    o[1] = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
    o[2] = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
}

struct ICh { double I, C, h; };
struct IPT { double I, P, T; };
struct RGB { double R, G, B; };

struct Gamut {
    double rgb2lms[9];
    double lms2rgb[9];
    double min_luma, max_luma;     // PQ-encoded
    double min_rgb, max_rgb;       // linear (pq_eotf of the above +- eps)
    // 1-item saturate() cache (reference gamut_mapping.c:263): LUT
    // entries iterate I fastest, so consecutive entries share the hue
    ICh peak_cache{0.0, 0.0, 0.0};
    bool cache_valid = false;
};

inline IPT ich2ipt(const ICh &c) {
    return {c.I, c.C * std::cos(c.h), c.C * std::sin(c.h)};
}

inline ICh ipt2ich(const IPT &c) {
    return {c.I, std::hypot(c.P, c.T), std::atan2(c.T, c.P)};
}

inline RGB ipt2rgb(const IPT &c, const Gamut &g) {
    double iptv[3] = {c.I, c.P, c.T}, lmsp[3], lms[3], rgb[3];
    mat3(IPT2LMS, iptv, lmsp);
    lms[0] = pq_eotf(lmsp[0]);
    lms[1] = pq_eotf(lmsp[1]);
    lms[2] = pq_eotf(lmsp[2]);
    mat3(g.lms2rgb, lms, rgb);
    return {rgb[0], rgb[1], rgb[2]};
}

inline IPT rgb2ipt(const RGB &c, const Gamut &g) {
    double rgb[3] = {c.R, c.G, c.B}, lms[3], lmsp[3], ipt[3];
    mat3(g.rgb2lms, rgb, lms);
    lmsp[0] = pq_oetf(lms[0]);
    lmsp[1] = pq_oetf(lms[1]);
    lmsp[2] = pq_oetf(lms[2]);
    mat3(LMS2IPT, lmsp, ipt);
    return {ipt[0], ipt[1], ipt[2]};
}

inline bool ingamut(const IPT &c, const Gamut &g) {
    double iptv[3] = {c.I, c.P, c.T}, lmsp[3], lms[3], rgb[3];
    mat3(IPT2LMS, iptv, lmsp);
    for (int i = 0; i < 3; i++)
        if (lmsp[i] < g.min_luma || lmsp[i] > g.max_luma)
            return false;
    lms[0] = pq_eotf(lmsp[0]);
    lms[1] = pq_eotf(lmsp[1]);
    lms[2] = pq_eotf(lmsp[2]);
    mat3(g.lms2rgb, lms, rgb);
    for (int i = 0; i < 3; i++)
        if (rgb[i] < g.min_rgb || rgb[i] > g.max_rgb)
            return false;
    return true;
}

constexpr int BISECT_ITERS = 20;
constexpr int GOLDEN_ITERS = 22;

// Bisect for the gamut boundary chroma at (I, h); matches the Python
// _desat_bounded exactly (returns the proven-inside bound, clamps at
// the luma extremes).
ICh desat_bounded(double I, double h, double Cmin, double Cmax,
                  const Gamut &g) {
    double lo = Cmin, hi = Cmax;
    double ch = std::cos(h), sh = std::sin(h);
    for (int it = 0; it < BISECT_ITERS; it++) {
        double C = (lo + hi) / 2;
        IPT test{I, C * ch, C * sh};
        if (ingamut(test, g)) lo = C; else hi = C;
    }
    double C = lo;
    if (I <= g.min_luma || I >= g.max_luma)
        C = 0.0;
    double I_out = std::min(std::max(I, g.min_luma), g.max_luma);
    return {I_out, C, h};
}

// Maximally saturated in-gamut color for a hue; golden-section over I
// (Python _saturate), with the reference's 1-item hue cache.
ICh saturate(double hue, Gamut &g) {
    if (g.cache_valid && std::fabs(g.peak_cache.h - hue) < 1e-3)
        return g.peak_cache;
    constexpr double invphi = 0.6180339887498948;
    constexpr double invphi2 = 0.38196601125010515;
    double lo = g.min_luma, hi = g.max_luma;
    double de = hi - lo;
    ICh a = desat_bounded(lo + invphi2 * de, hue, 0.0, 0.5, g);
    ICh b = desat_bounded(lo + invphi * de, hue, 0.0, 0.5, g);
    for (int it = 0; it < GOLDEN_ITERS; it++) {
        de *= invphi;
        if (a.C > b.C) {
            ICh probe = desat_bounded(lo + invphi2 * de, hue, 0.0, 0.5, g);
            b = a;
            a = probe;
        } else {
            lo = a.I;
            ICh probe = desat_bounded(lo + invphi * de, hue, 0.0, 0.5, g);
            a = b;
            b = probe;
        }
    }
    ICh peak = (a.C > b.C) ? a : b;
    g.peak_cache = peak;
    g.cache_valid = true;
    return peak;
}

// Mobius soft clip; matches Python _softclip_scalar (incl. guards).
double softclip(double value, double source, double target, double knee) {
    if (target == 0.0)
        return 0.0;
    double peak = source / target;
    double x = std::min(value / target, peak);
    double j = knee;
    if (x <= j || peak <= 1.0)
        return value;
    double denom_a = j * j - 2.0 * j + peak;
    if (std::fabs(denom_a) < 1e-12)
        denom_a = 1e-12;
    double a = -j * j * (peak - 1.0) / denom_a;
    double b = (j * j - 2.0 * j * peak + peak) / std::max(1e-6, peak - 1.0);
    double scale = (b * b + 2.0 * b * j + j * j) / (b - a);
    return scale * (x + a) / (x + b) * target;
}

// Clip along exponential curves toward the per-hue peak (Python
// _clip_gamma / reference clip_gamma, gamut_mapping.c:548).
IPT clip_gamma(const IPT &ipt, double gamma, Gamut &g) {
    if (ipt.I <= g.min_luma)
        return {g.min_luma, 0.0, 0.0};
    if (ingamut(ipt, g))
        return ipt;
    ICh ich = ipt2ich(ipt);
    if (gamma == 0.0)
        return ich2ipt(desat_bounded(ich.I, ich.h, 0.0,
                                     std::max(ich.C, 1e-9), g));
    ICh peak = saturate(ich.h, g);
    // Python _scale_gamma
    double Irel = std::max((ich.I - g.min_luma) / (peak.I - g.min_luma),
                           0.0);
    double gs = gamma * Irel * Irel * Irel *
                std::min(ich.C / std::max(peak.C, 1e-9), 1.0);
    double lo = 0.0, hi = 1.0, x = 0.5;
    for (int it = 0; it < BISECT_ITERS; it++) {
        double I = peak.I + (ich.I - peak.I) * std::pow(std::max(x, 0.0), gs);
        IPT test = ich2ipt({I, ich.C * x, ich.h});
        if (ingamut(test, g)) lo = x; else hi = x;
        x = (lo + hi) / 2;
    }
    double I = peak.I + (ich.I - peak.I) * std::pow(std::max(x, 0.0), gs);
    return ich2ipt({I, ich.C * x, ich.h});
}

// Natural-cubic hue-shift spline between gamuts (Python
// _hueshift_prepare/_hueshift_apply; reference gamut_mapping.c:628,682).
struct HueShift {
    static constexpr int S = 12;
    static constexpr int N = S + 2;
    double hues[N], deltas[N], dh[N], dddh[N], K[N];
};

void hueshift_prepare(HueShift &hs, const Gamut &src, const Gamut &dst) {
    constexpr int S = HueShift::S;
    constexpr int N = HueShift::N;
    double O = pq_eotf(src.min_luma);
    double X = pq_eotf(src.max_luma);
    double M = (O + X) / 2.0;
    const double ref[S][3] = {
        {X, O, O}, {O, X, O}, {O, O, X},
        {O, X, X}, {X, O, X}, {X, X, O},
        {O, X, M}, {X, O, M}, {X, M, O},
        {O, M, X}, {M, O, X}, {M, X, O},
    };
    double hs_src[S], delta[S];
    for (int i = 0; i < S; i++) {
        RGB rgb{ref[i][0], ref[i][1], ref[i][2]};
        ICh cs = ipt2ich(rgb2ipt(rgb, src));
        ICh cd = ipt2ich(rgb2ipt(rgb, dst));
        double d = cd.h - cs.h;
        if (d > kPi) d -= 2 * kPi;
        else if (d < -kPi) d += 2 * kPi;
        hs_src[i] = cs.h;
        delta[i] = d;
    }
    // stable sort by source hue
    int order[S];
    for (int i = 0; i < S; i++) order[i] = i;
    std::stable_sort(order, order + S, [&](int a, int b) {
        return hs_src[a] < hs_src[b];
    });
    for (int i = 0; i < S; i++) {
        hs.hues[i + 1] = hs_src[order[i]];
        hs.deltas[i + 1] = delta[order[i]];
    }
    hs.hues[0] = hs.hues[S] - 2 * kPi;
    hs.deltas[0] = hs.deltas[S];
    hs.hues[S + 1] = hs.hues[1] + 2 * kPi;
    hs.deltas[S + 1] = hs.deltas[1];

    std::memset(hs.dh, 0, sizeof(hs.dh));
    std::memset(hs.dddh, 0, sizeof(hs.dddh));
    for (int i = N - 1; i > 0; i--) {
        hs.dh[i - 1] = hs.hues[i] - hs.hues[i - 1];
        hs.dddh[i] = (hs.deltas[i] - hs.deltas[i - 1]) / hs.dh[i - 1];
    }
    // natural cubic spline via gaussian elimination (same steps as the
    // Python port)
    double tmp[N][N];
    std::memset(tmp, 0, sizeof(tmp));
    for (int i = 1; i < N - 1; i++) {
        tmp[i][i] = 2 * (hs.dh[i - 1] + hs.dh[i]);
        if (i != 1) {
            tmp[i][i - 1] = hs.dh[i - 1];
            tmp[i - 1][i] = hs.dh[i - 1];
        }
        tmp[i][N - 1] = 6 * (hs.dddh[i + 1] - hs.dddh[i]);
    }
    for (int i = 1; i < N - 2; i++) {
        double q = tmp[i + 1][i] / tmp[i][i];
        for (int j = 1; j < N; j++)
            tmp[i + 1][j] -= q * tmp[i][j];
    }
    std::memset(hs.K, 0, sizeof(hs.K));
    for (int i = N - 2; i > 0; i--) {
        double s = 0.0;
        for (int j = i; j < N - 1; j++)
            s += tmp[i][j] * hs.K[j];
        hs.K[i] = (tmp[i][N - 1] - s) / tmp[i][i];
    }
}

double hueshift_apply(const HueShift &hs, double h) {
    constexpr int N = HueShift::N;
    // first interval i with hues[i] <= h < hues[i+1] (searchsorted-right
    // minus one, clipped — matches the Python _hueshift_apply)
    int idx = 0;
    for (int i = 0; i < N; i++) {
        if (hs.hues[i] <= h) idx = i; else break;
    }
    if (h < hs.hues[0]) idx = 0;
    idx = std::min(std::max(idx, 0), N - 2);
    double a = (hs.K[idx + 1] - hs.K[idx]) / (6 * hs.dh[idx]);
    double b = hs.K[idx] / 2;
    double c = hs.dddh[idx + 1] -
               (2 * hs.dh[idx] * hs.K[idx] + hs.K[idx + 1] * hs.dh[idx]) / 6;
    double d = hs.deltas[idx];
    double x = h - hs.hues[idx];
    double delta = ((a * x + b) * x + c) * x + d;
    return h + delta;
}

struct Consts {
    double gamma, knee, desat, deadzone, strength;
};

enum Op {
    OP_CLIP = 0, OP_PERCEPTUAL, OP_SOFTCLIP, OP_RELATIVE, OP_SATURATION,
    OP_ABSOLUTE, OP_DESATURATE, OP_DARKEN, OP_HIGHLIGHT, OP_LINEAR,
};

IPT map_one(int op, const IPT &ipt, const Consts &c, Gamut &src, Gamut &dst,
            Gamut &src_post, Gamut &dst_post, const HueShift *hs,
            const double *adapt, double darken_gain, double linear_gain) {
    switch (op) {
    case OP_CLIP:
        return ipt;
    case OP_PERCEPTUAL: {
        ICh ich = ipt2ich(ipt);
        ICh sp = saturate(ich.h, src);
        ICh dp = saturate(ich.h, dst);
        IPT mapped = rgb2ipt(ipt2rgb(ipt, src), dst);
        double maxC = std::max(sp.C, dp.C);
        double k = smoothstep(c.deadzone, 1.0,
                              ich.C / std::max(maxC, 1e-9)) * c.strength;
        IPT m{ipt.I + (mapped.I - ipt.I) * k,
              ipt.P + (mapped.P - ipt.P) * k,
              ipt.T + (mapped.T - ipt.T) * k};
        RGB rgb = ipt2rgb(m, dst);
        double maxRGB = std::max(rgb.R, std::max(rgb.G, rgb.B));
        rgb.R = std::max(softclip(rgb.R, maxRGB, dst.max_rgb, c.knee),
                         dst.min_rgb);
        rgb.G = std::max(softclip(rgb.G, maxRGB, dst.max_rgb, c.knee),
                         dst.min_rgb);
        rgb.B = std::max(softclip(rgb.B, maxRGB, dst.max_rgb, c.knee),
                         dst.min_rgb);
        return rgb2ipt(rgb, dst);
    }
    case OP_SOFTCLIP: {
        if (ipt.I <= dst.min_luma)
            return {ipt.I, 0.0, 0.0};
        ICh ich = ipt2ich(ipt);
        if (ich.C <= 1e-2)
            return ipt;
        double I = ich.I, h = ich.h, C = ich.C;
        double shifted = hueshift_apply(*hs, h);
        bool has_shift = std::fabs(shifted - h) >= 1e-3;
        double h_new = h, margin = 1.0;
        Gamut *s = &src, *d = &dst;
        if (has_shift) {
            ICh src_border = desat_bounded(I, h, 0.0, 0.5, src);
            ICh dst_border = desat_bounded(I, h, 0.0, 0.5, dst);
            double k = smoothstep(dst_border.C * c.knee,
                                  std::max(src_border.C, 1e-9), C);
            h_new = h + (shifted - h) * k;
            // separate caches after the shift (reference softclip_map)
            s = &src_post;
            d = &dst_post;
            ICh shift_border = desat_bounded(I, h_new, 0.0, 0.5, *s);
            margin = std::max(1.0, src_border.C /
                                       std::max(shift_border.C, 1e-9));
        }
        ICh source = saturate(h_new, *s);
        ICh target = saturate(h_new, *d);
        ICh border = desat_bounded(I, h_new, 0.0, target.C, *d);
        double chromaticity =
            target.C + (border.C - target.C) * c.desat;
        double C_new = softclip(C, margin * source.C, chromaticity, c.knee);
        RGB peak = ipt2rgb(ich2ipt({I, chromaticity, h_new}), *d);
        RGB rgb = ipt2rgb(ich2ipt({I, C_new, h_new}), *d);
        rgb.R = std::max(softclip(rgb.R, peak.R, d->max_rgb, c.knee),
                         d->min_rgb);
        rgb.G = std::max(softclip(rgb.G, peak.G, d->max_rgb, c.knee),
                         d->min_rgb);
        rgb.B = std::max(softclip(rgb.B, peak.B, d->max_rgb, c.knee),
                         d->min_rgb);
        return rgb2ipt(rgb, *d);
    }
    case OP_RELATIVE:
        return clip_gamma(ipt, c.gamma, dst);
    case OP_SATURATION:
        return rgb2ipt(ipt2rgb(ipt, src), dst);
    case OP_ABSOLUTE: {
        RGB rgb = ipt2rgb(ipt, dst);
        double v[3] = {rgb.R, rgb.G, rgb.B}, o[3];
        mat3(adapt, v, o);
        IPT a = rgb2ipt({o[0], o[1], o[2]}, dst);
        return clip_gamma(a, c.gamma, dst);
    }
    case OP_DESATURATE:
        return clip_gamma(ipt, 0.0, dst);
    case OP_DARKEN: {
        RGB rgb = ipt2rgb(ipt, dst);
        IPT a = rgb2ipt({rgb.R * darken_gain, rgb.G * darken_gain,
                         rgb.B * darken_gain}, dst);
        return clip_gamma(a, c.gamma, dst);
    }
    case OP_HIGHLIGHT: {
        if (ingamut(ipt, dst))
            return ipt;
        return {std::min(ipt.I + 0.1, 1.0),
                std::min(std::max(-1.2 * ipt.P, -0.5), 0.5),
                std::min(std::max(-1.2 * ipt.T, -0.5), 0.5)};
    }
    case OP_LINEAR: {
        ICh ich = ipt2ich(ipt);
        ich.C *= linear_gain;
        return ich2ipt(ich);
    }
    }
    return ipt;
}

} // namespace

extern "C" int plg_gamut_generate(
    int op,
    const double *src_rgb2lms, const double *src_lms2rgb,
    const double *dst_rgb2lms, const double *dst_lms2rgb,
    const double *adapt,                  // 3x3 (absolute); else identity
    double min_luma, double max_luma,     // PQ-encoded
    const double *consts,                 // gamma,knee,desat,deadzone,strength
    int NI, int NC, int Nh,
    float *out)                           // (Nh, NC, NI, 3)
{
    if (op < 0 || op > OP_LINEAR || NI < 1 || NC < 1 || Nh < 1)
        return -1;
    Consts c{consts[0], consts[1], consts[2], consts[3], consts[4]};

    auto make_gamut = [&](const double *r2l, const double *l2r) {
        Gamut g;
        std::memcpy(g.rgb2lms, r2l, sizeof(g.rgb2lms));
        std::memcpy(g.lms2rgb, l2r, sizeof(g.lms2rgb));
        g.min_luma = min_luma;
        g.max_luma = max_luma;
        constexpr double eps = 1e-6;
        g.min_rgb = pq_eotf(min_luma) - eps;
        g.max_rgb = pq_eotf(max_luma) + eps;
        return g;
    };
    Gamut src0 = make_gamut(src_rgb2lms, src_lms2rgb);
    Gamut dst0 = make_gamut(dst_rgb2lms, dst_lms2rgb);

    HueShift hs;
    if (op == OP_SOFTCLIP)
        hueshift_prepare(hs, src0, dst0);

    // per-op global gains (hue-sweep / cusp precomputations)
    double darken_gain = 1.0, linear_gain = 1.0;
    if (op == OP_DARKEN) {
        const double pts[6][3] = {
            {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
            {0, 1, 1}, {1, 0, 1}, {1, 1, 0},
        };
        double gain = 1e30;
        for (auto &p : pts) {
            RGB m = ipt2rgb(rgb2ipt({p[0], p[1], p[2]}, src0), dst0);
            double mx = std::max(m.R, std::max(m.G, m.B));
            gain = std::min(gain, 1.0 / mx);
        }
        darken_gain = gain;
    } else if (op == OP_LINEAR) {
        Gamut s = src0, d = dst0;
        double gain = 1.0;
        // np.arange(-pi, pi, 0.1): 63 samples at -pi + 0.1*i
        int n_hues = (int)std::ceil(2 * kPi / 0.1);
        for (int i = 0; i < n_hues; i++) {
            double hue = -kPi + 0.1 * i;
            s.cache_valid = d.cache_valid = false;
            double sc = saturate(hue, s).C;
            double dc = saturate(hue, d).C;
            gain = std::min(gain, std::min(1.0, dc / std::max(sc, 1e-9)));
        }
        linear_gain = gain;
    }

    // grid (identical to Python generate())
    std::vector<double> Ix(NI), Cx(NC), hx(Nh);
    for (int i = 0; i < NI; i++)
        Ix[i] = NI == 1 ? min_luma
                        : min_luma + (max_luma - min_luma) * i / (NI - 1);
    for (int i = 0; i < NC; i++)
        Cx[i] = NC == 1 ? 0.0 : 0.5 * i / (NC - 1);
    for (int i = 0; i < Nh; i++)
        hx[i] = Nh == 1 ? -kPi : -kPi + 2 * kPi * i / (Nh - 1);

    int n_threads = (int)std::thread::hardware_concurrency();
    n_threads = std::max(1, std::min(n_threads, Nh));

    auto work = [&](int h_begin, int h_end) {
        // thread-local gamut copies: the 1-item peak caches are
        // per-thread state
        Gamut src = src0, dst = dst0;
        Gamut src_post = src0, dst_post = dst0;
        for (int ih = h_begin; ih < h_end; ih++) {
            double ch = std::cos(hx[ih]), sh = std::sin(hx[ih]);
            for (int ic = 0; ic < NC; ic++) {
                double C = Cx[ic];
                float *row = out + ((size_t)ih * NC + ic) * NI * 3;
                for (int ii = 0; ii < NI; ii++) {
                    IPT ipt{Ix[ii], C * ch, C * sh};
                    IPT m = map_one(op, ipt, c, src, dst, src_post,
                                    dst_post, &hs, adapt, darken_gain,
                                    linear_gain);
                    row[ii * 3 + 0] = (float)m.I;
                    row[ii * 3 + 1] = (float)m.P;
                    row[ii * 3 + 2] = (float)m.T;
                }
            }
        }
    };

    if (n_threads == 1) {
        work(0, Nh);
    } else {
        std::vector<std::thread> threads;
        int chunk = (Nh + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int b = t * chunk, e = std::min(Nh, b + chunk);
            if (b < e)
                threads.emplace_back(work, b, e);
        }
        for (auto &t : threads)
            t.join();
    }
    return 0;
}
