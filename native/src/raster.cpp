/* Native CPU render core — behavioral twin of the device pipeline.
 *
 * Same architecture as the device path (renderer.py + ops/): structure-of-arrays
 * scene, batched vertex/normal transform, fixed-shape near-plane clip prepass
 * (T triangles -> 2T slots with validity), per-slot setup table with closed-form
 * barycentric constants, visibility resolve into a winner-id buffer, then
 * deferred shading (each pixel lit and textured exactly once).
 *
 * Numerics match the golden oracle (golden/renderer.py): f32 everywhere,
 * w(px, py) = w00 + px*dx + py*dy evaluated closed-form (build with
 * -ffp-contract=off so the compiler doesn't fuse those into FMAs), depth = 1/z
 * cleared to 0 with strictly-greater wins, area < min_area backface/small cull
 * (reference render/render.swift:280), and the reference's exact anisotropic
 * ripmap addressing (render.swift:94-111).
 *
 * Slot order is [primaries 0..T) then [appended T..2T)], matching the
 * reference's processing order (originals first, then mid-frame appends in
 * creation order — render.swift:260) for depth-tie behavior.
 */

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "internal.h"

/* S3D_NATIVE_PROF=1 prints per-phase wall times to stderr — the native twin
 * of utils/telemetry.py's per-stage timers. */
static const bool kProf = []() {
    const char *e = getenv("S3D_NATIVE_PROF");
    return e && e[0] == '1';
}();

#if defined(__AVX512F__) && defined(__AVX512BW__)
#define S3D_HAVE_AVX512 1
#include <immintrin.h>
#endif

/* S3D_NATIVE_SIMD=0 forces the scalar visibility/shade loops (differential
 * testing aid; the AVX-512 visibility path is bit-identical by construction —
 * same op order, no FMA contraction — and the shade path agrees to <1 LSB). */
static const bool kSimd = []() {
    const char *e = getenv("S3D_NATIVE_SIMD");
    return !(e && e[0] == '0');
}();
static inline double now_ms() {
    return std::chrono::duration<double, std::milli>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

/* Row-band parallelism: fn(y_begin, y_end) over [0, height) split across the
 * host cores. Bands are disjoint rows, so the visibility resolve (per-pixel
 * depth test) and the deferred shade are race-free and bit-identical to the
 * serial order — unlike the reference, which is single-threaded by design
 * (reference README.md:31). Small frames stay serial. */
static void parallel_rows(int height, int min_rows_per_thread,
                          const std::function<void(int, int)> &fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int nthreads = (int)std::min<unsigned>(hw ? hw : 1, 16);
    nthreads = std::min(nthreads, std::max(1, height / min_rows_per_thread));
    if (nthreads <= 1) {
        fn(0, height);
        return;
    }
    std::vector<std::thread> pool;
    int per = (height + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int y0 = t * per, y1 = std::min(height, y0 + per);
        if (y0 >= y1) break;
        pool.emplace_back(fn, y0, y1);
    }
    for (auto &th : pool) th.join();
}

namespace {

struct Slot {
    float w00[3], dx[3], dy[3], rvz[3];
    float cvp[3][3], np_[3][3], attrp[3][3];
    float tpp[2], dzv[2];
    int xmin, xmax, ymin, ymax;
    int32_t tex;
    bool istex;
    bool live;
};

struct Corner {
    Vec3 cv, rv, attr, n;
};

inline float edge_fn(const Vec3 &a, const Vec3 &b, float cx, float cy) {
    return (cx - a.x) * (a.y - b.y) + (cy - a.y) * (b.x - a.x);
}

#if defined(__SSE__)
#include <immintrin.h>
/* Hardware rsqrt + one Newton step: ~1e-7 relative error, which perturbs the
 * final 8-bit channel by well under 1 LSB (shade is continuous in the inputs)
 * while removing a sqrt+div dependency chain per call. */
inline float rsqrt_nr(float x) {
    float r = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x)));
    return r * (1.5f - 0.5f * x * r * r);
}
#else
inline float rsqrt_nr(float x) { return 1.0f / sqrtf(x); }
#endif

inline Vec3 normalize3(Vec3 v) {
    float inv = rsqrt_nr(dot3(v, v));
    return {v.x * inv, v.y * inv, v.z * inv};
}

inline uint32_t next_pow2(float f) {
    int i = (int)f - 1; /* truncate first (render.swift:95-101) */
    i |= i >> 1;
    i |= i >> 2;
    i |= i >> 4;
    return (uint32_t)(i + 1);
}

#ifdef S3D_HAVE_AVX512

/* ---- AVX-512 visibility: 16 pixels per step, bit-identical to the scalar
 * loop (identical op order: w = wr + fx*dx with separate mul+add, ooz =
 * ((w0*rz0 + w1*rz1) + w2*rz2), strict > against the depth row). Masked
 * loads/stores keep lanes past xmax untouched and unfaulting. */
static void vis_slot_avx512(const Slot &sl, int32_t sidx, float *depth,
                            int32_t *win, int W, int y_lo, int y_hi) {
    const __m512 dx0 = _mm512_set1_ps(sl.dx[0]);
    const __m512 dx1 = _mm512_set1_ps(sl.dx[1]);
    const __m512 dx2 = _mm512_set1_ps(sl.dx[2]);
    const __m512 rz0 = _mm512_set1_ps(sl.rvz[0]);
    const __m512 rz1 = _mm512_set1_ps(sl.rvz[1]);
    const __m512 rz2 = _mm512_set1_ps(sl.rvz[2]);
    const __m512i vid = _mm512_set1_epi32(sidx);
    const __m512 zero = _mm512_setzero_ps();
    const __m512 lane = _mm512_cvtepi32_ps(_mm512_set_epi32(
        15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0));
    for (int y = y_lo; y <= y_hi; y++) {
        float fy = (float)y;
        float wr0 = sl.w00[0] + fy * sl.dy[0];
        float wr1 = sl.w00[1] + fy * sl.dy[1];
        float wr2 = sl.w00[2] + fy * sl.dy[2];
        const __m512 vr0 = _mm512_set1_ps(wr0);
        const __m512 vr1 = _mm512_set1_ps(wr1);
        const __m512 vr2 = _mm512_set1_ps(wr2);
        float *drow = depth + (size_t)y * W;
        int32_t *wrow = win + (size_t)y * W;
        for (int x = sl.xmin; x <= sl.xmax; x += 16) {
            int rem = sl.xmax - x + 1;
            __mmask16 bm = rem >= 16 ? (__mmask16)0xFFFF
                                     : (__mmask16)((1u << rem) - 1u);
            __m512 fx = _mm512_add_ps(_mm512_set1_ps((float)x), lane);
            __m512 w0 = _mm512_add_ps(vr0, _mm512_mul_ps(fx, dx0));
            __m512 w1 = _mm512_add_ps(vr1, _mm512_mul_ps(fx, dx1));
            __m512 w2 = _mm512_add_ps(vr2, _mm512_mul_ps(fx, dx2));
            __mmask16 cov = _mm512_mask_cmp_ps_mask(bm, w0, zero, _CMP_GE_OQ);
            cov = _mm512_mask_cmp_ps_mask(cov, w1, zero, _CMP_GE_OQ);
            cov = _mm512_mask_cmp_ps_mask(cov, w2, zero, _CMP_GE_OQ);
            if (!cov) continue;
            __m512 ooz = _mm512_add_ps(
                _mm512_add_ps(_mm512_mul_ps(w0, rz0), _mm512_mul_ps(w1, rz1)),
                _mm512_mul_ps(w2, rz2));
            __m512 d = _mm512_maskz_loadu_ps(cov, drow + x);
            __mmask16 upd = _mm512_mask_cmp_ps_mask(cov, ooz, d, _CMP_GT_OQ);
            if (!upd) continue;
            _mm512_mask_storeu_ps(drow + x, upd, ooz);
            _mm512_mask_storeu_epi32(wrow + x, upd, vid);
        }
    }
}

/* Vector twins of the scalar helpers (same formulas; rsqrt14+NR instead of
 * the SSE rsqrt+NR — both ~1e-7 relative, <1 LSB on the packed channel). */
static inline __m512 v_rsqrt_nr(__m512 x) {
    __m512 r = _mm512_rsqrt14_ps(x);
    __m512 half_x = _mm512_mul_ps(_mm512_set1_ps(0.5f), x);
    return _mm512_mul_ps(
        r, _mm512_sub_ps(_mm512_set1_ps(1.5f),
                         _mm512_mul_ps(half_x, _mm512_mul_ps(r, r))));
}

/* next_pow2((int)clamp(f, 1, 256)) — the reference's level pick
 * (render.swift:95-101), 16 lanes at a time. */
static inline __m512i v_next_pow2(__m512 f) {
    f = _mm512_max_ps(_mm512_min_ps(f, _mm512_set1_ps(256.f)),
                      _mm512_set1_ps(1.f));
    __m512i i = _mm512_sub_epi32(_mm512_cvttps_epi32(f),
                                 _mm512_set1_epi32(1));
    i = _mm512_or_epi32(i, _mm512_srli_epi32(i, 1));
    i = _mm512_or_epi32(i, _mm512_srli_epi32(i, 2));
    i = _mm512_or_epi32(i, _mm512_srli_epi32(i, 4));
    return _mm512_add_epi32(i, _mm512_set1_epi32(1));
}

struct VTexel {
    __m512 r, g, b;
};

/* 16 texels by explicit scalar loads: hardware vpgather is microcoded on
 * some cores (measured ~10x slower than 16 loads on the build machine), so
 * assemble the vector manually. Addresses are wrapped into the 512x512
 * atlas (AND 0x3FFFF) so lanes masked off upstream stay in-bounds. */
static inline __m512i v_texel_load(__m512i addr, const uint32_t *tex) {
    addr = _mm512_and_epi32(addr, _mm512_set1_epi32(0x3FFFF));
    alignas(64) int32_t a[16];
    alignas(64) int32_t t[16];
    _mm512_store_epi32(a, addr);
    for (int k = 0; k < 16; k++) t[k] = (int32_t)tex[(uint32_t)a[k]];
    return _mm512_load_epi32(t);
}

static inline VTexel v_unpack_rgb(__m512i t) {
    const __m512i m255 = _mm512_set1_epi32(255);
    return {_mm512_cvtepi32_ps(_mm512_and_epi32(_mm512_srli_epi32(t, 16), m255)),
            _mm512_cvtepi32_ps(_mm512_and_epi32(_mm512_srli_epi32(t, 8), m255)),
            _mm512_cvtepi32_ps(_mm512_and_epi32(t, m255))};
}

/* AVX-512 deferred shade for one slot over its bbox ∩ band: pixels whose
 * winner id matches are re-derived from the slot constants exactly as the
 * scalar loop does (one reciprocal of 1/z, mul/add interpolation order). */
static void shade_slot_avx512(const Slot &sl, int32_t sidx, const float *depth,
                              const int32_t *win, uint32_t *pixels, int W,
                              int y_lo, int y_hi, const uint32_t *tex,
                              bool bilinear) {
    const __m512i vid = _mm512_set1_epi32(sidx);
    const __m512 one = _mm512_set1_ps(1.f);
    const __m512 lane = _mm512_cvtepi32_ps(_mm512_set_epi32(
        15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0));
    const __m512 w000 = _mm512_set1_ps(sl.w00[0]);
    const __m512 w001 = _mm512_set1_ps(sl.w00[1]);
    const __m512 w002 = _mm512_set1_ps(sl.w00[2]);
    const __m512 dx0 = _mm512_set1_ps(sl.dx[0]);
    const __m512 dx1 = _mm512_set1_ps(sl.dx[1]);
    const __m512 dx2 = _mm512_set1_ps(sl.dx[2]);
    const __m512 sgn = _mm512_set1_ps(-0.0f);
    for (int y = y_lo; y <= y_hi; y++) {
        const __m512 fy = _mm512_set1_ps((float)y);
        const float *drow = depth + (size_t)y * W;
        const int32_t *wrow = win + (size_t)y * W;
        uint32_t *prow = pixels + (size_t)y * W;
        for (int x = sl.xmin; x <= sl.xmax; x += 16) {
            int rem = sl.xmax - x + 1;
            __mmask16 bm = rem >= 16 ? (__mmask16)0xFFFF
                                     : (__mmask16)((1u << rem) - 1u);
            __m512i wl = _mm512_maskz_loadu_epi32(bm, wrow + x);
            __mmask16 m = _mm512_mask_cmpeq_epi32_mask(bm, wl, vid);
            if (!m) continue;
            /* ooz: masked-off lanes get 1.0 so the reciprocal stays finite. */
            __m512 ooz = _mm512_mask_loadu_ps(one, m, drow + x);
            __m512 zi = _mm512_div_ps(one, ooz);
            __m512 fx = _mm512_add_ps(_mm512_set1_ps((float)x), lane);
            /* scalar order: ((w00 + fx*dx) + fy*dy) * zi */
            __m512 w0 = _mm512_mul_ps(
                _mm512_add_ps(
                    _mm512_add_ps(w000, _mm512_mul_ps(fx, dx0)),
                    _mm512_mul_ps(fy, _mm512_set1_ps(sl.dy[0]))),
                zi);
            __m512 w1 = _mm512_mul_ps(
                _mm512_add_ps(
                    _mm512_add_ps(w001, _mm512_mul_ps(fx, dx1)),
                    _mm512_mul_ps(fy, _mm512_set1_ps(sl.dy[1]))),
                zi);
            __m512 w2 = _mm512_mul_ps(
                _mm512_add_ps(
                    _mm512_add_ps(w002, _mm512_mul_ps(fx, dx2)),
                    _mm512_mul_ps(fy, _mm512_set1_ps(sl.dy[2]))),
                zi);
            /* interp(v) = v0*w0 + v1*w1 + v2*w2, ((a + b) + c) order. */
            auto interp = [&](const float v[3][3], int c) -> __m512 {
                return _mm512_add_ps(
                    _mm512_add_ps(
                        _mm512_mul_ps(_mm512_set1_ps(v[0][c]), w0),
                        _mm512_mul_ps(_mm512_set1_ps(v[1][c]), w1)),
                    _mm512_mul_ps(_mm512_set1_ps(v[2][c]), w2));
            };
            __m512 cx = interp(sl.cvp, 0), cy = interp(sl.cvp, 1),
                   cz = interp(sl.cvp, 2);
            __m512 nx = interp(sl.np_, 0), ny = interp(sl.np_, 1),
                   nz = interp(sl.np_, 2);
            auto dot3v = [&](__m512 ax, __m512 ay, __m512 az, __m512 bx,
                             __m512 by, __m512 bz) -> __m512 {
                return _mm512_add_ps(
                    _mm512_add_ps(_mm512_mul_ps(ax, bx),
                                  _mm512_mul_ps(ay, by)),
                    _mm512_mul_ps(az, bz));
            };
            __m512 ci = v_rsqrt_nr(dot3v(cx, cy, cz, cx, cy, cz));
            /* point = -normalize(cv) */
            __m512 px = _mm512_xor_ps(_mm512_mul_ps(cx, ci), sgn);
            __m512 py = _mm512_xor_ps(_mm512_mul_ps(cy, ci), sgn);
            __m512 pz = _mm512_xor_ps(_mm512_mul_ps(cz, ci), sgn);
            __m512 ni = v_rsqrt_nr(dot3v(nx, ny, nz, nx, ny, nz));
            nx = _mm512_mul_ps(nx, ni);
            ny = _mm512_mul_ps(ny, ni);
            nz = _mm512_mul_ps(nz, ni);
            __m512 hx = _mm512_add_ps(px, nx), hy = _mm512_add_ps(py, ny),
                   hz = _mm512_add_ps(pz, nz);
            __m512 hi = v_rsqrt_nr(dot3v(hx, hy, hz, hx, hy, hz));
            __m512 shade = _mm512_mul_ps(dot3v(hx, hy, hz, nx, ny, nz), hi);
            __m512 cr = interp(sl.attrp, 0);
            __m512 cg = interp(sl.attrp, 1);
            __m512 cb = interp(sl.attrp, 2);
            if (sl.istex) {
                __m512 u = cr, v = cg;
                const __m512 absm = _mm512_set1_ps(-0.0f);
                __m512 lu = _mm512_div_ps(
                    ooz, _mm512_andnot_ps(
                             absm, _mm512_sub_ps(
                                       _mm512_set1_ps(sl.tpp[0]),
                                       _mm512_mul_ps(
                                           u, _mm512_set1_ps(sl.dzv[0])))));
                __m512 lv = _mm512_div_ps(
                    ooz, _mm512_andnot_ps(
                             absm, _mm512_sub_ps(
                                       _mm512_set1_ps(sl.tpp[1]),
                                       _mm512_mul_ps(
                                           v, _mm512_set1_ps(sl.dzv[1])))));
                __m512i Lx = v_next_pow2(lu), Ly = v_next_pow2(lv);
                /* off = 511 & ~(2L - 1) */
                const __m512i c511 = _mm512_set1_epi32(511);
                const __m512i cm1 = _mm512_set1_epi32(-1);
                __m512i offx = _mm512_and_epi32(
                    c511, _mm512_xor_epi32(
                              _mm512_sub_epi32(_mm512_slli_epi32(Lx, 1),
                                               _mm512_set1_epi32(1)),
                              cm1));
                __m512i offy = _mm512_and_epi32(
                    c511, _mm512_xor_epi32(
                              _mm512_sub_epi32(_mm512_slli_epi32(Ly, 1),
                                               _mm512_set1_epi32(1)),
                              cm1));
                __m512 Lxf = _mm512_cvtepi32_ps(Lx);
                __m512 Lyf = _mm512_cvtepi32_ps(Ly);
                VTexel t;
                if (!bilinear) {
                    /* x = (int)((u - trunc u) * Lx) + offx, clamped to 511 */
                    __m512 fu = _mm512_sub_ps(
                        u, _mm512_roundscale_ps(
                               u, _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC));
                    __m512 fv = _mm512_sub_ps(
                        v, _mm512_roundscale_ps(
                               v, _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC));
                    __m512i xi = _mm512_add_epi32(
                        _mm512_cvttps_epi32(_mm512_mul_ps(fu, Lxf)), offx);
                    __m512i yi = _mm512_add_epi32(
                        _mm512_cvttps_epi32(_mm512_mul_ps(fv, Lyf)), offy);
                    const __m512i zi32 = _mm512_setzero_si512();
                    xi = _mm512_min_epi32(_mm512_max_epi32(xi, zi32), c511);
                    yi = _mm512_min_epi32(_mm512_max_epi32(yi, zi32), c511);
                    __m512i addr =
                        _mm512_add_epi32(xi, _mm512_slli_epi32(yi, 9));
                    t = v_unpack_rgb(v_texel_load(addr, tex));
                } else {
                    /* bilinear: 4 wrapped gathers + lerp (scalar twin above) */
                    __m512 fu = _mm512_sub_ps(
                        u, _mm512_roundscale_ps(
                               u, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC));
                    __m512 fv = _mm512_sub_ps(
                        v, _mm512_roundscale_ps(
                               v, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC));
                    __m512 tu = _mm512_sub_ps(_mm512_mul_ps(fu, Lxf),
                                              _mm512_set1_ps(0.5f));
                    __m512 tv = _mm512_sub_ps(_mm512_mul_ps(fv, Lyf),
                                              _mm512_set1_ps(0.5f));
                    __m512 x0f = _mm512_roundscale_ps(
                        tu, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
                    __m512 y0f = _mm512_roundscale_ps(
                        tv, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
                    __m512i x0 = _mm512_cvttps_epi32(x0f);
                    __m512i y0 = _mm512_cvttps_epi32(y0f);
                    __m512 wx = _mm512_sub_ps(tu, x0f);
                    __m512 wy = _mm512_sub_ps(tv, y0f);
                    __m512i lmx = _mm512_sub_epi32(Lx, _mm512_set1_epi32(1));
                    __m512i lmy = _mm512_sub_epi32(Ly, _mm512_set1_epi32(1));
                    auto fetch = [&](__m512i xi, __m512i yi) -> VTexel {
                        xi = _mm512_add_epi32(_mm512_and_epi32(xi, lmx), offx);
                        yi = _mm512_add_epi32(_mm512_and_epi32(yi, lmy), offy);
                        __m512i addr =
                            _mm512_add_epi32(xi, _mm512_slli_epi32(yi, 9));
                        return v_unpack_rgb(v_texel_load(addr, tex));
                    };
                    __m512i x1 = _mm512_add_epi32(x0, _mm512_set1_epi32(1));
                    __m512i y1 = _mm512_add_epi32(y0, _mm512_set1_epi32(1));
                    VTexel c00 = fetch(x0, y0), c10 = fetch(x1, y0);
                    VTexel c01 = fetch(x0, y1), c11 = fetch(x1, y1);
                    __m512 iwx = _mm512_sub_ps(one, wx);
                    __m512 iwy = _mm512_sub_ps(one, wy);
                    __m512 w00v = _mm512_mul_ps(iwx, iwy);
                    __m512 w10v = _mm512_mul_ps(wx, iwy);
                    __m512 w01v = _mm512_mul_ps(iwx, wy);
                    __m512 w11v = _mm512_mul_ps(wx, wy);
                    auto lerp = [&](__m512 a, __m512 b, __m512 c,
                                    __m512 d) -> __m512 {
                        return _mm512_add_ps(
                            _mm512_add_ps(_mm512_mul_ps(w00v, a),
                                          _mm512_mul_ps(w10v, b)),
                            _mm512_add_ps(_mm512_mul_ps(w01v, c),
                                          _mm512_mul_ps(w11v, d)));
                    };
                    t = {lerp(c00.r, c10.r, c01.r, c11.r),
                         lerp(c00.g, c10.g, c01.g, c11.g),
                         lerp(c00.b, c10.b, c01.b, c11.b)};
                }
                cr = t.r;
                cg = t.g;
                cb = t.b;
            }
            __m512i rr = _mm512_cvttps_epi32(_mm512_mul_ps(shade, cr));
            __m512i gg = _mm512_cvttps_epi32(_mm512_mul_ps(shade, cg));
            __m512i bb = _mm512_cvttps_epi32(_mm512_mul_ps(shade, cb));
            __m512i pix = _mm512_or_epi32(
                _mm512_or_epi32(_mm512_slli_epi32(rr, 16),
                                _mm512_slli_epi32(gg, 8)),
                bb);
            _mm512_mask_storeu_epi32(prow + x, m, pix);
        }
    }
}

#endif  // S3D_HAVE_AVX512

}  // namespace

struct s3d_renderer {
    const s3d_scene *scene;
    std::vector<Vec3> cv, rv;     /* per vertex */
    std::vector<Vec3> nrm;        /* per attribute */
    std::vector<Slot> slots;      /* 2T */
    std::vector<float> depth_own; /* used when fb->depth == NULL */
    std::vector<int32_t> winner;
};

extern "C" s3d_renderer *s3d_renderer_create(const s3d_scene *scene) {
    auto r = new s3d_renderer();
    r->scene = scene;
    r->cv.resize((size_t)scene->vertex_count());
    r->rv.resize((size_t)scene->vertex_count());
    r->nrm.resize((size_t)scene->attribute_count());
    r->slots.resize((size_t)scene->triangle_count() * 2);
    return r;
}

extern "C" void s3d_renderer_free(s3d_renderer *r) { delete r; }

namespace {

/* Crossing point on edge i -> j at depth == near (render.swift:186-199). */
Corner crossing(const Corner &a, const Corner &b, float near, float factor,
                float half_w, float half_h) {
    float t = (near - a.rv.z) / (b.rv.z - a.rv.z);
    Corner out;
    out.cv = a.cv * (1 - t) + b.cv * t;
    out.rv = {out.cv.x * factor / near + half_w,
              -out.cv.y * factor / near + half_h, near};
    out.attr = a.attr * (1 - t) + b.attr * t;
    out.n = a.n * (1 - t) + b.n * t;
    return out;
}

void fill_slot(Slot &slot, const Corner c[3], int32_t tex, int width, int height,
               float min_area) {
    const Vec3 &r0 = c[0].rv, &r1 = c[1].rv, &r2 = c[2].rv;
    float rvmax_x = fmaxf(fmaxf(r0.x, r1.x), r2.x);
    float rvmax_y = fmaxf(fmaxf(r0.y, r1.y), r2.y);
    float rvmin_x = fminf(fminf(r0.x, r1.x), r2.x);
    float rvmin_y = fminf(fminf(r0.y, r1.y), r2.y);
    float area = edge_fn(r0, r1, r2.x, r2.y);
    slot.live = !(rvmax_x < 0 || rvmax_y < 0 || rvmin_x >= (float)width ||
                  rvmin_y >= (float)height || area < min_area);
    if (!slot.live) return;
    float ooa = 1.0f / area;
    slot.w00[0] = edge_fn(r1, r2, 0.5f, 0.5f) * ooa;
    slot.w00[1] = edge_fn(r2, r0, 0.5f, 0.5f) * ooa;
    slot.w00[2] = edge_fn(r0, r1, 0.5f, 0.5f) * ooa;
    slot.dx[0] = (r1.y - r2.y) * ooa;
    slot.dx[1] = (r2.y - r0.y) * ooa;
    slot.dx[2] = (r0.y - r1.y) * ooa;
    slot.dy[0] = (r2.x - r1.x) * ooa;
    slot.dy[1] = (r0.x - r2.x) * ooa;
    slot.dy[2] = (r1.x - r0.x) * ooa;
    slot.xmin = (int)fmaxf(0.f, rvmin_x);
    slot.xmax = (int)fminf((float)(width - 1), rvmax_x);
    slot.ymin = (int)fmaxf(0.f, rvmin_y);
    slot.ymax = (int)fminf((float)(height - 1), rvmax_y);
    for (int k = 0; k < 3; k++) {
        float rz = 1.0f / c[k].rv.z;
        slot.rvz[k] = rz;
        Vec3 cvp = c[k].cv * rz, np = c[k].n * rz, ap = c[k].attr * rz;
        memcpy(slot.cvp[k], &cvp, 12);
        memcpy(slot.np_[k], &np, 12);
        memcpy(slot.attrp[k], &ap, 12);
    }
    slot.dzv[0] = slot.rvz[0] * slot.dx[0] + slot.rvz[1] * slot.dx[1] +
                  slot.rvz[2] * slot.dx[2];
    slot.dzv[1] = slot.rvz[0] * slot.dy[0] + slot.rvz[1] * slot.dy[1] +
                  slot.rvz[2] * slot.dy[2];
    slot.tpp[0] = slot.attrp[0][0] * slot.dx[0] + slot.attrp[1][0] * slot.dx[1] +
                  slot.attrp[2][0] * slot.dx[2];
    slot.tpp[1] = slot.attrp[0][1] * slot.dy[0] + slot.attrp[1][1] * slot.dy[1] +
                  slot.attrp[2][1] * slot.dy[2];
    slot.tex = tex;
    slot.istex = tex >= 0;
}

/* Reference-exact nearest ripmap fetch (render.swift:104-111). */
inline Vec3 fetch_nearest(const uint32_t *tex, float u, float v, float lu,
                          float lv) {
    uint32_t Lx = next_pow2(fmaxf(fminf(lu, 256.f), 1.f));
    uint32_t Ly = next_pow2(fmaxf(fminf(lv, 256.f), 1.f));
    /* fmodf(t, 1) == t - truncf(t) exactly (single roundss vs libm call). */
    int x = (int)((u - truncf(u)) * (float)Lx) + (int)(511u & ~(2u * Lx - 1u));
    int y = (int)((v - truncf(v)) * (float)Ly) + (int)(511u & ~(2u * Ly - 1u));
    x = x < 0 ? 0 : (x > 511 ? 511 : x);
    y = y < 0 ? 0 : (y > 511 ? 511 : y);
    uint32_t rgb = tex[x + (y << 9)];
    return {(float)(rgb >> 16), (float)((rgb >> 8) & 255), (float)(rgb & 255)};
}

/* Bilinear within the level (framework extension; utils/ripmap.py twin). */
inline Vec3 fetch_bilinear(const uint32_t *tex, float u, float v, float lu,
                           float lv) {
    uint32_t Lx = next_pow2(fmaxf(fminf(lu, 256.f), 1.f));
    uint32_t Ly = next_pow2(fmaxf(fminf(lv, 256.f), 1.f));
    float fu = u - floorf(u), fv = v - floorf(v); /* positive wrap */
    float tu = fu * (float)Lx - 0.5f, tv = fv * (float)Ly - 0.5f;
    int x0 = (int)floorf(tu), y0 = (int)floorf(tv);
    float wx = tu - (float)x0, wy = tv - (float)y0;
    int offx = (int)(511u & ~(2u * Lx - 1u)), offy = (int)(511u & ~(2u * Ly - 1u));
    auto texel = [&](int xi, int yi) -> Vec3 {
        /* Lx/Ly are powers of two: euclidean mod == bitwise AND (two's
         * complement), replacing two idivs per coordinate. */
        int x = (xi & (int)(Lx - 1u)) + offx;
        int y = (yi & (int)(Ly - 1u)) + offy;
        uint32_t rgb = tex[x + (y << 9)];
        return {(float)(rgb >> 16), (float)((rgb >> 8) & 255), (float)(rgb & 255)};
    };
    Vec3 c00 = texel(x0, y0), c10 = texel(x0 + 1, y0);
    Vec3 c01 = texel(x0, y0 + 1), c11 = texel(x0 + 1, y0 + 1);
    return (1 - wx) * (1 - wy) * c00 + wx * (1 - wy) * c10 +
           (1 - wx) * wy * c01 + wx * wy * c11;
}

}  // namespace

extern "C" void s3d_render(s3d_renderer *r, const float *m,
                           const s3d_config *config, s3d_framebuffer *fb) {
    const s3d_scene *sc = r->scene;
    const int W = (int)fb->width, H = (int)fb->height;
    const float near = config->near_plane;
    const float scale = near * tanf(config->fov / 2.f);
    const float factor = near * (float)H / (2.f * scale);
    const float half_w = (float)W / 2.f, half_h = (float)H / 2.f;
    const int64_t V = sc->vertex_count(), A = sc->attribute_count(),
                  T = sc->triangle_count();

    double t_geo = now_ms();

    /* Vertex + normal stages (batched; reference render.swift:248-255). */
    for (int64_t i = 0; i < V; i++) {
        const float *p = &sc->vertices[i * 4];
        Vec3 cv = {m[0] * p[0] + m[1] * p[1] + m[2] * p[2] + m[3],
                   m[4] * p[0] + m[5] * p[1] + m[6] * p[2] + m[7],
                   m[8] * p[0] + m[9] * p[1] + m[10] * p[2] + m[11]};
        r->cv[i] = cv;
        float z = -cv.z;
        r->rv[i] = {cv.x * factor / z + half_w, -cv.y * factor / z + half_h, z};
    }
    for (int64_t i = 0; i < A; i++) {
        const float *p = &sc->normals[i * 4];
        r->nrm[i] = {m[0] * p[0] + m[1] * p[1] + m[2] * p[2],
                     m[4] * p[0] + m[5] * p[1] + m[6] * p[2],
                     m[8] * p[0] + m[9] * p[1] + m[10] * p[2]};
    }

    /* Clip prepass -> 2T slots (fixed shape; see ops/clip.py for the cases). */
    for (int64_t t = 0; t < T; t++) {
        Slot &prim = r->slots[(size_t)t];
        Slot &sec = r->slots[(size_t)(T + t)];
        prim.live = sec.live = false;
        Corner c[3];
        int32_t tex = (int32_t)sc->attr_tex[sc->attribute_indices[3 * t]];
        for (int k = 0; k < 3; k++) {
            int64_t vi = sc->vertex_indices[3 * t + k];
            int64_t ai = sc->attribute_indices[3 * t + k];
            c[k].cv = r->cv[vi];
            c[k].rv = r->rv[vi];
            c[k].n = r->nrm[ai];
            const float *av = &sc->attr_vec[ai * 3];
            c[k].attr = {av[0], av[1], av[2]};
        }
        bool front[3];
        int nfront = 0;
        for (int k = 0; k < 3; k++) {
            front[k] = c[k].rv.z > near;
            nfront += front[k];
        }
        if (nfront == 0) continue;                 /* render.swift:269 */
        if (nfront == 3) {
            fill_slot(prim, c, tex, W, H, config->min_area);
            continue;
        }
        int s = 0;
        while (front[s] != front[(s + 1) % 3]) s++;
        int nxt = (s + 1) % 3, prc = (s + 2) % 3;
        Corner x_next = crossing(c[nxt], c[prc], near, factor, half_w, half_h);
        Corner x_prec = crossing(c[prc], c[s], near, factor, half_w, half_h);
        if (front[s]) { /* two in front: modify + append (render.swift:202-222) */
            Corner p3[3] = {c[0], c[1], c[2]};
            p3[prc] = x_next;
            fill_slot(prim, p3, tex, W, H, config->min_area);
            Corner a3[3] = {c[s], x_next, x_prec};
            fill_slot(sec, a3, tex, W, H, config->min_area);
        } else {        /* one in front: shrink in place (render.swift:223-226) */
            Corner p3[3] = {c[0], c[1], c[2]};
            p3[s] = x_prec;
            p3[nxt] = x_next;
            fill_slot(prim, p3, tex, W, H, config->min_area);
        }
    }

    double t_vis = now_ms();

    /* Clear + visibility resolve into the winner buffer. */
    float *depth = fb->depth;
    if (!depth) {
        r->depth_own.assign((size_t)W * H, 0.f);
        depth = r->depth_own.data();
    } else {
        memset(depth, 0, (size_t)W * H * 4);
    }
    r->winner.assign((size_t)W * H, -1);
    int32_t *win = r->winner.data();

    parallel_rows(H, 64, [&](int band_y0, int band_y1) {
    for (size_t sidx = 0; sidx < r->slots.size(); sidx++) {
        const Slot &sl = r->slots[sidx];
        if (!sl.live) continue;
        int y_lo = std::max(sl.ymin, band_y0);
        int y_hi = std::min(sl.ymax, band_y1 - 1);
#ifdef S3D_HAVE_AVX512
        if (kSimd) {
            vis_slot_avx512(sl, (int32_t)sidx, depth, win, W, y_lo, y_hi);
            continue;
        }
#endif
        for (int y = y_lo; y <= y_hi; y++) {
            float fy = (float)y;
            float wr0 = sl.w00[0] + fy * sl.dy[0];
            float wr1 = sl.w00[1] + fy * sl.dy[1];
            float wr2 = sl.w00[2] + fy * sl.dy[2];
            float *drow = depth + (size_t)y * W;
            int32_t *wrow = win + (size_t)y * W;
            for (int x = sl.xmin; x <= sl.xmax; x++) {
                float fx = (float)x;
                float w0 = wr0 + fx * sl.dx[0];
                float w1 = wr1 + fx * sl.dx[1];
                float w2 = wr2 + fx * sl.dx[2];
                if (w0 >= 0 && w1 >= 0 && w2 >= 0) {
                    float ooz = w0 * sl.rvz[0] + w1 * sl.rvz[1] + w2 * sl.rvz[2];
                    if (ooz > drow[x]) {
                        drow[x] = ooz;
                        wrow[x] = (int32_t)sidx;
                    }
                }
            }
        }
    }
    });

    double t_shade = now_ms();

    /* Deferred shading (render.swift:326-331 + texture path :312-316). */
    const uint32_t *tex_base = sc->textures.data();
#ifdef S3D_HAVE_AVX512
    if (kSimd) {
        parallel_rows(H, 32, [&](int band_y0, int band_y1) {
            /* Unwon pixels -> background (vector compare + masked store). */
            const __m512i bg = _mm512_set1_epi32((int32_t)config->background);
            const __m512i neg = _mm512_set1_epi32(-1);
            for (int y = band_y0; y < band_y1; y++) {
                int32_t *wrow = win + (size_t)y * W;
                uint32_t *prow = fb->pixels + (size_t)y * W;
                for (int x = 0; x < W; x += 16) {
                    int rem = W - x;
                    __mmask16 bm = rem >= 16 ? (__mmask16)0xFFFF
                                             : (__mmask16)((1u << rem) - 1u);
                    __m512i wl = _mm512_maskz_loadu_epi32(bm, wrow + x);
                    __mmask16 mneg =
                        _mm512_mask_cmpeq_epi32_mask(bm, wl, neg);
                    _mm512_mask_storeu_epi32(prow + x, mneg, bg);
                }
            }
            /* Winner pixels are disjoint across slots, so per-slot masked
             * overwrite shades each pixel exactly once (the deferred shade of
             * the device pipeline). */
            for (size_t sidx = 0; sidx < r->slots.size(); sidx++) {
                const Slot &sl = r->slots[sidx];
                if (!sl.live) continue;
                int y_lo = std::max(sl.ymin, band_y0);
                int y_hi = std::min(sl.ymax, band_y1 - 1);
                if (y_lo > y_hi) continue;
                const uint32_t *tex =
                    sl.istex ? tex_base + ((size_t)sl.tex << 18) : nullptr;
                shade_slot_avx512(sl, (int32_t)sidx, depth, win, fb->pixels,
                                  W, y_lo, y_hi, tex, config->bilinear != 0);
            }
        });
    } else
#endif
    parallel_rows(H, 32, [&](int band_y0, int band_y1) {
    for (int y = band_y0; y < band_y1; y++) {
    const float fy = (float)y;
    const int64_t row = (int64_t)y * W;
    for (int64_t p = row; p < row + W; p++) {
        int32_t sidx = win[p];
        if (sidx < 0) {
            fb->pixels[p] = config->background;
            continue;
        }
        const Slot &sl = r->slots[(size_t)sidx];
        float fx = (float)(p - row);
        float ooz = depth[p];
        float zi = 1.0f / ooz; /* one reciprocal; w/ooz as multiplies */
        float w0 = (sl.w00[0] + fx * sl.dx[0] + fy * sl.dy[0]) * zi;
        float w1 = (sl.w00[1] + fx * sl.dx[1] + fy * sl.dy[1]) * zi;
        float w2 = (sl.w00[2] + fx * sl.dx[2] + fy * sl.dy[2]) * zi;
        auto interp = [&](const float v[3][3]) -> Vec3 {
            return {v[0][0] * w0 + v[1][0] * w1 + v[2][0] * w2,
                    v[0][1] * w0 + v[1][1] * w1 + v[2][1] * w2,
                    v[0][2] * w0 + v[1][2] * w1 + v[2][2] * w2};
        };
        Vec3 point = -normalize3(interp(sl.cvp));
        Vec3 normal = normalize3(interp(sl.np_));
        Vec3 halfway = normalize3(point + normal);
        float shade = dot3(halfway, normal);
        Vec3 color = interp(sl.attrp);
        if (sl.istex) {
            float u = color.x, v = color.y;
            float lu = ooz / fabsf(sl.tpp[0] - u * sl.dzv[0]);
            float lv = ooz / fabsf(sl.tpp[1] - v * sl.dzv[1]);
            const uint32_t *tex = tex_base + ((size_t)sl.tex << 18);
            color = config->bilinear ? fetch_bilinear(tex, u, v, lu, lv)
                                     : fetch_nearest(tex, u, v, lu, lv);
        }
        uint32_t rr = (uint32_t)(shade * color.x);
        uint32_t gg = (uint32_t)(shade * color.y);
        uint32_t bb = (uint32_t)(shade * color.z);
        fb->pixels[p] = (rr << 16) | (gg << 8) | bb;
    }
    }
    });

    if (kProf) {
        double t_end = now_ms();
        fprintf(stderr,
                "[s3d-native] geometry %7.3f ms  visibility %7.3f ms  "
                "shade %7.3f ms  total %7.3f ms\n",
                t_vis - t_geo, t_shade - t_vis, t_end - t_shade, t_end - t_geo);
    }
}
