// Native single-scale Haar-cascade evaluator for the port's face detector,
// a copy of the JAX package's native/cascade_eval.cpp (host code: the port
// imports nothing of that package and builds its own copy with g++ at
// first use, ops/_build.py:host_library).
//
// preprocess/cascade.py parses the OpenCV XML, builds the scale pyramid and
// groups rectangles; it hands one scaled float64 gray image per call and
// receives the surviving window origins.  Per window: variance
// normalisation over the 1-px-inset rect, raw-sum stump test
// `feat < thresh · vnorm`, per-stage early rejection -- the semantics of
// the numpy engine, in the same order of operations, so that both engines
// give the same windows.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace {

struct FeatRect {
    int x, y, w, h;
    double weight;
};

struct Context {
    int win_w = 0, win_h = 0;
    std::vector<int> stage_off;        // n_stages + 1 prefix offsets
    std::vector<double> stage_thr;     // n_stages
    std::vector<int> feat_idx;         // n_weak_total
    std::vector<double> node_thr, left_val, right_val;
    std::vector<FeatRect> rects;       // 3 per feature
};

inline double rect_sum(const double* sat, int stride, int x, int y,
                       int w, int h) {
    return sat[(y + h) * stride + x + w] - sat[y * stride + x + w]
         - sat[(y + h) * stride + x] + sat[y * stride + x];
}

}  // namespace

extern "C" {

void* cascade_create(int win_w, int win_h, int n_stages,
                     const int* stage_offsets,
                     const double* stage_thresholds,
                     const int* feature_idx,
                     const double* node_thresh,
                     const double* left_val,
                     const double* right_val,
                     int n_weak_total,
                     int n_features,
                     const double* features /* (n_features, 3, 5) */) {
    auto* ctx = new Context();
    ctx->win_w = win_w;
    ctx->win_h = win_h;
    ctx->stage_off.assign(stage_offsets, stage_offsets + n_stages + 1);
    ctx->stage_thr.assign(stage_thresholds, stage_thresholds + n_stages);
    ctx->feat_idx.assign(feature_idx, feature_idx + n_weak_total);
    ctx->node_thr.assign(node_thresh, node_thresh + n_weak_total);
    ctx->left_val.assign(left_val, left_val + n_weak_total);
    ctx->right_val.assign(right_val, right_val + n_weak_total);
    ctx->rects.resize(static_cast<size_t>(n_features) * 3);
    for (int f = 0; f < n_features; ++f) {
        for (int k = 0; k < 3; ++k) {
            const double* r = features + (static_cast<size_t>(f) * 3 + k) * 5;
            ctx->rects[static_cast<size_t>(f) * 3 + k] = FeatRect{
                static_cast<int>(r[0]), static_cast<int>(r[1]),
                static_cast<int>(r[2]), static_cast<int>(r[3]), r[4]};
        }
    }
    return ctx;
}

void cascade_destroy(void* p) { delete static_cast<Context*>(p); }

// img: (h, w) float64 grayscale (same values the numpy path resizes to).
// Fills out_xy with surviving (x, y) origin pairs; returns the count
// (clamped to max_out pairs).
int cascade_detect_scaled(const void* p, const double* img, int h, int w,
                          int stride_step, int* out_xy, int max_out) {
    const auto* ctx = static_cast<const Context*>(p);
    const int win_w = ctx->win_w, win_h = ctx->win_h;
    const int hh = h - win_h, ww = w - win_w;
    if (hh <= 0 || ww <= 0) return 0;

    // Integral images with a zero top row/left column, like the numpy
    // path's (H+1, W+1) layout.
    const int sw = w + 1;
    std::vector<double> sat(static_cast<size_t>(h + 1) * sw, 0.0);
    std::vector<double> sat2(static_cast<size_t>(h + 1) * sw, 0.0);
    for (int y = 0; y < h; ++y) {
        double row = 0.0, row2 = 0.0;
        const double* src = img + static_cast<size_t>(y) * w;
        double* s = sat.data() + static_cast<size_t>(y + 1) * sw;
        double* s2 = sat2.data() + static_cast<size_t>(y + 1) * sw;
        const double* su = sat.data() + static_cast<size_t>(y) * sw;
        const double* s2u = sat2.data() + static_cast<size_t>(y) * sw;
        for (int x = 0; x < w; ++x) {
            row += src[x];
            row2 += src[x] * src[x];
            s[x + 1] = su[x + 1] + row;
            s2[x + 1] = s2u[x + 1] + row2;
        }
    }

    const double norm_area =
        static_cast<double>(win_w - 2) * (win_h - 2);
    const int n_stages = static_cast<int>(ctx->stage_thr.size());
    int count = 0;

    // Precompute flattened SAT corner offsets per weak stump for THIS
    // stride (sw), resolving the feat_idx indirection: the stage walk is
    // a single linear scan and each rectangle is four indexed loads off a
    // per-window base pointer (the layout the AVX-512 path below needs).
    struct FlatRect { int o0, o1, o2, o3; double w; };
    const int n_weak = static_cast<int>(ctx->feat_idx.size());
    std::vector<FlatRect> flat(static_cast<size_t>(n_weak) * 3);
    std::vector<uint8_t> nrects(n_weak);
    for (int wk = 0; wk < n_weak; ++wk) {
        const FeatRect* fr =
            &ctx->rects[static_cast<size_t>(ctx->feat_idx[wk]) * 3];
        int nr = 0;
        for (int k = 0; k < 3; ++k) {
            const FeatRect& r = fr[k];
            if (r.weight == 0.0) continue;
            FlatRect& o = flat[static_cast<size_t>(wk) * 3 + nr];
            o.o0 = r.y * sw + r.x;
            o.o1 = o.o0 + r.w;
            o.o2 = o.o0 + r.h * sw;
            o.o3 = o.o2 + r.w;
            o.w = r.weight;
            ++nr;
        }
        nrects[wk] = static_cast<uint8_t>(nr);
    }
    const int v0 = (1) * sw + 1;                    // variance rect corners
    const int v1 = v0 + (win_w - 2);
    const int v2 = v0 + (win_h - 2) * sw;
    const int v3 = v2 + (win_w - 2);

#ifdef __AVX512F__
    // Window-parallel evaluation: 8 window origins per 512-bit vector,
    // all stages run under an alive-lane mask with block-level early
    // exit; 8 lanes amortize the scalar loop's dependent-load chains.
    // Strided (step 1/2) corner loads
    // come from two contiguous vectors + one lane permute — no gathers.
    // Lane arithmetic is the same mul/add sequence as the scalar path.
    if (stride_step == 1 || stride_step == 2) {
        const int step = stride_step;
        const int block_span = 8 * step;            // origins covered/vector
        const __m512i even = _mm512_set_epi64(14, 12, 10, 8, 6, 4, 2, 0);
        const __m512d vone = _mm512_set1_pd(1.0);
        const __m512d vzero = _mm512_setzero_pd();
        const __m512d varea = _mm512_set1_pd(norm_area);
        auto loadw = [&](const double* basep, int off) -> __m512d {
            if (step == 1) return _mm512_loadu_pd(basep + off);
            const __m512d lo = _mm512_loadu_pd(basep + off);
            const __m512d hi = _mm512_loadu_pd(basep + off + 8);
            return _mm512_permutex2var_pd(lo, even, hi);
        };
        for (int y = 0; y < hh; y += step) {
            const double* satrow = sat.data() + static_cast<size_t>(y) * sw;
            const double* sat2row =
                sat2.data() + static_cast<size_t>(y) * sw;
            int x = 0;
            for (; x + block_span <= ww; x += block_span) {
                const double* base = satrow + x;
                const double* base2 = sat2row + x;
                const __m512d total = _mm512_add_pd(
                    _mm512_sub_pd(_mm512_sub_pd(loadw(base, v3),
                                                loadw(base, v1)),
                                  loadw(base, v2)),
                    loadw(base, v0));
                const __m512d sq = _mm512_add_pd(
                    _mm512_sub_pd(_mm512_sub_pd(loadw(base2, v3),
                                                loadw(base2, v1)),
                                  loadw(base2, v2)),
                    loadw(base2, v0));
                const __m512d nf = _mm512_sub_pd(
                    _mm512_mul_pd(varea, sq), _mm512_mul_pd(total, total));
                const __mmask8 pos =
                    _mm512_cmp_pd_mask(nf, vzero, _CMP_GT_OQ);
                const __m512d vnorm = _mm512_mask_sqrt_pd(vone, pos, nf);

                __mmask8 alive = 0xFF;
                const FlatRect* fr = flat.data();
                // Block-level early exit bounds the dead-lane waste.
                for (int s = 0; s < n_stages; ++s) {
                    __m512d stage_sum = vzero;
                    const int end = ctx->stage_off[s + 1];
                    for (int wk = ctx->stage_off[s]; wk < end; ++wk) {
                        __m512d feat = _mm512_mul_pd(
                            _mm512_set1_pd(fr[0].w),
                            _mm512_add_pd(
                                _mm512_sub_pd(
                                    _mm512_sub_pd(loadw(base, fr[0].o3),
                                                  loadw(base, fr[0].o1)),
                                    loadw(base, fr[0].o2)),
                                loadw(base, fr[0].o0)));
                        feat = _mm512_add_pd(feat, _mm512_mul_pd(
                            _mm512_set1_pd(fr[1].w),
                            _mm512_add_pd(
                                _mm512_sub_pd(
                                    _mm512_sub_pd(loadw(base, fr[1].o3),
                                                  loadw(base, fr[1].o1)),
                                    loadw(base, fr[1].o2)),
                                loadw(base, fr[1].o0))));
                        if (nrects[wk] == 3)
                            feat = _mm512_add_pd(feat, _mm512_mul_pd(
                                _mm512_set1_pd(fr[2].w),
                                _mm512_add_pd(
                                    _mm512_sub_pd(
                                        _mm512_sub_pd(loadw(base, fr[2].o3),
                                                      loadw(base, fr[2].o1)),
                                        loadw(base, fr[2].o2)),
                                    loadw(base, fr[2].o0))));
                        const __mmask8 lt = _mm512_cmp_pd_mask(
                            feat,
                            _mm512_mul_pd(_mm512_set1_pd(ctx->node_thr[wk]),
                                          vnorm),
                            _CMP_LT_OQ);
                        stage_sum = _mm512_add_pd(
                            stage_sum,
                            _mm512_mask_blend_pd(
                                lt, _mm512_set1_pd(ctx->right_val[wk]),
                                _mm512_set1_pd(ctx->left_val[wk])));
                        fr += 3;
                    }
                    alive &= _mm512_cmp_pd_mask(
                        stage_sum, _mm512_set1_pd(ctx->stage_thr[s]),
                        _CMP_GE_OQ);
                    if (!alive) break;
                }
                for (int lane = 0; alive; ++lane, alive >>= 1)
                    if ((alive & 1) && count < max_out) {
                        out_xy[2 * count] = x + lane * step;
                        out_xy[2 * count + 1] = y;
                        ++count;
                    }
            }
            // scalar tail of the row (identical math)
            for (; x < ww; x += step) {
                const double* base = satrow + x;
                const double* base2 = sat2row + x;
                const double total =
                    base[v3] - base[v1] - base[v2] + base[v0];
                const double sq =
                    base2[v3] - base2[v1] - base2[v2] + base2[v0];
                const double nf = norm_area * sq - total * total;
                const double vnorm = nf > 0.0 ? std::sqrt(nf) : 1.0;
                bool alive = true;
                const FlatRect* fr = flat.data();
                for (int s = 0; s < n_stages; ++s) {
                    double stage_sum = 0.0;
                    const int end = ctx->stage_off[s + 1];
                    for (int wk = ctx->stage_off[s]; wk < end; ++wk) {
                        double feat =
                            fr[0].w * (base[fr[0].o3] - base[fr[0].o1]
                                       - base[fr[0].o2] + base[fr[0].o0])
                          + fr[1].w * (base[fr[1].o3] - base[fr[1].o1]
                                       - base[fr[1].o2] + base[fr[1].o0]);
                        if (nrects[wk] == 3)
                            feat += fr[2].w * (base[fr[2].o3] - base[fr[2].o1]
                                               - base[fr[2].o2]
                                               + base[fr[2].o0]);
                        stage_sum += feat < ctx->node_thr[wk] * vnorm
                                         ? ctx->left_val[wk]
                                         : ctx->right_val[wk];
                        fr += 3;
                    }
                    if (stage_sum < ctx->stage_thr[s]) {
                        alive = false;
                        break;
                    }
                }
                if (alive && count < max_out) {
                    out_xy[2 * count] = x;
                    out_xy[2 * count + 1] = y;
                    ++count;
                }
            }
        }
        return count;
    }
#endif  // __AVX512F__

    for (int y = 0; y < hh; y += stride_step) {
        const double* satrow = sat.data() + static_cast<size_t>(y) * sw;
        const double* sat2row = sat2.data() + static_cast<size_t>(y) * sw;
        for (int x = 0; x < ww; x += stride_step) {
            const double* base = satrow + x;
            const double* base2 = sat2row + x;
            const double total = base[v3] - base[v1] - base[v2] + base[v0];
            const double sq = base2[v3] - base2[v1] - base2[v2] + base2[v0];
            const double nf = norm_area * sq - total * total;
            const double vnorm = nf > 0.0 ? std::sqrt(nf) : 1.0;

            bool alive = true;
            const FlatRect* fr = flat.data();
            for (int s = 0; s < n_stages; ++s) {
                double stage_sum = 0.0;
                const int end = ctx->stage_off[s + 1];
                for (int wk = ctx->stage_off[s]; wk < end; ++wk) {
                    // (s3 - s1) - s2 + s0: the exact association order
                    // of the original rect_sum, so stage sums (and any
                    // borderline windows) are bit-identical.
                    double feat = fr[0].w * (base[fr[0].o3] - base[fr[0].o1]
                                             - base[fr[0].o2]
                                             + base[fr[0].o0])
                                + fr[1].w * (base[fr[1].o3] - base[fr[1].o1]
                                             - base[fr[1].o2]
                                             + base[fr[1].o0]);
                    if (nrects[wk] == 3)
                        feat += fr[2].w * (base[fr[2].o3] - base[fr[2].o1]
                                           - base[fr[2].o2]
                                           + base[fr[2].o0]);
                    stage_sum += feat < ctx->node_thr[wk] * vnorm
                                     ? ctx->left_val[wk]
                                     : ctx->right_val[wk];
                    fr += 3;
                }
                if (stage_sum < ctx->stage_thr[s]) { alive = false; break; }
            }
            if (alive && count < max_out) {
                out_xy[2 * count] = x;
                out_xy[2 * count + 1] = y;
                ++count;
            }
        }
    }
    return count;
}

}  // extern "C"
