// Native data-path kernels for the host-side pipeline.
//
// The reference leans on external native wheels (decord, open3d, cv2) for its
// host work; here the hot host ops are in-tree C++ behind ctypes:
//   * build_sequence_metadata — one-pass construction of the packed-sequence
//     TokenInfo/rope/scatter-index arrays (the Python builder in
//     models/g2vlm.py is the fallback; this is the production path for
//     36k-token packs)
//   * depth_unproject — pinhole depth -> world points + validity mask
//   * resize_bilinear_f32 — antialias-free bilinear resize (align_corners
//     False, matching torch) for depth/feature maps
//
// Build: g++ -O3 -march=native -shared -fPIC datapath.cpp -o libdatapath.so

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

// Segment descriptor: {type, a, b, c}
//   type 0 = text:   a = num tokens
//   type 1 = dino:   a = hp, b = wp            (framed with soi/eoi)
//   type 2 = vit:    a = t, b = hm, c = wm     (merged grid, framed)
// Attention split ids: text = -1 (causal); dino segments of one sample share
// `dino_fn`; each vit segment gets a fresh id.
struct Seg { int32_t type, a, b, c; };

int64_t build_sequence_metadata(
    const int32_t* segs, int64_t n_segs,
    int32_t doc, int32_t rope_start, int64_t curr_start,
    int32_t fn_start, int32_t dino_fn,
    int32_t soi, int32_t eoi,
    // outputs (caller-allocated, sized for the full pack)
    int32_t* doc_id, int32_t* fn_id, int32_t* noise_id, int32_t* pos_meta,
    int64_t* position_ids,       // (3, S) flattened row-major rows
    uint8_t* is_geo,
    int32_t* text_ids, int64_t* text_indexes, int64_t* n_text_io,
    int64_t* dino_indexes, int64_t* n_dino_io,
    int64_t* vit_indexes, int64_t* n_vit_io,
    int64_t stride /* row stride of position_ids == total S */)
{
    int64_t curr = curr_start;
    int64_t rope = rope_start;
    int64_t nt = *n_text_io, nd = *n_dino_io, nv = *n_vit_io;
    int32_t next_fn = fn_start;

    auto emit = [&](int64_t n, int32_t fn, bool geo) {
        for (int64_t i = 0; i < n; ++i) {
            doc_id[curr + i] = doc;
            fn_id[curr + i] = fn;
            noise_id[curr + i] = -1;
            pos_meta[curr + i] = (int32_t)(curr + i);
            is_geo[curr + i] = geo ? 1 : 0;
        }
    };
    auto set_pos = [&](int64_t at, int64_t t, int64_t h, int64_t w) {
        position_ids[0 * stride + at] = t;
        position_ids[1 * stride + at] = h;
        position_ids[2 * stride + at] = w;
    };
    auto text_token = [&](int32_t tok, int32_t fn) {
        text_ids[nt] = tok;
        text_indexes[nt] = curr;
        ++nt;
        emit(1, fn, false);
        set_pos(curr, rope, rope, rope);
        ++curr;
        ++rope;
    };

    for (int64_t s = 0; s < n_segs; ++s) {
        const Seg& g = *reinterpret_cast<const Seg*>(segs + 4 * s);
        if (g.type == 0) {
            // token ids are filled by the caller (slots marked -1)
            for (int32_t i = 0; i < g.a; ++i) {
                text_ids[nt] = -1;
                text_indexes[nt] = curr;
                ++nt;
                emit(1, -1, false);
                set_pos(curr, rope, rope, rope);
                ++curr;
                ++rope;
            }
        } else if (g.type == 1) {  // dino view
            int64_t hp = g.a, wp = g.b, hw = hp * wp;
            text_token(soi, dino_fn);
            for (int64_t i = 0; i < hw; ++i) {
                int64_t at = curr + i;
                dino_indexes[nd++] = at;
                set_pos(at, rope, rope + i / wp, rope + i % wp);
            }
            emit(hw, dino_fn, true);
            curr += hw;
            rope += std::max(hp, wp) - 1 + 1;
            text_token(eoi, dino_fn);
        } else {  // vit view
            int32_t fn = next_fn++;
            int64_t t = g.a, hm = g.b, wm = g.c, hw = t * hm * wm;
            text_token(soi, fn);
            for (int64_t i = 0; i < hw; ++i) {
                int64_t at = curr + i;
                vit_indexes[nv++] = at;
                int64_t ti = i / (hm * wm), rem = i % (hm * wm);
                set_pos(at, rope + ti, rope + rem / wm, rope + rem % wm);
            }
            emit(hw, fn, false);
            curr += hw;
            int64_t mx = std::max({t, hm, wm});
            rope += mx - 1 + 1;
            text_token(eoi, fn);
        }
    }
    *n_text_io = nt;
    *n_dino_io = nd;
    *n_vit_io = nv;
    // encode final cursors: curr in low 32 bits semantics are fine as return
    return (rope << 32) | (curr & 0xffffffffLL);
}

void depth_unproject(
    const float* depth, int64_t h, int64_t w,
    const float* intrinsics /* 3x3 row-major */,
    const float* cam2world /* 4x4 row-major */,
    float* world_points /* (h, w, 3) */, uint8_t* valid /* (h, w) */)
{
    const float fx = intrinsics[0], cx = intrinsics[2];
    const float fy = intrinsics[4], cy = intrinsics[5];
    const float* R = cam2world;
    for (int64_t v = 0; v < h; ++v) {
        for (int64_t u = 0; u < w; ++u) {
            float d = depth[v * w + u];
            float x = ((float)u - cx) * d / fx;
            float y = ((float)v - cy) * d / fy;
            float wx = R[0] * x + R[1] * y + R[2] * d + R[3];
            float wy = R[4] * x + R[5] * y + R[6] * d + R[7];
            float wz = R[8] * x + R[9] * y + R[10] * d + R[11];
            float* out = world_points + (v * w + u) * 3;
            out[0] = wx; out[1] = wy; out[2] = wz;
            valid[v * w + u] = (std::isfinite(d) && d > 0.f) ? 1 : 0;
        }
    }
}

void resize_bilinear_f32(
    const float* src, int64_t sh, int64_t sw,
    float* dst, int64_t dh, int64_t dw)
{
    const float scale_y = (float)sh / dh, scale_x = (float)sw / dw;
    for (int64_t y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * scale_y - 0.5f;
        int64_t y0 = (int64_t)std::floor(fy);
        float wy = fy - y0;
        int64_t y0c = std::clamp(y0, (int64_t)0, sh - 1);
        int64_t y1c = std::clamp(y0 + 1, (int64_t)0, sh - 1);
        for (int64_t x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * scale_x - 0.5f;
            int64_t x0 = (int64_t)std::floor(fx);
            float wx = fx - x0;
            int64_t x0c = std::clamp(x0, (int64_t)0, sw - 1);
            int64_t x1c = std::clamp(x0 + 1, (int64_t)0, sw - 1);
            float a = src[y0c * sw + x0c], b = src[y0c * sw + x1c];
            float c = src[y1c * sw + x0c], d = src[y1c * sw + x1c];
            dst[y * dw + x] =
                (a * (1 - wx) + b * wx) * (1 - wy) +
                (c * (1 - wx) + d * wx) * wy;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused Qwen2-VL ViT host preprocess: uint8 HWC RGB -> bicubic resize (Keys
// a=-0.5 with PIL-style support scaling on downscale, i.e. antialiased) ->
// CLIP normalize -> merge-grouped patch rows, all in one pass with no
// intermediate CHW tensor or 8-D transpose. Replaces the PIL+numpy chain
// (data/vit_preprocess.py:81-107 / reference image_processing_qwen2_vl.py:
// 155-273 + transforms.py:151-178) that measured 1.6 img/s on one host core.
// Float accumulation throughout (PIL quantizes to uint8 between the two
// separable passes, so outputs differ by <~1/255 per channel pre-normalize).

namespace {

struct ResamplePlan {
    // for each output index: first source index + kernel taps
    std::int64_t ksize;
    // bounds[i*2] = first tap source index, bounds[i*2+1] = tap count
    std::int64_t* bounds;
    float* coeffs;  // (out, ksize)
};

static inline double keys_cubic(double x) {
    // Keys bicubic, a = -0.5 (PIL's BICUBIC filter)
    const double a = -0.5;
    x = std::abs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

static inline double lanczos3(double x) {
    // PIL's LANCZOS filter: sinc(x) * sinc(x/3), support 3
    x = std::abs(x);
    if (x >= 3.0) return 0.0;
    if (x < 1e-12) return 1.0;
    const double pi = 3.14159265358979323846;
    double a = pi * x;
    return 3.0 * std::sin(a) * std::sin(a / 3.0) / (a * a);
}

// filter: 0 = bicubic (support 2), 1 = lanczos3 (support 3)
static ResamplePlan make_plan(std::int64_t in, std::int64_t out,
                              int filter = 0) {
    const double support0 = filter == 1 ? 3.0 : 2.0;
    double (*kern)(double) = filter == 1 ? lanczos3 : keys_cubic;
    double scale = (double)in / out;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support0 * filterscale;
    std::int64_t ksize = (std::int64_t)std::ceil(support) * 2 + 1;
    ResamplePlan p;
    p.ksize = ksize;
    p.bounds = new std::int64_t[out * 2];
    p.coeffs = new float[out * ksize];
    for (std::int64_t xx = 0; xx < out; ++xx) {
        double center = (xx + 0.5) * scale;
        std::int64_t xmin = (std::int64_t)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        std::int64_t xmax = (std::int64_t)(center + support + 0.5);
        if (xmax > in) xmax = in;
        std::int64_t n = xmax - xmin;
        double ss = 0.0;
        double* tmp = new double[n];
        for (std::int64_t i = 0; i < n; ++i) {
            double w = kern((xmin + i - center + 0.5) / filterscale);
            tmp[i] = w;
            ss += w;
        }
        for (std::int64_t i = 0; i < n; ++i)
            p.coeffs[xx * ksize + i] = (float)(ss != 0.0 ? tmp[i] / ss : 0.0);
        for (std::int64_t i = n; i < ksize; ++i) p.coeffs[xx * ksize + i] = 0.f;
        p.bounds[xx * 2] = xmin;
        p.bounds[xx * 2 + 1] = n;
        delete[] tmp;
    }
    return p;
}

static void free_plan(ResamplePlan& p) {
    delete[] p.bounds;
    delete[] p.coeffs;
}

// separable resize of a crop window: uint8 HWC (row stride `sstride` pixels,
// window origin cl,ct, window dims sh,sw) -> float32 HWC (values in [0,255])
static void resize_window_u8_f32(
    const std::uint8_t* src0, std::int64_t sh, std::int64_t sw,
    std::int64_t sstride, std::int64_t cl, std::int64_t ct,
    float* dst, std::int64_t dh, std::int64_t dw, std::int64_t c,
    int filter)
{
    const std::uint8_t* src = src0 + (ct * sstride + cl) * c;
    ResamplePlan px = make_plan(sw, dw, filter);
    ResamplePlan py = make_plan(sh, dh, filter);
    // horizontal pass: (sh, dw, c)
    float* mid = new float[sh * dw * c];
    for (std::int64_t y = 0; y < sh; ++y) {
        const std::uint8_t* row = src + y * sstride * c;
        for (std::int64_t x = 0; x < dw; ++x) {
            std::int64_t x0 = px.bounds[x * 2], n = px.bounds[x * 2 + 1];
            const float* k = px.coeffs + x * px.ksize;
            float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            for (std::int64_t i = 0; i < n; ++i) {
                const std::uint8_t* pix = row + (x0 + i) * c;
                for (std::int64_t ch = 0; ch < c; ++ch)
                    acc[ch] += k[i] * (float)pix[ch];
            }
            float* out = mid + (y * dw + x) * c;
            // PIL clips each separable pass to the uint8 range (bicubic
            // overshoots); clamp without quantizing
            for (std::int64_t ch = 0; ch < c; ++ch)
                out[ch] = std::clamp(acc[ch], 0.f, 255.f);
        }
    }
    // vertical pass
    for (std::int64_t y = 0; y < dh; ++y) {
        std::int64_t y0 = py.bounds[y * 2], n = py.bounds[y * 2 + 1];
        const float* k = py.coeffs + y * py.ksize;
        for (std::int64_t x = 0; x < dw; ++x) {
            float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            for (std::int64_t i = 0; i < n; ++i) {
                const float* pix = mid + ((y0 + i) * dw + x) * c;
                for (std::int64_t ch = 0; ch < c; ++ch)
                    acc[ch] += k[i] * pix[ch];
            }
            float* out = dst + (y * dw + x) * c;
            for (std::int64_t ch = 0; ch < c; ++ch)
                out[ch] = std::clamp(acc[ch], 0.f, 255.f);
        }
    }
    delete[] mid;
    free_plan(px);
    free_plan(py);
}

// original full-image bicubic entry, kept for vit_preprocess_u8
static void resize_bicubic_u8(
    const std::uint8_t* src, std::int64_t sh, std::int64_t sw,
    float* dst, std::int64_t dh, std::int64_t dw, std::int64_t c)
{
    resize_window_u8_f32(src, sh, sw, sw, 0, 0, dst, dh, dw, c, 0);
}

}  // namespace

extern "C" {

// uint8 HWC RGB (sh, sw) -> patch rows (gh*gw, c*tps*p*p), fused two-stage
// resize (to 768-budget target, then smart_resize multiple-of-28 dims —
// both computed by the Python caller), CLIP normalize, and patch tiling.
// Layout matches data/vit_preprocess.py:tile_patches with gt=1:
//   row index = (ghh/m, gww/m, ghh%m, gww%m) row-major over merge groups;
//   row payload = [ch][t][py][px] with the single frame duplicated tps times.
void vit_preprocess_u8(
    const std::uint8_t* src, std::int64_t sh, std::int64_t sw,
    std::int64_t mh, std::int64_t mw,   // stage-1 target (e.g. 768x768)
    std::int64_t th, std::int64_t tw,   // stage-2 smart_resize dims
    const float* mean, const float* stdev,  // (3,)
    std::int64_t patch, std::int64_t merge, std::int64_t tps,
    float* out_rows)
{
    const std::int64_t c = 3;
    float* stage1 = new float[mh * mw * c];
    resize_bicubic_u8(src, sh, sw, stage1, mh, mw, c);
    float* img = stage1;
    float* stage2 = nullptr;
    if (th != mh || tw != mw) {
        // PIL round-trips through uint8 between the two resizes; quantize to
        // match (cheap, and keeps the csrc path within 1/255 of the host one)
        std::uint8_t* q = new std::uint8_t[mh * mw * c];
        for (std::int64_t i = 0; i < mh * mw * c; ++i) {
            float v = stage1[i];
            v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
            q[i] = (std::uint8_t)(v + 0.5f);
        }
        stage2 = new float[th * tw * c];
        resize_bicubic_u8(q, mh, mw, stage2, th, tw, c);
        delete[] q;
        img = stage2;
    }
    const std::int64_t gh = th / patch, gw = tw / patch;
    const std::int64_t m = merge, p = patch;
    const std::int64_t row_len = c * tps * p * p;
    // out row order: (gh/m, gw/m, m, m); payload [ch][t][py][px]
    for (std::int64_t gy = 0; gy < gh; ++gy) {
        for (std::int64_t gx = 0; gx < gw; ++gx) {
            std::int64_t row =
                ((gy / m) * (gw / m) + (gx / m)) * (m * m)
                + (gy % m) * m + (gx % m);
            float* out = out_rows + row * row_len;
            for (std::int64_t ch = 0; ch < c; ++ch) {
                float mu = mean[ch], sd = stdev[ch];
                for (std::int64_t t = 0; t < tps; ++t) {
                    for (std::int64_t py = 0; py < p; ++py) {
                        const float* srow =
                            img + ((gy * p + py) * tw + gx * p) * c + ch;
                        float* orow =
                            out + ((ch * tps + t) * p + py) * p;
                        for (std::int64_t px = 0; px < p; ++px)
                            orow[px] = (srow[px * c] / 255.f - mu) / sd;
                    }
                }
            }
        }
    }
    delete[] stage2;
    delete[] stage1;
}

// PIL-semantics crop+resize: uint8 HWC image, crop window (cl, ct, cw, chh)
// resized to (dh, dw), quantized back to uint8 exactly like PIL's 8bpc
// output rounding. Drop-in for Image.crop((l,t,r,b)).resize((dw,dh), f)
// in the dino/recon host path (data/cropping.py rescale_image_depthmap,
// reference pi3/utils/cropping.py:21-208). filter: 0 bicubic, 1 lanczos3
// (the reference uses LANCZOS when downscaling, BICUBIC upscaling).
void resize_window_u8(
    const std::uint8_t* src, std::int64_t sh, std::int64_t sw,
    std::int64_t cl, std::int64_t ct, std::int64_t cw, std::int64_t chh,
    std::uint8_t* dst, std::int64_t dh, std::int64_t dw,
    std::int64_t c, std::int64_t filter)
{
    float* tmp = new float[dh * dw * c];
    resize_window_u8_f32(src, chh, cw, sw, cl, ct, tmp, dh, dw, c,
                         (int)filter);
    for (std::int64_t i = 0; i < dh * dw * c; ++i) {
        float v = tmp[i];
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        dst[i] = (std::uint8_t)(v + 0.5f);
    }
    delete[] tmp;
}

// torchvision-ColorJitter-order augmentation on (3, h, w) float32 [0,1],
// in place — the exact op sequence of data/augment.py
// random_color_augmentation (reference data/augmentation_vggt.py:11-72):
// ops[i] in {0 brightness, 1 contrast, 2 saturation, 3 hue} applied in the
// given order with a clip to [0,1] after each; optional grayscale after.
// RNG draws (factors, order, gates) stay in Python so the augmentation
// stream is identical to the numpy fallback.
void color_jitter_f32(
    float* img, std::int64_t h, std::int64_t w,
    const std::int32_t* ops, std::int64_t n_ops,
    float fb, float fc, float fs, float fh,
    std::int32_t do_grayscale)
{
    const std::int64_t plane = h * w;
    float* r = img;
    float* g = img + plane;
    float* b = img + 2 * plane;
    auto clip01 = [](float v) {
        return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    };
    for (std::int64_t o = 0; o < n_ops; ++o) {
        switch (ops[o]) {
        case 0:  // brightness
            for (std::int64_t i = 0; i < 3 * plane; ++i)
                img[i] = clip01(img[i] * fb);
            break;
        case 1: {  // contrast about the mean luminance
            double acc = 0.0;
            for (std::int64_t i = 0; i < plane; ++i)
                acc += 0.299 * r[i] + 0.587 * g[i] + 0.114 * b[i];
            float m = (float)(acc / plane);
            for (std::int64_t i = 0; i < 3 * plane; ++i)
                img[i] = clip01((img[i] - m) * fc + m);
            break;
        }
        case 2:  // saturation toward per-pixel luminance
            for (std::int64_t i = 0; i < plane; ++i) {
                float gray = 0.299f * r[i] + 0.587f * g[i] + 0.114f * b[i];
                r[i] = clip01((r[i] - gray) * fs + gray);
                g[i] = clip01((g[i] - gray) * fs + gray);
                b[i] = clip01((b[i] - gray) * fs + gray);
            }
            break;
        default:  // hue rotation via HSV round-trip (augment.py:20-46)
            for (std::int64_t i = 0; i < plane; ++i) {
                float rr = clip01(r[i]), gg = clip01(g[i]), bb = clip01(b[i]);
                float maxc = std::max({rr, gg, bb});
                float minc = std::min({rr, gg, bb});
                float v = maxc, delta = maxc - minc;
                float s = maxc > 0.f
                    ? delta / std::max(maxc, 1e-12f) : 0.f;
                float dz = std::max(delta, 1e-12f);
                float rc = (maxc - rr) / dz;
                float gc = (maxc - gg) / dz;
                float bc = (maxc - bb) / dz;
                float hh = rr == maxc ? bc - gc
                         : gg == maxc ? 2.f + rc - bc
                                      : 4.f + gc - rc;
                hh = hh / 6.f;
                hh -= std::floor(hh);
                if (delta == 0.f) hh = 0.f;
                hh += fh;
                hh -= std::floor(hh);
                float f6 = hh * 6.f;
                float fi = std::floor(f6);
                float f = f6 - fi;
                float p = v * (1.f - s);
                float q = v * (1.f - s * f);
                float t = v * (1.f - s * (1.f - f));
                int ii = ((int)fi) % 6;
                float r2, g2, b2;
                switch (ii) {
                case 0: r2 = v; g2 = t; b2 = p; break;
                case 1: r2 = q; g2 = v; b2 = p; break;
                case 2: r2 = p; g2 = v; b2 = t; break;
                case 3: r2 = p; g2 = q; b2 = v; break;
                case 4: r2 = t; g2 = p; b2 = v; break;
                default: r2 = v; g2 = p; b2 = q; break;
                }
                r[i] = clip01(r2); g[i] = clip01(g2); b[i] = clip01(b2);
            }
        }
    }
    if (do_grayscale) {
        for (std::int64_t i = 0; i < plane; ++i) {
            float gray = 0.299f * r[i] + 0.587f * g[i] + 0.114f * b[i];
            gray = clip01(gray);
            r[i] = gray; g[i] = gray; b[i] = gray;
        }
    }
}

}  // extern "C"
