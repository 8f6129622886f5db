// Native image loader: PNG/JPEG decode -> grayscale -> Pillow-exact BILINEAR
// resize, with a pthread batch API and entry points for in-memory images.
//
// The host side of serving: the reference feeds its recognizer through
// PIL.Image.open().convert("L") + resize (netra_ocr/recognition/
// preprocessor.py:38-48), which holds the GIL. This loader reproduces those
// pixels BIT-EXACTLY for PNG inputs (lossless decode + the same fixed-point
// luminance and resample arithmetic as Pillow's convert("L") /
// resize(BILINEAR)) and runs decode+resize for a whole batch on a thread
// pool, off the GIL. The same source as the JAX package's loader.
//
//   * Luminance: Pillow L24 table — L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.
//   * Resize: Pillow resample.c 8bpc two-pass (horizontal then vertical)
//     triangle filter, PRECISION_BITS = 22, per-pass uint8 rounding, the
//     support window / coefficient normalization / rounding replicated.
//   * JPEG: decoded with the system libjpeg-turbo; identical to Pillow when
//     both link the same turbo generation (Pillow bundles its own — tests
//     allow +-1 on JPEG, PNG must be exact).
//
// C ABI only — Python marshals via ctypes (native/imageio.py), built with
// g++ at first use (native/build.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <csetjmp>
#include <vector>
#include <thread>
#include <atomic>

#include <png.h>
#include <jpeglib.h>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow resample.c

inline uint8_t clip8(int64_t in) {
    int64_t v = in >> PRECISION_BITS;
    if (v < 0) return 0;
    if (v > 255) return 255;
    return (uint8_t)v;
}

inline uint8_t rgb_to_l(uint8_t r, uint8_t g, uint8_t b) {
    // Pillow convert.c L24(rgb) >> 16
    return (uint8_t)(((uint32_t)r * 19595 + (uint32_t)g * 38470 + (uint32_t)b * 7471 + 0x8000) >> 16);
}

struct Gray {
    int w = 0, h = 0;
    std::vector<uint8_t> px;  // row-major h x w
};

// ---------------------------------------------------------------------------
// Pillow-exact triangle (bilinear) resample coefficients
// ---------------------------------------------------------------------------

struct Coeffs {
    int ksize = 0;
    std::vector<int> bounds;  // 2 per out pixel: xmin, xcount
    std::vector<int32_t> kk;  // ksize per out pixel
};

static Coeffs precompute_coeffs(int in_size, int out_size) {
    // Mirrors Pillow precompute_coeffs + normalize_coeffs_8bpc for the
    // triangle filter (support 1.0), box [0, in_size].
    Coeffs c;
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // triangle support
    int ksize = (int)ceil(support) * 2 + 1;
    c.ksize = ksize;
    c.bounds.resize(2 * out_size);
    c.kk.resize((size_t)ksize * out_size);
    std::vector<double> prek(ksize);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        int x;
        for (x = 0; x < xmax; x++) {
            double arg = (x + xmin - center + 0.5) * ss;
            if (arg < 0) arg = -arg;
            double w = arg < 1.0 ? 1.0 - arg : 0.0;  // triangle filter
            prek[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) prek[x] /= ww;
        }
        for (; x < ksize; x++) prek[x] = 0;
        // normalize_coeffs_8bpc rounding
        for (x = 0; x < ksize; x++) {
            double v = prek[x];
            c.kk[(size_t)xx * ksize + x] =
                (int32_t)(v < 0 ? v * (1 << PRECISION_BITS) - 0.5 : v * (1 << PRECISION_BITS) + 0.5);
        }
        c.bounds[xx * 2 + 0] = xmin;
        c.bounds[xx * 2 + 1] = xmax;
    }
    return c;
}

static void resample_horizontal(const Gray &in, Gray &out, int out_w, const Coeffs &c) {
    out.w = out_w;
    out.h = in.h;
    out.px.resize((size_t)out_w * in.h);
    for (int y = 0; y < in.h; y++) {
        const uint8_t *row = &in.px[(size_t)y * in.w];
        uint8_t *orow = &out.px[(size_t)y * out_w];
        for (int xx = 0; xx < out_w; xx++) {
            int xmin = c.bounds[xx * 2 + 0];
            int xmax = c.bounds[xx * 2 + 1];
            const int32_t *k = &c.kk[(size_t)xx * c.ksize];
            int64_t ss = 1 << (PRECISION_BITS - 1);
            for (int x = 0; x < xmax; x++) ss += (int64_t)row[xmin + x] * k[x];
            orow[xx] = clip8(ss);
        }
    }
}

static void resample_vertical(const Gray &in, Gray &out, int out_h, const Coeffs &c) {
    out.w = in.w;
    out.h = out_h;
    out.px.resize((size_t)in.w * out_h);
    for (int yy = 0; yy < out_h; yy++) {
        int ymin = c.bounds[yy * 2 + 0];
        int ymax = c.bounds[yy * 2 + 1];
        const int32_t *k = &c.kk[(size_t)yy * c.ksize];
        uint8_t *orow = &out.px[(size_t)yy * in.w];
        for (int x = 0; x < in.w; x++) {
            int64_t ss = 1 << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++) ss += (int64_t)in.px[(size_t)(ymin + y) * in.w + x] * k[y];
            orow[x] = clip8(ss);
        }
    }
}

// Pillow ImagingResample order: horizontal pass first, then vertical, each
// pass rounding to uint8.
static Gray resize_bilinear(const Gray &in, int out_w, int out_h) {
    const Gray *cur = &in;
    Gray tmp, outv;
    if (out_w != in.w) {
        Coeffs ch = precompute_coeffs(in.w, out_w);
        resample_horizontal(*cur, tmp, out_w, ch);
        cur = &tmp;
    }
    if (out_h != cur->h) {
        Coeffs cv = precompute_coeffs(cur->h, out_h);
        resample_vertical(*cur, outv, out_h, cv);
        return outv;
    }
    return *cur;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng) -> Gray
// ---------------------------------------------------------------------------

static bool decode_png(FILE *f, Gray &g) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    png_uint_32 w, h;
    int bit_depth, color_type;
    png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);
    if (bit_depth == 16) png_set_strip_16(png);
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    // alpha is dropped — PIL convert("L") ignores alpha (no compositing)
    if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    png_read_update_info(png, info);
    int channels = png_get_channels(png, info);
    size_t rowbytes = png_get_rowbytes(png, info);
    std::vector<uint8_t> raw((size_t)h * rowbytes);
    std::vector<png_bytep> rows(h);
    for (png_uint_32 y = 0; y < h; y++) rows[y] = &raw[(size_t)y * rowbytes];
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);

    g.w = (int)w;
    g.h = (int)h;
    g.px.resize((size_t)w * h);
    if (channels == 1) {
        for (png_uint_32 y = 0; y < h; y++) memcpy(&g.px[(size_t)y * w], &raw[(size_t)y * rowbytes], w);
    } else if (channels == 3) {
        for (png_uint_32 y = 0; y < h; y++) {
            const uint8_t *r = &raw[(size_t)y * rowbytes];
            uint8_t *o = &g.px[(size_t)y * w];
            for (png_uint_32 x = 0; x < w; x++) o[x] = rgb_to_l(r[3 * x], r[3 * x + 1], r[3 * x + 2]);
        }
    } else {
        return false;
    }
    return true;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) -> Gray
// ---------------------------------------------------------------------------

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr *e = (JpegErr *)cinfo->err;
    longjmp(e->jb, 1);
}

static bool decode_jpeg(FILE *f, Gray &g) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = cinfo.num_components == 1 ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_start_decompress(&cinfo);
    int w = cinfo.output_width, h = cinfo.output_height, ch = cinfo.output_components;
    g.w = w;
    g.h = h;
    g.px.resize((size_t)w * h);
    std::vector<uint8_t> row((size_t)w * ch);
    uint8_t *rp = row.data();
    for (int y = 0; y < h; y++) {
        jpeg_read_scanlines(&cinfo, &rp, 1);
        uint8_t *o = &g.px[(size_t)y * w];
        if (ch == 1) {
            memcpy(o, rp, w);
        } else {
            for (int x = 0; x < w; x++) o[x] = rgb_to_l(rp[3 * x], rp[3 * x + 1], rp[3 * x + 2]);
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

static bool decode_any(const char *path, Gray &g) {
    FILE *f = fopen(path, "rb");
    if (!f) return false;
    uint8_t magic[4] = {0};
    size_t n = fread(magic, 1, 4, f);
    rewind(f);
    bool ok = false;
    if (n == 4 && magic[0] == 0x89 && magic[1] == 'P') {
        ok = decode_png(f, g);
    } else if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
        ok = decode_jpeg(f, g);
    }
    fclose(f);
    return ok;
}

// resize a decoded Gray to (out_h, max(min_w, int(out_h * w/h))) with output
// columns capped at cap_w (identical to full resize + column truncation
// because both resample passes are per-output-column independent).
static int resize_capped(const Gray &g, int out_h, int min_w, int cap_w, uint8_t *out, int *out_w) {
    double aspect = (double)g.w / (double)g.h;
    int new_w = (int)(out_h * aspect);  // int() truncation, reference arithmetic
    if (new_w < min_w) new_w = min_w;
    *out_w = new_w;
    int w_eff = new_w < cap_w ? new_w : cap_w;
    // horizontal coefficients are computed against the FULL new_w grid, then
    // only the first w_eff output columns are evaluated.
    const Gray *cur = &g;
    Gray tmp, outv;
    if (new_w != g.w) {
        Coeffs ch = precompute_coeffs(g.w, new_w);
        // evaluate only w_eff columns
        tmp.w = w_eff;
        tmp.h = g.h;
        tmp.px.resize((size_t)w_eff * g.h);
        for (int y = 0; y < g.h; y++) {
            const uint8_t *row = &g.px[(size_t)y * g.w];
            uint8_t *orow = &tmp.px[(size_t)y * w_eff];
            for (int xx = 0; xx < w_eff; xx++) {
                int xmin = ch.bounds[xx * 2 + 0];
                int xmax = ch.bounds[xx * 2 + 1];
                const int32_t *k = &ch.kk[(size_t)xx * ch.ksize];
                int64_t ss = 1 << (PRECISION_BITS - 1);
                for (int x = 0; x < xmax; x++) ss += (int64_t)row[xmin + x] * k[x];
                orow[xx] = clip8(ss);
            }
        }
        cur = &tmp;
    } else if (w_eff != g.w) {
        // no horizontal resize but cap narrower than input
        tmp.w = w_eff;
        tmp.h = g.h;
        tmp.px.resize((size_t)w_eff * g.h);
        for (int y = 0; y < g.h; y++) memcpy(&tmp.px[(size_t)y * w_eff], &g.px[(size_t)y * g.w], w_eff);
        cur = &tmp;
    }
    if (out_h != cur->h) {
        Coeffs cv = precompute_coeffs(cur->h, out_h);
        resample_vertical(*cur, outv, out_h, cv);
        cur = &outv;
    }
    for (int y = 0; y < out_h; y++) memcpy(out + (size_t)y * cap_w, &cur->px[(size_t)y * cur->w], cur->w);
    return 0;
}

static int load_one(const char *path, int out_h, int min_w, int cap_w, uint8_t *out, int *out_w) {
    Gray g;
    if (!decode_any(path, g) || g.w <= 0 || g.h <= 0) return 1;
    return resize_capped(g, out_h, min_w, cap_w, out, out_w);
}

// In-memory source -> Gray. channels: 1 (gray), 3 (RGB), 4 (RGBA; alpha
// dropped, same as the PNG path / PIL convert("L")). row_stride in BYTES.
static int gray_from_mem(const uint8_t *px, int in_h, int in_w, int channels,
                         int64_t row_stride, Gray &g) {
    if (in_h <= 0 || in_w <= 0 || px == nullptr) return 1;
    if (channels != 1 && channels != 3 && channels != 4) return 1;
    g.w = in_w;
    g.h = in_h;
    g.px.resize((size_t)in_w * in_h);
    for (int y = 0; y < in_h; y++) {
        const uint8_t *r = px + (size_t)y * row_stride;
        uint8_t *o = &g.px[(size_t)y * in_w];
        if (channels == 1) {
            memcpy(o, r, in_w);
        } else {
            for (int x = 0; x < in_w; x++)
                o[x] = rgb_to_l(r[channels * x], r[channels * x + 1], r[channels * x + 2]);
        }
    }
    return 0;
}

static int resize_one_mem(const uint8_t *px, int in_h, int in_w, int channels,
                          int64_t row_stride, int out_h, int min_w, int cap_w,
                          uint8_t *out, int *out_w) {
    Gray g;
    if (gray_from_mem(px, in_h, in_w, channels, row_stride, g) != 0) return 1;
    return resize_capped(g, out_h, min_w, cap_w, out, out_w);
}

}  // namespace

extern "C" {

// Decode+resize one image. out: out_h x cap_w row-major uint8 (caller zeroed /
// whatever — columns beyond *out_w are untouched). Returns 0 on success.
int kh_load_resize_gray(const char *path, int out_h, int min_w, int cap_w,
                        uint8_t *out, int *out_w) {
    return load_one(path, out_h, min_w, cap_w, out, out_w);
}

// Batch version on a thread pool. outs: n * (out_h * cap_w) uint8;
// out_ws/errs: n ints. n_threads <= 0 -> hardware concurrency.
void kh_load_resize_gray_batch(const char **paths, int64_t n, int out_h, int min_w,
                               int cap_w, uint8_t *outs, int *out_ws, int *errs,
                               int n_threads) {
    if (n_threads <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        n_threads = hc ? (int)hc : 1;
    }
    if (n_threads > n) n_threads = (int)n;
    std::atomic<int64_t> next(0);
    size_t stride = (size_t)out_h * cap_w;
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            errs[i] = kh_load_resize_gray(paths[i], out_h, min_w, cap_w,
                                          outs + (size_t)i * stride, &out_ws[i]);
        }
    };
    if (n_threads <= 1) {
        worker();
        return;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto &t : ts) t.join();
}

// Resize an in-memory uint8 image (gray/RGB/RGBA) — the crops-from-memory
// entry point: detection emits page crops as arrays, not files, and the
// document pipeline would otherwise take GIL-held PIL for every crop. Same
// Pillow-exact arithmetic as the file path.
// row_stride in bytes. Returns 0 on success.
int kh_resize_gray_mem(const uint8_t *px, int in_h, int in_w, int channels,
                       int64_t row_stride, int out_h, int min_w, int cap_w,
                       uint8_t *out, int *out_w) {
    return resize_one_mem(px, in_h, in_w, channels, row_stride, out_h, min_w, cap_w, out, out_w);
}

// Batch version on a thread pool. pxs: n pointers; in_hs/in_ws/channels_a/
// strides: n entries; outs: n * (out_h * cap_w) uint8; out_ws/errs: n ints.
void kh_resize_gray_mem_batch(const uint8_t **pxs, const int *in_hs, const int *in_ws,
                              const int *channels_a, const int64_t *strides, int64_t n,
                              int out_h, int min_w, int cap_w, uint8_t *outs,
                              int *out_ws, int *errs, int n_threads) {
    if (n_threads <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        n_threads = hc ? (int)hc : 1;
    }
    if (n_threads > n) n_threads = (int)n;
    std::atomic<int64_t> next(0);
    size_t stride = (size_t)out_h * cap_w;
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            errs[i] = resize_one_mem(pxs[i], in_hs[i], in_ws[i], channels_a[i], strides[i],
                                     out_h, min_w, cap_w, outs + (size_t)i * stride, &out_ws[i]);
        }
    };
    if (n_threads <= 1) {
        worker();
        return;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto &t : ts) t.join();
}

}  // extern "C"
