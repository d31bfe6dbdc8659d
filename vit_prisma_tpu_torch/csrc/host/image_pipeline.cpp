// Native image preprocessing pipeline for vit_prisma_tpu.
//
// The reference relies on torchvision's Python/PIL preprocessing
// (model_transforms.py) which is the host-side bottleneck when feeding a
// TPU activation store.  This library does the whole per-image pipeline in
// one pass, in C++:
//
//   JPEG bytes -> decode (libjpeg) -> antialiased bicubic resize of the
//   shorter side (separable, precomputed weights — same algorithm family
//   as PIL's ANTIALIAS bicubic, a = -0.5) -> center crop -> [0,1] scale ->
//   mean/std normalize -> float32 CHW.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency):
//   ip_preprocess_rgb    : uint8 HWC -> float32 CHW (resize+crop+normalize)
//   ip_decode_jpeg       : JPEG bytes -> uint8 HWC (caller frees via
//                          ip_free)
//   ip_decode_preprocess : JPEG bytes -> float32 CHW, fused
//   ip_preprocess_batch  : N x (uint8 HWC) -> float32 NCHW, threaded
//
// Build: g++ -O3 -march=native -shared -fPIC image_pipeline.cpp -ljpeg
//        (see vit_prisma_tpu/dataloaders/native.py, which builds lazily).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------------------
// Bicubic kernel (Catmull-Rom family, a = -0.5 — matches PIL's BICUBIC).
// ---------------------------------------------------------------------------

inline double bicubic(double x) {
    constexpr double a = -0.5;
    x = std::abs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

struct FilterTaps {
    // For each output index: first input index + normalized weights.
    std::vector<int> first;
    std::vector<int> count;
    std::vector<double> weights;  // flattened [out][max_count]
    int max_count = 0;
};

// Precompute antialiased separable filter weights, PIL-style: when
// downscaling, the kernel is stretched by the scale ratio.
FilterTaps make_taps(int in_size, int out_size) {
    FilterTaps t;
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = std::max(scale, 1.0);
    const double support = 2.0 * filterscale;  // bicubic support = 2
    t.max_count = static_cast<int>(std::ceil(support)) * 2 + 1;
    t.first.resize(out_size);
    t.count.resize(out_size);
    t.weights.assign(static_cast<size_t>(out_size) * t.max_count, 0.0);

    for (int xx = 0; xx < out_size; ++xx) {
        const double center = (xx + 0.5) * scale;
        int lo = static_cast<int>(center - support + 0.5);
        int hi = static_cast<int>(center + support + 0.5);
        lo = std::max(lo, 0);
        hi = std::min(hi, in_size);
        double sum = 0.0;
        const int n = hi - lo;
        for (int i = 0; i < n; ++i) {
            const double w = bicubic((lo + i - center + 0.5) / filterscale);
            t.weights[xx * t.max_count + i] = w;
            sum += w;
        }
        if (sum != 0.0)
            for (int i = 0; i < n; ++i) t.weights[xx * t.max_count + i] /= sum;
        t.first[xx] = lo;
        t.count[xx] = n;
    }
    return t;
}

// Separable resize uint8 HWC -> float HWC (h_out x w_out x c).
void resize_bicubic(const uint8_t* in, int h, int w, int c,
                    float* out, int h_out, int w_out) {
    const FilterTaps tx = make_taps(w, w_out);
    const FilterTaps ty = make_taps(h, h_out);

    // horizontal pass: [h, w_out, c]
    std::vector<float> tmp(static_cast<size_t>(h) * w_out * c);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = in + static_cast<size_t>(y) * w * c;
        float* orow = tmp.data() + static_cast<size_t>(y) * w_out * c;
        for (int x = 0; x < w_out; ++x) {
            const int lo = tx.first[x], n = tx.count[x];
            const double* wts = tx.weights.data() + static_cast<size_t>(x) * tx.max_count;
            for (int ch = 0; ch < c; ++ch) {
                double acc = 0.0;
                for (int i = 0; i < n; ++i)
                    acc += wts[i] * row[(lo + i) * c + ch];
                orow[x * c + ch] = static_cast<float>(acc);
            }
        }
    }
    // vertical pass: [h_out, w_out, c]
    for (int y = 0; y < h_out; ++y) {
        const int lo = ty.first[y], n = ty.count[y];
        const double* wts = ty.weights.data() + static_cast<size_t>(y) * ty.max_count;
        float* orow = out + static_cast<size_t>(y) * w_out * c;
        for (int x = 0; x < w_out * c; ++x) {
            double acc = 0.0;
            for (int i = 0; i < n; ++i)
                acc += wts[i] * tmp[static_cast<size_t>(lo + i) * w_out * c + x];
            orow[x] = static_cast<float>(acc);
        }
    }
}

// Full pipeline: uint8 HWC -> float32 CHW [3, out_size, out_size].
void preprocess_one(const uint8_t* in, int h, int w, int c, int out_size,
                    const float* mean, const float* stdv, float* out_chw) {
    // resize shorter side to out_size
    int rh, rw;
    if (w <= h) {
        rw = out_size;
        rh = std::max(1, static_cast<int>(std::lround(
            static_cast<double>(h) * out_size / w)));
    } else {
        rh = out_size;
        rw = std::max(1, static_cast<int>(std::lround(
            static_cast<double>(w) * out_size / h)));
    }
    std::vector<float> resized(static_cast<size_t>(rh) * rw * c);
    resize_bicubic(in, h, w, c, resized.data(), rh, rw);

    const int top = (rh - out_size) / 2;
    const int left = (rw - out_size) / 2;
    const size_t plane = static_cast<size_t>(out_size) * out_size;
    for (int y = 0; y < out_size; ++y) {
        const float* row = resized.data() +
            (static_cast<size_t>(top + y) * rw + left) * c;
        for (int x = 0; x < out_size; ++x) {
            for (int ch = 0; ch < 3; ++ch) {
                // grayscale -> RGB broadcast when c == 1
                const float v = row[x * c + (c == 3 ? ch : 0)] / 255.0f;
                out_chw[ch * plane + y * out_size + x] =
                    (std::clamp(v, 0.0f, 1.0f) - mean[ch]) / stdv[ch];
            }
        }
    }
}

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jb, 1);
}

}  // namespace

extern "C" {

// uint8 HWC (h, w, c in {1,3}) -> float32 CHW [3, out, out].  Returns 0 OK.
int ip_preprocess_rgb(const uint8_t* in, int h, int w, int c, int out_size,
                      const float* mean, const float* stdv, float* out_chw) {
    if (!in || !out_chw || (c != 1 && c != 3) || h < 1 || w < 1 || out_size < 1)
        return -1;
    preprocess_one(in, h, w, c, out_size, mean, stdv, out_chw);
    return 0;
}

// JPEG bytes -> RGB uint8 HWC.  On success *out (malloc'd; free with
// ip_free), *h, *w set; returns 0.
int ip_decode_jpeg(const uint8_t* data, long len, uint8_t** out,
                   int* h, int* w) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    uint8_t* buf = nullptr;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        std::free(buf);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int W = cinfo.output_width, H = cinfo.output_height;
    buf = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(W) * H * 3));
    if (!buf) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = buf + static_cast<size_t>(cinfo.output_scanline) * W * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    *h = H;
    *w = W;
    return 0;
}

void ip_free(void* p) { std::free(p); }

// JPEG bytes -> float32 CHW, fused.  Returns 0 OK.
int ip_decode_preprocess(const uint8_t* data, long len, int out_size,
                         const float* mean, const float* stdv,
                         float* out_chw) {
    uint8_t* rgb = nullptr;
    int h = 0, w = 0;
    const int rc = ip_decode_jpeg(data, len, &rgb, &h, &w);
    if (rc != 0) return rc;
    preprocess_one(rgb, h, w, 3, out_size, mean, stdv, out_chw);
    std::free(rgb);
    return 0;
}

// Batch of same-shape uint8 HWC images -> float32 NCHW, threaded.
int ip_preprocess_batch(const uint8_t* in, int n, int h, int w, int c,
                        int out_size, const float* mean, const float* stdv,
                        float* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    const size_t in_stride = static_cast<size_t>(h) * w * c;
    const size_t out_stride = 3UL * out_size * out_size;
    auto work = [&](int t) {
        for (int i = t; i < n; i += n_threads)
            preprocess_one(in + i * in_stride, h, w, c, out_size, mean, stdv,
                           out + i * out_stride);
    };
    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
    return 0;
}

}  // extern "C"
