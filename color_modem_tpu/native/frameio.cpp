// Native frame I/O codec — the host-side hot path of the video pipeline.
//
// The reference does all image handling through PIL + NumPy in Python
// (SURVEY.md C7); at production video rates the uint8 HWC <-> float32 CHW
// conversion and PPM (de)serialization on the host become the feeder
// bottleneck for the accelerator (one 1080-line frame is ~6 MB that must be
// de-interleaved, normalized and laid out before device transfer).  This
// translation unit implements those loops in C++ with OpenMP-free manual
// threading (std::thread) so the Python layer stays a thin ctypes shim
// (color_modem_tpu/native/__init__.py) with a NumPy fallback.
//
// Exposed C ABI (all little-endian, caller owns all buffers):
//   cmt_rgb8_hwc_to_chw_f32(src, dst, frames, lines, samples, threads)
//   cmt_chw_f32_to_rgb8_hwc(src, dst, frames, lines, samples, threads)
//   cmt_write_ppm(path, rgb8_hwc, lines, samples) -> 0/errno
//   cmt_read_ppm(path, dst_rgb8_hwc, max_bytes, &lines, &samples) -> 0/errno
//   cmt_version() -> int

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kVersion = 2;

inline uint8_t clamp_u8(float v) {
    v = v * 255.0f + 0.5f;
    // NaN fails both ordered comparisons below and casting NaN to an
    // integer type is UB — map it to 0 like the NumPy fallback's clip
    if (!(v > 0.0f)) return 0;
    if (v >= 255.0f) return 255;
    return static_cast<uint8_t>(v);
}

void parallel_for(int64_t n, int threads, void (*body)(int64_t, int64_t, void*),
                  void* ctx) {
    if (threads < 1) threads = 1;
    if (threads == 1 || n < 2) {
        body(0, n, ctx);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        pool.emplace_back(body, lo, hi, ctx);
    }
    for (auto& th : pool) th.join();
}

struct ConvCtx {
    const void* src;
    void* dst;
    int64_t lines, samples;
};

// one work item = one (frame, line) row
void u8_to_f32_body(int64_t lo, int64_t hi, void* p) {
    auto* c = static_cast<ConvCtx*>(p);
    const int64_t N = c->samples, L = c->lines;
    const auto* src = static_cast<const uint8_t*>(c->src);
    auto* dst = static_cast<float*>(c->dst);
    for (int64_t row = lo; row < hi; ++row) {
        const int64_t f = row / L, l = row % L;
        const uint8_t* s = src + (f * L + l) * N * 3;
        float* d0 = dst + ((f * 3 + 0) * L + l) * N;
        float* d1 = dst + ((f * 3 + 1) * L + l) * N;
        float* d2 = dst + ((f * 3 + 2) * L + l) * N;
        // true division (not reciprocal multiply): bit-identical to NumPy's
        // float32 x / 255.0, so native and fallback paths are equal
        for (int64_t n = 0; n < N; ++n) {
            d0[n] = s[3 * n + 0] / 255.0f;
            d1[n] = s[3 * n + 1] / 255.0f;
            d2[n] = s[3 * n + 2] / 255.0f;
        }
    }
}

void f32_to_u8_body(int64_t lo, int64_t hi, void* p) {
    auto* c = static_cast<ConvCtx*>(p);
    const int64_t N = c->samples, L = c->lines;
    const auto* src = static_cast<const float*>(c->src);
    auto* dst = static_cast<uint8_t*>(c->dst);
    for (int64_t row = lo; row < hi; ++row) {
        const int64_t f = row / L, l = row % L;
        uint8_t* d = dst + (f * L + l) * N * 3;
        const float* s0 = src + ((f * 3 + 0) * L + l) * N;
        const float* s1 = src + ((f * 3 + 1) * L + l) * N;
        const float* s2 = src + ((f * 3 + 2) * L + l) * N;
        for (int64_t n = 0; n < N; ++n) {
            d[3 * n + 0] = clamp_u8(s0[n]);
            d[3 * n + 1] = clamp_u8(s1[n]);
            d[3 * n + 2] = clamp_u8(s2[n]);
        }
    }
}

struct Y4mCtx {
    const uint8_t* raw;   // first frame's marker byte
    float* dst;           // (count, 3, h, w) float32 RGB
    int64_t stride;       // bytes per frame incl. marker
    int64_t marker;       // marker bytes before each frame's Y plane
    int64_t h, w, ch, cw; // luma / chroma plane dims
    int sv, sh;           // chroma subsampling factors (vertical, horizontal)
};

// One work item = one output (frame, line) row.  BT.601 studio-range
// YCbCr -> RGB with nearest-neighbor chroma upsampling.  Math is FLOAT32
// in the NumPy fallback's exact operation order (NEP 50: python-float
// scalars stay weak, so the fallback never promotes to double), and the
// build passes -ffp-contract=off so no FMA fusion breaks the bit-for-bit
// parity (tests/test_native.py).
void y4m_body(int64_t lo, int64_t hi, void* p) {
    auto* c = static_cast<Y4mCtx*>(p);
    const int64_t H = c->h, W = c->w, CW = c->cw, CH = c->ch;
    // scalar constants rounded to f32 once, as NEP 50 does
    const float c2r = static_cast<float>(2.0 * (1.0 - 0.299));
    const float c2b = static_cast<float>(2.0 * (1.0 - 0.114));
    const float kr = 0.299f, kb = 0.114f;
    const float kg = static_cast<float>(1.0 - 0.299 - 0.114);
    for (int64_t row = lo; row < hi; ++row) {
        const int64_t f = row / H, l = row % H;
        const uint8_t* y8 = c->raw + f * c->stride + c->marker;
        const uint8_t* cb8 = y8 + H * W;
        const uint8_t* cr8 = cb8 + CH * CW;
        int64_t cl = l / c->sv;
        if (cl >= CH) cl = CH - 1;  // odd-dimension guard
        const uint8_t* yl = y8 + l * W;
        const uint8_t* cbl = cb8 + cl * CW;
        const uint8_t* crl = cr8 + cl * CW;
        float* dr = c->dst + ((f * 3 + 0) * H + l) * W;
        float* dg = c->dst + ((f * 3 + 1) * H + l) * W;
        float* db = c->dst + ((f * 3 + 2) * H + l) * W;
        for (int64_t n = 0; n < W; ++n) {
            int64_t cn = n / c->sh;
            if (cn >= CW) cn = CW - 1;
            const float y = (static_cast<float>(yl[n]) - 16.0f) / 219.0f;
            const float cb = (static_cast<float>(cbl[cn]) - 128.0f) / 224.0f;
            const float cr = (static_cast<float>(crl[cn]) - 128.0f) / 224.0f;
            float r = y + c2r * cr;
            float b = y + c2b * cb;
            float g = ((y - kr * r) - kb * b) / kg;
            if (r < 0.0f) r = 0.0f; else if (r > 1.0f) r = 1.0f;
            if (g < 0.0f) g = 0.0f; else if (g > 1.0f) g = 1.0f;
            if (b < 0.0f) b = 0.0f; else if (b > 1.0f) b = 1.0f;
            dr[n] = r;
            dg[n] = g;
            db[n] = b;
        }
    }
}

}  // namespace

extern "C" {

int cmt_version() { return kVersion; }

// Raw planar Y4M frames (marker + Y + Cb + Cr each) -> (count, 3, h, w)
// float32 RGB in [0, 1].  BT.601 studio range, nearest-neighbor chroma.
void cmt_y4m_to_chw_f32(const uint8_t* raw, float* dst, int64_t count,
                        int64_t stride, int64_t marker, int64_t h, int64_t w,
                        int64_t ch, int64_t cw, int sv, int sh, int threads) {
    Y4mCtx c{raw, dst, stride, marker, h, w, ch, cw, sv, sh};
    parallel_for(count * h, threads, y4m_body, &c);
}

// (frames, lines, samples, 3) uint8 -> (frames, 3, lines, samples) float32
void cmt_rgb8_hwc_to_chw_f32(const uint8_t* src, float* dst, int64_t frames,
                             int64_t lines, int64_t samples, int threads) {
    ConvCtx c{src, dst, lines, samples};
    parallel_for(frames * lines, threads, u8_to_f32_body, &c);
}

// (frames, 3, lines, samples) float32 in [0,1] -> (frames, lines, samples, 3)
void cmt_chw_f32_to_rgb8_hwc(const float* src, uint8_t* dst, int64_t frames,
                             int64_t lines, int64_t samples, int threads) {
    ConvCtx c{src, dst, lines, samples};
    parallel_for(frames * lines, threads, f32_to_u8_body, &c);
}

// binary PPM (P6, maxval 255)
int cmt_write_ppm(const char* path, const uint8_t* rgb_hwc, int64_t lines,
                  int64_t samples) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    std::fprintf(f, "P6\n%lld %lld\n255\n", static_cast<long long>(samples),
                 static_cast<long long>(lines));
    size_t n = static_cast<size_t>(lines * samples * 3);
    size_t w = std::fwrite(rgb_hwc, 1, n, f);
    std::fclose(f);
    return w == n ? 0 : 2;
}

int cmt_read_ppm(const char* path, uint8_t* dst, int64_t max_bytes,
                 int64_t* lines, int64_t* samples) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    long long w = 0, h = 0;
    int maxval = 0;
    if (std::fscanf(f, "P6 %lld %lld %d", &w, &h, &maxval) != 3 ||
        maxval != 255 || w <= 0 || h <= 0) {
        std::fclose(f);
        return 3;
    }
    std::fgetc(f);  // single whitespace after header
    int64_t need = static_cast<int64_t>(w) * h * 3;
    if (need > max_bytes) {
        std::fclose(f);
        return 4;
    }
    size_t r = std::fread(dst, 1, static_cast<size_t>(need), f);
    std::fclose(f);
    if (r != static_cast<size_t>(need)) return 5;
    *lines = h;
    *samples = w;
    return 0;
}

}  // extern "C"
