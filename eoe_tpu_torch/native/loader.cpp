// Native batch image decoder of the port's folder data path: the port's own
// copy of eoe_tpu/native/loader.cpp (the same C API, version 1).
//
// One C++ call decodes a whole index batch with a thread pool (no GIL, no
// fork), fusing decode -> RGB/gray conversion -> bilinear resize to the
// dataset's fixed raw shape, writing straight into the caller's numpy
// buffer. JPEG decode uses libjpeg DCT scaling (1/2, 1/4, 1/8) to decode near
// the target size instead of full size. It is host code: the trainer moves
// the decoded uint8 batch to the card.
//
// C API (ctypes-bound in eoe_tpu_torch/native/__init__.py):
//   eoe_decode_batch(paths, n, out_h, out_w, channels, out, n_threads, status)
//     status[i]: 0 ok, nonzero = decode failed (the caller decodes that image
//     with PIL).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
    std::vector<uint8_t> data;
    int h = 0, w = 0, c = 0;
};

// ----------------------------------------------------------------- jpeg

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, int want_c, int out_h, int out_w,
                 Image& img) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    cinfo.out_color_space = want_c == 1 ? JCS_GRAYSCALE : JCS_RGB;
    // DCT scaling: decode at >= target size but as small as possible
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    for (int denom = 8; denom >= 2; denom /= 2) {
        if ((int)cinfo.image_height / denom >= out_h &&
            (int)cinfo.image_width / denom >= out_w) {
            cinfo.scale_denom = denom;
            break;
        }
    }
    jpeg_start_decompress(&cinfo);
    img.h = cinfo.output_height;
    img.w = cinfo.output_width;
    img.c = cinfo.output_components;
    img.data.resize((size_t)img.h * img.w * img.c);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = img.data.data() + (size_t)cinfo.output_scanline * img.w * img.c;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

// ----------------------------------------------------------------- png

struct PngReadState {
    const uint8_t* data;
    size_t size;
    size_t offset;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
    PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
    if (s->offset + n > s->size) {
        png_error(png, "read past end");
    }
    std::memcpy(out, s->data + s->offset, n);
    s->offset += n;
}

bool decode_png(const uint8_t* buf, size_t len, int want_c, Image& img) {
    if (png_sig_cmp(buf, 0, 8) != 0) return false;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                             nullptr);
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
    PngReadState state{buf, len, 0};
    png_set_read_fn(png, &state, png_mem_read);
    png_read_info(png, info);

    png_set_strip_16(png);
    png_set_strip_alpha(png);
    png_set_packing(png);
    int color = png_get_color_type(png, info);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && png_get_bit_depth(png, info) < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (want_c == 3 && (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA))
        png_set_gray_to_rgb(png);
    if (want_c == 1 && (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
                        color == PNG_COLOR_TYPE_PALETTE))
        png_set_rgb_to_gray_fixed(png, 1, -1, -1);
    png_read_update_info(png, info);

    img.h = png_get_image_height(png, info);
    img.w = png_get_image_width(png, info);
    img.c = png_get_channels(png, info);
    img.data.resize((size_t)img.h * img.w * img.c);
    std::vector<png_bytep> rows(img.h);
    for (int y = 0; y < img.h; y++)
        rows[y] = img.data.data() + (size_t)y * img.w * img.c;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

// ----------------------------------------------------------------- resize

// Pillow-compatible separable triangle (BILINEAR) resampling: the filter
// support scales with the downscale ratio (antialiasing), half-pixel centers.
struct Taps {
    std::vector<int> xmin;      // first source index per output pixel
    std::vector<int> count;     // number of taps per output pixel
    std::vector<float> weights; // max_taps weights per output pixel
    int max_taps = 0;
};

Taps compute_taps(int in_size, int out_size) {
    Taps t;
    const double scale = (double)in_size / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = 1.0 * filterscale;  // triangle filter support
    t.max_taps = (int)std::ceil(support) * 2 + 1;
    t.xmin.resize(out_size);
    t.count.resize(out_size);
    t.weights.assign((size_t)out_size * t.max_taps, 0.0f);
    for (int x = 0; x < out_size; x++) {
        double center = (x + 0.5) * scale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        double total = 0.0;
        int k = 0;
        for (int i = xmin; i < xmax; i++, k++) {
            double d = (i - center + 0.5) / filterscale;
            double w = d < 0 ? (d > -1 ? 1 + d : 0) : (d < 1 ? 1 - d : 0);
            t.weights[(size_t)x * t.max_taps + k] = (float)w;
            total += w;
        }
        if (total > 0) {
            for (int j = 0; j < k; j++)
                t.weights[(size_t)x * t.max_taps + j] /= (float)total;
        }
        t.xmin[x] = xmin;
        t.count[x] = k;
    }
    return t;
}

void bilinear_resize(const Image& src, int out_h, int out_w, int out_c, uint8_t* out) {
    Taps tx = compute_taps(src.w, out_w);
    Taps ty = compute_taps(src.h, out_h);
    // horizontal pass into float (src.h, out_w, out_c)
    std::vector<float> tmp((size_t)src.h * out_w * out_c);
    for (int y = 0; y < src.h; y++) {
        const uint8_t* row = src.data.data() + (size_t)y * src.w * src.c;
        float* trow = tmp.data() + (size_t)y * out_w * out_c;
        for (int x = 0; x < out_w; x++) {
            const float* w = &tx.weights[(size_t)x * tx.max_taps];
            for (int ch = 0; ch < out_c; ch++) {
                int sc = ch < src.c ? ch : src.c - 1;  // replicate when src gray
                float acc = 0.0f;
                for (int k = 0; k < tx.count[x]; k++)
                    acc += w[k] * row[(size_t)(tx.xmin[x] + k) * src.c + sc];
                trow[(size_t)x * out_c + ch] = acc;
            }
        }
    }
    // vertical pass into uint8 (out_h, out_w, out_c)
    for (int y = 0; y < out_h; y++) {
        const float* w = &ty.weights[(size_t)y * ty.max_taps];
        uint8_t* orow = out + (size_t)y * out_w * out_c;
        for (int x = 0; x < out_w * out_c; x++) {
            float acc = 0.0f;
            for (int k = 0; k < ty.count[y]; k++)
                acc += w[k] * tmp[(size_t)(ty.xmin[y] + k) * out_w * out_c + x];
            acc += 0.5f;
            orow[x] = acc <= 0 ? 0 : (acc >= 255 ? 255 : (uint8_t)acc);
        }
    }
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    if (size <= 0) {
        std::fclose(f);
        return false;
    }
    std::fseek(f, 0, SEEK_SET);
    buf.resize(size);
    size_t got = std::fread(buf.data(), 1, size, f);
    std::fclose(f);
    return got == (size_t)size;
}

int decode_one(const char* path, int out_h, int out_w, int channels, uint8_t* out) {
    std::vector<uint8_t> buf;
    if (!read_file(path, buf) || buf.size() < 8) return 1;
    Image img;
    bool ok = false;
    if (buf[0] == 0xFF && buf[1] == 0xD8) {
        ok = decode_jpeg(buf.data(), buf.size(), channels, out_h, out_w, img);
    } else if (png_sig_cmp(buf.data(), 0, 8) == 0) {
        ok = decode_png(buf.data(), buf.size(), channels, img);
    }
    if (!ok || img.h <= 0 || img.w <= 0) return 1;
    if (img.h == out_h && img.w == out_w && img.c == channels) {
        std::memcpy(out, img.data.data(), (size_t)out_h * out_w * channels);
    } else {
        bilinear_resize(img, out_h, out_w, channels, out);
    }
    return 0;
}

}  // namespace

extern "C" {

// decode n images into out (n, out_h, out_w, channels) uint8; status per image
void eoe_decode_batch(const char** paths, int n, int out_h, int out_w, int channels,
                      uint8_t* out, int n_threads, int* status) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int> next(0);
    const size_t stride = (size_t)out_h * out_w * channels;
    auto worker = [&]() {
        for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
            status[i] = decode_one(paths[i], out_h, out_w, channels, out + stride * i);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads - 1; t++) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
}

int eoe_loader_version() { return 1; }

}  // extern "C"
