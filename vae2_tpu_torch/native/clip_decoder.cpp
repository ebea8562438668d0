// Native clip-decode core for the video data pipeline.
//
// The host-side hot path of training is zip -> PNG/JPEG decode -> resize for
// every frame of every clip (reference lib/datasets/cityscapes.py:300-309
// does this with PIL in Python worker processes). This module is the
// C++ equivalent the input pipeline calls through ctypes:
//
//   - PNG decode via libpng (from memory), JPEG via libjpeg
//   - bilinear resize to the training crop, fused with the decode output
//   - a std::thread fan-out that decodes a whole batch of frames in one call
//     (releases the GIL for the entire batch instead of per-image)
//
// C ABI only — bound from vae2_tpu_torch/native/__init__.py with ctypes
// (no pybind11 dependency).
//
// Build: see vae2_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
//        clip_decoder.cpp -lpng -ljpeg -lz)

#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <cmath>
#include <vector>
#include <thread>
#include <atomic>

#include <png.h>
#include <jpeglib.h>

namespace {

struct MemReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  MemReader* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->size) {
    png_error(png, "read past end");
    return;
  }
  std::memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

// Decode a PNG from memory into an RGB8 buffer (h*w*3), returning (w, h).
bool decode_png_rgb(const uint8_t* bytes, size_t len,
                    std::vector<uint8_t>* rgb, int* w, int* h) {
  if (len < 8 || png_sig_cmp(bytes, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
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
  MemReader reader{bytes, len, 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  // normalize everything to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA ||
      png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  rgb->resize(static_cast<size_t>(width) * height * 3);
  std::vector<png_bytep> rows(height);
  for (png_uint_32 y = 0; y < height; ++y)
    rows[y] = rgb->data() + static_cast<size_t>(y) * width * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  return true;
}

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg_rgb(const uint8_t* bytes, size_t len,
                     std::vector<uint8_t>* rgb, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(bytes),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() +
                   static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Separable triangle-filter resize with scale-aware support (antialiased
// downscaling), half-pixel centers — the algorithm PIL's BILINEAR and
// jax.image.resize use, so all three decode paths agree numerically.
struct FilterTaps {
  std::vector<int> start;      // first source index per output pixel
  std::vector<float> weights;  // taps per output pixel, row-major
  int ntaps;
};

FilterTaps build_taps(int src, int dst) {
  FilterTaps t;
  const double scale = static_cast<double>(src) / dst;
  const double support = scale > 1.0 ? scale : 1.0;  // triangle half-width
  t.ntaps = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.start.resize(dst);
  t.weights.assign(static_cast<size_t>(dst) * t.ntaps, 0.0f);
  for (int i = 0; i < dst; ++i) {
    const double center = (i + 0.5) * scale - 0.5;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    double total = 0.0;
    std::vector<double> w(t.ntaps, 0.0);
    for (int k = 0; k < t.ntaps; ++k) {
      int j = lo + k;
      double d = (j - center) / (scale > 1.0 ? scale : 1.0);
      double v = d < 0 ? 1.0 + d : 1.0 - d;  // triangle
      if (v < 0) v = 0;
      w[k] = v;
      total += v;
    }
    t.start[i] = lo;
    for (int k = 0; k < t.ntaps; ++k)
      t.weights[static_cast<size_t>(i) * t.ntaps + k] =
          static_cast<float>(w[k] / total);
  }
  return t;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

void resize_bilinear_rgb(const uint8_t* src, int sw, int sh,
                         uint8_t* dst, int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(dw) * dh * 3);
    return;
  }
  FilterTaps tx = build_taps(sw, dw);
  FilterTaps ty = build_taps(sh, dh);

  // horizontal pass: (sh, sw) -> (sh, dw), float intermediate
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      const float* w = tx.weights.data() + static_cast<size_t>(x) * tx.ntaps;
      for (int k = 0; k < tx.ntaps; ++k) {
        if (w[k] == 0.0f) continue;
        int j = clampi(tx.start[x] + k, 0, sw - 1);
        const uint8_t* p = row + j * 3;
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      out[x * 3 + 0] = acc[0];
      out[x * 3 + 1] = acc[1];
      out[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass: (sh, dw) -> (dh, dw)
  for (int y = 0; y < dh; ++y) {
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    const float* w = ty.weights.data() + static_cast<size_t>(y) * ty.ntaps;
    for (int x = 0; x < dw * 3; ++x) {
      float acc = 0;
      for (int k = 0; k < ty.ntaps; ++k) {
        if (w[k] == 0.0f) continue;
        int j = clampi(ty.start[y] + k, 0, sh - 1);
        acc += w[k] * tmp[static_cast<size_t>(j) * dw * 3 + x];
      }
      float v = acc + 0.5f;
      out[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

int decode_one(const uint8_t* bytes, size_t len, int out_w, int out_h,
               uint8_t* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  bool ok = false;
  if (len >= 8 && !png_sig_cmp(bytes, 0, 8)) {
    ok = decode_png_rgb(bytes, len, &rgb, &w, &h);
  } else if (len >= 2 && bytes[0] == 0xFF && bytes[1] == 0xD8) {
    ok = decode_jpeg_rgb(bytes, len, &rgb, &w, &h);
  }
  if (!ok) return -1;
  resize_bilinear_rgb(rgb.data(), w, h, out, out_w, out_h);
  return 0;
}

}  // namespace

extern "C" {

// Decode one PNG/JPEG image from memory and bilinear-resize into
// out (out_h * out_w * 3, uint8, row-major). Returns 0 on success.
int vae2_decode_frame(const uint8_t* bytes, size_t len, int out_w, int out_h,
                      uint8_t* out) {
  return decode_one(bytes, len, out_w, out_h, out);
}

// Decode `count` images concurrently. bufs/lens index the encoded images;
// out is (count, out_h, out_w, 3) uint8. Returns the number of failures
// (failed slots are zero-filled).
int vae2_decode_batch(const uint8_t** bufs, const size_t* lens, int count,
                      int out_w, int out_h, uint8_t* out, int n_threads) {
  const size_t frame_bytes = static_cast<size_t>(out_w) * out_h * 3;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) break;
      uint8_t* dst = out + frame_bytes * i;
      if (decode_one(bufs[i], lens[i], out_w, out_h, dst) != 0) {
        std::memset(dst, 0, frame_bytes);
        failures.fetch_add(1);
      }
    }
  };
  int nt = n_threads;
  if (nt < 1) nt = 1;
  if (nt > count) nt = count;
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failures.load();
}

int vae2_native_version() { return 1; }

}  // extern "C"
