// lc2is native data loader: thread-pooled JPEG/PNG decode + resize, the
// port's copy of the JAX package's native/loader.cpp (the code unchanged, so
// both decode to the same bytes; data/native_loader.py builds it with g++).
//
// The reference's input pipe is single-threaded Python PIL decode
// (data/dataset.py:140-141, DataLoader with no workers at evaluate.py:62).
// The host must keep the card fed; this library decodes and resizes a whole
// batch in parallel C++ threads, writing into one caller-owned buffer (zero
// Python-object churn, one host->device transfer per batch).
//
// C ABI (ctypes-friendly):
//   lc2is_decode_resize_batch(paths, n, out, out_h, out_w, channels,
//                             nearest, num_threads) -> 0 on success,
//   else the (1-based) index of the first failing file negated.
//
// channels=3: force RGB (JPEG or PNG); channels=1: grayscale (label PNGs).
// nearest=1: nearest resize (labels); 0: bilinear (images).
// Resize uses half-pixel centers (torch align_corners=False semantics for
// bilinear; floor(i*in/out) for nearest) — the fast training path. The
// PIL-exact antialiased path remains in Python for parity-critical eval.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  std::vector<uint8_t> data;  // interleaved
  int w = 0, h = 0, c = 0;
};

// ---------------- JPEG ----------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, int want_channels, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = want_channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = cinfo.output_components;
  out->data.resize(size_t(out->w) * out->h * out->c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * out->c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------- PNG ----------------

bool decode_png(FILE* f, int want_channels, Image* out) {
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

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (bit_depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (want_channels == 3 &&
      (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA))
    png_set_gray_to_rgb(png);
  if (want_channels == 1 &&
      (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
       color == PNG_COLOR_TYPE_PALETTE))
    png_set_rgb_to_gray(png, 1, -1, -1);
  png_read_update_info(png, info);

  int c = png_get_channels(png, info);
  out->w = int(w);
  out->h = int(h);
  out->c = c;
  out->data.resize(size_t(w) * h * c);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + size_t(y) * w * c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, int want_channels, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, want_channels, out);
  } else if (magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, want_channels, out);
  }
  fclose(f);
  return ok && out->c >= 1;
}

// ---------------- resize ----------------

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

void resize_nearest(const Image& src, uint8_t* dst, int oh, int ow, int oc) {
  for (int y = 0; y < oh; ++y) {
    int sy = clampi(int((int64_t(y) * src.h) / oh), 0, src.h - 1);
    for (int x = 0; x < ow; ++x) {
      int sx = clampi(int((int64_t(x) * src.w) / ow), 0, src.w - 1);
      const uint8_t* sp = src.data.data() + (size_t(sy) * src.w + sx) * src.c;
      uint8_t* dp = dst + (size_t(y) * ow + x) * oc;
      for (int ch = 0; ch < oc; ++ch) dp[ch] = sp[ch < src.c ? ch : src.c - 1];
    }
  }
}

void resize_bilinear(const Image& src, uint8_t* dst, int oh, int ow, int oc) {
  const float sh = float(src.h) / oh, sw = float(src.w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sh - 0.5f;
    int y0 = int(fy >= 0 ? fy : fy - 1);
    float wy = fy - y0;
    int y0c = clampi(y0, 0, src.h - 1), y1c = clampi(y0 + 1, 0, src.h - 1);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sw - 0.5f;
      int x0 = int(fx >= 0 ? fx : fx - 1);
      float wx = fx - x0;
      int x0c = clampi(x0, 0, src.w - 1), x1c = clampi(x0 + 1, 0, src.w - 1);
      uint8_t* dp = dst + (size_t(y) * ow + x) * oc;
      for (int ch = 0; ch < oc; ++ch) {
        int sc = ch < src.c ? ch : src.c - 1;
        float v00 = src.data[(size_t(y0c) * src.w + x0c) * src.c + sc];
        float v01 = src.data[(size_t(y0c) * src.w + x1c) * src.c + sc];
        float v10 = src.data[(size_t(y1c) * src.w + x0c) * src.c + sc];
        float v11 = src.data[(size_t(y1c) * src.w + x1c) * src.c + sc];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11);
        dp[ch] = uint8_t(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode n files and resize each into out[i] (HWC interleaved uint8,
// out_h*out_w*channels per item).  Returns 0 on success, -(i+1) on the first
// failing item.
int lc2is_decode_resize_batch(const char** paths, int n, uint8_t* out,
                              int out_h, int out_w, int channels, int nearest,
                              int num_threads) {
  if (num_threads <= 0) num_threads = int(std::thread::hardware_concurrency());
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) return;
      Image img;
      if (!decode_file(paths[i], channels, &img)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, -(i + 1));
        return;
      }
      uint8_t* dst = out + size_t(i) * out_h * out_w * channels;
      if (nearest)
        resize_nearest(img, dst, out_h, out_w, channels);
      else
        resize_bilinear(img, dst, out_h, out_w, channels);
    }
  };
  std::vector<std::thread> threads;
  int nt = num_threads < n ? num_threads : n;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

// Decode one file without resize; caller passes a buffer of cap bytes and
// receives dims.  Returns bytes written, 0 on decode failure, -needed if the
// buffer is too small.
long lc2is_decode(const char* path, uint8_t* out, long cap, int channels,
                  int* w, int* h) {
  Image img;
  if (!decode_file(path, channels, &img)) return 0;
  long need = long(img.data.size());
  if (need > cap) return -need;
  memcpy(out, img.data.data(), img.data.size());
  *w = img.w;
  *h = img.h;
  return need;
}

}  // extern "C"
