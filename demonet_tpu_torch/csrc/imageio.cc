// The native data-loader core: JPEG decode + bilinear resize + [0,1]
// float conversion, multithreaded batch assembly. Host code: no kernel.
//
// A copy of cpp/imageio.cc, the JAX package's, for the PyTorch port: the
// port builds its own library from this file and never loads the JAX
// package's. Counterpart of the reference's native input path (torch
// DataLoader worker processes + libjpeg inside PIL/torchvision,
// reference train.py:137-144). A plain C ABI read through ctypes
// (demonet_tpu_torch/data/native.py).
//
// Build: demonet_tpu_torch/data/native.py runs g++ on it at first use
// (-O3 -shared -fPIC -pthread, -ljpeg) into demonet_tpu_torch/_build/.

#include <cstddef>
#include <cstdio>
#include <cmath>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG bytes to RGB8. Returns true on success.
bool DecodeJpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                int* height, int* width) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *height = cinfo.output_height;
  *width = cinfo.output_width;
  const int stride = cinfo.output_width * cinfo.output_components;
  out->resize(static_cast<size_t>(stride) * cinfo.output_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize RGB8 (h, w) -> float32 [0,1] (out_h, out_w, 3),
// half-pixel centers (matches cv2.INTER_LINEAR / torch
// align_corners=False).
void ResizeToFloat(const uint8_t* src, int h, int w, int out_h, int out_w,
                   float* dst) {
  const float sy = static_cast<float>(h) / out_h;
  const float sx = static_cast<float>(w) / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, h - 1);
    y0 = std::max(y0, 0);
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, w - 1);
      x0 = std::max(x0, 0);
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * w + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * w + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * w + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * w + x1) * 3;
      float* o = dst + (static_cast<size_t>(oy) * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        o[c] = (top * (1 - wy) + bot * wy) * (1.0f / 255.0f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode one JPEG and resize into out (out_h*out_w*3 float32 [0,1]).
// orig_hw receives the pre-resize (height, width). Returns 0 on success.
int demonet_decode_jpeg_resize(const uint8_t* data, int64_t len, int out_h,
                               int out_w, float* out, int* orig_hw) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!DecodeJpeg(data, static_cast<size_t>(len), &rgb, &h, &w)) return 1;
  if (orig_hw) {
    orig_hw[0] = h;
    orig_hw[1] = w;
  }
  ResizeToFloat(rgb.data(), h, w, out_h, out_w, out);
  return 0;
}

// Batch variant: `n` JPEG buffers (data[i], sizes[i]) decoded/resized in
// parallel with `num_threads` workers into out (n, out_h, out_w, 3).
// Returns the number of failures.
int demonet_decode_jpeg_batch(const uint8_t* const* data,
                              const int64_t* sizes, int n, int out_h,
                              int out_w, float* out, int* orig_hw,
                              int num_threads) {
  std::atomic<int> next(0), failures(0);
  const size_t img_elems = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int rc = demonet_decode_jpeg_resize(
          data[i], sizes[i], out_h, out_w, out + img_elems * i,
          orig_hw ? orig_hw + 2 * i : nullptr);
      if (rc != 0) failures.fetch_add(1);
    }
  };
  int t = std::max(1, num_threads);
  std::vector<std::thread> threads;
  threads.reserve(t - 1);
  for (int i = 1; i < t; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
