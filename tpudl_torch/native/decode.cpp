// tpudl native input pipeline: batch JPEG decode + resize + pack.
//
// The reference's image hot loop decodes per row on the executor CPU
// (PIL/libjpeg in Python workers, java.awt in the JVM — SURVEY.md §2.3,
// §3.1 "historically the bottleneck"). This is the TPU-native rebuild's
// one first-party native component (SURVEY.md §7.3): a multithreaded
// libjpeg decoder that goes straight from encoded bytes to the packed
// uint8 BGR batch the device transfer wants, with DCT-domain downscale
// (libjpeg scale_num/denom) so a 4000px photo headed for 299×299 never
// materializes at full size.
//
// Copied from tpudl/native/decode.cpp (the port's host decoder; no GPU
// code). Build: g++ -O3 -shared -fPIC -std=c++17 decode.cpp -ljpeg
//        -lpthread -o <lib>.so   (driven by tpudl_torch/native/__init__.py)
// ABI: plain C, consumed via ctypes — no pybind11 in this image.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void silent_output(j_common_ptr) {}

// Bilinear resize HxWx3 -> out_h x out_w x 3 (uint8), channel-order
// preserving. Matches the semantics (not bit-exactness) of the
// reference's bilinear resizes (PIL BILINEAR / Graphics2D bilinear).
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float y_ratio = static_cast<float>(sh) / dh;
  const float x_ratio = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    // half-pixel centers
    float sy = (y + 0.5f) * y_ratio - 0.5f;
    if (sy < 0) sy = 0;
    int y0 = static_cast<int>(sy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float fy = sy - y0;
    for (int x = 0; x < dw; ++x) {
      float sx = (x + 0.5f) * x_ratio - 0.5f;
      if (sx < 0) sx = 0;
      int x0 = static_cast<int>(sx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float fx = sx - x0;
      for (int c = 0; c < 3; ++c) {
        float tl = src[(y0 * sw + x0) * 3 + c];
        float tr = src[(y0 * sw + x1) * 3 + c];
        float bl = src[(y1 * sw + x0) * 3 + c];
        float br = src[(y1 * sw + x1) * 3 + c];
        float top = tl + (tr - tl) * fx;
        float bot = bl + (br - bl) * fx;
        dst[(y * dw + x) * 3 + c] =
            static_cast<uint8_t>(top + (bot - top) * fy + 0.5f);
      }
    }
  }
}

// Decode one JPEG into BGR uint8 at (out_h, out_w). Returns true on
// success. Uses libjpeg DCT scaling to decode at <= 2x the target size.
bool decode_one(const uint8_t* data, size_t size, int out_h, int out_w,
                uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: pick M/8 (M in 1..8) so the decoded image is
  // the smallest size still >= the resize target in both dims.
  for (int m = 1; m <= 8; ++m) {
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
    long sh = (static_cast<long>(cinfo.image_height) * m + 7) / 8;
    long sw = (static_cast<long>(cinfo.image_width) * m + 7) / 8;
    if (sh >= out_h && sw >= out_w) break;
  }
  jpeg_start_decompress(&cinfo);
  // out_color_space = JCS_RGB above makes libjpeg emit 3 components for
  // every convertible source (grayscale included); unconvertible color
  // spaces error out through error_exit -> caller's PIL fallback.
  const int sh = cinfo.output_height, sw = cinfo.output_width;
  const int row_stride = sw * cinfo.output_components;
  std::vector<uint8_t> decoded(static_cast<size_t>(sh) * sw * 3);
  std::vector<uint8_t> row(row_stride);
  uint8_t* rowp = row.data();
  for (int y = 0; y < sh; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    std::memcpy(decoded.data() + static_cast<size_t>(y) * sw * 3, rowp,
                static_cast<size_t>(sw) * 3);
  }
  jpeg_finish_decompress(&cinfo);
  // Truncated/corrupt-but-recoverable streams surface as libjpeg
  // warnings (padded gray output), not error_exit. The reference's PIL
  // path rejects such files (null-row discipline) — match it.
  const long warnings = cinfo.err->num_warnings;
  jpeg_destroy_decompress(&cinfo);
  if (warnings > 0) return false;

  std::vector<uint8_t> resized(static_cast<size_t>(out_h) * out_w * 3);
  resize_bilinear(decoded.data(), sh, sw, resized.data(), out_h, out_w);
  // RGB -> BGR pack (Spark image-schema storage order)
  const size_t n = static_cast<size_t>(out_h) * out_w;
  for (size_t i = 0; i < n; ++i) {
    out[i * 3] = resized[i * 3 + 2];
    out[i * 3 + 1] = resized[i * 3 + 1];
    out[i * 3 + 2] = resized[i * 3];
  }
  return true;
}

}  // namespace

extern "C" {

// Decode n JPEGs -> packed (n, out_h, out_w, 3) uint8 BGR batch.
// status[i] = 1 ok, 0 decode failure (row left zeroed).
// Returns the number of successfully decoded images.
int tpudl_decode_resize_batch(const uint8_t** datas, const size_t* sizes,
                              int n, int out_h, int out_w, uint8_t* out,
                              uint8_t* status, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n) n_threads = n;
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      bool good = decode_one(datas[i], sizes[i], out_h, out_w,
                             out + static_cast<size_t>(i) * img_bytes);
      status[i] = good ? 1 : 0;
      if (good) {
        ok.fetch_add(1);
      } else {
        std::memset(out + static_cast<size_t>(i) * img_bytes, 0, img_bytes);
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return ok.load();
}

int tpudl_native_abi_version() { return 1; }

}  // extern "C"
