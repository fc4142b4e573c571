// awseg_host — native host-side data pipeline of the PyTorch port (the
// port's own copy of awsegbench/native/awseg_host.cpp, unchanged below).
//
// The reference delegates its host image work to OpenCV's C++ (cv2.imread /
// cv2.resize in loader.py:202-250); this library provides the same
// capabilities natively so the data layer needs no OpenCV: a minimal PNG
// decoder (8-bit gray/RGB/RGBA, non-interlaced — the Cityscapes/KITTI
// formats), half-pixel-center bilinear and nearest resize matching
// cv2.INTER_LINEAR / INTER_NEAREST, and a threaded batch packer.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC awseg_host.cpp -lz -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG decoding (8-bit, color types 0/2/4/6, non-interlaced)
// ---------------------------------------------------------------------------

static uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Parse header only: returns 0 on success, fills width/height/channels.
int awseg_png_info(const uint8_t* data, int64_t size, int32_t* width,
                   int32_t* height, int32_t* channels) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 33 || std::memcmp(data, magic, 8) != 0) return -1;
  if (std::memcmp(data + 12, "IHDR", 4) != 0) return -2;
  uint32_t w = read_be32(data + 16), h = read_be32(data + 20);
  uint8_t bit_depth = data[24], color_type = data[25];
  uint8_t interlace = data[28];
  if (bit_depth != 8 || interlace != 0) return -3;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return -4;
  }
  *width = int32_t(w);
  *height = int32_t(h);
  *channels = ch;
  return 0;
}

// Full decode into caller-allocated out[h*w*channels]. Returns 0 on success.
int awseg_png_decode(const uint8_t* data, int64_t size, uint8_t* out,
                     int32_t out_h, int32_t out_w, int32_t out_ch) {
  int32_t w, h, ch;
  int rc = awseg_png_info(data, size, &w, &h, &ch);
  if (rc != 0) return rc;
  if (w != out_w || h != out_h || ch != out_ch) return -5;

  // concatenate IDAT chunks
  std::vector<uint8_t> compressed;
  int64_t pos = 8;
  while (pos + 12 <= size) {
    uint32_t len = read_be32(data + pos);
    const uint8_t* type = data + pos + 4;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      compressed.insert(compressed.end(), data + pos + 8,
                        data + pos + 8 + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (compressed.empty()) return -6;

  const size_t stride = size_t(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_size = uLongf(raw.size());
  if (uncompress(raw.data(), &raw_size, compressed.data(),
                 uLong(compressed.size())) != Z_OK ||
      raw_size != raw.size()) {
    return -7;
  }

  // un-filter rows
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    uint8_t filter = src[0];
    uint8_t* dst = out + size_t(y) * stride;
    const uint8_t* row = src + 1;
    switch (filter) {
      case 0:
        std::memcpy(dst, row, stride);
        break;
      case 1:  // sub
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(row[x] + (x >= size_t(ch) ? dst[x - ch] : 0));
        break;
      case 2:  // up
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(row[x] + prev[x]);
        break;
      case 3:  // average
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(ch) ? dst[x - ch] : 0;
          dst[x] = uint8_t(row[x] + ((a + prev[x]) >> 1));
        }
        break;
      case 4:  // paeth
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(ch) ? dst[x - ch] : 0;
          int c = x >= size_t(ch) ? prev[x - ch] : 0;
          dst[x] = uint8_t(row[x] + paeth(a, prev[x], c));
        }
        break;
      default:
        return -8;
    }
    std::memcpy(prev.data(), dst, stride);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// resize (uint8, HWC) — half-pixel centers, matching cv2 INTER_LINEAR /
// INTER_NEAREST conventions
// ---------------------------------------------------------------------------

void awseg_resize_nearest_u8(const uint8_t* src, int32_t sh, int32_t sw,
                             uint8_t* dst, int32_t dh, int32_t dw,
                             int32_t ch) {
  const double sy = double(sh) / dh, sx = double(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    // cv2 INTER_NEAREST: floor(y * scale)
    int ys = std::min(int(y * sy), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int xs = std::min(int(x * sx), sw - 1);
      std::memcpy(dst + (size_t(y) * dw + x) * ch,
                  src + (size_t(ys) * sw + xs) * ch, ch);
    }
  }
}

void awseg_resize_bilinear_u8(const uint8_t* src, int32_t sh, int32_t sw,
                              uint8_t* dst, int32_t dh, int32_t dw,
                              int32_t ch) {
  const double sy = double(sh) / dh, sx = double(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int y0 = int(std::floor(fy));
    double wy = fy - y0;
    int y1 = std::min(std::max(y0 + 1, 0), sh - 1);
    y0 = std::min(std::max(y0, 0), sh - 1);
    for (int x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int x0 = int(std::floor(fx));
      double wx = fx - x0;
      int x1 = std::min(std::max(x0 + 1, 0), sw - 1);
      int x0c = std::min(std::max(x0, 0), sw - 1);
      for (int c = 0; c < ch; ++c) {
        double v00 = src[(size_t(y0) * sw + x0c) * ch + c];
        double v01 = src[(size_t(y0) * sw + x1) * ch + c];
        double v10 = src[(size_t(y1) * sw + x0c) * ch + c];
        double v11 = src[(size_t(y1) * sw + x1) * ch + c];
        double v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                   v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(size_t(y) * dw + x) * ch + c] = uint8_t(std::lround(v));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// threaded batch pack: gather n item buffers into one contiguous batch
// ---------------------------------------------------------------------------

void awseg_pack_batch(const uint8_t** items, int32_t n, int64_t item_bytes,
                      uint8_t* dst, int32_t n_threads) {
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int i = t; i < n; i += n_threads) {
        std::memcpy(dst + int64_t(i) * item_bytes, items[i],
                    size_t(item_bytes));
      }
    });
  }
  for (auto& th : workers) th.join();
}

}  // extern "C"
