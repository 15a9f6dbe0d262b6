// PNG row unfiltering (PNG specification, section 9: filter method 0).
//
// png_unfilter undoes the five per-row filters (None, Sub, Up, Average,
// Paeth) of a whole inflated, non-interlaced image in one call. Average and
// Paeth predict each byte from the reconstructed byte bpp to its left, so a
// row is a serial chain of bytes: a Python loop over them costs ~0.5 s per
// 752x480 RGB frame, this loop a few milliseconds.
//
// C ABI only (consumed via ctypes); no Python.h dependency.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC png.cpp -o libpng.so

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);
  const int pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// raw: h rows of (1 filter byte + stride data bytes), as inflated from the
// IDAT stream. out: h * stride bytes. bpp: bytes per complete pixel, rounded
// up to 1 for sub-byte depths (1..8).
// Returns 0 on success, -1 on bad arguments, and 1 + y when row y carries a
// filter type other than 0..4.
int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride,
                 int bpp) {
  if (raw == nullptr || out == nullptr || h < 0 || stride < 0 || bpp < 1 ||
      bpp > 8)
    return -1;
  const uint8_t* prev = nullptr;  // the row above, reconstructed; none on row 0
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const int ftype = line[0];
    ++line;
    uint8_t* cur = out + y * stride;
    switch (ftype) {
      case 0:
        std::memcpy(cur, line, static_cast<size_t>(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + paeth(a, b, c));
        }
        break;
      default:
        return static_cast<int>(1 + y);
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
