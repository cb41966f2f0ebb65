// PNG row filters reversed in place, for the port's host PNG decoder
// (vtc_tpu_torch/data/png.py), which the machine with the card needs
// because it has no PIL.
//
// The five filters of the PNG specification (section 9): None, Sub, Up,
// Average and Paeth, each on bytes, with `bpp` the bytes of one pixel
// (at least 1) and the missing left or upper neighbour read as 0. Sub and Up
// are elementwise, Average and Paeth depend on the byte just reversed to
// their left, so the whole pass runs here rather than in numpy.
//
// Built at first use by vtc_tpu_torch/ops/_build.py (g++ -O3 -shared -fPIC),
// loaded with ctypes.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// `raw` holds `rows` scanlines of 1 + `stride` bytes each (the filter type,
// then the filtered bytes); the reversed bytes go to `out` (rows x stride).
// Returns -1 - row at an unknown filter type, else 0.
int vtc_png_unfilter(const uint8_t* raw, int rows, int stride, int bpp, uint8_t* out) {
  for (int r = 0; r < rows; ++r) {
    const uint8_t* in = raw + static_cast<size_t>(r) * (stride + 1);
    uint8_t* cur = out + static_cast<size_t>(r) * stride;
    const uint8_t* prev = r > 0 ? cur - stride : nullptr;
    int type = in[0];
    ++in;
    for (int i = 0; i < stride; ++i) {
      int a = i >= bpp ? cur[i - bpp] : 0;
      int b = prev ? prev[i] : 0;
      int c = prev && i >= bpp ? prev[i - bpp] : 0;
      int x = in[i];
      switch (type) {
        case 0: cur[i] = static_cast<uint8_t>(x); break;
        case 1: cur[i] = static_cast<uint8_t>(x + a); break;
        case 2: cur[i] = static_cast<uint8_t>(x + b); break;
        case 3: cur[i] = static_cast<uint8_t>(x + ((a + b) >> 1)); break;
        case 4: cur[i] = static_cast<uint8_t>(x + paeth(a, b, c)); break;
        default: return -1 - r;
      }
    }
  }
  return 0;
}

}  // extern "C"
