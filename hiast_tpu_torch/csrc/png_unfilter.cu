// PNG row unfiltering on the host, for the port's decoder
// (hiast_tpu_torch/data/png.py).  Host code only: no kernel runs on the
// card.  It is built by hiast_tpu_torch/ops/cuda/build.py with the same
// nvcc -> shared library -> ctypes route as the kernels, which needs no
// zlib header (Python's zlib inflates the stream first).
//
// Replaces the unfilter half of the JAX package's native decoder
// (native/hiast_host_ops.cc, through hiast_tpu/data/native_ops.py).  The
// Average and Paeth filters are serial along a row (each byte needs the
// unfiltered byte bpp to its left), which numpy cannot vectorise; here
// one pass over the bytes does every filter type.
//
// png_unfilter(raw, out, h, stride, bpp):
//   raw   h rows of 1 + stride bytes: the filter type, then the filtered row
//   out   h rows of stride unfiltered bytes
//   bpp   bytes per complete pixel, ceil(channels * bit depth / 8), at least 1
// Returns 0, or 1 + the index of the first row whose filter type is not 0-4
// (the rows before it are unfiltered).

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" int png_unfilter(const uint8_t* raw, uint8_t* out, long long h, long long stride, int bpp) {
  for (long long y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (stride + 1) + 1;
    const int filter = raw[y * (stride + 1)];
    uint8_t* row = out + y * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;  // the row above, unfiltered
    switch (filter) {
      case 0:  // None
        for (long long x = 0; x < stride; ++x) row[x] = src[x];
        break;
      case 1:  // Sub
        for (long long x = 0; x < stride; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (x >= bpp ? row[x - bpp] : 0));
        break;
      case 2:  // Up
        for (long long x = 0; x < stride; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (up ? up[x] : 0));
        break;
      case 3:  // Average
        for (long long x = 0; x < stride; ++x) {
          const int left = x >= bpp ? row[x - bpp] : 0;
          const int above = up ? up[x] : 0;
          row[x] = static_cast<uint8_t>(src[x] + ((left + above) >> 1));
        }
        break;
      case 4:  // Paeth
        for (long long x = 0; x < stride; ++x) {
          const int left = x >= bpp ? row[x - bpp] : 0;
          const int above = up ? up[x] : 0;
          const int corner = (up && x >= bpp) ? up[x - bpp] : 0;
          row[x] = static_cast<uint8_t>(src[x] + paeth(left, above, corner));
        }
        break;
      default:
        return static_cast<int>(y + 1);
    }
  }
  return 0;
}
