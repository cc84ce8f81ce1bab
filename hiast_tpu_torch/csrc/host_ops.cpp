// The port's fused host ops: the data path's pixel work on the host, in
// C++ with a plain C interface, loaded with ctypes by
// hiast_tpu_torch/data/native_ops.py (a ctypes call releases the
// interpreter lock, so the loader threads run these in parallel).  Host
// code only: no kernel runs on the card.  hiast_tpu_torch/ops/cuda/build.py
// compiles it with the host C++ compiler ($CXX, else c++) at
// -O3 -ffp-contract=off.
//
// Each function computes exactly what its plain numpy version in the port
// computes; that version is the specification, and the two agree bit for
// bit.  So each one keeps the plain version's arithmetic order, types and
// rounding, and no multiply-add may be fused (-ffp-contract=off):
//
// png_unfilter(raw, out, h, stride, bpp)          data/png.py:unfilter_plain
//   raw   h rows of 1 + stride bytes: the filter type, then the filtered row
//   out   h rows of stride unfiltered bytes
//   bpp   bytes per complete pixel, ceil(channels * bit depth / 8), at least 1
//   Returns 0, or 1 + the index of the first row whose filter type is not
//   0-4 (the rows before it are unfiltered).  The Average and Paeth filters
//   are serial along a row (each byte needs the unfiltered byte bpp to its
//   left), which numpy cannot vectorise; one pass here does every type.
// crop_flip_resize_u8(src, w, c, y0, x0, ch, cw, flip, dst, oh, ow)
//                                                  data/augment.py:crop_flip_resize
//   The crop [y0, y0 + ch) x [x0, x0 + cw) of a [h, w, c] image, flipped
//   within the window when flip, resized to [oh, ow, c]: float32 taps
//   (x + 0.5) * cw / ow - 0.5 clamped to [0, cw - 1], the blend along x
//   first, then y, rounded by + 0.5 and truncation.
// crop_flip_resize_nearest_u8(src, w, y0, x0, ch, cw, flip, dst, oh, ow)
//   The same crop and flip of a [h, w] label, nearest: source index
//   floor(x * (cw / ow)) in double, at most cw - 1.
// resize_linear_u8(src, h, w, c, dst, oh, ow)     data/augment.py:resize_linear
//   Half-pixel bilinear: taps in double, the fraction cast to float and set
//   to 0 where the lower tap is off either edge; rows blended first (over
//   the whole source width), then columns; rounded half to even.
// resize_nearest_u8(src, h, w, c, dst, oh, ow)    data/augment.py:resize_nearest
// paste_hard_classes(img, lbl, cp_mask, donor_img, donor_lbl, lut, n, c)
//                                                  data/copy_paste.py:paste_hard_classes
//   In place, in one pass: where lut[donor_lbl] is not 0, the donor's pixel
//   into img and its label into lbl and cp_mask.
//
// Every buffer is C-contiguous uint8 and every size is checked by the
// Python wrappers before the call: nothing here checks a bound.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// augment.py:_crop_taps: crop-relative source indices (a, b) and the
// weight of b per output position, all in float32.
void crop_taps(int64_t n_crop, int64_t n_out, std::vector<int64_t>& a, std::vector<int64_t>& b,
               std::vector<float>& frac) {
  a.resize(n_out);
  b.resize(n_out);
  frac.resize(n_out);
  const float hi = static_cast<float>(n_crop - 1);
  for (int64_t i = 0; i < n_out; ++i) {
    float f = (static_cast<float>(i) + 0.5f) * static_cast<float>(n_crop) / static_cast<float>(n_out);
    f = std::min(std::max(f - 0.5f, 0.0f), hi);
    a[i] = static_cast<int64_t>(f);
    b[i] = std::min(a[i] + 1, n_crop - 1);
    frac[i] = f - static_cast<float>(a[i]);
  }
}

// floor(i * (n_in / n_out)) in double, at most n_in - 1: the nearest
// source index of augment.py's resize_nearest and crop_flip_resize.
std::vector<int64_t> nearest_taps(int64_t n_in, int64_t n_out) {
  std::vector<int64_t> idx(n_out);
  const double scale = static_cast<double>(n_in) / static_cast<double>(n_out);
  for (int64_t i = 0; i < n_out; ++i)
    idx[i] = std::min(static_cast<int64_t>(std::floor(static_cast<double>(i) * scale)), n_in - 1);
  return idx;
}

// augment.py:_linear_taps: lower and upper source index and the weight of
// the upper one, the taps in double and the weight cast to float.
void linear_taps(int64_t n_in, int64_t n_out, std::vector<int64_t>& lo, std::vector<int64_t>& hi,
                 std::vector<float>& frac) {
  lo.resize(n_out);
  hi.resize(n_out);
  frac.resize(n_out);
  const double scale = static_cast<double>(n_in) / static_cast<double>(n_out);
  for (int64_t i = 0; i < n_out; ++i) {
    const double src = (static_cast<double>(i) + 0.5) * scale - 0.5;
    int64_t l = static_cast<int64_t>(std::floor(src));
    float f = static_cast<float>(src - static_cast<double>(l));
    if (l < 0 || l >= n_in - 1) f = 0.0f;
    l = std::min(std::max(l, int64_t{0}), n_in - 1);
    lo[i] = l;
    hi[i] = std::min(l + 1, n_in - 1);
    frac[i] = f;
  }
}

// dst row = src rows picked by the nearest taps, c bytes a pixel
void gather_nearest(const uint8_t* src, int64_t w, int64_t c, const std::vector<int64_t>& rows,
                    const std::vector<int64_t>& cols, uint8_t* dst) {
  const int64_t ow = static_cast<int64_t>(cols.size());
  for (size_t y = 0; y < rows.size(); ++y) {
    const uint8_t* srow = src + rows[y] * w * c;
    uint8_t* drow = dst + static_cast<int64_t>(y) * ow * c;
    if (c == 1) {
      for (int64_t x = 0; x < ow; ++x) drow[x] = srow[cols[x]];
    } else {
      for (int64_t x = 0; x < ow; ++x) std::memcpy(drow + x * c, srow + cols[x] * c, c);
    }
  }
}

}  // namespace

extern "C" {

int png_unfilter(const uint8_t* raw, uint8_t* out, long long h, long long stride, int bpp) {
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

void crop_flip_resize_u8(const uint8_t* src, int64_t w, int64_t c, int64_t y0, int64_t x0, int64_t ch,
                         int64_t cw, int flip, uint8_t* dst, int64_t oh, int64_t ow) {
  std::vector<int64_t> ya, yb, xa, xb;
  std::vector<float> fy, fx;
  crop_taps(ch, oh, ya, yb, fy);
  crop_taps(cw, ow, xa, xb, fx);
  for (int64_t x = 0; x < ow; ++x) {
    if (flip) {  // flip within the crop window
      xa[x] = cw - 1 - xa[x];
      xb[x] = cw - 1 - xb[x];
    }
    xa[x] = (x0 + xa[x]) * c;
    xb[x] = (x0 + xb[x]) * c;
  }
  for (int64_t y = 0; y < oh; ++y) {
    const uint8_t* r0 = src + (y0 + ya[y]) * w * c;
    const uint8_t* r1 = src + (y0 + yb[y]) * w * c;
    const float wy1 = fy[y], wy0 = 1.0f - wy1;
    uint8_t* drow = dst + y * ow * c;
    for (int64_t x = 0; x < ow; ++x) {
      const float wx1 = fx[x], wx0 = 1.0f - wx1;
      for (int64_t k = 0; k < c; ++k) {
        const float a0 = static_cast<float>(r0[xa[x] + k]) * wx0 + static_cast<float>(r0[xb[x] + k]) * wx1;
        const float a1 = static_cast<float>(r1[xa[x] + k]) * wx0 + static_cast<float>(r1[xb[x] + k]) * wx1;
        drow[x * c + k] = static_cast<uint8_t>(a0 * wy0 + a1 * wy1 + 0.5f);
      }
    }
  }
}

void crop_flip_resize_nearest_u8(const uint8_t* src, int64_t w, int64_t y0, int64_t x0, int64_t ch, int64_t cw,
                                 int flip, uint8_t* dst, int64_t oh, int64_t ow) {
  std::vector<int64_t> rows = nearest_taps(ch, oh), cols = nearest_taps(cw, ow);
  for (int64_t& r : rows) r += y0;
  for (int64_t& col : cols) col = x0 + (flip ? cw - 1 - col : col);
  gather_nearest(src, w, 1, rows, cols, dst);
}

void resize_linear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, uint8_t* dst, int64_t oh,
                      int64_t ow) {
  std::vector<int64_t> ly, hy, lx, hx;
  std::vector<float> fy, fx;
  linear_taps(h, oh, ly, hy, fy);
  linear_taps(w, ow, lx, hx, fx);
  std::vector<float> row(static_cast<size_t>(w * c));
  for (int64_t y = 0; y < oh; ++y) {
    const uint8_t* r0 = src + ly[y] * w * c;
    const uint8_t* r1 = src + hy[y] * w * c;
    const float wy1 = fy[y], wy0 = 1.0f - wy1;
    for (int64_t i = 0; i < w * c; ++i)
      row[i] = static_cast<float>(r0[i]) * wy0 + static_cast<float>(r1[i]) * wy1;
    uint8_t* drow = dst + y * ow * c;
    for (int64_t x = 0; x < ow; ++x) {
      const float wx1 = fx[x], wx0 = 1.0f - wx1;
      const float* p0 = row.data() + lx[x] * c;
      const float* p1 = row.data() + hx[x] * c;
      for (int64_t k = 0; k < c; ++k) {
        const float v = std::nearbyint(p0[k] * wx0 + p1[k] * wx1);  // half to even, as np.rint
        drow[x * c + k] = static_cast<uint8_t>(std::min(std::max(v, 0.0f), 255.0f));
      }
    }
  }
}

void resize_nearest_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, uint8_t* dst, int64_t oh,
                       int64_t ow) {
  gather_nearest(src, w, c, nearest_taps(h, oh), nearest_taps(w, ow), dst);
}

void paste_hard_classes(uint8_t* img, uint8_t* lbl, uint8_t* cp_mask, const uint8_t* donor_img,
                        const uint8_t* donor_lbl, const uint8_t* lut, int64_t n_pixels, int64_t c) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    const uint8_t d = donor_lbl[i];
    if (lut[d]) {
      std::memcpy(img + i * c, donor_img + i * c, c);
      lbl[i] = d;
      cp_mask[i] = d;
    }
  }
}

}  // extern "C"
