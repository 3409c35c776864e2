// Host-side image kernels of the port's data loader: PNG row unfiltering and
// Pillow's fixed-point BILINEAR resampler, with a plain C interface for
// ctypes (synfmc_tpu_torch/data/image.py builds and loads this file).
//
// The PNG container (chunks, CRCs, the zlib stream) is read in Python with
// the standard library's zlib; what is left is the per-row filter, whose
// Average and Paeth predictors depend on the byte to the left and so run
// byte by byte, and the resize.  Both are exact integer arithmetic:
//   * sfi_unfilter: the PNG specification's reconstruction (filter types
//     0-4, bpp bytes per pixel, the row above taken as zeros for row 0);
//   * sfi_resize_bilinear: byte-identical to PIL's Image.resize(BILINEAR),
//     the resampler of synfmc_tpu/native/fastimage.cpp:36-160 copied as it
//     is: Pillow's coefficient windows, INT32 fixed point
//     (PRECISION_BITS = 22), a uint8 intermediate between the horizontal
//     and the vertical pass.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Pillow-exact BILINEAR resampling (see Pillow src/libImaging/Resample.c).
// ---------------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Coefficient windows for one axis: in_size -> out_size.
// bounds[2*xx] = xmin, bounds[2*xx+1] = xmax (count); kk is (out_size, ksize)
// INT32 fixed-point.  Mirrors Pillow precompute_coeffs + normalize_coeffs_8bpc.
int precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<int>* kk) {
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = filterscale;  // bilinear support 1.0 * filterscale
  int ksize = (int)std::ceil(support) * 2 + 1;

  bounds->assign((size_t)out_size * 2, 0);
  kk->assign((size_t)out_size * ksize, 0);
  std::vector<double> k(ksize);

  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    int* krow = kk->data() + (size_t)xx * ksize;
    for (int x = 0; x < xmax; x++) {
      double v = k[x] * (1 << PRECISION_BITS);
      krow[x] = (int)(v < 0 ? v - 0.5 : v + 0.5);
    }
    (*bounds)[2 * xx] = xmin;
    (*bounds)[2 * xx + 1] = xmax;
  }
  return ksize;
}

// Horizontal pass: (h, in_w, c) uint8 -> (h, out_w, c) uint8.
void resample_horizontal(const uint8_t* in, int h, int in_w, int c,
                         uint8_t* out, int out_w, const std::vector<int>& bounds,
                         const std::vector<int>& kk, int ksize) {
  for (int yy = 0; yy < h; yy++) {
    const uint8_t* irow = in + (size_t)yy * in_w * c;
    uint8_t* orow = out + (size_t)yy * out_w * c;
    for (int xx = 0; xx < out_w; xx++) {
      int xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
      const int* krow = kk.data() + (size_t)xx * ksize;
      for (int ch = 0; ch < c; ch++) {
        int ss0 = 1 << (PRECISION_BITS - 1);
        for (int x = 0; x < xmax; x++)
          ss0 += (int)irow[(size_t)(xmin + x) * c + ch] * krow[x];
        orow[(size_t)xx * c + ch] = clip8(ss0);
      }
    }
  }
}

// Vertical pass: (in_h, w, c) uint8 -> (out_h, w, c) uint8.
void resample_vertical(const uint8_t* in, int in_h, int w, int c, uint8_t* out,
                       int out_h, const std::vector<int>& bounds,
                       const std::vector<int>& kk, int ksize) {
  for (int yy = 0; yy < out_h; yy++) {
    int ymin = bounds[2 * yy], ymax = bounds[2 * yy + 1];
    const int* krow = kk.data() + (size_t)yy * ksize;
    uint8_t* orow = out + (size_t)yy * w * c;
    for (int xx = 0; xx < w * c; xx++) {
      int ss0 = 1 << (PRECISION_BITS - 1);
      for (int y = 0; y < ymax; y++)
        ss0 += (int)in[(size_t)(ymin + y) * w * c + xx] * krow[y];
      orow[xx] = clip8(ss0);
    }
  }
}

// PIL order (Resample.c ImagingResampleInner): horizontal, then vertical,
// with a uint8 intermediate (the horizontal result is clip8-quantized
// before the vertical pass reads it).
void resize_bilinear_u8(const uint8_t* in, int in_h, int in_w, int c,
                        uint8_t* out, int out_h, int out_w) {
  std::vector<int> xb, xk, yb, yk;
  int xks = precompute_coeffs(in_w, out_w, &xb, &xk);
  int yks = precompute_coeffs(in_h, out_h, &yb, &yk);
  if (in_w == out_w && in_h == out_h) {
    std::memcpy(out, in, (size_t)in_h * in_w * c);
    return;
  }
  if (in_w == out_w) {
    resample_vertical(in, in_h, in_w, c, out, out_h, yb, yk, yks);
    return;
  }
  std::vector<uint8_t> tmp((size_t)in_h * out_w * c);
  resample_horizontal(in, in_h, in_w, c, tmp.data(), out_w, xb, xk, xks);
  if (in_h == out_h) {
    std::memcpy(out, tmp.data(), tmp.size());
    return;
  }
  resample_vertical(tmp.data(), in_h, out_w, c, out, out_h, yb, yk, yks);
}

// PNG's Paeth predictor of the byte from its left (a), upper (b) and
// upper-left (c) neighbours.
inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

}  // namespace

extern "C" {

// raw: h rows of (1 filter byte + rowbytes filtered bytes), the inflated
// IDAT stream; out: h * rowbytes reconstructed bytes.  Returns 0, or
// 1 + the row whose filter type is not 0-4.
int sfi_unfilter(const uint8_t* raw, uint8_t* out, int h, int rowbytes, int bpp) {
  std::vector<uint8_t> zeros((size_t)rowbytes, 0);
  const uint8_t* prior = zeros.data();
  for (int y = 0; y < h; y++) {
    const uint8_t* src = raw + (size_t)y * (rowbytes + 1);
    const uint8_t ft = *src++;
    uint8_t* dst = out + (size_t)y * rowbytes;
    switch (ft) {
      case 0:
        std::memcpy(dst, src, (size_t)rowbytes);
        break;
      case 1:  // Sub
        for (int i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < rowbytes; i++) dst[i] = (uint8_t)(src[i] + prior[i]);
        break;
      case 3:  // Average
        for (int i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (((i >= bpp ? dst[i - bpp] : 0) + prior[i]) >> 1));
        break;
      case 4:  // Paeth
        for (int i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0, c = i >= bpp ? prior[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(a, prior[i], c));
        }
        break;
      default:
        return 1 + y;
    }
    prior = dst;
  }
  return 0;
}

// (in_h, in_w, c) uint8 -> (out_h, out_w, c) uint8, PIL's BILINEAR.
int sfi_resize_bilinear(const uint8_t* in, int in_h, int in_w, int c, uint8_t* out, int out_h,
                        int out_w) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || c <= 0) return 1;
  resize_bilinear_u8(in, in_h, in_w, c, out, out_h, out_w);
  return 0;
}

}  // extern "C"
