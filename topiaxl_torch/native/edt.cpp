// Exact 2D squared Euclidean distance transform with nearest-site
// indices (Felzenszwalb & Huttenlocher, "Distance Transforms of
// Sampled Functions", ToC 2012). Replaces the texture-seam inpaint's
// dependence on cv2.distanceTransformWithLabels (reference uses a
// dilation-band + sklearn KDTree KNN fill, inference.py:200-211):
// one deterministic native path instead of silently environment-
// dependent cv2/scipy branches.
//
// Column pass: per-column nearest site row via two linear scans
// (input is binary, so the 1D transform degenerates to run scans).
// Row pass: lower envelope of parabolas with argmin propagation.

#include <cstdint>
#include <vector>

namespace {

constexpr double kInf = 1e18;

// Lower-envelope 1D squared-distance transform over sampled function f
// (length n), writing distances d and the argmin source index arg.
void dt1d(const double* f, int64_t n, double* d, int32_t* arg,
          std::vector<int32_t>& v, std::vector<double>& z) {
  v.resize(n);
  z.resize(n + 1);
  int64_t k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int64_t q = 1; q < n; ++q) {
    double s;
    for (;;) {
      const int64_t p = v[k];
      s = ((f[q] + double(q) * q) - (f[p] + double(p) * p)) /
          (2.0 * double(q - p));
      if (s <= z[k] && k > 0) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = int32_t(q);
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[k + 1] < double(q)) ++k;
    const int64_t p = v[k];
    d[q] = f[p] + double(q - p) * double(q - p);
    arg[q] = int32_t(p);
  }
}

}  // namespace

extern "C" {

// sites: [H*W] uint8, nonzero marks a site. Outputs (both [H*W]):
//   out_d2 : int32 squared L2 distance to the nearest site
//   out_idx: int32 flat index (y*W + x) of that nearest site
// Returns 0 on success, 1 if there are no sites.
int edt_index(const uint8_t* sites, int64_t H, int64_t W,
              int32_t* out_d2, int32_t* out_idx) {
  const int64_t n = H * W;
  bool any = false;
  for (int64_t i = 0; i < n; ++i) {
    if (sites[i]) {
      any = true;
      break;
    }
  }
  if (!any) return 1;

  // Column pass: for each (y, x), distance^2 to the nearest site in
  // column x and that site's row. Binary input -> two run scans.
  std::vector<double> colD(n, kInf);
  std::vector<int32_t> colY(n, -1);
  for (int64_t x = 0; x < W; ++x) {
    int64_t last = -1;
    for (int64_t y = 0; y < H; ++y) {
      const int64_t i = y * W + x;
      if (sites[i]) last = y;
      if (last >= 0) {
        const double dy = double(y - last);
        colD[i] = dy * dy;
        colY[i] = int32_t(last);
      }
    }
    last = -1;
    for (int64_t y = H - 1; y >= 0; --y) {
      const int64_t i = y * W + x;
      if (sites[i]) last = y;
      if (last >= 0) {
        const double dy = double(last - y);
        const double d2 = dy * dy;
        if (d2 < colD[i]) {
          colD[i] = d2;
          colY[i] = int32_t(last);
        }
      }
    }
  }

  // Row pass: lower envelope across x of parabolas rooted at each
  // column's best site; the winning root q gives the site (colY[q], q).
  std::vector<double> d(W);
  std::vector<int32_t> arg(W);
  std::vector<int32_t> v;
  std::vector<double> z;
  for (int64_t y = 0; y < H; ++y) {
    const double* f = colD.data() + y * W;
    dt1d(f, W, d.data(), arg.data(), v, z);
    for (int64_t x = 0; x < W; ++x) {
      const int64_t q = arg[x];
      out_d2[y * W + x] = int32_t(d[x] < 2147483647.0 ? d[x] : 2147483647.0);
      out_idx[y * W + x] = int32_t(colY[y * W + q]) * int32_t(W) + int32_t(q);
    }
  }
  return 0;
}

}  // extern "C"
