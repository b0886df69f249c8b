// UV-atlas triangle rasterizer for texture baking (replaces nvdiffrast
// on the reference bake path, inference.py:172-174: positions + coverage
// only, no gradients). Scanline-free barycentric fill per triangle —
// UV charts are tiny (a few texels each at 100k faces / 1024^2), so a
// simple bbox loop in C++ beats any vectorized host formulation on the
// single-core machines this runs on.
//
// Texel convention matches extract/rasterize.py: texel (row r, col c)
// has uv = ((c+0.5)/W, (r+0.5)/H).

#include <cmath>
#include <cstdint>

extern "C" void raster_uv(
    const float *uv,     // [F, 3, 2] uv corners in [0, 1]
    const float *attr,   // [F, 3, A] per-corner attributes
    int64_t F, int64_t A, int64_t H, int64_t W,
    float *out,          // [H * W, A] (caller-zeroed)
    uint8_t *covered) {  // [H * W]  (caller-zeroed)
  const float eps = 1e-6f;
  for (int64_t f = 0; f < F; ++f) {
    const float *u = uv + f * 6;
    float ax = u[0] * W - 0.5f, ay = u[1] * H - 0.5f;
    float bx = u[2] * W - 0.5f, by = u[3] * H - 0.5f;
    float cx = u[4] * W - 0.5f, cy = u[5] * H - 0.5f;

    float lox = ax < bx ? (ax < cx ? ax : cx) : (bx < cx ? bx : cx);
    float hix = ax > bx ? (ax > cx ? ax : cx) : (bx > cx ? bx : cx);
    float loy = ay < by ? (ay < cy ? ay : cy) : (by < cy ? by : cy);
    float hiy = ay > by ? (ay > cy ? ay : cy) : (by > cy ? by : cy);
    int64_t x0 = (int64_t)std::ceil(lox), x1 = (int64_t)std::floor(hix);
    int64_t y0 = (int64_t)std::ceil(loy), y1 = (int64_t)std::floor(hiy);
    if (x0 < 0) x0 = 0;
    if (y0 < 0) y0 = 0;
    if (x1 >= W) x1 = W - 1;
    if (y1 >= H) y1 = H - 1;
    if (x0 > x1 || y0 > y1) continue;

    float det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay);
    if (det > -1e-12f && det < 1e-12f) det = 1e-12f;
    float inv = 1.0f / det;
    const float *a0 = attr + (f * 3 + 0) * A;
    const float *a1 = attr + (f * 3 + 1) * A;
    const float *a2 = attr + (f * 3 + 2) * A;

    for (int64_t y = y0; y <= y1; ++y) {
      float fy = (float)y;
      for (int64_t x = x0; x <= x1; ++x) {
        float fx = (float)x;
        float w1 = ((fx - ax) * (cy - ay) - (cx - ax) * (fy - ay)) * inv;
        float w2 = ((bx - ax) * (fy - ay) - (fx - ax) * (by - ay)) * inv;
        float w0 = 1.0f - w1 - w2;
        if (w0 < -eps || w1 < -eps || w2 < -eps) continue;
        int64_t idx = y * W + x;
        float *o = out + idx * A;
        for (int64_t ch = 0; ch < A; ++ch)
          o[ch] = w0 * a0[ch] + w1 * a1[ch] + w2 * a2[ch];
        covered[idx] = 1;
      }
    }
  }
}
