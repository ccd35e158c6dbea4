// Host-side scanline polygon fill for the data feed: the port's own copy of
// objgan_tpu/native/rasterize.cc.
//
// The feed fills one polygon per object into the object's box frame for
// every Stage-B, Stage-C and eval batch that carries masks; in numpy that
// loop bounds the feed, so it runs here as native code, loaded through
// ctypes (objgan_tpu_torch/native/__init__.py builds it with g++ at first
// use).
//
// Even-odd fill sampled at pixel centers over the unit square, matching
// objgan_tpu_torch/data/pipeline.py:_numpy_polygon_fill bit for bit (built
// with -ffp-contract=off, so no multiply-add is fused).

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// poly: n_pts * 2 doubles (x, y) in box-local [0,1] coords.
// out:  size * size floats, row-major (y, x), 1.0 inside.
void rasterize_polygon(const double* poly, int n_pts, int size, float* out) {
  std::fill(out, out + static_cast<int64_t>(size) * size, 0.0f);
  if (n_pts < 3) return;
  std::vector<double> xs;
  xs.reserve(n_pts);
  for (int row = 0; row < size; ++row) {
    const double y = (row + 0.5) / size;
    xs.clear();
    for (int i = 0; i < n_pts; ++i) {
      const int j = (i + 1) % n_pts;
      const double y1 = poly[2 * i + 1], y2 = poly[2 * j + 1];
      if ((y1 <= y) != (y2 <= y)) {
        const double t = (y - y1) / (y2 - y1);
        xs.push_back(poly[2 * i] + t * (poly[2 * j] - poly[2 * i]));
      }
    }
    if (xs.empty()) continue;
    std::sort(xs.begin(), xs.end());
    // even-odd: pixels with an odd number of intercepts <= x are inside
    float* row_out = out + static_cast<int64_t>(row) * size;
    size_t k = 0;
    bool inside = false;
    for (int col = 0; col < size; ++col) {
      const double x = (col + 0.5) / size;
      while (k < xs.size() && xs[k] <= x) {
        inside = !inside;
        ++k;
      }
      row_out[col] = inside ? 1.0f : 0.0f;
    }
  }
}

// Batched variant: polys concatenated, offsets[i]..offsets[i+1] delimiting
// each polygon's points. Fills n_polys masks of size*size.
void rasterize_polygons(const double* polys, const int64_t* offsets,
                        int n_polys, int size, float* out) {
  for (int p = 0; p < n_polys; ++p) {
    const int64_t begin = offsets[p], end = offsets[p + 1];
    rasterize_polygon(polys + 2 * begin, static_cast<int>(end - begin), size,
                      out + static_cast<int64_t>(p) * size * size);
  }
}

}  // extern "C"
