// Native geometry kernels for the host-side setup path.
//
// The accelerator owns the compute path (JAX/XLA/Pallas); these C++ kernels serve the
// host-side preprocessing that sits outside the jitted graphs:
//   * nearest-boundary distance tables (reference src/mpc/track.py:113-169
//     reduces to a nearest-sample search; O(n*m) pairwise scan, OpenMP),
//   * the sequential corner-mask morphology (reference src/utils.py:41-67),
//     whose data-dependent in-place loops don't vectorize.
//
// Built as a plain shared library, bound via ctypes (no pybind11 dependency);
// the Python callers fall back to numpy implementations when the library is
// unavailable, and tests assert exact parity between the two.

#include <cmath>
#include <cstdint>

extern "C" {

// out[i] = min_j  hypot(path[i] - boundary[j])
void lto_nearest_distances(const double* px, const double* py, int64_t n,
                           const double* bx, const double* by, int64_t m,
                           double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double best = 1e300;
    const double xi = px[i], yi = py[i];
    for (int64_t j = 0; j < m; ++j) {
      const double dx = xi - bx[j];
      const double dy = yi - by[j];
      const double d = dx * dx + dy * dy;
      if (d < best) best = d;
    }
    out[i] = std::sqrt(best);
  }
}

// In-place corner-mask morphology on the (already roll-shifted) mask:
// 1) straights shorter than `proximity` become corner samples,
// 2) corners shorter than `length` are dropped.
// Sequential in-place semantics identical to utils/corners.py.
void lto_filter_corners(uint8_t* mask, const double* dists, int64_t n,
                        double length, double proximity) {
  int64_t start = 0;
  for (int64_t i = 1; i < n; ++i) {
    if (mask[i - 1] && !mask[i]) {
      start = i;  // corner -> straight
    } else if (!mask[i - 1] && mask[i]) {
      const uint8_t val = (dists[i] - dists[start]) < proximity ? 1 : 0;
      for (int64_t j = start; j < i; ++j) mask[j] = val;
    }
  }
  start = 0;
  for (int64_t i = 1; i < n; ++i) {
    if (mask[i - 1] && !mask[i]) {
      const uint8_t val = (dists[i] - dists[start]) > length ? 1 : 0;
      for (int64_t j = start; j < i; ++j) mask[j] = val;
    } else if (!mask[i - 1] && mask[i]) {
      start = i;  // straight -> corner
    }
  }
}

}  // extern "C"
