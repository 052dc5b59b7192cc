// Host-side post-processing of stored chains for bssm_tpu_torch.
//
// Copy of the JAX package's bssm_tpu/native/fastdiag.cpp: Sokal IACT
// (src/R_iact.cpp of the R package), streaming weighted moments
// (src/summary.cpp) and stratified resampling (src/stratified_sample.cpp).
// These run on the host, not on the GPU.  Compiled to a plain C shared
// library loaded via ctypes; the diagnostics fall back to numpy when the
// library is unavailable.
//
// Build: bssm_tpu_torch/native/__init__.py (g++ -O3 -march=native -shared
// -fPIC, into bssm_tpu_torch/_build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Sokal adaptive-window IACT of a single standardized series
// (reference: src/R_iact.cpp:4-15).  x must be mean-0, sd-1.
double bssm_iact(const double* x, int64_t n) {
  if (n < 2) return 0.0;
  double C = std::max(5.0, std::log10(static_cast<double>(n)));
  double tau = 1.0;
  for (int64_t k = 1; k < n; k++) {
    double acc = 0.0;
    for (int64_t i = 0; i + k < n; i++) acc += x[i] * x[i + k];
    tau += 2.0 * acc / static_cast<double>(n - k);
    if (static_cast<double>(k) > C * tau) break;
  }
  return std::max(0.0, tau);
}

// Batched IACT: xs is (m, n) row-major raw series; out gets m values.
// Standardisation happens here so callers can pass raw draws.
void bssm_iact_batch(const double* xs, int64_t m, int64_t n, double* out) {
  std::vector<double> buf(n);
  for (int64_t j = 0; j < m; j++) {
    const double* x = xs + j * n;
    double mean = 0.0;
    for (int64_t i = 0; i < n; i++) mean += x[i];
    mean /= static_cast<double>(n);
    double var = 0.0;
    for (int64_t i = 0; i < n; i++) {
      double d = x[i] - mean;
      var += d * d;
    }
    var /= static_cast<double>(n - 1);
    if (var <= 0.0) {
      out[j] = 0.0;
      continue;
    }
    double sd = std::sqrt(var);
    for (int64_t i = 0; i < n; i++) buf[i] = (x[i] - mean) / sd;
    out[j] = bssm_iact(buf.data(), n);
  }
}

// Streaming weighted mean/variance of draws (reference: src/summary.cpp
// weighted_summary): x (s, d) row-major, w (s,); outputs mean (d,),
// var (d,) (diagonal only — the full covariance path stays on device).
void bssm_weighted_moments(const double* x, const double* w, int64_t s,
                           int64_t d, double* mean, double* var) {
  std::vector<double> m(d, 0.0), v(d, 0.0);
  double cum_w = 0.0;
  for (int64_t i = 0; i < s; i++) {
    double wi = w[i];
    if (wi <= 0.0) continue;
    double tmp = cum_w + wi;
    for (int64_t j = 0; j < d; j++) {
      double diff = x[i * d + j] - m[j];
      m[j] += diff * wi / tmp;
      v[j] += wi * diff * (x[i * d + j] - m[j]);
    }
    cum_w = tmp;
  }
  for (int64_t j = 0; j < d; j++) {
    mean[j] = m[j];
    var[j] = cum_w > 0.0 ? v[j] / cum_w : 0.0;
  }
}

// Stratified resampling (reference: src/stratified_sample.cpp:9-28):
// p (n,) normalised weights, r (N,) uniforms, out (N,) indices.
void bssm_stratified_sample(const double* p, int64_t n, const double* r,
                            int64_t N, int64_t* out) {
  std::vector<double> cp(n);
  double acc = 0.0;
  for (int64_t i = 0; i < n; i++) {
    acc += p[i];
    cp[i] = acc;
  }
  cp[n - 1] = 1.0;
  int64_t j = 0;
  double alpha = 1.0 / static_cast<double>(N);
  for (int64_t k = 0; k < n && j < N; k++) {
    while (j < N && (r[j] + static_cast<double>(j)) * alpha <= cp[k]) {
      out[j] = k;
      j++;
    }
  }
  while (j < N) out[j++] = n - 1;
}

}  // extern "C"
