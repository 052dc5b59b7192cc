// kalman_filter: the Kalman log-likelihood and the fast smoother with
// log-likelihood of univariate linear-Gaussian state-space models, one kernel
// launch for a batch of models.
//
// kalman_ll replaces the TPU kernel `_ll_kernel`
// (bssm_tpu/ops/pallas_kalman.py:303, called at :386): the masked Joseph-form
// forward pass, returning the log-likelihood of each row.  It is the whole
// target of linear-Gaussian marginal MCMC.  Plain version:
// ops/kalman.log_likelihood.
//
// fast_smoother_ll replaces the TPU kernel `_kernel` (pallas_kalman.py:244,
// called at :487): the same forward pass, then the backward mean pass of the
// fast smoother, alphahat_t = a_t + P_t r_{t-1} (Durbin-Koopman eq. 4.44).
// It serves the conditional means of the simulation smoother's draws.  Plain
// version: ops/kalman.fast_smoother_ll.
//
// What bounds them on this card: as in laplace_solve.cu, neither the bytes
// (y, H^2 and D series plus the system: microseconds at 16384 rows) nor the
// operations, but the latency of one chain of n dependent Kalman steps per
// row with m x m matrices in registers.  The batch is the only parallelism,
// so one thread owns one row and blocks are one warp wide, which spreads a
// few thousand rows over every SM.  The per-time inputs of a batched series
// arrive time-major (the wrapper lays them out as (n, B)), so the threads of
// a warp read neighbouring addresses; a series shared by all rows is read
// once per step by every thread from the same address.
//
// kalman_ll keeps its whole state (a, P, ll) in registers and stages
// nothing: the TPU kernel staged v, F, ok, a_t and P_t only because its
// forward pass is shared with the smoother.  fast_smoother_ll stages
// v, F, ok, a_t and P_t (3 + m + m^2 values a step) in a scratch tensor laid
// out time-major (n, rows, B), as laplace_solve.cu does, and recomputes the
// gain in the backward pass instead of staging it.  alpha is written in the
// (B, n+1, m) layout its callers read, as the backward pass produces it.
#include "kalman_common.cuh"

namespace bssm {

template <typename R, int M>
__global__ void kalman_ll_kernel(long B, int n, const R* __restrict__ y,
                                 long y_bs, long y_ts,
                                 const R* __restrict__ h2, long h_bs,
                                 long h_ts, const R* __restrict__ D,
                                 long D_bs, long D_ts,
                                 const R* __restrict__ sys,
                                 R* __restrict__ ll_out) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int MM = M * M;
  Sys<R, M> s;
  load_sys<R, M>(s, sys, B, b);
  y += b * y_bs;
  h2 += b * h_bs;
  D += b * D_bs;

  R a[M], P[MM];
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = s.a1[i];
#pragma unroll
  for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
  R ll = R(0);
  for (int t = 0; t < n; ++t) {
    R v, Fs, okf, inc, att[M], Ptt[MM];
    kf_step<R, M>(s, a, P, y[t * y_ts], h2[t * h_ts], D[t * D_ts], v, Fs,
                  okf, inc, att, Ptt);
    ll += inc;
  }
  ll_out[b] = ll;
}

template <typename R, int M>
__global__ void fast_smoother_ll_kernel(
    long B, int n, const R* __restrict__ y, long y_bs, long y_ts,
    const R* __restrict__ h2, long h_bs, long h_ts, const R* __restrict__ D,
    long D_bs, long D_ts, const R* __restrict__ sys, R* __restrict__ alpha,
    R* __restrict__ ll_out, R* __restrict__ scratch) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int MM = M * M;
  // scratch rows per time step: v, F, ok, a_t (M), P_t (MM)
  constexpr int ROWS = 3 + M + MM;
  constexpr int kV = 0, kF = 1, kOk = 2, kA = 3, kP = 3 + M;
#define SC(t, r) scratch[((long)(t) * ROWS + (r)) * B + b]

  Sys<R, M> s;
  load_sys<R, M>(s, sys, B, b);
  y += b * y_bs;
  h2 += b * h_bs;
  D += b * D_bs;
  alpha += b * (long)(n + 1) * M;

  // ---- forward: Kalman filter, staging what the backward pass needs
  R a[M], P[MM];
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = s.a1[i];
#pragma unroll
  for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
  R ll = R(0);
  for (int t = 0; t < n; ++t) {
#pragma unroll
    for (int i = 0; i < M; ++i) SC(t, kA + i) = a[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) SC(t, kP + i) = P[i];
    R v, Fs, okf, inc, att[M], Ptt[MM];
    kf_step<R, M>(s, a, P, y[t * y_ts], h2[t * h_ts], D[t * D_ts], v, Fs,
                  okf, inc, att, Ptt);
    SC(t, kV) = v;
    SC(t, kF) = Fs;
    SC(t, kOk) = okf;
    ll += inc;
  }
  // alphahat_n = a_n: no observation after the last step
#pragma unroll
  for (int i = 0; i < M; ++i) alpha[(long)n * M + i] = a[i];

  // ---- backward: r recursion and smoothed means
  R r[M];
#pragma unroll
  for (int i = 0; i < M; ++i) r[i] = R(0);
  for (int t = n - 1; t >= 0; --t) {
    R at[M], Pt[MM], al[M];
#pragma unroll
    for (int i = 0; i < M; ++i) at[i] = SC(t, kA + i);
#pragma unroll
    for (int i = 0; i < MM; ++i) Pt[i] = SC(t, kP + i);
    bwd_mean_step<R, M>(s, SC(t, kV), SC(t, kF), SC(t, kOk), at, Pt, r, al);
#pragma unroll
    for (int i = 0; i < M; ++i) alpha[(long)t * M + i] = al[i];
  }
  ll_out[b] = ll;
#undef SC
}

}  // namespace bssm

// Plain C entry points.  Pointers are device pointers.  Each per-time input
// (y, h2 = H^2, D) comes with its batch stride and its time stride in
// elements: (1, B) for a batched series laid out time-major, (0, 1) for one
// shared by all rows, time stride 0 for one constant in time.  `sys` is the
// packed (rows, B) system tensor [Z, T, RR, a1, P1, C].  The log-likelihood
// is the filter's sum; the degenerate-model rule is the wrapper's.  Return
// the launch's cudaError_t, or -1 for an unsupported m.
extern "C" int bssm_kalman_ll(int is_double, int m, long B, int n,
                              const void* y, long y_bs, long y_ts,
                              const void* h2, long h_bs, long h_ts,
                              const void* D, long D_bs, long D_ts,
                              const void* sys, void* ll, int threads,
                              void* stream) {
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  bool known;
#define LAUNCH(R, M)                                                         \
  bssm::kalman_ll_kernel<R, M><<<blocks, threads, 0, (cudaStream_t)stream>>>( \
      B, n, (const R*)y, y_bs, y_ts, (const R*)h2, h_bs, h_ts, (const R*)D,  \
      D_bs, D_ts, (const R*)sys, (R*)ll)
  BSSM_DISPATCH(is_double, m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}

// As bssm_kalman_ll; also writes alpha (B, n+1, m), contiguous, and uses
// `scratch`, (n, 3 + m + m^2, B) values.
extern "C" int bssm_fast_smoother_ll(int is_double, int m, long B, int n,
                                     const void* y, long y_bs, long y_ts,
                                     const void* h2, long h_bs, long h_ts,
                                     const void* D, long D_bs, long D_ts,
                                     const void* sys, void* alpha, void* ll,
                                     void* scratch, int threads,
                                     void* stream) {
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  bool known;
#define LAUNCH(R, M)                                                        \
  bssm::fast_smoother_ll_kernel<R, M>                                       \
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(                       \
          B, n, (const R*)y, y_bs, y_ts, (const R*)h2, h_bs, h_ts,          \
          (const R*)D, D_bs, D_ts, (const R*)sys, (R*)alpha, (R*)ll,        \
          (R*)scratch)
  BSSM_DISPATCH(is_double, m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}
