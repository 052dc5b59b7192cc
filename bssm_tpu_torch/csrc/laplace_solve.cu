// laplace_solve: the whole Laplace (Gaussian-approximation) mode iteration of
// a non-Gaussian state-space model, one kernel launch for a batch of models.
//
// Replaces the TPU kernel `_laplace_solve_kernel`
// (bssm_tpu/ops/pallas_kalman.py:785, called at :920).  Per batch row:
//   repeat { pseudo-observations (ytilde, HHtilde) from the current signal
//            mode -> masked Joseph-form Kalman filter + log-likelihood ->
//            backward mean pass of the fast smoother -> new signal mode }
//   until the mean-squared change of the mode is <= conv_tol, or max_iter.
//
// What bounds it on this card: neither its bytes nor its operations (both
// bounds are tens of microseconds at 16384 rows) but the latency of one long
// chain of dependent operations per row (n steps forward, n steps backward,
// four or five passes) with m x m matrices in registers.  The batch is the
// only parallelism, and 4096 rows are 128 warps for 132 SMs.  The design
// therefore gives one thread one row and uses blocks of one warp so that
// every SM gets work.  The per-time quantities the backward pass needs
// (v, F, ok, a_t, P_t: 3 + m + m^2 values a step) do not fit in registers, so
// they are staged in a scratch tensor the wrapper allocates, laid out
// time-major (n, rows, B): the threads of a warp touch neighbouring
// addresses.  At m = 2, n = 153, float32 the scratch is 6.7 KB a row: 27 MB
// at 4096 rows, inside the 50 MB L2 cache, and 110 MB at 16384 rows, where
// every pass streams it through device memory and the time per row goes up.
// The two mode buffers of the iteration live in the same scratch.
// Convergence is tested per row, as the JAX package's scan path does; a
// thread whose row has converged idles until its warp is done.
#include "kalman_common.cuh"

namespace bssm {

template <typename R, int M>
__global__ void laplace_solve_kernel(
    int dist, long B, int n, const R* __restrict__ y, long y_bs,
    const R* __restrict__ u, long u_bs, const R* __restrict__ D, long D_bs,
    long D_ts, const R* __restrict__ mode0, long mode0_bs,
    const R* __restrict__ sys, R conv_tol, int max_iter,
    R* __restrict__ mode_out, R* __restrict__ prev_out,
    R* __restrict__ ll_out, int* __restrict__ niter_out,
    R* __restrict__ diff_out, R* __restrict__ scratch) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int MM = M * M;
  // scratch rows per time step: v, F, ok, mode buffer 0, mode buffer 1,
  // a (M), P (MM)
  constexpr int ROWS = 5 + M + MM;
  constexpr int kV = 0, kF = 1, kOk = 2, kMode = 3, kA = 5, kP = 5 + M;
#define SC(t, r) scratch[((long)(t) * ROWS + (r)) * B + b]

  Sys<R, M> s;
  load_sys<R, M>(s, sys, B, b);
  const R phi = sys[(long)sys_rows<M>() * B + b];
  y += b * y_bs;
  u += b * u_bs;
  D += b * D_bs;
  mode0 += b * mode0_bs;

  for (int t = 0; t < n; ++t) {
    const R m0 = mode0[t];
    SC(t, kMode) = m0;
    SC(t, kMode + 1) = m0;
  }

  int cur = 0;  // which mode buffer holds the newest mode
  int it = 0;
  R diff = conv_tol + R(1);
  R ll = R(0);
  while (it < max_iter && diff > conv_tol) {
    const int lin = kMode + cur;        // the mode this pass linearises at
    const int nw = kMode + (1 - cur);  // where the new mode goes
    // ---- forward: match + Kalman filter, staging the backward pass's needs
    R a[M], P[MM];
#pragma unroll
    for (int i = 0; i < M; ++i) a[i] = s.a1[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
    ll = R(0);
    for (int t = 0; t < n; ++t) {
      const R yt_obs = y[t];
      R yt, hh;
      laplace_match<R>(dist, yt_obs, u[t], phi, SC(t, lin), yt, hh);
      hh = (isfinite(hh) && hh > R(0)) ? hh : R(1);
      yt = isfinite(yt_obs) ? yt : R(NAN);
#pragma unroll
      for (int i = 0; i < M; ++i) SC(t, kA + i) = a[i];
#pragma unroll
      for (int i = 0; i < MM; ++i) SC(t, kP + i) = P[i];
      R v, Fs, okf, inc, att[M], Ptt[MM];
      kf_step<R, M>(s, a, P, yt, hh, D[t * D_ts], v, Fs, okf, inc, att, Ptt);
      SC(t, kV) = v;
      SC(t, kF) = Fs;
      SC(t, kOk) = okf;
      ll += inc;
    }
    // ---- backward: smoothed means -> new signal mode, squared change
    R r[M];
#pragma unroll
    for (int i = 0; i < M; ++i) r[i] = R(0);
    R dacc = R(0);
    for (int t = n - 1; t >= 0; --t) {
      R at[M], Pt[MM], alpha[M];
#pragma unroll
      for (int i = 0; i < M; ++i) at[i] = SC(t, kA + i);
#pragma unroll
      for (int i = 0; i < MM; ++i) Pt[i] = SC(t, kP + i);
      bwd_mean_step<R, M>(s, SC(t, kV), SC(t, kF), SC(t, kOk), at, Pt, r,
                          alpha);
      R new_mode;
      if (dist == kSvm) {
        new_mode = alpha[0];
      } else {
        new_mode = D[t * D_ts];
#pragma unroll
        for (int i = 0; i < M; ++i) new_mode += s.Z[i] * alpha[i];
      }
      SC(t, nw) = new_mode;
      const R delta = new_mode - SC(t, lin);
      dacc += delta * delta;
    }
    diff = dacc / R(n);
    cur = 1 - cur;
    ++it;
  }

  for (int t = 0; t < n; ++t) {
    mode_out[b * n + t] = SC(t, kMode + cur);
    prev_out[b * n + t] = SC(t, kMode + (1 - cur));
  }
  ll_out[b] = ll;
  niter_out[b] = it;
  diff_out[b] = diff;
#undef SC
}

}  // namespace bssm

// Plain C entry point.  Pointers are device pointers; *_bs are batch strides
// in elements (0 for a leaf shared by all rows), D_ts the time stride of D
// (0 when D is constant in time).  `sys` is the packed (rows + 1, B) system
// tensor [Z, T, RR, a1, P1, C, phi].  Returns the launch's cudaError_t, or
// -1 for an unsupported m.
extern "C" int bssm_laplace_solve(
    int is_double, int m, int dist, long B, int n, const void* y, long y_bs,
    const void* u, long u_bs, const void* D, long D_bs, long D_ts,
    const void* mode0, long mode0_bs, const void* sys, double conv_tol,
    int max_iter, void* mode, void* prev, void* ll, void* niter, void* diff,
    void* scratch, int threads, void* stream) {
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  bool known;
#define LAUNCH(R, M)                                                         \
  bssm::laplace_solve_kernel<R, M>                                           \
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(                        \
          dist, B, n, (const R*)y, y_bs, (const R*)u, u_bs, (const R*)D,     \
          D_bs, D_ts, (const R*)mode0, mode0_bs, (const R*)sys, (R)conv_tol, \
          max_iter, (R*)mode, (R*)prev, (R*)ll, (int*)niter, (R*)diff,       \
          (R*)scratch)
  BSSM_DISPATCH(is_double, m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}

extern "C" const char* bssm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
