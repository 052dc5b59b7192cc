// laplace_solve and laplace_step: the Laplace (Gaussian-approximation) mode
// iteration of a non-Gaussian state-space model, for a batch of models.
//
// One pass of the iteration, per batch row:
//   pseudo-observations (ytilde, HHtilde) from the current signal mode ->
//   masked Joseph-form Kalman filter + log-likelihood -> backward mean pass
//   of the fast smoother -> new signal mode and its mean-squared change.
// `laplace_pass` below is that pass, written once from the device functions
// of kalman_common.cuh; the two kernels differ only in how often they run it.
//
// laplace_solve_kernel replaces the TPU kernel `_laplace_solve_kernel`
// (bssm_tpu/ops/pallas_kalman.py:785, called at :920): it repeats the pass
// until the mean-squared change is <= conv_tol, or max_iter, one launch for
// the whole iteration.  Plain version: inference/approx.laplace_solve_plain.
//
// laplace_step_kernel replaces the TPU kernel `_laplace_step_kernel`
// (pallas_kalman.py:581, called at :680): one pass, mode in, (new mode,
// log-likelihood, mean-squared change) out.  The single-model solve
// (inference/approx.laplace_solve_steps) loops over it on the host, testing
// convergence between launches, as the JAX package's `_laplace_solve_base`
// loops over its step.  Plain version: inference/approx._laplace_step.
//
// What bounds them on this card: neither their bytes nor their operations
// (both bounds are tens of microseconds at 16384 rows) but the latency of one
// long chain of dependent operations per row (n steps forward, n steps
// backward, four or five passes for the solve) with m x m matrices in
// registers.  The batch is the only parallelism, and 4096 rows are 128 warps
// for 132 SMs.  The design therefore gives one thread one row and uses blocks
// of one warp so that every SM gets work; a single model (the step's main
// caller) is one thread of one block, pure latency.  The per-time quantities
// the backward pass needs (v, F, ok, a_t, P_t: 3 + m + m^2 values a step) do
// not fit in registers, so they are staged in a scratch tensor the wrapper
// allocates, laid out time-major (n, rows, B): the threads of a warp touch
// neighbouring addresses.  At m = 2, n = 153, float32 the solve's scratch is
// 6.7 KB a row: 27 MB at 4096 rows, inside the 50 MB L2 cache, and 110 MB at
// 16384 rows, where every pass streams it through device memory and the time
// per row goes up.  The solve keeps its two mode buffers in the same scratch;
// the step reads its mode from the input and writes the new one to a
// separate output.  The solve tests convergence per row, as the JAX
// package's scan path does; a thread whose row has converged idles until its
// warp is done.
#include "kalman_common.cuh"

namespace bssm {

// value r of time t of this thread's row in the time-major scratch
template <typename R> struct Stage {
  R* p;
  long B, b;
  int rows;
  __device__ __forceinline__ R& operator()(int t, int r) const {
    return p[((long)t * rows + r) * B + b];
  }
};

// scratch rows of one time step used by the pass: v, F, ok, a (M), P (MM)
template <int M> __host__ __device__ constexpr int pass_rows() {
  return 3 + M + M * M;
}

// One pass at the mode `mode_at(t)`; `emit(t, new_mode_t)` receives the new
// mode, backwards in time.  Returns the mean-squared change; `ll` gets the
// Kalman log-likelihood of the approximating model.
template <typename R, int M, typename ModeAt, typename Emit>
__device__ __forceinline__ R laplace_pass(const Sys<R, M>& s, int dist,
                                          R phi, int n, const R* y,
                                          const R* u, const R* D, long D_ts,
                                          const Stage<R>& sc, ModeAt mode_at,
                                          Emit emit, R& ll) {
  constexpr int MM = M * M;
  constexpr int kV = 0, kF = 1, kOk = 2, kA = 3, kP = 3 + M;
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
    laplace_match<R>(dist, yt_obs, u[t], phi, mode_at(t), yt, hh);
    hh = (isfinite(hh) && hh > R(0)) ? hh : R(1);
    yt = isfinite(yt_obs) ? yt : R(NAN);
#pragma unroll
    for (int i = 0; i < M; ++i) sc(t, kA + i) = a[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) sc(t, kP + i) = P[i];
    R v, Fs, okf, inc, att[M], Ptt[MM];
    kf_step<R, M>(s, a, P, yt, hh, D[t * D_ts], v, Fs, okf, inc, att, Ptt);
    sc(t, kV) = v;
    sc(t, kF) = Fs;
    sc(t, kOk) = okf;
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
    for (int i = 0; i < M; ++i) at[i] = sc(t, kA + i);
#pragma unroll
    for (int i = 0; i < MM; ++i) Pt[i] = sc(t, kP + i);
    bwd_mean_step<R, M>(s, sc(t, kV), sc(t, kF), sc(t, kOk), at, Pt, r,
                        alpha);
    R new_mode;
    if (dist == kSvm) {
      new_mode = alpha[0];
    } else {
      new_mode = D[t * D_ts];
#pragma unroll
      for (int i = 0; i < M; ++i) new_mode += s.Z[i] * alpha[i];
    }
    const R delta = new_mode - mode_at(t);
    emit(t, new_mode);
    dacc += delta * delta;
  }
  return dacc / R(n);
}

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
  // scratch rows per time step: the pass's, then mode buffers 0 and 1
  constexpr int kMode = pass_rows<M>();
  const Stage<R> sc{scratch, B, b, kMode + 2};

  Sys<R, M> s;
  load_sys<R, M>(s, sys, B, b);
  const R phi = sys[(long)sys_rows<M>() * B + b];
  y += b * y_bs;
  u += b * u_bs;
  D += b * D_bs;
  mode0 += b * mode0_bs;

  for (int t = 0; t < n; ++t) {
    const R m0 = mode0[t];
    sc(t, kMode) = m0;
    sc(t, kMode + 1) = m0;
  }

  int cur = 0;  // which mode buffer holds the newest mode
  int it = 0;
  R diff = conv_tol + R(1);
  R ll = R(0);
  while (it < max_iter && diff > conv_tol) {
    const int lin = kMode + cur;        // the mode this pass linearises at
    const int nw = kMode + (1 - cur);  // where the new mode goes
    diff = laplace_pass<R, M>(
        s, dist, phi, n, y, u, D, D_ts, sc,
        [&](int t) { return sc(t, lin); },
        [&](int t, R v) { sc(t, nw) = v; }, ll);
    cur = 1 - cur;
    ++it;
  }

  for (int t = 0; t < n; ++t) {
    mode_out[b * n + t] = sc(t, kMode + cur);
    prev_out[b * n + t] = sc(t, kMode + (1 - cur));
  }
  ll_out[b] = ll;
  niter_out[b] = it;
  diff_out[b] = diff;
}

template <typename R, int M>
__global__ void laplace_step_kernel(
    int dist, long B, int n, const R* __restrict__ y, long y_bs,
    const R* __restrict__ u, long u_bs, const R* __restrict__ D, long D_bs,
    long D_ts, const R* __restrict__ mode, long mode_bs,
    const R* __restrict__ sys, R* __restrict__ mode_out,
    R* __restrict__ ll_out, R* __restrict__ diff_out,
    R* __restrict__ scratch) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Stage<R> sc{scratch, B, b, pass_rows<M>()};

  Sys<R, M> s;
  load_sys<R, M>(s, sys, B, b);
  const R phi = sys[(long)sys_rows<M>() * B + b];
  y += b * y_bs;
  u += b * u_bs;
  D += b * D_bs;
  mode += b * mode_bs;
  R* out = mode_out + b * n;

  R ll;
  const R diff = laplace_pass<R, M>(
      s, dist, phi, n, y, u, D, D_ts, sc, [&](int t) { return mode[t]; },
      [&](int t, R v) { out[t] = v; }, ll);
  ll_out[b] = ll;
  diff_out[b] = diff;
}

}  // namespace bssm

// Plain C entry points.  Pointers are device pointers; *_bs are batch
// strides in elements (0 for a leaf shared by all rows), D_ts the time stride
// of D (0 when D is constant in time).  `sys` is the packed (rows + 1, B)
// system tensor [Z, T, RR, a1, P1, C, phi].  Each returns the launch's
// cudaError_t, or -1 for an unsupported m.
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

// Scratch: (n, 3 + m + m^2, B) of the real type.
extern "C" int bssm_laplace_step(int is_double, int m, int dist, long B,
                                 int n, const void* y, long y_bs,
                                 const void* u, long u_bs, const void* D,
                                 long D_bs, long D_ts, const void* mode,
                                 long mode_bs, const void* sys,
                                 void* mode_out, void* ll, void* diff,
                                 void* scratch, int threads, void* stream) {
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  bool known;
#define LAUNCH(R, M)                                                       \
  bssm::laplace_step_kernel<R, M>                                          \
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(                      \
          dist, B, n, (const R*)y, y_bs, (const R*)u, u_bs, (const R*)D,   \
          D_bs, D_ts, (const R*)mode, mode_bs, (const R*)sys,              \
          (R*)mode_out, (R*)ll, (R*)diff, (R*)scratch)
  BSSM_DISPATCH(is_double, m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}

extern "C" const char* bssm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
