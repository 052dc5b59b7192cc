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
// Both take the spec's own tensors: y, H and D as series with a batch and a
// time stride (KalmanArgs), the system as leaves with a batch stride
// (SystemArg, R R' formed in registers), and both apply the degenerate-model
// rule of the JAX package's kernel wrappers themselves (degenerate_h2rr:
// H^2 summed over the steps as the filter reads them, plus sum |R R'|), so
// a call is one launch: no packed system, no transposed copy, no mask.
//
// What bounds them on this card: neither the bytes (the series and the
// system: microseconds at 16384 rows) nor the operations, but the latency of
// one chain of n dependent Kalman steps per row with m x m matrices in
// registers.  The batch is the only parallelism, so one thread owns one row
// and blocks are one warp wide, which spreads a few thousand rows over every
// SM; the chain of n steps is the serial floor of this design.
//
// kalman_ll keeps its whole state (a, P, ll, the sum of H^2) in registers.
// Its inputs are kept off the chain: y, H and D of step t + 1 are loaded
// before step t's arithmetic, and an intercept D that varies over rows and
// time (X beta per chain, laid out (B, n) as the model builds it) is copied
// by the block into shared memory with cp.async, consecutive threads on
// consecutive t of one row, in chunks of time steps: all n at once when the
// 32 rows fit in 48 KB (n <= 383 float32, <= 191 float64; 19.6 KB at n = 153
// float32), else chunks of 191 (float32) or 95 (float64) steps,
// double-buffered so that the copy of chunk c + 1 runs under the steps of
// chunk c.  A row of the tile has an odd leading dimension, so the warp
// reads one step's 32 values from 32 banks.  A D shared by all rows or
// constant in time is read where it lies (a broadcast).  The wrapper
// (ops/cuda_kalman.kalman_tile) sets the chunk.
//
// fast_smoother_ll keeps its first design: it stages v, F, ok, a_t and P_t
// (3 + m + m^2 values a step) in a scratch tensor laid out time-major
// (n, rows, B) and recomputes the gain in the backward pass.  alpha is
// written in the (B, n+1, m) layout its callers read.
#include <string.h>

#include "kalman_common.cuh"

namespace bssm {

// Launch arguments of bssm_kalman_ll and bssm_fast_smoother_ll, packed by
// ops/cuda_kalman.py in this order.
struct KalmanArgs {
  long long is_double, m, B, n;
  SeriesArg y, H, D;
  SystemArg sys;
  long long ll;       // (B,) log-likelihood out
  long long alpha;    // (B, n+1, m) smoothed means out (smoother only)
  long long scratch;  // (n, 3 + m + m^2, B) (smoother only)
  long long chunk;    // kalman_ll: time steps of a D tile chunk, 0: no tile
  long long smem;     // kalman_ll: dynamic shared memory of a block, bytes
  long long stream;
};

constexpr int kRowsLG = 32;  // rows (threads) of a block

// One filter step of kalman_ll's row: H^2 into the degenerate sum, then the
// masked Kalman step.
template <typename R, int M>
__device__ __forceinline__ void ll_step(const Sys<R, M>& s, R (&a)[M],
                                        R (&P)[M * M], R y, R h, R d, R& ll,
                                        R& hsum) {
  const R h2 = h * h;
  hsum += h2;
  R v, Fs, okf, inc, att[M], Ptt[M * M];
  kf_step<R, M>(s, a, P, y, h2, d, v, Fs, okf, inc, att, Ptt);
  ll += inc;
}

template <typename R, int M, bool kTile>
__global__ void kalman_ll_kernel(const KalmanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int MM = M * M;
  const int lane = threadIdx.x, n = (int)a.n;
  const long B = a.B, b0 = (long)blockIdx.x * kRowsLG, b = b0 + lane;
  const bool active = b < B;
  const R* y = series_row<R>(a.y, b);
  const R* H = series_row<R>(a.H, b);
  const R* D = series_row<R>(a.D, b);
  const long y_ts = a.y.ts, h_ts = a.H.ts, d_ts = a.D.ts;

  Sys<R, M> s;
  R av[M], P[MM];
  R ll = R(0), hsum = R(0);
  R yn = R(0), hn = R(0), dn = R(0);  // the next step's inputs
  if (active) {
    load_sys_leaves<R, M>(s, a.sys, b);
#pragma unroll
    for (int i = 0; i < M; ++i) av[i] = s.a1[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
    yn = y[0];
    hn = H[0];
    if (!kTile) dn = D[0];
  }

  if constexpr (!kTile) {
    if (active) {
      for (int t = 0; t < n; ++t) {
        const R yt = yn, ht = hn, dt = dn;
        if (t + 1 < n) {
          yn = y[(t + 1) * y_ts];
          hn = H[(t + 1) * h_ts];
          dn = D[(t + 1) * d_ts];
        }
        ll_step<R, M>(s, av, P, yt, ht, dt, ll, hsum);
      }
    }
  } else {
    // D (B, n) through shared memory: buffers of kRowsLG x ldc values
    const int C = (int)a.chunk, ldc = C | 1;
    const int nchunks = (n + C - 1) / C;
    const int nb = B - b0 < kRowsLG ? (int)(B - b0) : kRowsLG;
    R* const tile = reinterpret_cast<R*>(smem_raw);
    const long tile_elems = (long)kRowsLG * ldc;
    const R* D0 = reinterpret_cast<const R*>(a.D.p);
    auto load_chunk = [&](int c) {
      R* buf = tile + (c & 1) * tile_elems;
      const int t0 = c * C, len = min(C, n - t0);
      for (int r = 0; r < nb; ++r) {
        const R* src = D0 + (b0 + r) * a.D.bs + (long)t0 * d_ts;
        for (int j = lane; j < len; j += kRowsLG)
          cp_async<sizeof(R)>(buf + (long)r * ldc + j, src + (long)j * d_ts);
      }
      cp_async_commit();
    };
    load_chunk(0);
    if (nchunks > 1) load_chunk(1);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      const int t0 = c * C, t1 = min(n, t0 + C);
      const R* d_row = tile + (c & 1) * tile_elems + (long)lane * ldc;
      if (active) {
        for (int t = t0; t < t1; ++t) {
          const R yt = yn, ht = hn;
          if (t + 1 < n) {
            yn = y[(t + 1) * y_ts];
            hn = H[(t + 1) * h_ts];
          }
          ll_step<R, M>(s, av, P, yt, ht, d_row[t - t0], ll, hsum);
        }
      }
      __syncthreads();
      if (c + 2 < nchunks) load_chunk(c + 2);
    }
  }
  if (active)
    reinterpret_cast<R*>(a.ll)[b] =
        degenerate_h2rr<R, M>(hsum, s) ? R(-INFINITY) : ll;
}

template <typename R, int M>
__global__ void fast_smoother_ll_kernel(const KalmanArgs a) {
  const long B = a.B;
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int MM = M * M;
  const int n = (int)a.n;
  // scratch rows per time step: v, F, ok, a_t (M), P_t (MM)
  constexpr int ROWS = 3 + M + MM;
  constexpr int kV = 0, kF = 1, kOk = 2, kA = 3, kP = 3 + M;
  R* const scratch = reinterpret_cast<R*>(a.scratch);
#define SC(t, r) scratch[((long)(t) * ROWS + (r)) * B + b]

  Sys<R, M> s;
  load_sys_leaves<R, M>(s, a.sys, b);
  const R* y = series_row<R>(a.y, b);
  const R* H = series_row<R>(a.H, b);
  const R* D = series_row<R>(a.D, b);
  R* alpha = reinterpret_cast<R*>(a.alpha) + b * (long)(n + 1) * M;

  // ---- forward: Kalman filter, staging what the backward pass needs
  R av[M], P[MM];
#pragma unroll
  for (int i = 0; i < M; ++i) av[i] = s.a1[i];
#pragma unroll
  for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
  R ll = R(0), hsum = R(0);
  for (int t = 0; t < n; ++t) {
#pragma unroll
    for (int i = 0; i < M; ++i) SC(t, kA + i) = av[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) SC(t, kP + i) = P[i];
    const R h = H[t * a.H.ts];
    const R h2 = h * h;
    hsum += h2;
    R v, Fs, okf, inc, att[M], Ptt[MM];
    kf_step<R, M>(s, av, P, y[t * a.y.ts], h2, D[t * a.D.ts], v, Fs, okf,
                  inc, att, Ptt);
    SC(t, kV) = v;
    SC(t, kF) = Fs;
    SC(t, kOk) = okf;
    ll += inc;
  }
  // alphahat_n = a_n: no observation after the last step
#pragma unroll
  for (int i = 0; i < M; ++i) alpha[(long)n * M + i] = av[i];

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
  reinterpret_cast<R*>(a.ll)[b] =
      degenerate_h2rr<R, M>(hsum, s) ? R(-INFINITY) : ll;
#undef SC
}

template <typename R, int M> int launch_ll(const KalmanArgs& a) {
  const unsigned blocks = (unsigned)((a.B + kRowsLG - 1) / kRowsLG);
  const cudaStream_t stream = (cudaStream_t)a.stream;
  if (a.chunk > 0) {
    const long long ldc = a.chunk | 1;
    const long long nbuf = a.chunk < a.n ? 2 : 1;
    if (a.smem != nbuf * kRowsLG * ldc * (long long)sizeof(R) ||
        a.smem > 48 * 1024)
      return -3;
    kalman_ll_kernel<R, M, true>
        <<<blocks, kRowsLG, (size_t)a.smem, stream>>>(a);
  } else {
    kalman_ll_kernel<R, M, false><<<blocks, kRowsLG, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename R, int M> int launch_smoother(const KalmanArgs& a) {
  const unsigned blocks = (unsigned)((a.B + kRowsLG - 1) / kRowsLG);
  fast_smoother_ll_kernel<R, M>
      <<<blocks, kRowsLG, 0, (cudaStream_t)a.stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bssm

// Plain C entry points: `args` points to the packed KalmanArgs, `size` is
// its length in bytes.  Each returns the launch's cudaError_t, -1 for an
// unsupported m, -2 when `size` is not the struct's, -3 for a D tile
// geometry the kernel does not take.
extern "C" int bssm_kalman_ll(const void* args, long long size) {
  if (size != (long long)sizeof(bssm::KalmanArgs)) return -2;
  bssm::KalmanArgs a;
  memcpy(&a, args, sizeof a);
  int code = 0;
  bool known;
#define LAUNCH(R, M) code = bssm::launch_ll<R, M>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  return known ? code : -1;
}

extern "C" int bssm_fast_smoother_ll(const void* args, long long size) {
  if (size != (long long)sizeof(bssm::KalmanArgs)) return -2;
  bssm::KalmanArgs a;
  memcpy(&a, args, sizeof a);
  int code = 0;
  bool known;
#define LAUNCH(R, M) code = bssm::launch_smoother<R, M>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  return known ? code : -1;
}
