// laplace_solve and laplace_step: the Laplace (Gaussian-approximation) mode
// iteration of a non-Gaussian state-space model, for a batch of models.
//
// One pass of the iteration, per batch row:
//   pseudo-observations (ytilde, HHtilde) from the current signal mode ->
//   masked Joseph-form Kalman filter + log-likelihood -> backward mean pass
//   of the fast smoother -> new signal mode and its mean-squared change.
// `laplace_pass` below is that pass, written once from the device functions
// of kalman_common.cuh; the two kernels differ in how often they run it and
// where they stage it.
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
// Both read the system where the spec holds it (SystemArg: Z, T, R, a1, P1,
// C, phi, each with its batch stride, 0 for a leaf shared by all rows) and
// form R R' in registers, so the wrapper packs nothing and launches once.
//
// What bounds laplace_solve on this card: neither its bytes nor its
// operations (both bounds are tens of microseconds at 16384 rows) but the
// latency of one long chain of dependent operations per row: n match-and-
// filter steps forward, n smoother steps backward, four or five passes.
// The batch is the only parallelism, so one thread owns one row.  That chain
// is the serial floor of this design: at B <= 4096 every row's thread runs at
// once (one warp per SM), and the bare kernel is that chain and nothing
// else.  Going below it needs parallelism within a row (several lanes a row,
// or a parallel-in-time filter), not a better staging.
//
// The backward pass needs v, F, ok, a_t and P_t of every step (3 + m + m^2
// values), which do not fit in registers, so the forward pass stages them,
// with the two mode buffers (the mode a pass linearises at, the new one),
// in one of two places, a template flag of the same kernel:
//
// * Shared memory (kShared): a block's own rows.  In values of the real
//   type (laplace_block_elems):
//     rows x [(3 + m + m^2) n  pass values, (t, value, row): the threads of
//                              a warp touch neighbouring banks
//             + 2 (n | 1)]     the two mode buffers, row-major with an odd
//                              leading dimension: conflict-free both for a
//                              thread walking its row and for the block
//                              copying rows coalesced
//     + 2 n                    y and u when they are shared by all rows
//   Rows a block = min(32, what fits in 227 KB less the kernel's 128 static
//   bytes): 32 (216648 bytes) at the main path's m = 2, n = 153, float32;
//   17 in float64; 7 at m = 4 float64; none beyond n = 4467 at m = 2
//   float32 or n = 1075 at m = 4 float64.  One such block fills an SM, so
//   the chain sees shared memory instead of L2, but only 132 blocks run at
//   once: past one wave every further wave costs a whole chain.
// * Device memory: every row of the batch, the pass values (t, value, row)
//   over align32(B) rows and the two buffers (t, row) behind them
//   (laplace_row_elems values a row), as the first design staged: an L2
//   round trip (HBM once the batch outgrows L2) on the chain at every
//   backward step and mode read, but every row resident at once.
//
// The wrapper (ops/cuda_kalman.laplace_staging) takes shared memory only
// while its blocks run in one wave.  chip_smoke.py --staging-sweep times
// both over B = 1024..32768, m = 1..4 and both dtypes at n = 153 (H100 SXM,
// PERF.md): in one wave shared memory wins everywhere (0.38 against 0.59 ms
// at m = 2, B = 4096, float32); at two waves it wins at m = 2 / 3 and loses
// at m = 1 / 4, and at three or more it loses, up to 6x in float64.
//
// Series shared by all rows (y and u on the main path) are copied into
// shared memory once, before the passes, in the shared staging: a broadcast
// read of shared memory costs a few cycles on the chain, where a read of
// device memory, even from L1, costs more and one warp an SM has nothing to
// hide it behind.  A series that varies over rows is read where it lies.
// The modes come in and go out coalesced: with shared staging the block
// copies its rows, consecutive threads on consecutive t; with device
// staging each thread copies its own row, the warp one line a step.
//
// The solve tests convergence per row, as the JAX package's scan path does;
// a thread whose row has converged idles until its warp is done.
//
// laplace_step_kernel runs one pass for a block of rows, split as the fast
// smoother of kalman_filter.cu is (kalman_common.cuh): every thread of the
// block computes the pseudo-observations (ytilde, HHtilde) of every step
// at the mode, before the chain, into the block's tile in shared memory;
// one thread a row runs the Kalman filter from the tile, staging 2 + m +
// m(m+1)/2 values a step in it (v, F with the update mask folded in, a_t,
// P_t's upper triangle: 7 at m = 2, 4.3 KB a row at n = 153 float32); every
// thread computes c_t and L_t; one thread a row runs the r chain; every
// thread computes alphahat_t, the new mode and its squared change, and the
// new mode is stored a row's run at a time; the mean of the change is a
// reduction in a fixed order (each lane of a warp the steps t = lane mod
// 32, last first, then the warp's butterfly).  Its main caller is one model
// (B = 1), where the filter's chain is all that stays serial: one row a
// block of 128 threads.  The first design ran the whole pass on one thread
// a row and staged it in a device scratch allocated at every call.  The
// layouts are fast_smoother_ll's and so is the rule that picks them
// (ops/cuda_kalman.fs_geometry): the whole series of 8 rows a block (one
// row for one model), or 32 rows a block with tiles and checkpoints, where
// the blocks would need more waves or the rows do not fit.  Both compute
// every value alike and agree to the bit; the wrapper returns the three
// outputs as views of one allocation.
#include <string.h>

#include "kalman_common.cuh"

namespace bssm {

// Launch arguments of bssm_laplace_solve, packed by ops/cuda_kalman.py in
// this order.  `out` is one device buffer: mode (B, n), prev (B, n), ll (B),
// diff (B), niter (B int32, in the next B values), then, for the
// device-memory variant, from the next line of 32 values on, the staging of
// align32(B) rows.  `passes`, when not 0, is one unsigned 64-bit counter in
// device memory to which the kernel adds the sum of niter (the program's
// trace counts the Laplace passes with it, diagnostics/profiling.py).
struct LaplaceArgs {
  long long is_double, m, dist, B, n;
  SeriesArg y, u, D, mode;
  SystemArg sys;
  double conv_tol;
  long long max_iter;
  long long out;
  long long rows;         // rows of the batch a block takes, one thread each
  long long shared;       // 1: staging in shared memory, 0: in `out`
  long long smem;         // dynamic shared memory of a block, bytes
  long long block_elems;  // staging values of a block (shared) or a row
  long long passes;       // the pass counter, or 0
  long long stream;
};

// Launch arguments of bssm_laplace_step.  `out` is one device buffer: the
// new mode (B, n), ll (B), diff (B).
struct StepArgs {
  long long is_double, m, dist, B, n;
  SeriesArg y, u, D, mode;
  SystemArg sys;
  long long out;
  long long scratch;  // the checkpoints, 0 with one tile
  long long rows;     // rows of the batch a block takes
  long long threads;  // threads of a block
  long long chunk;    // steps of a tile, n: the whole series
  long long smem;     // dynamic shared memory of a block, bytes
  long long stream;
};

constexpr int kStepMaxThreads = 256;

// shared-memory values of a laplace_step block of `rows` rows whose tile
// holds `len` steps: each row's Z and T, the tile, and each row's 32
// partial sums of the squared change
__host__ __device__ inline long long step_block_elems(long long rows,
                                                      long long len,
                                                      long long m) {
  const long long ws = 2 * m + 1 + m * (m + 1) / 2;  // split_fields
  return rows * (m + m * m) + rows * ((ws * len) | 1) + rows * 32;
}

// values of one time step staged by the pass: v, F, ok, a (M), P (MM)
template <int M> __host__ __device__ constexpr int pass_rows() {
  return 3 + M + M * M;
}

// staging values of one laplace_solve block of `rows` rows in shared
// memory, and of one row in device memory (see the head)
__host__ __device__ inline long long laplace_block_elems(long long rows,
                                                         long long n,
                                                         long long m) {
  return rows * ((3 + m + m * m) * n + 2 * (n | 1)) + 2 * n;
}
__host__ __device__ inline long long laplace_row_elems(long long n,
                                                       long long m) {
  return (5 + m + m * m) * n;
}

// k rounded up to whole lines of 32 values: the device-memory staging
// starts on a line and holds align32(B) rows, so that a warp's 32 values of
// a step are one line, not two
__host__ __device__ inline long long align32(long long k) {
  return (k + 31) / 32 * 32;
}

// value r of time t of one row, staged time-major: `stride` rows sit between
// two values of the row, the row is `idx` among them
template <typename R> struct Stage {
  R* p;
  long stride, idx;
  int nval;
  __device__ __forceinline__ R& operator()(int t, int r) const {
    return p[((long)t * nval + r) * stride + idx];
  }
};

// One pass at the mode `mode_at(t)`; `emit(t, new_mode_t)` receives the new
// mode, backwards in time.  Returns the mean-squared change; `ll` gets the
// Kalman log-likelihood of the approximating model.  Value t of a series x
// is x[t * x_ts].
template <typename R, int M, typename ModeAt, typename Emit>
__device__ __forceinline__ R laplace_pass(const Sys<R, M>& s, int dist,
                                          R phi, int n, const R* y, long y_ts,
                                          const R* u, long u_ts, const R* D,
                                          long D_ts, const Stage<R>& sc,
                                          ModeAt mode_at, Emit emit, R& ll) {
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
    const R yt_obs = y[t * y_ts];
    R yt, hh;
    laplace_match<R>(dist, yt_obs, u[t * u_ts], phi, mode_at(t), yt, hh);
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

template <typename R, int M, bool kShared>
__global__ void laplace_solve_kernel(const LaplaceArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int cur_of[32];  // which mode buffer holds a row's newest mode
  constexpr int P = pass_rows<M>();
  const int rows = blockDim.x, lane = threadIdx.x;
  const int n = (int)a.n, ldm = n | 1;
  const long B = a.B, b0 = (long)blockIdx.x * rows, b = b0 + lane;
  const int nb = B - b0 < rows ? (int)(B - b0) : rows;  // rows of this block
  R* const out = reinterpret_cast<R*>(a.out);
  R* const mode_out = out;
  R* const prev_out = out + B * n;
  R* const ll_out = out + 2 * B * n;
  R* const diff_out = ll_out + B;
  int* const niter_out = reinterpret_cast<int*>(diff_out + B);
  // The staging: in shared memory the block's own rows, the pass values
  // (t, value, row), the two mode buffers row-major with leading dimension
  // n | 1, then y and u; in device memory every row of the batch, the pass
  // values (t, value, row) over align32(B) rows, then the two mode buffers
  // (t, row).  Value t of row r of a mode buffer is modes[mi(r, t)], the
  // second buffer `other` further.
  const long Bs = align32(B);
  R* const st = kShared ? reinterpret_cast<R*>(smem_raw)
                        : out + align32(2 * B * n + 3 * B);
  R* const modes = st + (long)n * P * (kShared ? rows : Bs);
  const long other = kShared ? (long)rows * ldm : (long)n * Bs;
  const auto mi = [&](int r, int t) -> long {
    return kShared ? (long)r * ldm + t : (long)t * Bs + b0 + r;
  };
  R* const ser = modes + 2 * other;

  // shared series into shared memory, once
  const R* y = series_row<R>(a.y, b);
  const R* u = series_row<R>(a.u, b);
  long y_ts = a.y.ts, u_ts = a.u.ts;
  if (kShared && a.y.bs == 0) {
    for (int t = lane; t < n; t += rows) ser[t] = y[t * y_ts];
    y = ser;
    y_ts = 1;
  }
  if (kShared && a.u.bs == 0) {
    for (int t = lane; t < n; t += rows) ser[n + t] = u[t * u_ts];
    u = ser + n;
    u_ts = 1;
  }
  // `each(f)` calls f(r, t) for every value of the block's rows of the
  // modes.  With shared staging the block walks each row, consecutive
  // threads on consecutive t, so that the reads and writes of the (B, n)
  // modes in device memory are coalesced.  With device staging each thread
  // walks its own row: the warp's accesses to the time-major buffers are
  // then one line, and a thread's to the (B, n) modes share lines.
  const auto each = [&](auto f) {
    if (kShared) {
      for (int r = 0; r < nb; ++r)
        for (int t = lane; t < n; t += rows) f(r, t);
    } else if (lane < nb) {
      for (int t = 0; t < n; ++t) f(lane, t);
    }
  };
  // mode0 into both mode buffers
  const R* mode0 = reinterpret_cast<const R*>(a.mode.p);
  each([&](int r, int t) {
    const R v = mode0[(b0 + r) * a.mode.bs + t * a.mode.ts];
    modes[mi(r, t)] = v;
    modes[other + mi(r, t)] = v;
  });
  __syncthreads();

  int passes = 0;  // this thread's row's passes, 0 past the batch
  if (b < B) {
    Sys<R, M> s;
    load_sys_leaves<R, M>(s, a.sys, b);
    const R phi = leaf_row<R>(a.sys.phi, b)[0];
    const R* D = series_row<R>(a.D, b);
    const Stage<R> sc{st, kShared ? rows : Bs, kShared ? lane : b, P};
    const R conv_tol = (R)a.conv_tol;
    int cur = 0;  // which mode buffer holds the newest mode
    int it = 0;
    R diff = conv_tol + R(1);
    R ll = R(0);
    while (it < a.max_iter && diff > conv_tol) {
      const R* lin = modes + cur * other;  // the mode this pass linearises at
      R* nw = modes + (1 - cur) * other;   // where the new mode goes
      diff = laplace_pass<R, M>(
          s, (int)a.dist, phi, n, y, y_ts, u, u_ts, D, a.D.ts, sc,
          [&](int t) { return lin[mi(lane, t)]; },
          [&](int t, R v) { nw[mi(lane, t)] = v; }, ll);
      cur = 1 - cur;
      ++it;
    }
    cur_of[lane] = cur;
    ll_out[b] = ll;
    niter_out[b] = it;
    diff_out[b] = diff;
    passes = it;
  }
  __syncthreads();
  // the block (one warp) adds its rows' passes to the counter: one atomic a
  // block, after the pass loop
  if (a.passes) {
    const unsigned all = rows == 32 ? 0xffffffffu : (1u << rows) - 1u;
    const unsigned sum = __reduce_add_sync(all, (unsigned)passes);
    if (lane == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.passes),
                (unsigned long long)sum);
  }

  // the newest and the previous mode out
  each([&](int r, int t) {
    const long o = (b0 + r) * n + t;
    mode_out[o] = modes[cur_of[r] * other + mi(r, t)];
    prev_out[o] = modes[(1 - cur_of[r]) * other + mi(r, t)];
  });
}

// One Laplace pass of every row of the block: the pseudo-observations of
// every step in parallel, the forward filter one thread a row, the split
// backward pass (kalman_common.cuh) tile by tile from the last steps to the
// first, the new mode and its squared change in parallel, the mean of the
// change by a fixed-order reduction.  One tile of n steps is the shared
// staging; shorter tiles keep checkpoints, as fast_smoother_ll's do.
template <typename R, int M>
__global__ void laplace_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SY = M + M * M;
  const int n = (int)a.n, rows = (int)a.rows, dist = (int)a.dist;
  const int C = (int)a.chunk;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const long B = a.B, b0 = (long)blockIdx.x * rows;
  const int nr = (int)min((long)rows, B - b0);
  R* const s_sys = reinterpret_cast<R*>(smem_raw);
  SplitTile<R> st{s_sys + rows * SY, (split_fields<M>() * C) | 1, C};
  R* const s_dacc = st.p + (long)rows * st.ld;  // [rows][32]
  // the block's checkpoints, one for every tile but the first
  R* const ck = reinterpret_cast<R*>(a.scratch) +
                b0 * (long)checkpoint_fields<M>() * ((n + C - 1) / C - 1);
  R* const mode_out = reinterpret_cast<R*>(a.out);
  R* const ll_out = mode_out + B * n;
  R* const diff_out = ll_out + B;

  for (int k = tid; k < nr * 32; k += nth) s_dacc[k] = R(0);
  Sys<R, M> s;
  if (tid < nr) {
    load_sys_leaves<R, M>(s, a.sys, b0 + tid);
    R* sy = s_sys + tid * SY;
#pragma unroll
    for (int i = 0; i < M; ++i) sy[i] = s.Z[i];
#pragma unroll
    for (int i = 0; i < M * M; ++i) sy[M + i] = s.T[i];
  }
  split_pass<R, M, false>(
      st, ck, s_sys, rows, nr, n, C, s,
      // the pseudo-observations (ytilde, HHtilde) at the mode of the tile's
      // steps, from t0, and D, into fields 0, 1 and M + 1
      [&](int t0, int len) {
        for (int k = tid; k < nr * len; k += nth) {
          const int r = k / len, t = k - r * len;
          const long b = b0 + r, tt = t0 + t;
          const R y = series_row<R>(a.y, b)[tt * a.y.ts];
          R yt, hh;
          laplace_match<R>(dist, y, series_row<R>(a.u, b)[tt * a.u.ts],
                           leaf_row<R>(a.sys.phi, b)[0],
                           series_row<R>(a.mode, b)[tt * a.mode.ts], yt, hh);
          st(r, 0, t) = isfinite(y) ? yt : R(NAN);
          st(r, 1, t) = (isfinite(hh) && hh > R(0)) ? hh : R(1);
          st(r, M + 1, t) = series_row<R>(a.D, b)[tt * a.D.ts];
        }
        __syncthreads();
      },
      [&](const R (&)[M], R ll, R) { ll_out[b0 + tid] = ll; },
      [&](int t0, int len) {
        // the new mode of every step, stored a row's run at a time, and its
        // squared change into field 0
        for (int k = tid; k < nr * len; k += nth) {
          const int r = k / len, t = k - r * len;
          const long b = b0 + r, tt = t0 + t;
          R al[M];
#pragma unroll
          for (int i = 0; i < M; ++i) al[i] = smoothed_mean<R, M>(st, r, t, i);
          R new_mode;
          if (dist == kSvm) {
            new_mode = al[0];
          } else {
            const R* Z = s_sys + r * SY;
            new_mode = series_row<R>(a.D, b)[tt * a.D.ts];
#pragma unroll
            for (int i = 0; i < M; ++i) new_mode += Z[i] * al[i];
          }
          mode_out[b * n + tt] = new_mode;
          const R delta = new_mode - series_row<R>(a.mode, b)[tt * a.mode.ts];
          st(r, 0, t) = delta * delta;
        }
        __syncthreads();
        // lane l of a row's warp adds the steps t = l (mod 32), last first:
        // the same order whatever the tiles
        for (int r = warp; r < nr; r += nwarps) {
          R acc = s_dacc[r * 32 + lane];
          const int last = t0 + len - 1;
          for (int t = last - (((last - lane) % 32) + 32) % 32; t >= t0;
               t -= 32)
            acc += st(r, 0, t - t0);
          s_dacc[r * 32 + lane] = acc;
        }
        __syncthreads();
      });
  for (int r = warp; r < nr; r += nwarps) {
    const R sum = warp_sum(s_dacc[r * 32 + lane]);
    if (lane == 0) diff_out[b0 + r] = sum / R(n);
  }
}

template <typename R, int M> int launch_solve(const LaplaceArgs& a) {
  if (a.rows < 1 || a.rows > 32 ||
      (a.shared && (a.block_elems != laplace_block_elems(a.rows, a.n, M) ||
                    a.smem != a.block_elems * (long long)sizeof(R))) ||
      (!a.shared && a.block_elems != laplace_row_elems(a.n, M)))
    return -3;
  const unsigned blocks = (unsigned)((a.B + a.rows - 1) / a.rows);
  const cudaStream_t stream = (cudaStream_t)a.stream;
  if (a.shared) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace_solve_kernel<R, M, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (e != cudaSuccess) return (int)e;
    laplace_solve_kernel<R, M, true>
        <<<blocks, (unsigned)a.rows, (size_t)a.smem, stream>>>(a);
  } else {
    laplace_solve_kernel<R, M, false>
        <<<blocks, (unsigned)a.rows, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename R, int M> int launch_step(const StepArgs& a) {
  const long long ntiles = a.chunk < 1 ? 0 : (a.n + a.chunk - 1) / a.chunk;
  if (a.rows < 1 || a.threads < a.rows || a.threads > kStepMaxThreads ||
      a.threads % 32 != 0 || a.n < 1 || a.chunk < 1 || a.chunk > a.n ||
      (ntiles > 1) != (a.scratch != 0) ||
      a.smem != step_block_elems(a.rows, a.chunk, M) * (long long)sizeof(R))
    return -3;
  const unsigned blocks = (unsigned)((a.B + a.rows - 1) / a.rows);
  if (a.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace_step_kernel<R, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (e != cudaSuccess) return (int)e;
  }
  laplace_step_kernel<R, M><<<blocks, (unsigned)a.threads, (size_t)a.smem,
                              (cudaStream_t)a.stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bssm

// Plain C entry points.  `args` points to the packed argument struct and
// `size` is its length in bytes.  Each returns the launch's cudaError_t, -1
// for an unsupported m, -2 when `size` is not the struct's, -3 for a
// staging geometry that disagrees with laplace_block_elems or a tile
// geometry that disagrees with step_block_elems.
extern "C" int bssm_laplace_solve(const void* args, long long size) {
  if (size != (long long)sizeof(bssm::LaplaceArgs)) return -2;
  bssm::LaplaceArgs a;
  memcpy(&a, args, sizeof a);
  int code = 0;
  bool known;
#define LAUNCH(R, M) code = bssm::launch_solve<R, M>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  return known ? code : -1;
}

extern "C" int bssm_laplace_step(const void* args, long long size) {
  if (size != (long long)sizeof(bssm::StepArgs)) return -2;
  bssm::StepArgs a;
  memcpy(&a, args, sizeof a);
  int code = 0;
  bool known;
#define LAUNCH(R, M) code = bssm::launch_step<R, M>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  return known ? code : -1;
}

extern "C" const char* bssm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
