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
// What bounds kalman_ll on this card: neither the bytes (the series and
// the system: microseconds at 16384 rows) nor the operations, but the latency
// of one chain of n dependent Kalman steps per row with m x m matrices in
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
// fast_smoother_ll runs the same forward chain, one thread a row, and then
// the backward pass split as kalman_common.cuh sets out: c_t and L_t (as
// w = v/F and g = T K) and alphahat_t are maps over (row, t) that every
// thread of the block computes; only the r chain, m^2 multiply-adds a step,
// stays one thread a row.  The first design was bound by the bytes of its
// device-memory staging (3 + m + m^2 values a step written and read back)
// and by reading the series and writing alpha at a stride of n a thread.
// Here the series come in through the block's tile in shared memory
// (cp.async, consecutive threads on consecutive t of a row), the forward
// pass stages 2 + m + m(m+1)/2 values a step in the tile (v, and F with the
// update mask folded in, a_t, P_t's upper triangle: 7 at m = 2, not 9), and
// each row's alpha goes out as one contiguous run.  The tile holds `chunk`
// steps of the block's rows; the wrapper's rule (ops/cuda_kalman.
// fs_geometry) picks one of two layouts:
// * the whole series (chunk = n) of 8 rows a block on 128 threads, nothing
//   staged outside shared memory, while the blocks run in at most
//   FS_SHARED_WAVES waves: each wave costs a whole forward chain;
// * beyond that, 32 rows a block on one warp (every row resident at once at
//   the path's 65536-row chunks) and tiles of fs_chunk steps (12 at m = 2
//   float32), with checkpoints: the forward pass keeps a and P's triangle at
//   the start of each tile in a small device buffer (a tenth of a staging's
//   bytes), and the backward pass runs each tile's forward steps again
//   before its backward steps, twice the forward arithmetic for no staging
//   traffic.  A staging of every step in device memory, coalesced, was
//   measured against it over m = 1..4, both dtypes and B = 1024..65536 and
//   lost in every case (development runs, PERF.md), so it is not kept.
// Both layouts compute every value by the same operations in the same
// order and agree to the bit.
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
  long long scratch;  // smoother: the checkpoints, 0 with one tile
  long long chunk;    // kalman_ll: time steps of a D tile chunk, 0: no tile;
                      // smoother: steps of a tile, n: the whole series
  long long smem;     // dynamic shared memory of a block, bytes
  long long rows;     // smoother: rows of the batch a block takes
  long long threads;  // smoother: threads of a block
  long long stream;
};

constexpr int kRowsLG = 32;  // rows (threads) of a kalman_ll block
constexpr int kFsMaxThreads = 256;  // threads of a smoother block

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

// the shared-memory values of a fast_smoother_ll block of `rows` rows whose
// tile holds `len` steps: each row's Z and T, then the tile
__host__ __device__ inline long long fs_block_elems(long long rows,
                                                    long long len,
                                                    long long m) {
  const long long ws = 2 * m + 1 + m * (m + 1) / 2;  // split_fields
  return rows * (m + m * m) + rows * ((ws * len) | 1);
}

// One launch: the forward filter of every row of the block, tile by tile,
// then the split backward pass (kalman_common.cuh) from the last tile to the
// first, alphahat stored as it comes.  One tile of n steps is the shared
// staging; shorter tiles keep checkpoints (see the head).
template <typename R, int M>
__global__ void fast_smoother_ll_kernel(const KalmanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SY = M + M * M;
  const int n = (int)a.n, rows = (int)a.rows, C = (int)a.chunk;
  const int tid = threadIdx.x, nth = blockDim.x;
  const long B = a.B, b0 = (long)blockIdx.x * rows;
  const int nr = (int)min((long)rows, B - b0);
  R* const s_sys = reinterpret_cast<R*>(smem_raw);
  SplitTile<R> st{s_sys + rows * SY, (split_fields<M>() * C) | 1, C};
  // the block's checkpoints, one for every tile but the first
  R* const ck = reinterpret_cast<R*>(a.scratch) +
                b0 * (long)checkpoint_fields<M>() * ((n + C - 1) / C - 1);
  R* const alpha = reinterpret_cast<R*>(a.alpha);

  Sys<R, M> s;
  if (tid < nr) {
    load_sys_leaves<R, M>(s, a.sys, b0 + tid);
    R* sy = s_sys + tid * SY;
#pragma unroll
    for (int i = 0; i < M; ++i) sy[i] = s.Z[i];
#pragma unroll
    for (int i = 0; i < M * M; ++i) sy[M + i] = s.T[i];
  }
  split_pass<R, M, true>(
      st, ck, s_sys, rows, nr, n, C, s,
      // y, H and D of the tile's steps, from t0, into fields 0, 1 and
      // M + 1, consecutive threads on consecutive steps of a row
      [&](int t0, int len) {
        for (int k = tid; k < nr * len; k += nth) {
          const int r = k / len, t = k - r * len;
          const long b = b0 + r, tt = t0 + t;
          cp_async<sizeof(R)>(&st(r, 0, t),
                              series_row<R>(a.y, b) + tt * a.y.ts);
          cp_async<sizeof(R)>(&st(r, 1, t),
                              series_row<R>(a.H, b) + tt * a.H.ts);
          cp_async<sizeof(R)>(&st(r, M + 1, t),
                              series_row<R>(a.D, b) + tt * a.D.ts);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      },
      [&](const R (&an)[M], R ll, R hsum) {
        const long b = b0 + tid;
        // alphahat_n = a_n: no observation after the last step
#pragma unroll
        for (int i = 0; i < M; ++i) alpha[(b * (n + 1) + n) * M + i] = an[i];
        reinterpret_cast<R*>(a.ll)[b] =
            degenerate_h2rr<R, M>(hsum, s) ? R(-INFINITY) : ll;
      },
      // alphahat of the tile's steps, each row's run stored contiguously
      [&](int t0, int len) {
        const int run = len * M;
        for (int k = tid; k < nr * run; k += nth) {
          const int r = k / run, q = k - r * run, t = q / M, i = q - t * M;
          alpha[(b0 + r) * (n + 1) * M + (long)t0 * M + q] =
              smoothed_mean<R, M>(st, r, t, i);
        }
        __syncthreads();
      });
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
  const long long ntiles = a.chunk < 1 ? 0 : (a.n + a.chunk - 1) / a.chunk;
  if (a.rows < 1 || a.threads < a.rows || a.threads > kFsMaxThreads ||
      a.threads % 32 != 0 || a.n < 1 || a.chunk < 1 || a.chunk > a.n ||
      (ntiles > 1) != (a.scratch != 0) ||
      a.smem != fs_block_elems(a.rows, a.chunk, M) * (long long)sizeof(R))
    return -3;
  const unsigned blocks = (unsigned)((a.B + a.rows - 1) / a.rows);
  if (a.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fast_smoother_ll_kernel<R, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (e != cudaSuccess) return (int)e;
  }
  fast_smoother_ll_kernel<R, M><<<blocks, (unsigned)a.threads,
                                  (size_t)a.smem, (cudaStream_t)a.stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bssm

// Plain C entry points: `args` points to the packed KalmanArgs, `size` is
// its length in bytes.  Each returns the launch's cudaError_t, -1 for an
// unsupported m, -2 when `size` is not the struct's, -3 for a D tile or a
// smoother geometry the kernel does not take.
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
