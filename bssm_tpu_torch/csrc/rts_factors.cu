// rts_factors: Kalman filter forward + J-form backward sweep emitting the
// backward (FFBS) factorisation of the smoothing law, the proposal of the
// psi-auxiliary particle filter:
//   alpha_n ~ N(ahat_n, Lb_n Lb_n'),
//   alpha_t | alpha_{t+1} ~ N(ahat_t + Ab_t (alpha_{t+1} - ahat_{t+1}),
//                             Lb_t Lb_t').
//
// Replaces the TPU kernel `_rts_kernel` (bssm_tpu/ops/pallas_kalman.py:1205,
// called at :1495).  Plain version: ops/kalman.smoother_bwd_factors.
//
// What bounds it on this card: the latency of the forward filter, one
// dependent chain of n Kalman steps a row, and the bytes of the factors,
// (n+1)(m + 2 m^2) values a row written once.  The backward factors do not
// depend on the backward recursion:
//   J_t   = Ptt_t T' pinv(T Ptt_t T' + RR),
//   Sig_t = (I - J_t T) Ptt_t (I - J_t T)' + J_t RR J_t',
//   Lb_t  = factor(Sig_t),  Ab_t = J_t
// are functions of the filtered moments at t alone; only
//   ahat_t = att_t + J_t (ahat_{t+1} - a_{t+1|t})
// is a recursion, and it is affine in m values.  So one launch runs three
// phases over a block of `rows` rows:
//
//   1. forward, one thread a row: the kf_step chain, staging att_t and
//      Ptt_t, and at t = n the factor of P_{n|n-1} (Lb_n; Ab_n = 0,
//      ahat_n = a_{n|n-1}, kept in the thread's registers for phase 3);
//   2. factors, every thread of the block over the (row, t) items, t < n
//      (in the shared staging consecutive threads take consecutive t of one
//      row, so Lb_t and Ab_t are stored contiguously in the (B, n+1, m, m)
//      layout the callers read).  `predict` recomputes
//      P_{t+1|t} from the staged moments by the very function the forward
//      pass used, so it agrees with it to the bit;
//   3. ahat, one thread a row: the affine recursion from the staged att_t,
//      J_t read back from Ab and a_{t+1|t} predicted again, m^2
//      multiply-adds a step, a group of steps' values read before any is
//      used.
//
// Every factor is computed as the first design (one thread a row, both
// passes in series) computed it, form for form and in the same order, so
// the two agree to the bit.
//
// Staging, att (m) and the upper triangle of Ptt (m (m+1) / 2) of every
// step, in one of two places, a template flag of the same kernel:
// * shared memory: the block's own rows, beside each row's T, RR and C,
//   row by row, field by field, each a run of n steps (rts_row_elems
//   values a row, odd); `rows` = 8, so that B = 1024 is 128 blocks over
//   the 132 SMs;
// * device memory, a scratch of every row of the batch, resident at once,
//   32 rows a block (a whole warp in phases 1 and 3), step by step, field
//   by field, the block's rows side by side, so that the one-thread-a-row
//   phases store and load a line at a time, and phase 2 takes its items
//   row-fastest to read them so.
// The wrapper (ops/cuda_kalman.rts_geometry) takes shared memory while its
// blocks run in at most 3.5 waves: every further wave costs a whole forward
// chain, but the device staging's traffic costs more up to there (measured
// over m = 1..4, both dtypes and B = 1024..16384 on an H100: shared wins at
// 3.1 waves by 23%, loses at 3.9 by 16%; PERF.md).
#include <string.h>

#include "kalman_common.cuh"

namespace bssm {

// Launch arguments of bssm_rts_factors, packed by ops/cuda_kalman.py in this
// order (see kalman_common.cuh).  H holds standard deviations.  `out` is one
// device buffer of the three outputs (rts_layout): ahat (B, n+1, m) from 0,
// Lb (B, n+1, m, m) from the first line of 32 values after it, Ab (B, n+1,
// m, m) right behind Lb.  `scratch` is the device-memory staging,
// rts_step_elems(m) n values for every row of the blocks (0 in the shared
// one).
struct RtsArgs {
  long long is_double, m, B, n;
  SeriesArg y, H, D;
  SystemArg sys;
  long long out, scratch;
  long long rows;     // rows of the batch a block takes
  long long threads;  // threads of a block
  long long shared;   // 1: staging in shared memory, 0: in `scratch`
  long long smem;     // dynamic shared memory of a block, bytes
  long long stream;
};

constexpr int kRtsMaxThreads = 128;
// blocks an SM holds of the shared-staging kernel in float at m <= 2 (a
// launch bound: 64 registers a thread), so that the main path's 16384-row
// chunks run in two waves, not three
constexpr int kRtsMinBlocks = 8;

// staged values of a step: att (m) and the upper triangle of the
// symmetric Ptt (m (m + 1) / 2)
__host__ __device__ constexpr long long rts_step_elems(long long m) {
  return m + m * (m + 1) / 2;
}
// staged values of one row in shared memory: n steps, made odd so that the
// threads of phases 1 and 3, one a row, touch different banks
__host__ __device__ inline long long rts_row_elems(long long n, long long m) {
  return (rts_step_elems(m) * n) | 1;
}
// offsets of Lb and Ab in `out`, and its length, in values: Lb starts on a
// line of 32 values, so that its runs of m^2 values, and Ab's, stay
// 16-byte aligned where they are a whole number of 16 bytes
__host__ __device__ inline void rts_layout(long long B, long long n,
                                           long long m, long long& lb,
                                           long long& ab, long long& total) {
  const long long k = B * (n + 1);
  lb = (k * m + 31) & ~31LL;
  ab = lb + k * m * m;
  total = ab + k * m * m;
}
// T, RR and C of one row, in shared memory in both stagings
__host__ __device__ constexpr long long rts_sys_elems(long long m) {
  return 2 * m * m + m;
}

// A run of K values, moved with 16-byte accesses where it is a whole number
// of them (its start is then 16-byte aligned by the layout: the buffer
// starts on a line and every run starts at a multiple of K values).
template <typename R, int K>
__device__ __forceinline__ void store_run(R* dst, const R (&v)[K]) {
  if constexpr ((K * sizeof(R)) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 16 / (int)sizeof(R)) {
      if constexpr (sizeof(R) == 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      else
        *reinterpret_cast<double2*>(dst + i) = make_double2(v[i], v[i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) dst[i] = v[i];
  }
}
template <typename R, int K>
__device__ __forceinline__ void load_run(R (&v)[K], const R* src) {
  if constexpr ((K * sizeof(R)) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 16 / (int)sizeof(R)) {
      if constexpr (sizeof(R) == 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + i);
        v[i] = x.x;
        v[i + 1] = x.y;
        v[i + 2] = x.z;
        v[i + 3] = x.w;
      } else {
        const double2 x = *reinterpret_cast<const double2*>(src + i);
        v[i] = x.x;
        v[i + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = src[i];
  }
}

template <typename R, int M, bool kShared>
__global__ void __launch_bounds__(
    kRtsMaxThreads, kShared && sizeof(R) == 4 && M <= 2 ? kRtsMinBlocks : 1)
rts_factors_kernel(const RtsArgs g) {
  constexpr int MM = M * M;
  constexpr int SYS = (int)rts_sys_elems(M);
  constexpr int W = (int)rts_step_elems(M);     // staged values a step
  extern __shared__ __align__(16) unsigned char rts_smem[];
  const long B = g.B;
  const int n = (int)g.n;
  const int rows = (int)g.rows;
  const long ld = rts_row_elems(n, M);
  const long b0 = (long)blockIdx.x * rows;
  const int nr = (int)min((long)rows, B - b0);  // rows of this block
  const int tid = threadIdx.x;

  R* const s_sys = reinterpret_cast<R*>(rts_smem);  // [rows][T, RR, C]
  long long lb_off, ab_off, total;
  rts_layout(B, n, M, lb_off, ab_off, total);
  R* const ahat = reinterpret_cast<R*>(g.out);      // (B, n+1, M)
  R* const Lb = ahat + lb_off;                       // (B, n+1, M, M)
  R* const Ab = ahat + ab_off;
  R* const st = kShared ? s_sys + rows * SYS
                        : reinterpret_cast<R*>(g.scratch) + b0 * W * n;
  // value f of a step (att, then Ptt's upper triangle row by row) of row r
  // at step t: row-major in shared memory, step-major with the block's rows
  // side by side in device memory (a warp's 32 rows one line)
  const auto at = [&](int r, int f, int t) -> long {
    return kShared ? r * ld + (long)f * n + t
                   : ((long)t * W + f) * rows + r;
  };
  // row r's T, RR, C
  const auto row_sys = [&](int r, Sys<R, M>& s) {
    const R* sy = s_sys + r * SYS;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      s.T[i] = sy[i];
      s.RR[i] = sy[MM + i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) s.C[i] = sy[2 * MM + i];
  };

  // ---- phase 1: forward filter, one thread a row
  R a[M];  // a_{n|n-1} at the end: ahat_n, the start of phase 3
  if (tid < nr) {
    const long b = b0 + tid;
    Sys<R, M> s;
    load_sys_leaves<R, M>(s, g.sys, b);
    R* const sy = s_sys + tid * SYS;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      sy[i] = s.T[i];
      sy[MM + i] = s.RR[i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) sy[2 * MM + i] = s.C[i];
    const R* __restrict__ y = series_row<R>(g.y, b);
    const R* __restrict__ H = series_row<R>(g.H, b);
    const R* __restrict__ D = series_row<R>(g.D, b);
    const long y_ts = g.y.ts, H_ts = g.H.ts, D_ts = g.D.ts;
    R P[MM];
#pragma unroll
    for (int i = 0; i < M; ++i) a[i] = s.a1[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
    for (int t = 0; t < n; ++t) {
      const R h = H[t * H_ts];
      R v, Fs, okf, inc, att[M], Ptt[MM];
      kf_step<R, M>(s, a, P, y[t * y_ts], h * h, D[t * D_ts], v, Fs, okf,
                    inc, att, Ptt);
      // Ptt is exactly symmetric (kf_step averages it with its transpose)
      int f = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) st[at(tid, f++, t)] = att[i];
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = i; j < M; ++j) st[at(tid, f++, t)] = Ptt[i * M + j];
    }
    // t = n: alpha_n ~ N(a_n, P_n), no observation
    R Ln[MM], Z0[MM];
    psd_factor<R, M>(P, Ln);
#pragma unroll
    for (int i = 0; i < MM; ++i) Z0[i] = R(0);
    const long on = b * (n + 1) + n;
#pragma unroll
    for (int i = 0; i < M; ++i) ahat[on * M + i] = a[i];
    store_run<R, MM>(Lb + on * MM, Ln);
    store_run<R, MM>(Ab + on * MM, Z0);
  }
  __syncthreads();

  // ---- phase 2: the factors of every (row, t < n), all threads; in
  // shared memory consecutive threads take consecutive t of a row, so that
  // Lb and Ab are stored contiguously, in device memory consecutive rows,
  // so that the staged moments are read a line at a time
  const int items = nr * n;
  for (int k = tid; k < items; k += blockDim.x) {
    const int r = kShared ? k / n : k % nr;
    const int t = kShared ? k - r * n : k / nr;
    Sys<R, M> s;
    row_sys(r, s);
    R att[M], Ptt[MM], a_next[M], P_next[MM];
    int f = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) att[i] = st[at(r, f++, t)];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = i; j < M; ++j) Ptt[i * M + j] = Ptt[j * M + i] =
          st[at(r, f++, t)];
    predict<R, M>(s, att, Ptt, a_next, P_next);
    // J = Ptt T' pinv(P_{t+1|t})
    R Pinv[MM], PT[MM], J[MM];
    psd_pinv<R, M>(P_next, Pinv);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        R acc = R(0);
#pragma unroll
        for (int l = 0; l < M; ++l) acc += Ptt[i * M + l] * s.T[j * M + l];
        PT[i * M + j] = acc;
      }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        R acc = R(0);
#pragma unroll
        for (int l = 0; l < M; ++l) acc += PT[i * M + l] * Pinv[l * M + j];
        J[i * M + j] = acc;
      }
    // Joseph form of the backward conditional covariance, all-additive:
    // Sig = (I - J T) Ptt (I - J T)' + J RR J'
    R ImJT[MM], MP[MM], JR[MM], Sig[MM], L[MM];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        R acc = R(0);
#pragma unroll
        for (int l = 0; l < M; ++l) acc += J[i * M + l] * s.T[l * M + j];
        ImJT[i * M + j] = (i == j ? R(1) : R(0)) - acc;
      }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        R acc = R(0), acc2 = R(0);
#pragma unroll
        for (int l = 0; l < M; ++l) {
          acc += ImJT[i * M + l] * Ptt[l * M + j];
          acc2 += J[i * M + l] * s.RR[l * M + j];
        }
        MP[i * M + j] = acc;
        JR[i * M + j] = acc2;
      }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        R acc = R(0);
#pragma unroll
        for (int l = 0; l < M; ++l)
          acc += MP[i * M + l] * ImJT[j * M + l] + JR[i * M + l] * J[j * M + l];
        Sig[i * M + j] = acc;
      }
    R SigS[MM];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j)
        SigS[i * M + j] = R(0.5) * (Sig[i * M + j] + Sig[j * M + i]);
    psd_factor<R, M>(SigS, L);
    const long o = (b0 + r) * (n + 1) + t;
    store_run<R, MM>(Lb + o * MM, L);
    store_run<R, MM>(Ab + o * MM, J);
  }
  __syncthreads();

  // ---- phase 3: ahat_t = att + J (ahat_{t+1} - a_{t+1|t}), one thread a
  // row: att from the staging, J_t read back from Ab (written by this block
  // in phase 2), a_{t+1|t} predicted again from att by the function the
  // forward pass used (so the same to the bit); K steps' values are read
  // before any is used
  if (tid < nr) {
    constexpr int K = M <= 2 ? 8 : 4;
    Sys<R, M> s;
    row_sys(tid, s);
    const R* const J_row = Ab + (b0 + tid) * (n + 1) * MM;
    R* const ah_out = ahat + (b0 + tid) * (n + 1) * M;
    R ah_next[M];
#pragma unroll
    for (int i = 0; i < M; ++i) ah_next[i] = a[i];
    for (int t1 = n; t1 > 0; t1 -= K) {
      R v_att[K][M], v_J[K][MM];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int t = max(t1 - 1 - q, 0);
#pragma unroll
        for (int i = 0; i < M; ++i) v_att[q][i] = st[at(tid, i, t)];
        load_run<R, MM>(v_J[q], J_row + (long)t * MM);
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int t = t1 - 1 - q;
        if (t < 0) break;
        R an[M], ah[M];
        predict_mean<R, M>(s.C, s.T, v_att[q], an);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          R acc = v_att[q][i];
#pragma unroll
          for (int j = 0; j < M; ++j)
            acc += v_J[q][i * M + j] * (ah_next[j] - an[j]);
          ah[i] = acc;
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          ah_out[(long)t * M + i] = ah[i];
          ah_next[i] = ah[i];
        }
      }
    }
  }
}

template <typename R, int M> int launch_rts(const RtsArgs& a) {
  constexpr long long SYS = rts_sys_elems(M);
  const long long want =
      a.rows * (SYS + (a.shared ? rts_row_elems(a.n, M) : 0)) *
      (long long)sizeof(R);
  if (a.rows < 1 || a.threads < a.rows || a.threads > kRtsMaxThreads ||
      a.threads % 32 != 0 || a.smem != want || a.n < 1 ||
      (a.shared == 0) != (a.scratch != 0))
    return -3;
  const unsigned blocks = (unsigned)((a.B + a.rows - 1) / a.rows);
  const cudaStream_t stream = (cudaStream_t)a.stream;
  if (a.shared) {
    if (a.smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          rts_factors_kernel<R, M, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
      if (e != cudaSuccess) return (int)e;
    }
    rts_factors_kernel<R, M, true>
        <<<blocks, (unsigned)a.threads, (size_t)a.smem, stream>>>(a);
  } else {
    rts_factors_kernel<R, M, false>
        <<<blocks, (unsigned)a.threads, (size_t)a.smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace bssm

// Plain C entry point.  `args` points to the packed RtsArgs and `size` is
// its length in bytes.  Returns the launch's cudaError_t, -1 for an
// unsupported m, -2 when `size` is not the struct's, -3 for a geometry
// that does not match n and m.
extern "C" int bssm_rts_factors(const void* args, long long size) {
  if (size != (long long)sizeof(bssm::RtsArgs)) return -2;
  bssm::RtsArgs a;
  memcpy(&a, args, sizeof a);
  bool known;
  int code = 0;
#define LAUNCH(R, M) code = bssm::launch_rts<R, M>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return code;
}
