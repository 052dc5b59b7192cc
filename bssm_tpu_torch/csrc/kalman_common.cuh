// Device functions shared by the state-space kernels of this package
// (laplace_solve.cu, kalman_filter.cu, rts_factors.cu, psi_logw.cu,
// particle_big.cu), written once.
//
// Everything is templated on the real type R (float or double) and on the
// state dimension M (1..4), so the small M x M matrices live in registers
// with every loop unrolled.  The system matrices Z, T, RR = R R', C are time
// invariant; y, the observation variance and the intercept D vary in time.
//
// The arithmetic follows the plain PyTorch versions in ops/kalman.py,
// ops/chol.py and core/distributions.py form for form (Joseph-form updates,
// Tikhonov-smoothed pseudo-inverse, closed-form 2x2 eigensystem with the same
// column convention), because the forms were chosen for float32 stability and
// the CPU tests hold the plain versions against the JAX reference.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bssm {

constexpr double kZeroTol = 1e-8;
constexpr double kLog2Pi = 1.8378770664093453;

enum Family { kSvm = 0, kPoisson = 1, kBinomial = 2, kNegbin = 3, kGamma = 4 };

template <typename R> __device__ __forceinline__ R eps_of();
template <> __device__ __forceinline__ float eps_of<float>() {
  return 1.1920928955078125e-07f;
}
template <> __device__ __forceinline__ double eps_of<double>() {
  return 2.220446049250313e-16;
}

// exp with the argument clipped below the type's overflow point
template <typename R> __device__ __forceinline__ R safe_exp(R x) {
  const R cap = sizeof(R) == 4 ? R(80) : R(700);
  return exp(fmin(x, cap));
}

// ---------------------------------------------------------------------------
// time-invariant system of one batch row, in registers
// ---------------------------------------------------------------------------
template <typename R, int M> struct Sys {
  R Z[M];
  R T[M * M];
  R RR[M * M];
  R a1[M];
  R P1[M * M];
  R C[M];
};

// ---------------------------------------------------------------------------
// the system and the series read where the spec holds them
// ---------------------------------------------------------------------------
// Every kernel but philox_fill takes the spec's own tensors and one packed
// launch-argument struct.  Every field is 8 bytes wide, so the wrapper packs
// a whole argument struct with struct.pack ("q" for an integer or a
// pointer, "d" for a double) and no padding.  Pointers are device pointers;
// strides count elements.

// a per-time series: value t of row b at x[b * bs + t * ts]
struct SeriesArg {
  long long p, bs, ts;
};
// a time-invariant leaf: element i of row b at x[b * bs + i], the leaf's
// core (the axes after batch and time) contiguous; bs = 0 when shared
struct LeafArg {
  long long p, bs;
};
struct SystemArg {
  LeafArg Z, T, R, a1, P1, C, phi;  // phi: unused by the linear-Gaussian
                                    // kernels
  long long k;                      // columns of R
};

template <typename R>
__device__ __forceinline__ const R* leaf_row(const LeafArg& l, long b) {
  return reinterpret_cast<const R*>(l.p) + b * l.bs;
}
template <typename R>
__device__ __forceinline__ const R* series_row(const SeriesArg& s, long b) {
  return reinterpret_cast<const R*>(s.p) + b * s.bs;
}

// Row b's system from the leaves; RR = R R' is formed here, in registers.
template <typename R, int M>
__device__ __forceinline__ void load_sys_leaves(Sys<R, M>& s,
                                                const SystemArg& a, long b) {
  constexpr int MM = M * M;
  const R* Z = leaf_row<R>(a.Z, b);
  const R* T = leaf_row<R>(a.T, b);
  const R* Rm = leaf_row<R>(a.R, b);
  const R* a1 = leaf_row<R>(a.a1, b);
  const R* P1 = leaf_row<R>(a.P1, b);
  const R* C = leaf_row<R>(a.C, b);
  const int k = (int)a.k;
#pragma unroll
  for (int i = 0; i < M; ++i) s.Z[i] = Z[i];
#pragma unroll
  for (int i = 0; i < MM; ++i) s.T[i] = T[i];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      R acc = R(0);
      for (int l = 0; l < k; ++l) acc += Rm[i * k + l] * Rm[j * k + l];
      s.RR[i * M + j] = acc;
    }
#pragma unroll
  for (int i = 0; i < M; ++i) s.a1[i] = a1[i];
#pragma unroll
  for (int i = 0; i < MM; ++i) s.P1[i] = P1[i];
#pragma unroll
  for (int i = 0; i < M; ++i) s.C[i] = C[i];
}

// The degenerate-model rule of the JAX package's kernel wrappers
// (ops/kalman.degenerate_h2rr): H^2 summed over the n steps (a constant H
// counts n times) plus sum |R R'| below kZeroTol makes the log-likelihood
// -inf.  `hsum` is that sum of H^2, taken before any masking, so a NaN H
// keeps the row finite as in the plain rule.
template <typename R, int M>
__device__ __forceinline__ bool degenerate_h2rr(R hsum, const Sys<R, M>& s) {
  R rr = R(0);
#pragma unroll
  for (int i = 0; i < M * M; ++i) rr += fabs(s.RR[i]);
  return hsum + rr < R(kZeroTol);
}

// ---------------------------------------------------------------------------
// asynchronous copies from device memory to shared memory (sm_80 and later)
// ---------------------------------------------------------------------------
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(gmem), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a_next = C + T att
template <typename R, int M>
__device__ __forceinline__ void predict_mean(const R (&C)[M],
                                             const R (&T)[M * M],
                                             const R (&att)[M],
                                             R (&a_next)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    R acc = C[i];
#pragma unroll
    for (int j = 0; j < M; ++j) acc += T[i * M + j] * att[j];
    a_next[i] = acc;
  }
}

// a_next = C + T att;  P_next = sym(T Ptt T' + RR)
template <typename R, int M>
__device__ __forceinline__ void predict(const Sys<R, M>& s, const R (&att)[M],
                                        const R (&Ptt)[M * M], R (&a_next)[M],
                                        R (&P_next)[M * M]) {
  constexpr int MM = M * M;
  predict_mean<R, M>(s.C, s.T, att, a_next);
  R TP[MM];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      R acc = R(0);
#pragma unroll
      for (int l = 0; l < M; ++l) acc += s.T[i * M + l] * Ptt[l * M + j];
      TP[i * M + j] = acc;
    }
  R Pn[MM];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      R acc = s.RR[i * M + j];
#pragma unroll
      for (int l = 0; l < M; ++l) acc += TP[i * M + l] * s.T[j * M + l];
      Pn[i * M + j] = acc;
    }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
      P_next[i * M + j] = R(0.5) * (Pn[i * M + j] + Pn[j * M + i]);
}

// One masked, Joseph-form Kalman step.  On entry (a, P) are the predicted
// moments of time t; on exit those of time t+1.  Outputs the innovation v,
// its variance Fs (1 where masked), the update mask okf (0/1), the
// log-likelihood increment, and the filtered moments (att, Ptt).
template <typename R, int M>
__device__ __forceinline__ void kf_step(const Sys<R, M>& s, R (&a)[M],
                                        R (&P)[M * M], R y, R h2, R d, R& v,
                                        R& Fs, R& okf, R& ll_inc, R (&att)[M],
                                        R (&Ptt)[M * M]) {
  constexpr int MM = M * M;
  // a missing y may come with a NaN pseudo-variance; keep the algebra clean
  h2 = isfinite(h2) ? h2 : R(1);
  R PZ[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    R acc = R(0);
#pragma unroll
    for (int j = 0; j < M; ++j) acc += P[i * M + j] * s.Z[j];
    PZ[i] = acc;
  }
  R F = h2;
  R za = R(0);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    F += s.Z[i] * PZ[i];
    za += s.Z[i] * a[i];
  }
  const bool ok = isfinite(y) && (F > R(kZeroTol));
  okf = ok ? R(1) : R(0);
  Fs = ok ? F : R(1);
  v = ok ? (y - d - za) : R(0);
  R K[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    K[i] = ok ? PZ[i] / Fs : R(0);
    att[i] = a[i] + K[i] * v;
  }
  // Joseph form: (I - K Z') P (I - K Z')' + h2 K K'
  R BP[MM];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      R acc = P[i * M + j];
#pragma unroll
      for (int l = 0; l < M; ++l) acc -= K[i] * s.Z[l] * P[l * M + j];
      BP[i * M + j] = acc;
    }
  R Pu[MM];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      R acc = BP[i * M + j];
#pragma unroll
      for (int l = 0; l < M; ++l) acc -= BP[i * M + l] * K[j] * s.Z[l];
      Pu[i * M + j] = ok ? acc + h2 * K[i] * K[j] : P[i * M + j];
    }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
      Ptt[i * M + j] = R(0.5) * (Pu[i * M + j] + Pu[j * M + i]);
  ll_inc = okf * (R(-0.5) * (R(kLog2Pi) + log(Fs) + v * v / Fs));
  predict<R, M>(s, att, Ptt, a, P);
}

// One step of the backward mean pass of the fast smoother:
//   r_{t-1} = ok (Z v/F + L' r_t) + (1 - ok) T' r_t,  L = T (I - K Z'),
//   alphahat_t = a_t + P_t r_{t-1}                    (Durbin-Koopman 4.44)
// The gain is recomputed from the staged (P, F, ok) instead of being staged.
template <typename R, int M>
__device__ __forceinline__ void bwd_mean_step(const Sys<R, M>& s, R v, R F,
                                              R okf, const R (&a)[M],
                                              const R (&P)[M * M], R (&r)[M],
                                              R (&alpha)[M]) {
  R K[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    R acc = R(0);
#pragma unroll
    for (int j = 0; j < M; ++j) acc += P[i * M + j] * s.Z[j];
    K[i] = okf * acc / F;
  }
  R TK[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    R acc = R(0);
#pragma unroll
    for (int l = 0; l < M; ++l) acc += s.T[i * M + l] * K[l];
    TK[i] = acc;
  }
  R rn[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    R st = R(0), sl = R(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      st += s.T[i * M + j] * r[i];
      sl += (s.T[i * M + j] - TK[i] * s.Z[j]) * r[i];
    }
    rn[j] = okf * (s.Z[j] * (v / F) + sl) + (R(1) - okf) * st;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    R acc = a[i];
#pragma unroll
    for (int j = 0; j < M; ++j) acc += P[i * M + j] * rn[j];
    alpha[i] = acc;
    r[i] = rn[i];
  }
}

// ---------------------------------------------------------------------------
// the fast smoother's backward mean pass, split (fast_smoother_ll and
// laplace_step)
// ---------------------------------------------------------------------------
// The backward pass is the affine recursion r_{t-1} = c_t + L_t' r_t with
//   c_t = ok Z v / F,  L_t = T (I - K_t Z') where the step updates, T where
//   it does not,
// and alphahat_t = a_t + P_t r_{t-1}.  c_t and L_t depend on the forward
// pass alone, so they are a map over (row, t); so is alphahat once the r
// chain is done.  Only the chain of m-vectors r is serial, m^2 multiply-adds
// a step.  The forward pass stages v and F with the update mask folded in:
// where a step updates nothing (missing y, or F <= kZeroTol), F = +inf and
// v = 0, so that K = P Z / F = 0 and v / F = 0, and c_t + L_t' r is the
// missing branch T' r with no mask.  (`ll` still takes the mask: only what
// is staged is folded.)  c_t and L_t are held as (w = v / F, g = T K), m + 1
// values, from which the chain forms them with the row's Z and T: form for
// form as bwd_mean_step forms them.
//
// A block keeps the steps of its rows in shared memory (SplitTile): row by
// row, field by field, each field a run of `len` steps, a row's runs
// `ld` values long with `ld` odd, so that threads on consecutive rows touch
// different banks and threads on consecutive steps of one row neighbouring
// ones.  The fields of a step (split_fields):
//   0 .. M     the backward slots: the step's inputs (y, H or H^2, and D in
//              field M + 1) before the forward pass; v and F after it;
//              w and g after bwd_terms; r_{t-1} in 0 .. M-1 after
//              bwd_chain;
//   M+1..2M    a_t, the predicted mean;
//   2M+1 ..    the upper triangle of P_t, row by row.
// The forward pass stages the staged_fields of a step: v, F, a_t and P_t's
// upper triangle, 7 values at m = 2.
//
// Where a block's rows do not fit in shared memory with their whole series,
// the tile holds `len` steps at a time: the forward pass keeps, at the start
// of every tile but the first, a checkpoint of a and P's upper triangle
// (split_save), and the backward pass runs each tile's forward steps again
// from its checkpoint (split_restore) before its backward steps.  The same
// function on the same values gives the same bits, so a tiled pass equals
// the whole-series one to the bit.

template <int M> __host__ __device__ constexpr int split_fields() {
  return 2 * M + 1 + M * (M + 1) / 2;
}
template <int M> __host__ __device__ constexpr int staged_fields() {
  return 2 + M + M * (M + 1) / 2;
}
template <int M> __host__ __device__ constexpr int checkpoint_fields() {
  return M + M * (M + 1) / 2;
}

// Checkpoint c of row r of a block of `rows` rows (the state at the start
// of tile c + 1): in the block's device buffer `ck`, checkpoint by
// checkpoint, field by field, the block's rows side by side.
template <typename R, int M>
__device__ __forceinline__ void split_save(R* ck, int rows, int r, int c,
                                           const R (&a)[M],
                                           const R (&P)[M * M]) {
  R* p = ck + (long)c * checkpoint_fields<M>() * rows + r;
#pragma unroll
  for (int i = 0; i < M; ++i, p += rows) *p = a[i];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i; j < M; ++j, p += rows) *p = P[i * M + j];
}
template <typename R, int M>
__device__ __forceinline__ void split_restore(const R* ck, int rows, int r,
                                              int c, R (&a)[M],
                                              R (&P)[M * M]) {
  const R* p = ck + (long)c * checkpoint_fields<M>() * rows + r;
#pragma unroll
  for (int i = 0; i < M; ++i, p += rows) a[i] = *p;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i; j < M; ++j, p += rows) P[i * M + j] = P[j * M + i] = *p;
}
// the tile field of staged field f
template <int M> __host__ __device__ constexpr int split_field_of(int f) {
  return f < 2 ? f : f + M - 1;
}

template <typename R> struct SplitTile {
  R* p;     // row 0, field 0, step 0
  int ld;   // values from one row to the next (odd)
  int len;  // steps of a field's run
  __device__ __forceinline__ R& operator()(int r, int f, int t) const {
    return p[r * ld + f * len + t];
  }
};

// One forward step of the split smoother: a_t and P_t's upper triangle as
// they stand before the step, then kf_step, then v and F with the mask
// folded in.  `out` in staged order: v, F, a_t, P_t.  Returns the
// log-likelihood increment.  P_t is exactly symmetric after the first step
// (predict averages it with its transpose); P1 is taken as symmetric.
template <typename R, int M>
__device__ __forceinline__ R split_fwd_step(const Sys<R, M>& s, R (&a)[M],
                                            R (&P)[M * M], R y, R h2, R d,
                                            R (&out)[staged_fields<M>()]) {
  int f = 2;
#pragma unroll
  for (int i = 0; i < M; ++i) out[f++] = a[i];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i; j < M; ++j) out[f++] = P[i * M + j];
  R v, Fs, okf, inc, att[M], Ptt[M * M];
  kf_step<R, M>(s, a, P, y, h2, d, v, Fs, okf, inc, att, Ptt);
  out[0] = v;  // 0 where the step updates nothing
  out[1] = okf != R(0) ? Fs : R(INFINITY);
  return inc;
}

// P_t of step t of row r, from its upper triangle
template <typename R, int M>
__device__ __forceinline__ void split_P(const SplitTile<R>& st, int r, int t,
                                        R (&P)[M * M]) {
  int f = 2 * M + 1;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i; j < M; ++j) P[i * M + j] = P[j * M + i] = st(r, f++, t);
}

// c_t and L_t of every (row, t) of the tile, as (w, g), by the threads
// tid, tid + nth, ...: row r's Z and T are sys[r * (M + M^2) ..] (Z, then
// T row-major).  Reads v, F and P_t; writes w into field 0, g into 1 .. M.
template <typename R, int M>
__device__ __forceinline__ void bwd_terms(const SplitTile<R>& st,
                                          const R* sys, int nr, int tid,
                                          int nth) {
  constexpr int MM = M * M;
  const int len = st.len;
  for (int k = tid; k < nr * len; k += nth) {
    const int r = k / len, t = k - r * len;
    const R* Z = sys + r * (M + MM);
    const R* T = Z + M;
    R P[MM];
    split_P<R, M>(st, r, t, P);
    const R v = st(r, 0, t), F = st(r, 1, t);
    R K[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      R acc = R(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += P[i * M + j] * Z[j];
      K[i] = acc / F;
    }
    st(r, 0, t) = v / F;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      R acc = R(0);
#pragma unroll
      for (int l = 0; l < M; ++l) acc += T[i * M + l] * K[l];
      st(r, 1 + i, t) = acc;
    }
  }
}

// The r chain of row r over the tile's steps, last to first, one thread:
// r_{t-1} = Z w + (T - g Z')' r, written over the step's fields 0 .. M-1.
// `rv` carries r from one tile to the one before it.  Kc steps' (w, g) are
// read before any is used, off the chain.
template <typename R, int M>
__device__ __forceinline__ void bwd_chain(const SplitTile<R>& st, int r,
                                          const R (&Z)[M],
                                          const R (&T)[M * M], R (&rv)[M]) {
  constexpr int Kc = 4;
  for (int t1 = st.len; t1 > 0; t1 -= Kc) {
    R w[Kc], g[Kc][M];
#pragma unroll
    for (int q = 0; q < Kc; ++q) {
      const int t = max(t1 - 1 - q, 0);
      w[q] = st(r, 0, t);
#pragma unroll
      for (int i = 0; i < M; ++i) g[q][i] = st(r, 1 + i, t);
    }
#pragma unroll
    for (int q = 0; q < Kc; ++q) {
      const int t = t1 - 1 - q;
      if (t < 0) break;
      R rn[M];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        R sl = R(0);
#pragma unroll
        for (int i = 0; i < M; ++i)
          sl += (T[i * M + j] - g[q][i] * Z[j]) * rv[i];
        rn[j] = Z[j] * w[q] + sl;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        rv[j] = rn[j];
        st(r, j, t) = rn[j];
      }
    }
  }
}

// the field of P_t's element (i, j) (upper triangle, row by row)
template <int M> __device__ __forceinline__ int split_P_field(int i, int j) {
  const int a = min(i, j), b = max(i, j);
  return 2 * M + 1 + a * M - a * (a - 1) / 2 + (b - a);
}

// The backward steps of a tile, every thread of the block: c_t and L_t
// (bwd_terms), then the r chain of each row on thread r (bwd_chain), each
// phase closed by a barrier.  After it, fields 0 .. M-1 of every step hold
// r_{t-1}, which smoothed_mean reads.
template <typename R, int M>
__device__ __forceinline__ void split_backward(const SplitTile<R>& st,
                                               const R* sys, int nr,
                                               const Sys<R, M>& s,
                                               R (&rv)[M]) {
  bwd_terms<R, M>(st, sys, nr, threadIdx.x, blockDim.x);
  __syncthreads();
  if ((int)threadIdx.x < nr) bwd_chain<R, M>(st, threadIdx.x, s.Z, s.T, rv);
  __syncthreads();
}

// alphahat_t, element i, of row r: a_t + P_t r_{t-1}
template <typename R, int M>
__device__ __forceinline__ R smoothed_mean(const SplitTile<R>& st, int r,
                                           int t, int i) {
  R acc = st(r, M + 1 + i, t);
#pragma unroll
  for (int j = 0; j < M; ++j) acc += st(r, split_P_field<M>(i, j), t) *
                                     st(r, j, t);
  return acc;
}

// The forward steps of the tile for row r, one thread, its inputs read
// from the tile a step ahead: y in field 0, the observation variance in
// field 1 (its square root where kSquareH), D in field M + 1.  kFirst: the
// first pass, which sums the log-likelihood and the variances; kKeep:
// stage the steps in the tile.
template <typename R, int M, bool kSquareH, bool kFirst, bool kKeep>
__device__ __forceinline__ void split_tile_forward(const SplitTile<R>& st,
                                                   int r, const Sys<R, M>& s,
                                                   R (&a)[M], R (&P)[M * M],
                                                   R& ll, R& hsum) {
  constexpr int W = staged_fields<M>();
  const int len = st.len;
  R yn = st(r, 0, 0), hn = st(r, 1, 0), dn = st(r, M + 1, 0);
  for (int t = 0; t < len; ++t) {
    const R y = yn, h = hn, d = dn;
    if (t + 1 < len) {
      yn = st(r, 0, t + 1);
      hn = st(r, 1, t + 1);
      dn = st(r, M + 1, t + 1);
    }
    const R h2 = kSquareH ? h * h : h;
    R out[W];
    const R inc = split_fwd_step<R, M>(s, a, P, y, h2, d, out);
    if constexpr (kFirst) {
      hsum += h2;
      ll += inc;
    }
    if constexpr (kKeep) {
#pragma unroll
      for (int f = 0; f < W; ++f) st(r, split_field_of<M>(f), t) = out[f];
    }
  }
}

// One split pass over a block's rows, tile by tile (fast_smoother_ll,
// laplace_step).  Row r < nr is run by thread r, whose system is `s`;
// `sys` holds each row's Z and T in shared memory.  `load(t0, len)`,
// called by every thread, fills fields 0, 1 and M + 1 of the tile's `len`
// steps from t0 and ends with a barrier.  The forward pass keeps a
// checkpoint at the start of every tile but the first in the block's `ck`
// and stages the last tile; then `done(a_n, ll, hsum)` on each row's
// thread.  The backward pass goes from the last tile to the first: every
// tile but the last runs its forward steps again from its checkpoint, then
// split_backward, then `tail(t0, len)` on every thread (which leaves the
// tile free with a barrier).  `st.len` follows the tile.
template <typename R, int M, bool kSquareH, typename Load, typename Done,
          typename Tail>
__device__ __forceinline__ void split_pass(SplitTile<R>& st, R* ck,
                                           const R* sys, int rows, int nr,
                                           int n, int C, const Sys<R, M>& s,
                                           Load load, Done done, Tail tail) {
  constexpr int MM = M * M;
  const int tid = threadIdx.x, ntiles = (n + C - 1) / C;
  const bool chain = tid < nr;
  R av[M], P[MM], ll = R(0), hsum = R(0);
  const auto start = [&]() {
#pragma unroll
    for (int i = 0; i < M; ++i) av[i] = s.a1[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
  };
  if (chain) start();
  for (int c = 0; c < ntiles; ++c) {
    st.len = min(C, n - c * C);
    if (chain && c > 0) split_save<R, M>(ck, rows, tid, c - 1, av, P);
    load(c * C, st.len);
    if (chain) {
      if (c == ntiles - 1)
        split_tile_forward<R, M, kSquareH, true, true>(st, tid, s, av, P, ll,
                                                       hsum);
      else
        split_tile_forward<R, M, kSquareH, true, false>(st, tid, s, av, P,
                                                        ll, hsum);
    }
    __syncthreads();
  }
  if (chain) done(av, ll, hsum);
  R rv[M];
#pragma unroll
  for (int i = 0; i < M; ++i) rv[i] = R(0);
  for (int c = ntiles - 1; c >= 0; --c) {
    const int t0 = c * C;
    st.len = min(C, n - t0);
    if (c < ntiles - 1) {
      if (chain) {
        if (c > 0)
          split_restore<R, M>(ck, rows, tid, c - 1, av, P);
        else
          start();
      }
      load(t0, st.len);
      if (chain)
        split_tile_forward<R, M, kSquareH, false, true>(st, tid, s, av, P,
                                                        ll, hsum);
      __syncthreads();
    }
    split_backward<R, M>(st, sys, nr, s, rv);
    tail(t0, st.len);
  }
}

// ---------------------------------------------------------------------------
// observation families
// ---------------------------------------------------------------------------

// (ytilde, HHtilde) of the local Gaussian approximation at signal s
template <typename R>
__device__ __forceinline__ void laplace_match(int dist, R y, R u, R phi, R s,
                                              R& yt, R& hh) {
  switch (dist) {
    case kSvm: {
      const R ys = fabs(y) < R(1e-4) ? R(1e-4) : y;
      const R q = ys / phi;
      hh = R(2) * safe_exp(s) / (q * q);
      yt = s + R(1) - R(0.5) * hh;
      break;
    }
    case kPoisson: {
      hh = R(1) / (safe_exp(s) * u);
      yt = y * hh + s - R(1);
      break;
    }
    case kBinomial: {
      const R es = safe_exp(s);
      hh = (R(1) + es) * (R(1) + es) / (u * es);
      yt = y * hh + s - R(1) - es;
      break;
    }
    case kNegbin: {
      const R eu = safe_exp(s) * u;
      hh = (phi + eu) * (phi + eu) / (phi * eu * (y + phi));
      yt = s + (phi + eu) * (y - eu) / ((y + phi) * eu);
      break;
    }
    default: {  // kGamma
      const R eu = safe_exp(s) * u;
      hh = eu / (y * phi);
      yt = s - eu / y + R(1);
      break;
    }
  }
}

// log g(y|s) - log g~(yt|s): the unnormalised importance log-weight
template <typename R>
__device__ __forceinline__ R log_weight(int dist, R y, R u, R phi, R s, R yt,
                                        R ht) {
  const bool ok = isfinite(y);
  const R ys = ok ? y : R(0);
  R w;
  switch (dist) {
    case kSvm: {
      const R q = ys / phi;
      w = R(-0.5) * (s + q * q * safe_exp(-s));
      break;
    }
    case kPoisson:
      w = ys * s - u * safe_exp(s);
      break;
    case kBinomial:
      // logaddexp(0, s) = max(s, 0) + log1p(exp(-|s|))
      w = ys * s - u * (fmax(s, R(0)) + log1p(exp(-fabs(s))));
      break;
    case kNegbin:
      w = ys * s - (ys + phi) * log(phi + u * safe_exp(s));
      break;
    default:  // kGamma
      w = -phi * (s + ys * safe_exp(-s) / u);
      break;
  }
  const bool okg = isfinite(yt);
  const R hts = (okg && ht > R(0)) ? ht : R(1);
  const R z = ((okg ? yt : R(0)) - s) / hts;
  const R g = okg ? R(-0.5) * z * z : R(0);
  return (ok ? w : R(0)) - g;
}

// ---------------------------------------------------------------------------
// warp-wide reductions and prefix sum (all 32 lanes take part)
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

template <typename R> __device__ __forceinline__ R warp_max(R x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmax(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <typename R> __device__ __forceinline__ R warp_sum(R x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename R>
__device__ __forceinline__ R warp_inclusive_scan(R x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const R up = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += up;
  }
  return x;
}

// ---------------------------------------------------------------------------
// counter-based random numbers (Philox-4x32-10, Salmon et al. 2011)
// ---------------------------------------------------------------------------
// A value is a pure function of (key, counter), so it depends neither on the
// launch geometry nor on the order in which threads run.  The plain PyTorch
// version is ops/cuda_kalman.philox_fill_plain; both follow the layout
//   counter = (particle, step, row, which),  key = (key0, key1),
// row being the row's place in the whole batch (row0 + the launch's row), so
// that a window of the batch draws what the whole batch draws there.
// which = 0: words (w0, w1) feed the Box-Muller pair of normals 0 and 1.  For
// M <= 2 word w2 of the same call feeds the resampling uniform, so a
// particle-step costs one Philox call.  For M > 2 the pair (w2, w3) feeds
// normals 2 and 3, and the uniform is word 0 of a second call, which = 1,
// made at resampling steps only.

__device__ __forceinline__ void philox4x32_10(unsigned c0, unsigned c1,
                                              unsigned c2, unsigned c3,
                                              unsigned k0, unsigned k1,
                                              unsigned (&out)[4]) {
  constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const unsigned hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// Uniform strictly inside (0, 1) from the top 24 bits: (b + 0.5) / 2^24,
// rounded once to R.  In float that rounding reaches 1 for the largest b, so
// the value is capped at the largest float below 1.
template <typename R> __device__ __forceinline__ R u01_from_bits(unsigned w);
template <> __device__ __forceinline__ float u01_from_bits<float>(unsigned w) {
  const float u = __fmaf_rn((float)(w >> 8), 5.9604644775390625e-08f,
                            2.98023223876953125e-08f);
  return fminf(u, 0.99999994039535522f);
}
template <>
__device__ __forceinline__ double u01_from_bits<double>(unsigned w) {
  return ((double)(w >> 8) + 0.5) * 5.9604644775390625e-08;
}

__device__ __forceinline__ void sincospi_of(float x, float& s, float& c) {
  sincospif(x, &s, &c);
}
__device__ __forceinline__ void sincospi_of(double x, double& s, double& c) {
  sincospi(x, &s, &c);
}

// Box-Muller: two independent standard normals from two uniforms
template <typename R>
__device__ __forceinline__ void box_muller(R u1, R u2, R& z0, R& z1) {
  const R rad = sqrt(R(-2) * log(u1));
  R sn, cs;
  sincospi_of(R(2) * u2, sn, cs);
  z0 = rad * cs;
  z1 = rad * sn;
}

// The four words of (row, step, particle) with which = 0
__device__ __forceinline__ void philox_words(unsigned k0, unsigned k1,
                                             unsigned row, unsigned step,
                                             unsigned particle,
                                             unsigned (&w)[4]) {
  philox4x32_10(particle, step, row, 0u, k0, k1, w);
}

// The M standard normals from those words
template <typename R, int M>
__device__ __forceinline__ void philox_normals(const unsigned (&w)[4],
                                               R (&z)[M]) {
  R a, b;
  box_muller<R>(u01_from_bits<R>(w[0]), u01_from_bits<R>(w[1]), a, b);
  z[0] = a;
  if constexpr (M > 1) z[1] = b;
  if constexpr (M > 2) {
    box_muller<R>(u01_from_bits<R>(w[2]), u01_from_bits<R>(w[3]), a, b);
    z[2] = a;
    if constexpr (M > 3) z[3] = b;
  }
}

// The resampling uniform of (row, step, particle): word 2 of `w` where the
// normals leave it unused, else word 0 of the call with which = 1
template <typename R, int M>
__device__ __forceinline__ R philox_uniform(const unsigned (&w)[4],
                                            unsigned k0, unsigned k1,
                                            unsigned row, unsigned step,
                                            unsigned particle) {
  if constexpr (M <= 2) {
    return u01_from_bits<R>(w[2]);
  } else {
    unsigned v[4];
    philox4x32_10(particle, step, row, 1u, k0, k1, v);
    return u01_from_bits<R>(v[0]);
  }
}

// ---------------------------------------------------------------------------
// small symmetric eigensystems
// ---------------------------------------------------------------------------

// Closed-form 2x2: eigenvalues (w_small, w_big); the big eigenvalue's
// eigenvector is (u1, u2), the small one's (-u2, u1).
template <typename R>
__device__ __forceinline__ void eig2(R v00, R v01, R v11, R& w_small,
                                     R& w_big, R& u1, R& u2) {
  const R half_tr = R(0.5) * (v00 + v11);
  const R half_diff = R(0.5) * (v00 - v11);
  const R r = sqrt(half_diff * half_diff + v01 * v01);
  const bool use_first = fabs(r - half_diff) > fabs(r + half_diff);
  R a = use_first ? v01 : r + half_diff;
  R b = use_first ? r - half_diff : v01;
  const R nrm = sqrt(a * a + b * b);
  const bool ok = nrm > R(0);
  u1 = ok ? a / nrm : R(1);
  u2 = ok ? b / nrm : R(0);
  w_small = half_tr - r;
  w_big = half_tr + r;
}

// Cyclic Jacobi for M in {3, 4}: 6 sweeps drive the off-diagonal mass below
// roundoff for these tiny matrices.  Eigenvalues w (unordered), eigenvectors
// in the columns of U (row major).
template <typename R, int M>
__device__ __forceinline__ void jacobi(const R (&V)[M * M], R (&w)[M],
                                       R (&U)[M * M]) {
  R A[M * M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      A[i * M + j] = R(0.5) * (V[i * M + j] + V[j * M + i]);
      U[i * M + j] = i == j ? R(1) : R(0);
    }
#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
#pragma unroll
    for (int p = 0; p < M - 1; ++p)
#pragma unroll
      for (int q = p + 1; q < M; ++q) {
        const R apq = A[p * M + q];
        const bool rot = fabs(apq) > R(1e-30);
        const R apqs = rot ? apq : R(1);
        const R tau = (A[q * M + q] - A[p * M + p]) / (R(2) * apqs);
        const R sgn = tau >= R(0) ? R(1) : R(-1);
        R t = sgn / (fabs(tau) + sqrt(R(1) + tau * tau));
        t = rot ? t : R(0);
        const R c = R(1) / sqrt(R(1) + t * t);
        const R sn = t * c;
        const R app = A[p * M + p] - t * apq;
        const R aqq = A[q * M + q] + t * apq;
#pragma unroll
        for (int k = 0; k < M; ++k) {
          if (k == p || k == q) continue;
          const R akp = A[k * M + p];
          const R akq = A[k * M + q];
          A[k * M + p] = A[p * M + k] = c * akp - sn * akq;
          A[k * M + q] = A[q * M + k] = sn * akp + c * akq;
        }
        A[p * M + p] = app;
        A[q * M + q] = aqq;
        A[p * M + q] = A[q * M + p] = rot ? R(0) : apq;
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const R ukp = U[k * M + p];
          const R ukq = U[k * M + q];
          U[k * M + p] = c * ukp - sn * ukq;
          U[k * M + q] = sn * ukp + c * ukq;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) w[i] = A[i * M + i];
}

template <typename R>
__device__ __forceinline__ R tikhonov_inv(R w, R delta) {
  const R den = w * w + delta * delta;
  return den > R(0) ? w / den : R(0);
}

// Tikhonov-smoothed pseudo-inverse of a PSD matrix:
// lambda / (lambda^2 + delta^2), delta = 4 M eps lambda_max
template <typename R, int M>
__device__ __forceinline__ void psd_pinv(const R (&V)[M * M],
                                         R (&out)[M * M]) {
  const R eps = eps_of<R>();
  if constexpr (M == 1) {
    const R v = fmax(V[0], R(0));
    out[0] = tikhonov_inv(v, R(4) * eps * v);
  } else if constexpr (M == 2) {
    R w1, w2, u1, u2;
    eig2<R>(V[0], R(0.5) * (V[1] + V[2]), V[3], w1, w2, u1, u2);
    w1 = fmax(w1, R(0));
    w2 = fmax(w2, R(0));
    const R delta = R(8) * eps * w2;
    const R i1 = tikhonov_inv(w1, delta), i2 = tikhonov_inv(w2, delta);
    out[0] = i1 * u2 * u2 + i2 * u1 * u1;
    out[1] = out[2] = -i1 * u2 * u1 + i2 * u1 * u2;
    out[3] = i1 * u1 * u1 + i2 * u2 * u2;
  } else {
    R w[M], U[M * M];
    jacobi<R, M>(V, w, U);
    R wmax = R(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      w[i] = fmax(w[i], R(0));
      wmax = fmax(wmax, w[i]);
    }
    const R delta = R(4 * M) * eps * wmax;
    R iw[M];
#pragma unroll
    for (int i = 0; i < M; ++i) iw[i] = tikhonov_inv(w[i], delta);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        R acc = R(0);
#pragma unroll
        for (int k = 0; k < M; ++k) acc += U[i * M + k] * iw[k] * U[j * M + k];
        out[i * M + j] = acc;
      }
  }
}

// Clipped square-root factor: columns = eigenvectors * sqrt(max(w, 0)).
// For M = 2 the column order is (small, big), as ops/chol._psd_factor.
template <typename R, int M>
__device__ __forceinline__ void psd_factor(const R (&V)[M * M],
                                           R (&out)[M * M]) {
  if constexpr (M == 1) {
    out[0] = sqrt(fmax(V[0], R(0)));
  } else if constexpr (M == 2) {
    R w1, w2, u1, u2;
    eig2<R>(V[0], R(0.5) * (V[1] + V[2]), V[3], w1, w2, u1, u2);
    const R s1 = sqrt(fmax(w1, R(0)));
    const R s2 = sqrt(fmax(w2, R(0)));
    out[0] = -u2 * s1;
    out[1] = u1 * s2;
    out[2] = u1 * s1;
    out[3] = u2 * s2;
  } else {
    R w[M], U[M * M];
    jacobi<R, M>(V, w, U);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const R sq = sqrt(fmax(w[j], R(0)));
#pragma unroll
      for (int i = 0; i < M; ++i) out[i * M + j] = U[i * M + j] * sq;
    }
  }
}

}  // namespace bssm

// Dispatch on (is_double, m) to a templated launcher: LAUNCH(R, M) must be a
// statement.  Sets `known` to false for an unsupported m.
#define BSSM_DISPATCH(is_double, m, known, LAUNCH)                  \
  do {                                                              \
    known = true;                                                   \
    if (is_double) {                                                \
      switch (m) {                                                  \
        case 1: LAUNCH(double, 1); break;                           \
        case 2: LAUNCH(double, 2); break;                           \
        case 3: LAUNCH(double, 3); break;                           \
        case 4: LAUNCH(double, 4); break;                           \
        default: known = false;                                     \
      }                                                             \
    } else {                                                        \
      switch (m) {                                                  \
        case 1: LAUNCH(float, 1); break;                            \
        case 2: LAUNCH(float, 2); break;                            \
        case 3: LAUNCH(float, 3); break;                            \
        case 4: LAUNCH(float, 4); break;                            \
        default: known = false;                                     \
      }                                                             \
    }                                                               \
  } while (0)
