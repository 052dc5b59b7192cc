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
//   counter = (particle, step, row, which),  key = (key0, key1).
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
