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
// What bounds it on this card: latency of one dependent chain per row, as in
// laplace_solve.cu, plus the write of the factors: (n+1)(m + 2 m^2) values a
// row in the (B, n+1, ...) layout the callers read, which a thread-per-row
// kernel cannot write coalesced.  The design is the simple one: one thread
// per row, blocks of one warp, filtered moments (att, Ptt: m + m^2 values a
// step) staged time-major in a scratch tensor (coalesced), predicted moments
// recomputed in the backward pass by the very function the forward pass used
// (so they agree to the bit), outputs written in place as they are produced.
#include <string.h>

#include "kalman_common.cuh"

namespace bssm {

// Launch arguments of bssm_rts_factors, packed by ops/cuda_kalman.py in this
// order (see kalman_common.cuh).  H holds standard deviations.  Outputs ahat
// (B, n+1, m), Lb and Ab (B, n+1, m, m), contiguous; scratch (n, m + m^2, B).
struct RtsArgs {
  long long is_double, m, B, n;
  SeriesArg y, H, D;
  SystemArg sys;
  long long ahat, Lb, Ab, scratch, threads, stream;
};

template <typename R, int M>
__global__ void rts_factors_kernel(const RtsArgs g) {
  const long B = g.B;
  const int n = (int)g.n;
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int MM = M * M;
  constexpr int ROWS = M + MM;  // att (M), Ptt (MM)
  R* const __restrict__ scratch = reinterpret_cast<R*>(g.scratch);
#define SC(t, r) scratch[((long)(t) * ROWS + (r)) * B + b]

  Sys<R, M> s;
  load_sys_leaves<R, M>(s, g.sys, b);
  const R* __restrict__ y = series_row<R>(g.y, b);
  const R* __restrict__ H = series_row<R>(g.H, b);
  const R* __restrict__ D = series_row<R>(g.D, b);
  const long y_ts = g.y.ts, H_ts = g.H.ts, D_ts = g.D.ts;
  const long row = b * (long)(n + 1);  // row b's first step in the outputs
  R* const __restrict__ ahat = reinterpret_cast<R*>(g.ahat) + row * M;
  R* const __restrict__ Lb = reinterpret_cast<R*>(g.Lb) + row * MM;
  R* const __restrict__ Ab = reinterpret_cast<R*>(g.Ab) + row * MM;

  // ---- forward filter, staging the filtered moments
  R a[M], P[MM];
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = s.a1[i];
#pragma unroll
  for (int i = 0; i < MM; ++i) P[i] = s.P1[i];
  for (int t = 0; t < n; ++t) {
    const R h = H[t * H_ts];
    R v, Fs, okf, inc, att[M], Ptt[MM];
    kf_step<R, M>(s, a, P, y[t * y_ts], h * h, D[t * D_ts], v, Fs, okf,
                  inc, att, Ptt);
#pragma unroll
    for (int i = 0; i < M; ++i) SC(t, i) = att[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) SC(t, M + i) = Ptt[i];
  }

  // ---- t = n: alpha_n ~ N(a_n, P_n), no observation
  R ah_next[M];
  {
    R Ln[MM];
    psd_factor<R, M>(P, Ln);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ah_next[i] = a[i];
      ahat[(long)n * M + i] = a[i];
    }
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      Lb[(long)n * MM + i] = Ln[i];
      Ab[(long)n * MM + i] = R(0);
    }
  }

  // ---- backward sweep
  for (int t = n - 1; t >= 0; --t) {
    R att[M], Ptt[MM], a_next[M], P_next[MM];
#pragma unroll
    for (int i = 0; i < M; ++i) att[i] = SC(t, i);
#pragma unroll
    for (int i = 0; i < MM; ++i) Ptt[i] = SC(t, M + i);
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
    // ahat_t = att + J (ahat_{t+1} - a_{t+1|t})
    R ah[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      R acc = att[i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc += J[i * M + j] * (ah_next[j] - a_next[j]);
      ah[i] = acc;
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
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ahat[(long)t * M + i] = ah[i];
      ah_next[i] = ah[i];
    }
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      Lb[(long)t * MM + i] = L[i];
      Ab[(long)t * MM + i] = J[i];
    }
  }
#undef SC
}

}  // namespace bssm

// Plain C entry point.  `args` points to the packed RtsArgs and `size` is
// its length in bytes.  Returns the launch's cudaError_t, -1 for an
// unsupported m, -2 when `size` is not the struct's.
extern "C" int bssm_rts_factors(const void* args, long long size) {
  if (size != (long long)sizeof(bssm::RtsArgs)) return -2;
  bssm::RtsArgs a;
  memcpy(&a, args, sizeof a);
  const unsigned blocks = (unsigned)((a.B + a.threads - 1) / a.threads);
  bool known;
#define LAUNCH(R, M)                                                  \
  bssm::rts_factors_kernel<R, M>                                      \
      <<<blocks, (unsigned)a.threads, 0, (cudaStream_t)a.stream>>>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}
