// psi_logw: the complete psi-auxiliary-particle-filter log-weight of one
// stored draw, for N <= 32 particles, from injected normals and uniforms.
//
// Replaces the TPU kernel `_psi_kernel` (bssm_tpu/ops/pallas_kalman.py:1599,
// called at :1843).  Plain version: inference/particle.psi_logw_scan.
//
// Generation runs backwards in time through the FFBS factors (ahat, Lb, Ab):
//   step 0:        alpha_n = ahat_n + Lb_n eps_0            (no weighting)
//   step s = 1..n: state t = n - s; stratified resampling of the ensemble
//                  with us[s-1] (cum[N-1] := 1, u_p = (p + r_p)/N, ancestor =
//                  first q with cum[q] >= u_p); propagate
//                  alpha_t = ahat_t + Ab_t (anc - ahat_{t+1}) + Lb_t eps_s;
//                  log-weight log g(y_t|s) - log g~(ytilde_t|s) - scales_t;
//                  log-sum-exp accumulation.  A missing y_t contributes 0 and
//                  resets the weights to 1/N; non-finite log-weights count as
//                  zero weight; an all-dead ensemble gives -inf.
//
// What bounds it on this card: bytes.  A row reads (n+1) N m normals and n N
// uniforms once (about 18 KB at n = 153, N = 10, m = 2, float32) and does a
// few hundred operations a step, far below the card's operations-per-byte
// balance.  The design is one warp per row, one particle per lane (lanes >= N
// idle and are masked out of every reduction): the ensemble never leaves
// registers, the randomness is read coalesced across lanes, the per-step
// scalars are warp-uniform loads, max / sum / prefix sum are warp shuffles,
// each lane searches the shuffled cumulative weights for its ancestor and
// fetches the ancestor's state with one shuffle per state component.  One
// thread per row with the ensemble in registers was the alternative; it
// would need N m live registers per thread and N^2 compares a step in one
// thread, and would read the randomness uncoalesced.  The kernel reads ahat /
// Lb / Ab in their natural time order and indexes backwards itself: no
// flipped or padded copies are made.
#include <string.h>

#include "kalman_common.cuh"

namespace bssm {

// Launch arguments of bssm_psi_logw, packed by ops/cuda_kalman.py in this
// order (see kalman_common.cuh).  y, u, D and the leaves Z, phi are read
// where the spec holds them; ytilde, Htilde, scales (B, n); ahat (B, n+1,
// m); Lb, Ab (B, n+1, m, m); eps (B, n+1, N, m); us (B, n, N); logw (B,),
// all contiguous.  `threads` is a multiple of 32; one warp serves one row.
struct PsiArgs {
  long long is_double, m, dist, N, B, n;
  SeriesArg y, u, D;
  LeafArg Z, phi;
  long long ytilde, Htilde, scales, ahat, Lb, Ab, eps, us, logw;
  long long threads, stream;
};

template <typename R, int M>
__global__ void psi_logw_kernel(const PsiArgs a) {
  const long B = a.B;
  const int N = (int)a.N, n = (int)a.n, dist = (int)a.dist;
  const long b = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // warp-uniform
  constexpr int MM = M * M;
  const bool active = lane < N;
  const R inv_n = R(1) / R(N);
  const R tiny = R(1e-35);

  R Z[M];
  const R* Zb = leaf_row<R>(a.Z, b);
#pragma unroll
  for (int i = 0; i < M; ++i) Z[i] = Zb[i];
  const R phi = leaf_row<R>(a.phi, b)[0];
  const auto in = [](long long p) { return reinterpret_cast<const R*>(p); };
  const R* __restrict__ ytilde = in(a.ytilde) + b * (long)n;
  const R* __restrict__ Htilde = in(a.Htilde) + b * (long)n;
  const R* __restrict__ scales = in(a.scales) + b * (long)n;
  const R* __restrict__ y = series_row<R>(a.y, b);
  const R* __restrict__ u = series_row<R>(a.u, b);
  const R* __restrict__ D = series_row<R>(a.D, b);
  const long y_ts = a.y.ts, u_ts = a.u.ts, D_ts = a.D.ts;
  const R* __restrict__ ahat = in(a.ahat) + b * (long)(n + 1) * M;
  const R* __restrict__ Lb = in(a.Lb) + b * (long)(n + 1) * MM;
  const R* __restrict__ Ab = in(a.Ab) + b * (long)(n + 1) * MM;
  const R* __restrict__ eps = in(a.eps) + b * (long)(n + 1) * N * M;
  const R* __restrict__ us = in(a.us) + b * (long)n * N;

  // ---- step 0: alpha_n ~ N(ahat_n, Lb_n Lb_n'), no observation
  R alpha[M], ah_prev[M];
  {
    R e[M];
#pragma unroll
    for (int j = 0; j < M; ++j) e[j] = active ? eps[(long)lane * M + j] : R(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ah_prev[i] = ahat[(long)n * M + i];
      R acc = ah_prev[i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc += Lb[(long)n * MM + i * M + j] * e[j];
      alpha[i] = acc;
    }
  }
  R nw = inv_n;
  R ll = R(0);

  for (int s = 1; s <= n; ++s) {
    const int t = n - s;
    // ---- stratified resampling
    R cum = warp_inclusive_scan<R>(active ? nw : R(0), lane);
    if (lane == N - 1) cum = R(1);
    const R r = active ? us[(long)(s - 1) * N + lane] : R(0);
    const R u_p = (R(lane) + r) * inv_n;
    int anc = N - 1;
    bool found = false;
    for (int q = 0; q < N; ++q) {
      const R c = __shfl_sync(kFull, cum, q);
      if (!found && c >= u_p) {
        anc = q;
        found = true;
      }
    }
    // ---- propagate through the backward conditional proposal
    R e[M], ah_t[M], dv[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const R anc_j = __shfl_sync(kFull, alpha[j], anc);
      dv[j] = anc_j - ah_prev[j];
      e[j] = active ? eps[((long)s * N + lane) * M + j] : R(0);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ah_t[i] = ahat[(long)t * M + i];
      R acc = ah_t[i];
#pragma unroll
      for (int j = 0; j < M; ++j)
        acc += Ab[(long)t * MM + i * M + j] * dv[j]
               + Lb[(long)t * MM + i * M + j] * e[j];
      alpha[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) ah_prev[i] = ah_t[i];
    // ---- weight
    const R y_t = y[t * y_ts];
    if (isfinite(y_t)) {  // warp-uniform
      R sig;
      if (dist == kSvm) {
        sig = alpha[0];
      } else {
        sig = D[t * D_ts];
#pragma unroll
        for (int i = 0; i < M; ++i) sig += Z[i] * alpha[i];
      }
      const R lw = log_weight<R>(dist, y_t, u[t * u_ts], phi, sig, ytilde[t],
                                 Htilde[t]) - scales[t];
      const bool alive = active && isfinite(lw);
      const R mx = warp_max<R>(alive ? lw : R(-INFINITY));
      const bool mx_ok = isfinite(mx);
      const R mxs = mx_ok ? mx : R(0);
      const R w = alive ? exp(lw - mxs) : R(0);
      const R sw = warp_sum<R>(w);
      const bool ok2 = (sw > R(0)) && mx_ok;
      const R sws = fmax(sw, tiny);
      ll += ok2 ? mxs + log(sws * inv_n) : R(-INFINITY);
      nw = ok2 ? w / sws : inv_n;
    } else {
      nw = inv_n;
    }
  }
  if (lane == 0) reinterpret_cast<R*>(a.logw)[b] = ll;
}

}  // namespace bssm

// Plain C entry point.  `args` points to the packed PsiArgs and `size` is
// its length in bytes.  Returns the launch's cudaError_t, -1 for an
// unsupported m, -2 for a struct of another size, N outside 1..32 or a
// block that is not whole warps.
extern "C" int bssm_psi_logw(const void* args, long long size) {
  if (size != (long long)sizeof(bssm::PsiArgs)) return -2;
  bssm::PsiArgs a;
  memcpy(&a, args, sizeof a);
  if (a.N < 1 || a.N > 32 || a.threads % 32 != 0) return -2;
  const long warps_per_block = a.threads / 32;
  const unsigned blocks =
      (unsigned)((a.B + warps_per_block - 1) / warps_per_block);
  bool known;
#define LAUNCH(R, M)                                                 \
  bssm::psi_logw_kernel<R, M>                                        \
      <<<blocks, (unsigned)a.threads, 0, (cudaStream_t)a.stream>>>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}
