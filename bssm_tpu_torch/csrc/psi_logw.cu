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
// What bounds it on this card: bytes by count (a row reads (n+1) N m normals
// and n N uniforms once, about 18 KB at n = 153, N = 10, m = 2, float32, and
// does a few hundred operations a step), but in fact the latency of a step:
// a chain of shuffles (scan, search, ancestor fetch, two reductions), the
// special functions of the weight, and the loads of the step's inputs.  The
// design:
// * A row is a segment of w lanes, w the least power of two >= N, one
//   particle a lane, so a warp serves 32 / w rows (2 at N = 10, 4 at
//   N <= 8, 32 at N = 1): the ensemble stays in registers, the randomness is
//   read coalesced, max / sum / prefix sum are width-w shuffles.  Lanes
//   p >= N hold the identity of each reduction (0 in a sum, -inf in a max),
//   so the width-w butterfly adds the live lanes in the very order the
//   32-lane butterfly of a warp a row did (its levels above w add zeros):
//   every sum, and with it every resampling decision, is the same to the
//   bit.  Do not reorder it.
// * The ancestor of particle p is the first q with cum[q] >= u_p.  A lower
//   bound over the segment finds it in log2 w shuffles, where the first
//   design read all N cumulative weights.  A scan in floating point need
//   not be nondecreasing (a tree adds in another order at every lane), so
//   the bound searches the running maximum of cum, which is, and whose
//   first entry >= u_p is the first such entry of cum: the same ancestor,
//   ties and zero weights included.
// * Step s + 1's inputs (ahat_t, Lb_t, Ab_t, y_t, u_t, D_t, ytilde_t,
//   Htilde_t, scales_t, and the lane's normals and uniform) are loaded at
//   the top of step s into a second set of registers, so that their
//   latency overlaps step s's chain.  The TPU kernel streams the same data
//   in double-buffered chunks (pallas_kalman.py:1628-1660).
// * A row's missing observation is a mask of its segment; every shuffle
//   runs on all 32 lanes.
// The kernel reads ahat / Lb / Ab in their natural time order and indexes
// backwards itself: no flipped or padded copies are made.
#include <string.h>

#include "kalman_common.cuh"

namespace bssm {

// Launch arguments of bssm_psi_logw, packed by ops/cuda_kalman.py in this
// order (see kalman_common.cuh).  y, u, D and the leaves Z, phi are read
// where the spec holds them; ytilde, Htilde, scales (B, n); ahat (B, n+1,
// m); Lb, Ab (B, n+1, m, m); eps (B, n+1, N, m); us (B, n, N); logw (B,),
// all contiguous.  `threads` is a multiple of 32; a warp serves 32 / w
// rows, w = psi_segment(N).
struct PsiArgs {
  long long is_double, m, dist, N, B, n;
  SeriesArg y, u, D;
  LeafArg Z, phi;
  long long ytilde, Htilde, scales, ahat, Lb, Ab, eps, us, logw;
  long long threads, stream;
};

// lanes a row: the least power of two >= N
__host__ __device__ inline int psi_segment(int N) {
  int w = 1;
  while (w < N) w <<= 1;
  return w;
}

// Reductions and prefix sums over segments of w lanes (w a power of two,
// uniform over the warp); every lane of the warp takes part.
template <typename R> __device__ __forceinline__ R seg_max(R x, int w) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < w) x = fmax(x, __shfl_xor_sync(kFull, x, o, w));
  return x;
}

template <typename R> __device__ __forceinline__ R seg_sum(R x, int w) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < w) x += __shfl_xor_sync(kFull, x, o, w);
  return x;
}

template <typename R>
__device__ __forceinline__ R seg_inclusive_scan(R x, int sl, int w) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < w) {
      const R up = __shfl_up_sync(kFull, x, o, w);
      if (sl >= o) x += up;
    }
  }
  return x;
}

// The first q < N of the segment with cum[q] >= u (N - 1 if none): the
// lower bound of u over the running maximum of cum.
template <typename R>
__device__ __forceinline__ int seg_ancestor(R cum, R u, int sl, int w,
                                            int N) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < w) {
      const R up = __shfl_up_sync(kFull, cum, o, w);
      if (sl >= o) cum = fmax(cum, up);
    }
  }
  int q = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    if (half < w) {
      const R c = __shfl_sync(kFull, cum, q + half - 1, w);
      q += c < u ? half : 0;
    }
  }
  return min(q, N - 1);
}

// the inputs of one generation step of a lane
template <typename R, int M> struct PsiStepIn {
  R ah[M], L[M * M], A[M * M];
  R y, u, D, yt, Ht, sc;
  R e[M], r;
};

template <typename R, int M>
__global__ void psi_logw_kernel(const PsiArgs a) {
  constexpr int MM = M * M;
  const long B = a.B;
  const int N = (int)a.N, n = (int)a.n, dist = (int)a.dist;
  const int w = psi_segment(N);
  const int lane = threadIdx.x & 31;
  const int sl = lane & (w - 1);                // the lane's particle
  const long first = (((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5)
                     * (32 / w);                // the warp's first row
  if (first >= B) return;                       // warp-uniform
  const long b_raw = first + lane / w;
  const bool row_ok = b_raw < B;
  const long b = row_ok ? b_raw : B - 1;        // rows past B: a copy, unsaved
  const bool active = sl < N;
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

  // the inputs of step s = 1..n (state t = n - s)
  const auto load = [&](PsiStepIn<R, M>& x, int s) {
    const int t = n - s;
#pragma unroll
    for (int i = 0; i < M; ++i) x.ah[i] = ahat[(long)t * M + i];
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      x.L[i] = Lb[(long)t * MM + i];
      x.A[i] = Ab[(long)t * MM + i];
    }
    x.y = y[t * y_ts];
    x.u = u[t * u_ts];
    x.D = D[t * D_ts];
    x.yt = ytilde[t];
    x.Ht = Htilde[t];
    x.sc = scales[t];
#pragma unroll
    for (int j = 0; j < M; ++j)
      x.e[j] = active ? eps[((long)s * N + sl) * M + j] : R(0);
    x.r = active ? us[(long)(s - 1) * N + sl] : R(0);
  };

  // ---- step 0: alpha_n ~ N(ahat_n, Lb_n Lb_n'), no observation
  R alpha[M], ah_prev[M];
  {
    R e[M];
#pragma unroll
    for (int j = 0; j < M; ++j) e[j] = active ? eps[(long)sl * M + j] : R(0);
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

  PsiStepIn<R, M> cur, nxt;
  if (n >= 1) load(cur, 1);
  for (int s = 1; s <= n; ++s) {
    load(nxt, min(s + 1, n));                   // step s + 1, in flight
    // ---- stratified resampling
    R cum = seg_inclusive_scan<R>(active ? nw : R(0), sl, w);
    if (sl == N - 1) cum = R(1);
    const R u_p = (R(sl) + cur.r) * inv_n;
    const int anc = seg_ancestor<R>(cum, u_p, sl, w, N);
    // ---- propagate through the backward conditional proposal
    R dv[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const R anc_j = __shfl_sync(kFull, alpha[j], anc, w);
      dv[j] = anc_j - ah_prev[j];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      R acc = cur.ah[i];
#pragma unroll
      for (int j = 0; j < M; ++j)
        acc += cur.A[i * M + j] * dv[j] + cur.L[i * M + j] * cur.e[j];
      alpha[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) ah_prev[i] = cur.ah[i];
    // ---- weight; a missing y_t masks its segment
    const bool obs = isfinite(cur.y);
    R sig;
    if (dist == kSvm) {
      sig = alpha[0];
    } else {
      sig = cur.D;
#pragma unroll
      for (int i = 0; i < M; ++i) sig += Z[i] * alpha[i];
    }
    const R lw = log_weight<R>(dist, cur.y, cur.u, phi, sig, cur.yt,
                               cur.Ht) - cur.sc;
    const bool alive = active && obs && isfinite(lw);
    const R mx = seg_max<R>(alive ? lw : R(-INFINITY), w);
    const bool mx_ok = isfinite(mx);
    const R mxs = mx_ok ? mx : R(0);
    const R wt = alive ? exp(lw - mxs) : R(0);
    const R sw = seg_sum<R>(wt, w);
    const bool ok2 = (sw > R(0)) && mx_ok;
    const R sws = fmax(sw, tiny);
    if (obs) ll += ok2 ? mxs + log(sws * inv_n) : R(-INFINITY);
    nw = (obs && ok2) ? wt / sws : inv_n;
    cur = nxt;
  }
  if (row_ok && sl == 0) reinterpret_cast<R*>(a.logw)[b] = ll;
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
  if (a.N < 1 || a.N > 32 || a.threads % 32 != 0 || a.threads < 32 ||
      a.threads > 1024)
    return -2;
  const long rows_per_block =
      a.threads / 32 * (32 / bssm::psi_segment((int)a.N));
  const unsigned blocks =
      (unsigned)((a.B + rows_per_block - 1) / rows_per_block);
  bool known;
#define LAUNCH(R, M)                                                 \
  bssm::psi_logw_kernel<R, M>                                        \
      <<<blocks, (unsigned)a.threads, 0, (cudaStream_t)a.stream>>>(a)
  BSSM_DISPATCH(a.is_double, a.m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}
