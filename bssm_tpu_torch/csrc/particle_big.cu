// particle_big: the log-likelihood estimate of an N-particle filter, one
// scalar per batch row, for 2 <= N <= 512 particles, in two modes that share
// every line but their loads:
//
//   psi mode  the psi-auxiliary particle filter log-weight of a stored draw.
//             Generation runs BACKWARDS in time through the FFBS factors
//             (ahat, Lb, Ab): step 0 draws alpha_n = ahat_n + Lb_n eps_0 with
//             no observation; step s = 1..n generates state t = n - s as
//             ahat_t + Ab_t (anc - ahat_{t+1}) + Lb_t eps_s and weights it by
//             log g(y_t|s) - log g~(ytilde_t|s) - scales_t.
//   bsf mode  the bootstrap filter log-likelihood (less the observation
//             constants).  Generation runs FORWARDS: step 0 draws
//             alpha_0 = a1 + chol(P1) eps_0 and weights it against y_0; step
//             s = 1..n-1 generates C + T anc + R eps_s and weights it by the
//             plain observation density log g(y_s|s).
//
// Replaces the TPU kernel `_psi_big_kernel` (bssm_tpu/ops/pallas_kalman.py:
// 2067), which the JAX package reaches through two calls: :2303 (psi mode)
// and :2484 (bsf mode).  Plain versions: inference/particle.psi_logw_scan
// (with resample_every) and inference/particle.bsf_logw_scan.
//
// Steps come in segments of `kk`.  At the first step of a segment the
// ensemble is stratified-resampled (cum = inclusive prefix sum of exp(lnw)
// with the last entry forced to 1, u_p = (p + r_p) / N, ancestor = first q
// with cum_q >= u_p) and the log-weights restart from -log N; on the other
// steps the particles propagate themselves and carry their log-weights.
// Weighting: lt = lnw + lw (lw = 0 where y is missing, -inf where not
// finite); inc = log-sum-exp(lt); the row's result gains inc where y is
// observed; lnw = lt - inc, or -log N for a dead ensemble.
//
// Randomness, two modes: stream (normals eps (B, S+1, N, M) and uniforms us
// (B, S, N) are read from memory; the uniforms of step s sit in us[s-1]) and
// Philox (generated in the kernel from (key, row, step, particle), see
// kalman_common.cuh).  `philox_fill_kernel` writes into eps/us exactly the
// values the Philox mode consumes, so the two modes can be held against each
// other.
//
// What bounds it on this card: operations.  In Philox mode a row reads its
// observation and factor rows once (about 10 KB at n = 153, m = 2) and does
// some hundreds of operations for each of its (S+1) N particle-steps, the
// generator included.  The design: one block per row, one particle per
// thread (block = N rounded up to a warp; lanes >= N are masked out of every
// reduction), the ensemble in registers between steps.  Block max and sum
// are warp shuffles plus one shared-memory stage; the prefix sum is a warp
// shuffle scan plus warp totals; cum and the ensemble go to shared memory
// only at a resampling step, where each thread binary-searches cum for its
// u_p and gathers its ancestor's state.  The step's scalars (factor row,
// observation row) are loaded by the block's threads, one or two entries
// each, and broadcast through shared memory.  The kernel indexes ahat/Lb/Ab backwards itself: no flipped,
// stacked or padded copies are made.  The observation family is a run-time
// switch (uniform over the block) rather than a template parameter, which
// keeps the number of instantiations at 16.
#include <string.h>

#include "kalman_common.cuh"

namespace bssm {

constexpr int kMaxNBig = 512;
constexpr int kMaxWarps = kMaxNBig / 32;

template <typename R> struct BigArgs {
  int dist, N, S, kk, philox;
  long B;
  // psi mode, (B, n) dense with n = S
  const R* ytilde;
  const R* Htilde;
  const R* scales;
  const R* ahat;  // (B, S+1, M)
  const R* Lb;    // (B, S+1, M, M)
  const R* Ab;    // (B, S+1, M, M)
  // bsf mode: (B, 2M + 3MM) = [a1, chol P1, C, R, T], n = S + 1
  const R* sysb;
  // both modes: the series and the leaves where the spec holds them
  SeriesArg y, u, D;
  LeafArg Z, phi;
  const R* eps;   // stream mode
  const R* us;
  const long long* key;  // Philox mode: two words, low 32 bits of each
  R* out;         // (B,)
};

template <typename R>
__device__ __forceinline__ R block_max(R x, R* stage, int lane, int warp,
                                       int nwarps) {
  x = warp_max<R>(x);
  if (lane == 0) stage[warp] = x;
  __syncthreads();
  return warp_max<R>(lane < nwarps ? stage[lane] : R(-INFINITY));
}

template <typename R>
__device__ __forceinline__ R block_sum(R x, R* stage, int lane, int warp,
                                       int nwarps) {
  x = warp_sum<R>(x);
  if (lane == 0) stage[warp] = x;
  __syncthreads();
  return warp_sum<R>(lane < nwarps ? stage[lane] : R(0));
}

template <typename R, int M, bool BSF>
__global__ void __launch_bounds__(kMaxNBig)
particle_big_kernel(const BigArgs<R> a) {
  constexpr int MM = M * M;
  constexpr int F = M + 2 * MM;     // [ah (M), L (MM), A (MM)]
  constexpr int ROW = F + 6;        // + [ytilde, Htilde, y, u, scales, D]
  const long b = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int nwarps = blockDim.x >> 5;
  const int N = a.N, S = a.S;
  const bool active = p < N;
  const R neg_log_n = -log(R(N));
  const R tiny = R(1e-35);

  __shared__ R s_row[2][ROW];
  __shared__ R s_cum[kMaxNBig];
  __shared__ R s_alpha[M][kMaxNBig];
  __shared__ R s_max[kMaxWarps], s_sum[kMaxWarps], s_scan[kMaxWarps];

  const R* y = series_row<R>(a.y, b);
  const R* u = series_row<R>(a.u, b);
  const R* D = series_row<R>(a.D, b);
  R Z[M];
  const R* Zb = leaf_row<R>(a.Z, b);
#pragma unroll
  for (int i = 0; i < M; ++i) Z[i] = Zb[i];
  const R phi = leaf_row<R>(a.phi, b)[0];
  unsigned k0 = 0, k1 = 0;
  if (a.philox) {
    k0 = (unsigned)a.key[0];
    k1 = (unsigned)a.key[1];
  }
  const R* eps = a.philox ? nullptr : a.eps + b * (long)(S + 1) * N * M;
  const R* us = a.philox ? nullptr : a.us + b * (long)S * N;

  // The threads fetch the ROW scalars of step s into s_row[s & 1]: thread p
  // entry p and, where the block is narrower than the row (32 threads, 42
  // scalars at m = 4), entry p + blockDim.x too.  A buffer is rewritten two
  // steps later, after the __syncthreads at the top of the step in between.
  auto load_entry = [&](int s, int i) -> R {
    R v;
    if (i < F) {
      if constexpr (BSF) {
        const R* sys = a.sysb + b * (long)(2 * M + 3 * MM);
        if (s == 0)
          v = i < M + MM ? sys[i] : R(0);          // [a1, chol P1, 0]
        else
          v = sys[M + MM + i];                     // [C, R, T]
      } else {
        const long t = S - s;                      // state index of step s
        const long base = b * (long)(S + 1) + t;
        if (i < M)
          v = a.ahat[base * M + i];
        else if (i < M + MM)
          v = a.Lb[base * MM + (i - M)];
        else
          v = a.Ab[base * MM + (i - M - MM)];
      }
    } else {
      const int k = i - F;
      if constexpr (BSF) {
        const long t = s;
        v = k == 0 ? R(NAN)
            : k == 1 ? R(1)
            : k == 2 ? y[t * a.y.ts]
            : k == 3 ? u[t * a.u.ts]
            : k == 4 ? R(0)
                     : D[t * a.D.ts];
      } else {
        if (s == 0) {                              // no observation
          v = (k == 0 || k == 2) ? R(NAN) : (k == 1 || k == 3) ? R(1) : R(0);
        } else {
          const long t = S - s;
          const long bt = b * (long)S + t;
          v = k == 0 ? a.ytilde[bt]
              : k == 1 ? a.Htilde[bt]
              : k == 2 ? y[t * a.y.ts]
              : k == 3 ? u[t * a.u.ts]
              : k == 4 ? a.scales[bt]
                       : D[t * a.D.ts];
        }
      }
    }
    return v;
  };
  auto load_row = [&](int s) {
    if (p < ROW) s_row[s & 1][p] = load_entry(s, p);
    if constexpr (ROW > 32) {       // the narrowest block has 32 threads
      const int i = p + blockDim.x;
      if (i < ROW) s_row[s & 1][i] = load_entry(s, i);
    }
  };

  // Randomness of step s.  In Philox mode the generator runs once at the
  // top of the step (integer work only); its words wait in registers for
  // the resampling uniform and, after the resampling, for the normals.
  unsigned w[4] = {0u, 0u, 0u, 0u};
  auto words = [&](int s) {
    if (a.philox)
      philox_words(k0, k1, (unsigned)b, (unsigned)s, (unsigned)p, w);
  };
  auto uniform = [&](int s) -> R {
    if (a.philox)
      return philox_uniform<R, M>(w, k0, k1, (unsigned)b, (unsigned)s,
                                  (unsigned)p);
    return active ? us[(long)(s - 1) * N + p] : R(0);
  };
  auto normals = [&](int s, R (&e)[M]) {
    if (a.philox) {
      philox_normals<R, M>(w, e);
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j)
        e[j] = active ? eps[((long)s * N + p) * M + j] : R(0);
    }
  };

  R alpha[M], ah_prev[M];
  R lnw = neg_log_n;
  R ll = R(0);

  // alpha' = ah + A (anc - ah_prev) + L e from the row in shared memory
  auto propagate = [&](const R* row, const R (&anc)[M], const R (&e)[M]) {
    R dv[M];
#pragma unroll
    for (int j = 0; j < M; ++j) dv[j] = anc[j] - ah_prev[j];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      R acc = row[i];
#pragma unroll
      for (int j = 0; j < M; ++j)
        acc += row[M + MM + i * M + j] * dv[j] + row[M + i * M + j] * e[j];
      alpha[i] = acc;
    }
    if constexpr (!BSF) {
#pragma unroll
      for (int i = 0; i < M; ++i) ah_prev[i] = row[i];
    }
  };

  auto weight = [&](const R* row) {
    const R* ob = row + F;
    const R y_t = ob[2];
    const bool oky = isfinite(y_t);
    R lw = R(0);
    if (oky) {
      R sig;
      if (a.dist == kSvm) {
        sig = alpha[0];
      } else {
        sig = ob[5];
#pragma unroll
        for (int i = 0; i < M; ++i) sig += Z[i] * alpha[i];
      }
      lw = log_weight<R>(a.dist, y_t, ob[3], phi, sig, ob[0], ob[1]) - ob[4];
    }
    R lt = lnw + lw;
    const bool fin = active && isfinite(lt);
    lt = fin ? lt : R(-INFINITY);
    const R mx = block_max<R>(lt, s_max, lane, warp, nwarps);
    const bool mx_ok = isfinite(mx);
    const R mxs = mx_ok ? mx : R(0);
    const R w = fin ? exp(lt - mxs) : R(0);
    const R sw = block_sum<R>(w, s_sum, lane, warp, nwarps);
    const bool ok2 = (sw > R(0)) && mx_ok;
    const R inc = ok2 ? mxs + log(fmax(sw, tiny)) : R(-INFINITY);
    if (oky) ll += inc;
    lnw = ok2 ? lt - inc : neg_log_n;
  };

  // ---- step 0: the initial ensemble
  load_row(0);
  __syncthreads();
  {
    R e[M];
    words(0);
    normals(0, e);
    const R* row = s_row[0];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      R acc = row[i];
#pragma unroll
      for (int j = 0; j < M; ++j) acc += row[M + i * M + j] * e[j];
      alpha[i] = acc;
      ah_prev[i] = BSF ? R(0) : row[i];
    }
    if constexpr (BSF) {
      weight(row);
    }
  }

  for (int s = 1; s <= S; ++s) {
    load_row(s);
    words(s);
    R anc[M];
    if ((s - 1) % a.kk == 0) {
      // ---- stratified resampling
      const R r = uniform(s);
      const R nw = (active && isfinite(lnw)) ? exp(lnw) : R(0);
      R c = warp_inclusive_scan<R>(nw, lane);
      if (lane == 31) s_scan[warp] = c;
#pragma unroll
      for (int j = 0; j < M; ++j) s_alpha[j][p] = alpha[j];
      __syncthreads();              // also publishes s_row[s & 1]
      R off = R(0);
      for (int wq = 0; wq < warp; ++wq) off += s_scan[wq];
      c += off;
      s_cum[p] = (p >= N - 1) ? R(1) : c;
      __syncthreads();
      const R u_p = (R(p) + r) / R(N);
      int lo = 0, hi = N - 1;       // first q in [0, N-1] with cum[q] >= u_p
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_cum[mid] >= u_p) hi = mid; else lo = mid + 1;
      }
      const int q = active ? lo : 0;
#pragma unroll
      for (int j = 0; j < M; ++j) anc[j] = s_alpha[j][q];
      lnw = neg_log_n;
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j) anc[j] = alpha[j];
      __syncthreads();              // publishes s_row[s & 1]
    }
    R e[M];
    normals(s, e);
    propagate(s_row[s & 1], anc, e);
    weight(s_row[s & 1]);
  }
  if (p == 0) a.out[b] = ll;
}

// eps (B, S+1, N, M) and us (B, S, N) as the Philox mode consumes them
template <typename R, int M>
__global__ void philox_fill_kernel(long B, int S, int N,
                                   const long long* __restrict__ key,
                                   R* __restrict__ eps, R* __restrict__ us) {
  const long total = B * (long)(S + 1) * N;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned k0 = (unsigned)key[0], k1 = (unsigned)key[1];
  const int p = (int)(i % N);
  const long bs = i / N;
  const int s = (int)(bs % (S + 1));
  const long b = bs / (S + 1);
  unsigned w[4];
  philox_words(k0, k1, (unsigned)b, (unsigned)s, (unsigned)p, w);
  R e[M];
  philox_normals<R, M>(w, e);
#pragma unroll
  for (int j = 0; j < M; ++j) eps[i * M + j] = e[j];
  if (s >= 1)
    us[(b * (long)S + (s - 1)) * N + p] = philox_uniform<R, M>(
        w, k0, k1, (unsigned)b, (unsigned)s, (unsigned)p);
}

}  // namespace bssm

// Launch arguments of bssm_particle_big, packed by ops/cuda_kalman.py in
// this order (see kalman_common.cuh).  S = generation steps after the
// initial draw (psi: n, bsf: n - 1).  psi mode (bsf = 0): ytilde, Htilde,
// scales (B, S); ahat (B, S+1, m); Lb, Ab (B, S+1, m, m); sysb unused.  bsf
// mode: sysb (B, 2m + 3m^2) = [a1, chol P1, C, R, T]; the psi tensors
// unused.  y, u, D and the leaves Z, phi where the spec holds them.  Stream
// mode (philox = 0): eps (B, S+1, N, m), us (B, S, N).  Philox mode: key
// points to two 64-bit words on the device.  out (B,).  The dense tensors
// are contiguous.
struct BigLaunch {
  long long is_double, m, dist, bsf, philox, N, B, S, kk;
  long long ytilde, Htilde, scales, ahat, Lb, Ab, sysb;
  bssm::SeriesArg y, u, D;
  bssm::LeafArg Z, phi;
  long long eps, us, key, out, stream;
};

// Plain C entry point of both modes.  `args` points to the packed BigLaunch
// and `size` is its length in bytes.  Returns the launch's cudaError_t, -1
// for an unsupported m, -2 for a struct of another size or arguments
// outside the kernel's contract.
extern "C" int bssm_particle_big(const void* args, long long size) {
  if (size != (long long)sizeof(BigLaunch)) return -2;
  BigLaunch g;
  memcpy(&g, args, sizeof g);
  const int N = (int)g.N;
  if (N < 2 || N > bssm::kMaxNBig || g.kk < 1 || g.S < 0 || g.B < 1)
    return -2;
  const int threads = ((N + 31) / 32) * 32;
  const cudaStream_t stream = (cudaStream_t)g.stream;
  bool known;
#define LAUNCH(R, M)                                                        \
  do {                                                                      \
    const auto in = [](long long p) { return (const R*)p; };                \
    bssm::BigArgs<R> a;                                                     \
    a.dist = (int)g.dist; a.N = N; a.S = (int)g.S; a.kk = (int)g.kk;        \
    a.philox = (int)g.philox; a.B = g.B;                                    \
    a.ytilde = in(g.ytilde); a.Htilde = in(g.Htilde);                       \
    a.scales = in(g.scales); a.ahat = in(g.ahat); a.Lb = in(g.Lb);          \
    a.Ab = in(g.Ab); a.sysb = in(g.sysb);                                   \
    a.y = g.y; a.u = g.u; a.D = g.D; a.Z = g.Z; a.phi = g.phi;              \
    a.eps = in(g.eps); a.us = in(g.us);                                     \
    a.key = (const long long*)g.key; a.out = (R*)g.out;                     \
    if (g.bsf)                                                              \
      bssm::particle_big_kernel<R, M, true>                                 \
          <<<(unsigned)g.B, threads, 0, stream>>>(a);                       \
    else                                                                    \
      bssm::particle_big_kernel<R, M, false>                                \
          <<<(unsigned)g.B, threads, 0, stream>>>(a);                       \
  } while (0)
  BSSM_DISPATCH(g.is_double, g.m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}

// eps (B, S+1, N, m) and us (B, S, N) filled with the values the Philox mode
// of bssm_particle_big consumes for the same key.
extern "C" int bssm_philox_fill(int is_double, int m, long B, int S, int N,
                                const void* key, void* eps, void* us,
                                void* stream) {
  if (N < 1 || S < 0 || B < 1) return -2;
  const long total = B * (long)(S + 1) * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  bool known;
#define LAUNCH(R, M)                                                      \
  bssm::philox_fill_kernel<R, M><<<blocks, threads, 0,                    \
                                    (cudaStream_t)stream>>>(              \
      B, S, N, (const long long*)key, (R*)eps, (R*)us)
  BSSM_DISPATCH(is_double, m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}
