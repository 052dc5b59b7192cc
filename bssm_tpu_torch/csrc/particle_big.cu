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
// other.  A check-only input `anc` (B, S, N) int32, stream mode only, gives
// the ancestor of every particle at every resampling step in place of the
// search, so that the kernel and its plain version can be fed the same
// ancestors and held together on every row in float32.
//
// What bounds it on this card: operations.  A row reads its observation and
// factor rows once (about 10 KB at n = 153, m = 2 in psi mode, 1.8 KB of
// series in bsf mode) and does some hundreds of operations for each of its
// (S+1) N particle-steps, the generator included.  The design (template and
// launchers in particle_big.cuh, instantiated per mode and real type in
// particle_big_{psi,bsf}_{f32,f64}.cu, which nvcc builds side by side):
//
// - A row takes `T` = 32 w threads (w = 1 up to N = 256, else 2 warps);
//   thread r holds the consecutive particles [r N / T, (r+1) N / T) in P
//   register slots between steps (P the fewest instantiated that hold them:
//   2, 7 or 8 for float32 at m <= 2, else 2 or 8).  With w = 1 a row is one
//   warp, several rows share a block, and nothing waits on a block barrier:
//   a row synchronises with __syncwarp.  Particle p keeps its Philox
//   counter (key, row, step, p) whichever thread holds it.  Threads a row
//   follow N alone: on an H100 two warps a row were 38-64% slower than one
//   at the paths' shapes, and at N = 200 seven slots 6% faster than eight
//   (chip_smoke.py --geometry-sweep, PERF.md).
// - Every loop over a thread's slots is one straight line, with no branch
//   on the slot: a slot past the thread's count works on a clamped index
//   and is masked out of the weights and the stores, and the family switch
//   sits outside the slot loop.  So the slots' independent chains
//   (generator, Box-Muller, propagation, log-weight, loads) overlap, and a
//   warp hides its own latencies where few warps share an SM.
// - The row's input is copied into shared memory with cp.async before the
//   steps that read it, in chunks of kChunk steps, double-buffered: chunk
//   c + 1 is in flight while chunk c is read, so no step waits on device
//   memory.  bsf mode keeps its system (C, T, R) in registers, read where
//   the spec holds it (R by its own column count).
// - One reduction a step: each warp forms its (max, sum of exp(lt - max))
//   pair with two shuffle butterflies over its threads' own particles (max
//   first, then the sum of each particle's exp against the warp's max), and
//   with w > 1 one shared stage (double-buffered by step parity) and one
//   barrier give every thread the warps' pairs, combined with online
//   rescaling into the row's pair, hence inc and lnw.  The cumulative weights of the next resampling come from
//   the same partials: a thread's own prefix, a warp shuffle scan of thread
//   totals, and the earlier warps' totals from the staged pairs; no serial
//   warp loop.  Block barriers a step: the reduction's (w > 1 only) and, at
//   a resampling step or a chunk boundary, one at the top of the step that
//   publishes the cumulative weights, the ensemble and the chunk: at most
//   two.
// - The search is monotone: u_p rises with p, so a thread bisects for its
//   first and last particles (two chains side by side) and then for the
//   others only between those two answers, all slots in one loop whose
//   count depends on the range alone.
// - The next step's Philox words are computed before the step's reduction,
//   so that integer work fills the reduction's latency.
#include <string.h>

#include "particle_big.cuh"

namespace bssm {

// eps (B, S+1, N, M) and us (B, S, N) as the Philox mode consumes them
template <typename R, int M>
__global__ void philox_fill_kernel(long B, int S, int N, long row0,
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
  const unsigned grow = (unsigned)(row0 + b);
  unsigned w[4];
  philox_words(k0, k1, grow, (unsigned)s, (unsigned)p, w);
  R e[M];
  philox_normals<R, M>(w, e);
#pragma unroll
  for (int j = 0; j < M; ++j) eps[i * M + j] = e[j];
  if (s >= 1)
    us[(b * (long)S + (s - 1)) * N + p] = philox_uniform<R, M>(
        w, k0, k1, grow, (unsigned)s, (unsigned)p);
}

}  // namespace bssm


// Plain C entry point of both modes.  `args` points to the packed BigLaunch
// and `size` is its length in bytes.  Returns the launch's cudaError_t, -1
// for an unsupported m, -2 for a struct of another size or arguments
// outside the kernel's contract.
extern "C" int bssm_particle_big(const void* args, long long size) {
  if (size != (long long)sizeof(BigLaunch)) return -2;
  BigLaunch g;
  memcpy(&g, args, sizeof g);
  const long long N = g.N, T = g.threads_per_row, rows = g.rows_per_block;
  if (N < 2 || N > bssm::kMaxNBig || g.kk < 1 || g.S < 0 || g.B < 1 ||
      g.row0 < 0)
    return -2;
  if (T < 32 || T % 32 != 0 || T > 32 * bssm::kMaxWarpsRow || rows < 1 ||
      (T > 32 && rows != 1) || T * rows > bssm::kMaxThreadsBig)
    return -2;
  if (g.pmax < 1 || g.pmax > 8 || (N + T - 1) / T > g.pmax) return -2;
  if (g.bsf && (g.k < 1 || g.k > g.m)) return -2;
  if (g.anc != 0 && g.philox) return -2;
  if (g.bsf) return g.is_double ? bssm_big_bsf_f64(g) : bssm_big_bsf_f32(g);
  return g.is_double ? bssm_big_psi_f64(g) : bssm_big_psi_f32(g);
}

// eps (B, S+1, N, m) and us (B, S, N) filled with the values the Philox mode
// of bssm_particle_big consumes for the same key and row0.
extern "C" int bssm_philox_fill(int is_double, int m, long B, int S, int N,
                                long row0, const void* key, void* eps,
                                void* us, void* stream) {
  if (N < 1 || S < 0 || B < 1 || row0 < 0) return -2;
  const long total = B * (long)(S + 1) * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  bool known;
#define LAUNCH(R, M)                                                      \
  bssm::philox_fill_kernel<R, M><<<blocks, threads, 0,                    \
                                    (cudaStream_t)stream>>>(              \
      B, S, N, row0, (const long long*)key, (R*)eps, (R*)us)
  BSSM_DISPATCH(is_double, m, known, LAUNCH);
#undef LAUNCH
  if (!known) return -1;
  return (int)cudaGetLastError();
}
