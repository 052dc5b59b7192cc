// The large-ensemble particle kernel's template (see particle_big.cu for
// what it computes and how it is laid out on the card), its launch-argument
// struct and its launchers.  The template is instantiated in four sources,
// one per mode and real type (particle_big_{psi,bsf}_{f32,f64}.cu), which
// nvcc compiles side by side; particle_big.cu holds the C entry points.
#pragma once

#include "kalman_common.cuh"

namespace bssm {

constexpr int kMaxNBig = 512;
constexpr int kChunk = 16;          // steps of row input a chunk holds
constexpr int kMaxWarpsRow = 2;     // warps a row may take
constexpr int kMaxThreadsBig = 128; // threads a block may have
constexpr int kSmemDefault = 48 * 1024;

// scalars of one step's row input: psi [ah (M), L (MM), A (MM), ytilde,
// Htilde, y, u, scales, D]; bsf [y, u, D]
__host__ __device__ constexpr int big_row_width(int M, bool bsf) {
  return bsf ? 3 : M + 2 * M * M + 6;
}

// shared values of one row: the two chunk buffers, the ensemble (M, N),
// the cumulative weights (N) and the reduction stage [2][kMaxWarpsRow][2]
__host__ __device__ inline long big_row_elems(int N, int M, bool bsf) {
  const long e = 2L * kChunk * big_row_width(M, bsf) + (long)M * N + N +
                 4 * kMaxWarpsRow;
  return (e + 1) & ~1L;
}

template <typename R> struct BigArgs {
  int dist, N, S, kk, philox, T, rows, k;
  long B;
  long row0;      // Philox mode: the global index of row 0 of the launch
  // psi mode, dense: ytilde, Htilde, scales (B, S); ahat (B, S+1, M);
  // Lb, Ab (B, S+1, M, M)
  const R* ytilde;
  const R* Htilde;
  const R* scales;
  const R* ahat;
  const R* Lb;
  const R* Ab;
  // both modes: the series and the leaves where the spec holds them; bsf
  // mode also a1, chol(P1), C, T and R (m x k)
  SeriesArg y, u, D;
  LeafArg Zl, phil, a1l, L1l, Cl, Tl, Rl;
  const R* eps;   // stream mode
  const R* us;
  const int* anc; // stream mode, check only: (B, S, N) ancestors, or null
  const long long* key;  // Philox mode: two words, low 32 bits of each
  R* out;         // (B,)
};

// (m, s) := (m, s) + (m2, s2), sums of exp(x - m) rescaled to the larger
// maximum (the warps' pairs of a row, combined in warp order)
template <typename R>
__device__ __forceinline__ void lse_combine(R& m, R& s, R m2, R s2) {
  const R hi = fmax(m, m2), lo = fmin(m, m2);
  const R e = lo == R(-INFINITY) ? R(0) : exp(lo - hi);
  s = m >= m2 ? s + s2 * e : s * e + s2;
  m = hi;
}

// For each of K slots, the first q in [q, q + len) with cum[q] >= u (the
// answer is known to lie there).  The loop count depends on len alone, so
// the slots' loads overlap.
template <typename R, int K>
__device__ __forceinline__ void bisect_slots(const R* cum, int (&q)[K],
                                             const R (&u)[K], int len) {
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < K; ++j) q[j] += cum[q[j] + half - 1] < u[j] ? half : 0;
    len -= half;
  }
}

template <typename R, int M, bool BSF, int P>
__global__ void __launch_bounds__(kMaxThreadsBig)
particle_big_kernel(const BigArgs<R> a) {
  constexpr int MM = M * M;
  constexpr int F = M + 2 * MM;     // [ah (M), L (MM), A (MM)]
  constexpr int ROW = big_row_width(M, BSF);
  extern __shared__ __align__(16) unsigned char big_smem[];

  const int T = a.T;
  const int nw = T >> 5;                        // warps of the row
  const int tid = (int)(threadIdx.x % (unsigned)T);
  const int rib = (int)(threadIdx.x / (unsigned)T);
  const long b = (long)blockIdx.x * a.rows + rib;
  if (b >= a.B) return;                         // the row's threads together
  const int lane = threadIdx.x & 31, warp = tid >> 5;
  const int N = a.N, S = a.S;
  const int plo = (int)(((long)tid * N) / T);
  const int cnt = (int)(((long)(tid + 1) * N) / T) - plo;
  const R neg_log_n = -log(R(N));
  const R tiny = R(1e-35);

  R* s_buf = reinterpret_cast<R*>(big_smem) + rib * big_row_elems(N, M, BSF);
  R* s_alpha = s_buf + 2 * kChunk * ROW;        // [M][N]
  R* s_cum = s_alpha + M * N;                   // [N]
  R* s_stage = s_cum + N;                       // [2][kMaxWarpsRow][2]
  // w = 1: the row is one warp; w > 1: one row a block
  auto row_sync = [&]() {
    if (nw > 1) __syncthreads(); else __syncwarp();
  };

  const R* yb = series_row<R>(a.y, b);
  const R* ub = series_row<R>(a.u, b);
  const R* Db = series_row<R>(a.D, b);
  R Z[M];
  {
    const R* Zb = leaf_row<R>(a.Zl, b);
#pragma unroll
    for (int i = 0; i < M; ++i) Z[i] = Zb[i];
  }
  const R phi = leaf_row<R>(a.phil, b)[0];
  R sC[M], sT[MM], sR[MM];                      // bsf mode: C, T, R (padded)
  if constexpr (BSF) {
    const R* Cb = leaf_row<R>(a.Cl, b);
    const R* Tb = leaf_row<R>(a.Tl, b);
    const R* Rb = leaf_row<R>(a.Rl, b);
#pragma unroll
    for (int i = 0; i < M; ++i) sC[i] = Cb[i];
#pragma unroll
    for (int i = 0; i < MM; ++i) sT[i] = Tb[i];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int l = 0; l < M; ++l) sR[i * M + l] = l < a.k ? Rb[i * a.k + l] : R(0);
  }

  // ---- row input: chunk c holds steps [c kChunk, (c+1) kChunk) in buffer
  // c & 1, [step][ROW]
  auto entry_src = [&](int s, int i) -> const R* {
    if constexpr (BSF) {
      return i == 0 ? yb + (long)s * a.y.ts
           : i == 1 ? ub + (long)s * a.u.ts
                    : Db + (long)s * a.D.ts;
    } else {
      const long t = S - s;                     // state index of step s
      const long base = b * (long)(S + 1) + t;
      if (i < M) return a.ahat + base * M + i;
      if (i < M + MM) return a.Lb + base * MM + (i - M);
      if (i < F) return a.Ab + base * MM + (i - M - MM);
      if (s == 0) return nullptr;               // no observation
      const int k = i - F;
      const long bt = b * (long)S + t;
      return k == 0 ? a.ytilde + bt
           : k == 1 ? a.Htilde + bt
           : k == 2 ? yb + t * a.y.ts
           : k == 3 ? ub + t * a.u.ts
           : k == 4 ? a.scales + bt
                    : Db + t * a.D.ts;
    }
  };
  auto load_chunk = [&](int c) {
    R* dst = s_buf + (c & 1) * (kChunk * ROW);
    const int s0 = c * kChunk;
    for (int f = tid; f < kChunk * ROW; f += T) {
      const int s = s0 + f / ROW;
      if (s > S) break;
      const R* src = entry_src(s, f % ROW);
      if (src != nullptr) cp_async<(int)sizeof(R)>(dst + f, src);
    }
    cp_async_commit();
  };

  // ---- randomness.  Every loop over the thread's slots j < P runs in
  // straight lines, with no branch on j: a slot past the thread's count
  // (j >= cnt) computes on a clamped particle index and is masked out of the
  // weights and the stores, so that the slots' independent chains of
  // generator, special functions and loads overlap.
  // the counter's row word is the row's place in the whole batch (a rank
  // of a mesh launches a window of it), so that the stream does not depend
  // on how the batch is split
  unsigned k0 = 0, k1 = 0;
  const unsigned grow = (unsigned)(a.row0 + b);
  if (a.philox) {
    k0 = (unsigned)a.key[0];
    k1 = (unsigned)a.key[1];
  }
  const R* eps = a.philox ? nullptr : a.eps + b * (long)(S + 1) * N * M;
  const R* us = a.philox ? nullptr : a.us + b * (long)S * N;
  const int* anc = a.anc == nullptr ? nullptr : a.anc + b * (long)S * N;
  auto pc = [&](int j) { return min(plo + j, N - 1); };  // clamped particle
  unsigned wd[P][4];
  auto words = [&](int s) {
    if (a.philox) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        philox_words(k0, k1, grow, (unsigned)s, (unsigned)(plo + j), wd[j]);
    }
  };
  auto normals = [&](int s, R (&e)[P][M]) {
    if (a.philox) {
#pragma unroll
      for (int j = 0; j < P; ++j) philox_normals<R, M>(wd[j], e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int i = 0; i < M; ++i)
          e[j][i] = eps[((long)s * N + pc(j)) * M + i];
    }
  };
  auto uniforms = [&](int s, R (&u)[P]) {
    if (a.philox) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        u[j] = philox_uniform<R, M>(wd[j], k0, k1, grow, (unsigned)s,
                                    (unsigned)(plo + j));
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) u[j] = us[(long)(s - 1) * N + pc(j)];
    }
  };

  R alpha[P][M], lnw[P], ah_prev[M];
  R ll = R(0);
  // the partials of the step's reduction: the row's (max, sum) and, w > 1,
  // each warp's; `weighted`: lnw came from a weighting that left the
  // ensemble alive (else it is -log N throughout)
  R rm = R(-INFINITY), rs = R(0);
  R pm[kMaxWarpsRow], ps[kMaxWarpsRow];
  bool weighted = false;

  auto weight = [&](const R* ob, int s) {
    R y_t, u_t, d_t, yt_t, ht_t, sc_t;
    if constexpr (BSF) {
      y_t = ob[0]; u_t = ob[1]; d_t = ob[2];
      yt_t = R(NAN); ht_t = R(1); sc_t = R(0);
    } else {
      yt_t = ob[0]; ht_t = ob[1]; y_t = ob[2]; u_t = ob[3]; sc_t = ob[4];
      d_t = ob[5];
    }
    const bool oky = isfinite(y_t);
    R lw[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      R sig = d_t;
#pragma unroll
      for (int i = 0; i < M; ++i) sig += Z[i] * alpha[j][i];
      lw[j] = sig;
    }
    // the family outside the slot loop: each case is one straight line
#define BSSM_LW(FAM)                                                        \
    for (int j = 0; j < P; ++j)                                             \
      lw[j] = log_weight<R>(FAM, y_t, u_t, phi,                             \
                            FAM == kSvm ? alpha[j][0] : lw[j], yt_t, ht_t)
    switch (a.dist) {
      case kSvm: { _Pragma("unroll") BSSM_LW(kSvm); break; }
      case kPoisson: { _Pragma("unroll") BSSM_LW(kPoisson); break; }
      case kBinomial: { _Pragma("unroll") BSSM_LW(kBinomial); break; }
      case kNegbin: { _Pragma("unroll") BSSM_LW(kNegbin); break; }
      default: { _Pragma("unroll") BSSM_LW(kGamma); break; }
    }
#undef BSSM_LW
    R lt[P];
    R mt = R(-INFINITY);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      R v = lnw[j] + (oky ? lw[j] - sc_t : R(0));
      v = (j < cnt && isfinite(v)) ? v : R(-INFINITY);
      lt[j] = v;
      mt = fmax(mt, v);
    }
    if (s < S) words(s + 1);     // integer work beside the reduction
    // the warp's pair: its max, then the sum of exp(lt - max); both
    // butterflies leave every lane with the same bits
    mt = warp_max<R>(mt);
    const R ms = mt == R(-INFINITY) ? R(0) : mt;
    R st = R(0);
#pragma unroll
    for (int j = 0; j < P; ++j)
      st += lt[j] == R(-INFINITY) ? R(0) : exp(lt[j] - ms);
    st = warp_sum<R>(st);
    rm = mt;
    rs = st;
    if (nw > 1) {
      R* stg = s_stage + (s & 1) * (2 * kMaxWarpsRow);
      if (lane == 0) {
        stg[2 * warp] = mt;
        stg[2 * warp + 1] = st;
      }
      __syncthreads();
      rm = R(-INFINITY);
      rs = R(0);
#pragma unroll
      for (int k = 0; k < kMaxWarpsRow; ++k)
        if (k < nw) {
          pm[k] = stg[2 * k];
          ps[k] = stg[2 * k + 1];
          lse_combine<R>(rm, rs, pm[k], ps[k]);
        }
    }
    const bool mx_ok = isfinite(rm);
    const R mxs = mx_ok ? rm : R(0);
    const bool ok2 = (rs > R(0)) && mx_ok;
    const R inc = ok2 ? mxs + log(fmax(rs, tiny)) : R(-INFINITY);
    if (oky) ll += inc;
#pragma unroll
    for (int j = 0; j < P; ++j) lnw[j] = ok2 ? lt[j] - inc : neg_log_n;
    weighted = ok2;
  };

  // The cumulative weights and the ensemble of the next step's resampling,
  // into shared memory; the top of that step publishes them.
  auto stage_resample = [&]() {
    if (nw == 1) __syncwarp();   // this step's gathers are done
    R pre[P];
    R c = R(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      c += (j < cnt && isfinite(lnw[j])) ? exp(lnw[j]) : R(0);
      pre[j] = c;
    }
    const R incl = warp_inclusive_scan<R>(c, lane);
    R off = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) off = R(0);
    if (nw > 1) {
      // the earlier warps' totals: sum exp(lt - inc) from their partials,
      // or their particle counts over N for a uniform ensemble
      const R inv = weighted ? R(1) / rs : R(0);
#pragma unroll
      for (int k = 0; k < kMaxWarpsRow - 1; ++k)
        if (k < warp) {
          R wk;
          if (weighted) {
            wk = pm[k] == R(-INFINITY) ? R(0) : ps[k] * exp(pm[k] - rm) * inv;
          } else {
            const int c0 = (int)(((long)(32 * k) * N) / T);
            const int c1 = (int)(((long)(32 * k + 32) * N) / T);
            wk = R(c1 - c0) * exp(neg_log_n);
          }
          off += wk;
        }
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < cnt) {
        const int p = plo + j;
        s_cum[p] = p >= N - 1 ? R(1) : off + pre[j];
#pragma unroll
        for (int i = 0; i < M; ++i) s_alpha[i * N + p] = alpha[j][i];
      }
  };

  // ---- prologue: chunks 0 and 1 in flight, wait for 0
  load_chunk(0);
  load_chunk(1);
  cp_async_wait<1>();
  row_sync();

  // ---- step 0: the initial ensemble
  words(0);
  {
    const R* row = s_buf;
    R a1[M], L1[MM];
    if constexpr (BSF) {
      const R* a1b = leaf_row<R>(a.a1l, b);
      const R* L1b = leaf_row<R>(a.L1l, b);
#pragma unroll
      for (int i = 0; i < M; ++i) a1[i] = a1b[i];
#pragma unroll
      for (int i = 0; i < MM; ++i) L1[i] = L1b[i];
    } else {
#pragma unroll
      for (int i = 0; i < M; ++i) a1[i] = row[i];
#pragma unroll
      for (int i = 0; i < MM; ++i) L1[i] = row[M + i];
    }
    R e[P][M];
    normals(0, e);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      lnw[j] = neg_log_n;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        R acc = a1[i];
#pragma unroll
        for (int l = 0; l < M; ++l) acc += L1[i * M + l] * e[j][l];
        alpha[j][i] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) ah_prev[i] = BSF ? R(0) : a1[i];
    if constexpr (BSF) {
      weight(row, 0);
    } else {
      if (S > 0) words(1);
    }
    if (S > 0) stage_resample();   // step 1 always resamples
  }

  for (int s = 1; s <= S; ++s) {
    const bool boundary = (s % kChunk) == 0;
    const bool resample = ((s - 1) % a.kk) == 0;
    if (boundary) cp_async_wait<0>();
    if (boundary || resample) row_sync();  // publishes chunk, cum, ensemble
    if (boundary) load_chunk(s / kChunk + 1);
    const R* row = s_buf + ((s / kChunk) & 1) * (kChunk * ROW)
                   + (s % kChunk) * ROW;
    R an[P][M];
    if (resample) {
      int q[P];
      if (anc != nullptr) {
#pragma unroll
        for (int j = 0; j < P; ++j) q[j] = anc[(long)(s - 1) * N + pc(j)];
      } else {
        // u rises with the particle: bisect for the thread's first and
        // last particles, then for the others between their two answers
        R u[P];
        uniforms(s, u);
#pragma unroll
        for (int j = 0; j < P; ++j) u[j] = (R(plo + j) + u[j]) / R(N);
#pragma unroll
        for (int j = 0; j < P; ++j) q[j] = 0;
        if constexpr (P <= 2) {
          bisect_slots<R, P>(s_cum, q, u, N);
        } else {
          const R ends[2] = {u[0], u[max(cnt - 1, 0)]};
          int qe[2] = {0, 0};
          bisect_slots<R, 2>(s_cum, qe, ends, N);
#pragma unroll
          for (int j = 0; j < P; ++j) q[j] = qe[0];
          bisect_slots<R, P>(s_cum, q, u, qe[1] - qe[0] + 1);
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int i = 0; i < M; ++i) an[j][i] = s_alpha[i * N + q[j]];
#pragma unroll
      for (int j = 0; j < P; ++j) lnw[j] = neg_log_n;
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int i = 0; i < M; ++i) an[j][i] = alpha[j][i];
    }
    R e[P][M];
    normals(s, e);
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int i = 0; i < M; ++i) {
        R acc;
        if constexpr (BSF) {
          acc = sC[i];
#pragma unroll
          for (int l = 0; l < M; ++l)
            acc += sT[i * M + l] * an[j][l] + sR[i * M + l] * e[j][l];
        } else {
          acc = row[i];
#pragma unroll
          for (int l = 0; l < M; ++l)
            acc += row[M + MM + i * M + l] * (an[j][l] - ah_prev[l])
                   + row[M + i * M + l] * e[j][l];
        }
        alpha[j][i] = acc;
      }
    if constexpr (!BSF) {
#pragma unroll
      for (int i = 0; i < M; ++i) ah_prev[i] = row[i];
    }
    weight(row + (BSF ? 0 : F), s);
    if (s < S && s % a.kk == 0) stage_resample();
  }
  cp_async_wait<0>();
  if (tid == 0) a.out[b] = ll;
}

// The most particles a thread holds (P) that are instantiated: 2 and 8, and
// for float32 at m <= 2 (the paths' shapes) also 7, which fits N = 200 on
// one warp with an eighth fewer idle slots than 8 and was 6% faster there on
// an H100 (chip_smoke.py --geometry-sweep; ops/cuda_kalman.big_pmax_choices).
template <typename R, int M>
__host__ __device__ constexpr bool big_all_p() {
  return sizeof(R) == 4 && M <= 2;
}

}  // namespace bssm

// Launch arguments of bssm_particle_big, packed by ops/cuda_kalman.py in
// this order (see kalman_common.cuh).  S = generation steps after the
// initial draw (psi: n, bsf: n - 1).  The geometry: threads a row (32 or
// 64), rows a block (1 unless a row is one warp; at most 128 threads a
// block) and P, the most particles a thread holds (2 or 8, at least
// ceil(N / threads a row)).  psi mode (bsf = 0): ytilde, Htilde, scales
// (B, S); ahat (B, S+1, m); Lb, Ab (B, S+1, m, m).  bsf mode: the leaves
// a1, L1 = chol(P1), C, T and R, whose k columns (1 <= k <= m) are read as
// they are.  Both: y, u, D and the leaves Z, phi where the spec holds them.
// Stream mode (philox = 0): eps (B, S+1, N, m), us (B, S, N), and anc
// (B, S, N) int32 or 0.  Philox mode: key points to two 64-bit words on the
// device, and row b of the launch draws as row row0 + b of the batch.
// out (B,).  The dense tensors are contiguous.
struct BigLaunch {
  long long is_double, m, dist, bsf, philox, N, B, S, kk, row0;
  long long threads_per_row, rows_per_block, pmax;
  long long ytilde, Htilde, scales, ahat, Lb, Ab;
  bssm::SeriesArg y, u, D;
  bssm::LeafArg Z, phi, a1, L1, C, T, R;
  long long k;
  long long eps, us, anc, key, out, stream;
};

namespace bssm {

template <typename R, int M, bool BSF, int P>
int launch_big(const BigArgs<R>& a, unsigned blocks, int threads,
               size_t smem, cudaStream_t stream) {
  auto kern = particle_big_kernel<R, M, BSF, P>;
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename R, int M, bool BSF>
int launch_big_p(const BigLaunch& g) {
  const auto in = [](long long p) { return (const R*)p; };
  BigArgs<R> a;
  a.dist = (int)g.dist; a.N = (int)g.N; a.S = (int)g.S; a.kk = (int)g.kk;
  a.philox = (int)g.philox; a.T = (int)g.threads_per_row;
  a.rows = (int)g.rows_per_block; a.k = (int)g.k; a.B = (long)g.B;
  a.row0 = (long)g.row0;
  a.ytilde = in(g.ytilde); a.Htilde = in(g.Htilde); a.scales = in(g.scales);
  a.ahat = in(g.ahat); a.Lb = in(g.Lb); a.Ab = in(g.Ab);
  a.y = g.y; a.u = g.u; a.D = g.D;
  a.Zl = g.Z; a.phil = g.phi; a.a1l = g.a1; a.L1l = g.L1; a.Cl = g.C;
  a.Tl = g.T; a.Rl = g.R;
  a.eps = in(g.eps); a.us = in(g.us); a.anc = (const int*)g.anc;
  a.key = (const long long*)g.key; a.out = (R*)g.out;
  const size_t smem = (size_t)g.rows_per_block *
                      big_row_elems(a.N, M, BSF) * sizeof(R);
  const unsigned blocks =
      (unsigned)((g.B + g.rows_per_block - 1) / g.rows_per_block);
  const int threads = (int)(g.threads_per_row * g.rows_per_block);
  const cudaStream_t st = (cudaStream_t)g.stream;
  switch (g.pmax) {
    case 2: return launch_big<R, M, BSF, 2>(a, blocks, threads, smem, st);
    case 8: return launch_big<R, M, BSF, 8>(a, blocks, threads, smem, st);
    default: break;
  }
  if constexpr (big_all_p<R, M>()) {
    switch (g.pmax) {
      case 7: return launch_big<R, M, BSF, 7>(a, blocks, threads, smem, st);
      default: break;
    }
  }
  return -2;
}

// One mode and real type, every m: the body of the four instantiating
// sources.  -1 for an unsupported m, -2 for an uninstantiated P.
template <typename R, bool BSF>
int launch_big_mode(const BigLaunch& g) {
  switch (g.m) {
    case 1: return launch_big_p<R, 1, BSF>(g);
    case 2: return launch_big_p<R, 2, BSF>(g);
    case 3: return launch_big_p<R, 3, BSF>(g);
    case 4: return launch_big_p<R, 4, BSF>(g);
    default: return -1;
  }
}

}  // namespace bssm

int bssm_big_psi_f32(const BigLaunch& g);
int bssm_big_psi_f64(const BigLaunch& g);
int bssm_big_bsf_f32(const BigLaunch& g);
int bssm_big_bsf_f64(const BigLaunch& g);
