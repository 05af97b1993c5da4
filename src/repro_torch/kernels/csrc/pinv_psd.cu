// pinv_psd for Hopper: the ALS solve's pseudo-inverse V+ of the R x R
// symmetric PSD matrix V = G_0 (*) G_1 (*) ... (the Hadamard product of the
// other modes' grams), in one CUDA block on the caller's stream.
//
// It replaces no TPU kernel: the reference leaves this R x R solve to XLA's
// eigh (src/repro/core/als.py). On the card torch.linalg.eigh is cuSOLVER's
// batched Jacobi, which synchronises with the host about ten times a call
// (its info and convergence reads), so the host waited for each mode's EC
// and exchange before it could enqueue that mode's solve. This kernel
// returns nothing to the host: the decision to stop is taken on the card.
//
// What bounds it: neither bytes (2-9 R^2 floats in, R^2 out) nor FLOPs
// (~4 R^3 fp64 a Jacobi sweep), but the latency of its dependent steps:
// m - 1 rounds a sweep (m = R rounded up to even), one block-wide barrier
// apart, each with two fp64 rsqrt on its path.
//
// What the design does about it:
//  0. Up to R 64 (pinv_psd_kernel), A, the next round's A (B) and U, fp64
//     with a padded row stride, are in shared memory (~100 KB at 64, so the
//     attribute is set, once a card). From 65 to 128, the ranks the EC
//     kernels also take, those three would need ~400 KB, so
//     pinv_psd_packed_kernel keeps A as its upper triangle, updated in
//     place, and U (~200 KB at 128): a 2 x 2 block of J^T A J reads only
//     the same block of A, so no second buffer is needed, but the next
//     round's rotations are computed after a second barrier, from A itself
//     (item 3's look-ahead would race with the in-place writes).
//  1. V is formed left to right in f32 with __fmul_rn, the bits of
//     functools.reduce over the grams, and held in fp64, made symmetric
//     from its lower triangle (eigh's default, UPLO 'L'). The padded row
//     and column of an odd R are zero and only ever see the identity
//     rotation, so every round treats all m indices alike.
//  2. Cyclic Jacobi in fp64, parallel in the round-robin (tournament)
//     order: a round's m / 2 rotations are disjoint and are applied at once,
//     A_next = J^T A J by 2 x 2 blocks (a row pair and a column pair), the
//     upper blocks only, each written with its mirror, into the other A
//     buffer, and U = U J in place, a (row, column pair) a task. Element
//     (x, y) off its pair's block is ((T1 + T4) + (T2 + T3)) of its four
//     products, each product and sum rounded alone (no FMA contraction): the
//     same bits for (y, x), so A stays exactly symmetric. A pair's own block
//     takes the closed form (a_xx -/+ t a_pq on the diagonal, 0 off it).
//  3. One barrier a round: while the other warps apply round r, warp 0
//     recomputes the three entries each pair of round r + 1 needs, by the
//     same arithmetic (same bits), and computes round r + 1's rotations
//     (t = tan(theta) from two rsqrt, no divide) into the other parameter
//     buffer.
//  4. Before each sweep the block sums the off-diagonal squares (a fixed
//     per-thread order, a fixed shuffle tree, the warps' sums in order, the
//     same bits in every thread) and stops once off <= eps64 * ||V||_F, or
//     after PINV_MAX_SWEEPS sweeps.
//  5. The cut is the solve's rule in fp64: w > rcond * max|w| gives 1 / w,
//     else 0. V+ = U diag(w+) U^T is summed over k in order in fp64 and
//     rounded once to f32; element (i, j) sums (U_ik U_jk) w+_k, so V+ is
//     exactly symmetric.
// No atomics and a fixed order throughout: the same bits in give the same
// bits out on every card, which keeps replicated solves bitwise equal.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define PINV_THREADS 512
#define PINV_WARPS (PINV_THREADS / 32)
// PINV_MAX_R, PINV_MAX_GRAMS and PINV_MAX_SWEEPS are mirrored in
// kernels/pinv.py (MAX_RANK, MAX_GRAMS, MAX_SWEEPS); pinv_psd_kernel takes
// R up to PINV_SMEM_R, pinv_psd_packed_kernel the rest.
#define PINV_MAX_R 128
#define PINV_SMEM_R 64
#define PINV_MAX_NP (PINV_MAX_R / 2)
// Tasks a round at R (even): the upper 2 x 2 blocks and the R x R / 2 U
// tasks.
#define PINV_NTASKS(R) ((R) / 2 * ((R) / 2 + 1) / 2 + (R) * ((R) / 2))
// pinv_psd_kernel: warp 0 computes the next round's rotations, the others
// apply the round, 3 tasks a worker at R 64, kept in registers (the packed
// kernel, 21 tasks a thread at R 128, reads its blocks from a table).
#define PINV_WORKERS (PINV_THREADS - 32)
#define PINV_TASKS \
  ((PINV_NTASKS(PINV_SMEM_R) + PINV_WORKERS - 1) / PINV_WORKERS)
#define PINV_MAX_GRAMS 8
#define PINV_MAX_SWEEPS 30

struct PinvGrams {
  const float* g[PINV_MAX_GRAMS];
};

// One round's rotations, pair k: c = cos, s = sin, t = tan of its angle
// (the pair's members follow from the round, pinv_pair).
struct PinvRound {
  double c[PINV_MAX_NP], s[PINV_MAX_NP], t[PINV_MAX_NP];
};

// What one index x takes from its pair in a round: row x of J^T A is
// a * row x + b * row partner (a = c, b = -s for p and +s for q), and its
// diagonal entry moves by dt * A[x][partner] (dt = -t for p, +t for q).
struct PinvCoef {
  double a, b, dt;
  int partner;
};

__device__ __forceinline__ int pinv_wrap(int x, int n) {
  return x >= n ? x - n : x;  // x in [0, 2n)
}

// Pair k of round r of the round-robin over m (even) indices: index m - 1
// stays, the others turn; over rounds 0..m-2 every pair meets once.
__device__ __forceinline__ void pinv_pair(int r, int k, int m, int* p,
                                          int* q) {
  int a = r, b = m - 1;
  if (k > 0) {
    a = pinv_wrap(r + k, m - 1);
    b = pinv_wrap(r - k + (m - 1), m - 1);
  }
  *p = a < b ? a : b;
  *q = a < b ? b : a;
}

// The pair of round r that holds index x, and x's partner in it.
__device__ __forceinline__ int pinv_pair_of(int r, int x, int m,
                                            int* partner) {
  if (x == m - 1 || x == r) {
    *partner = x == r ? m - 1 : r;
    return 0;
  }
  int v = 2 * r - x;  // pairs of round r sum to 2 r modulo m - 1
  if (v < 0) v += m - 1;
  *partner = pinv_wrap(v, m - 1);
  const int d = pinv_wrap(x - r + (m - 1), m - 1);
  return d < m / 2 ? d : (m - 1) - d;
}

// x's coefficients in round rd, x in pair k with `partner`.
__device__ __forceinline__ PinvCoef pinv_coef(const PinvRound& rd, int k,
                                              int x, int partner) {
  const bool low = x < partner;
  PinvCoef o;
  o.a = rd.c[k];
  o.b = low ? -rd.s[k] : rd.s[k];
  o.dt = low ? -rd.t[k] : rd.t[k];
  o.partner = partner;
  return o;
}

// Element (x, y) of J^T A J for x, y in different pairs, from A's entries
// (x, y), (x, y's partner), (x's partner, y) and the two partners: the same
// four products for (y, x), summed in the same association, so the same
// bits.
__device__ __forceinline__ double pinv_rot4(double axy, double axq,
                                            double apy, double apq,
                                            PinvCoef cx, PinvCoef cy) {
  const double t1 = __dmul_rn(__dmul_rn(cx.a, cy.a), axy);
  const double t2 = __dmul_rn(__dmul_rn(cx.a, cy.b), axq);
  const double t3 = __dmul_rn(__dmul_rn(cx.b, cy.a), apy);
  const double t4 = __dmul_rn(__dmul_rn(cx.b, cy.b), apq);
  return __dadd_rn(__dadd_rn(t1, t4), __dadd_rn(t2, t3));
}

__device__ __forceinline__ double pinv_rot_elem(const double* A, int ld,
                                                int x, PinvCoef cx, int y,
                                                PinvCoef cy) {
  return pinv_rot4(A[x * ld + y], A[x * ld + cy.partner],
                   A[cx.partner * ld + y], A[cx.partner * ld + cy.partner],
                   cx, cy);
}

// Diagonal entry x of J^T A J (A[x][partner] goes to 0).
__device__ __forceinline__ double pinv_diag(const double* A, int ld, int x,
                                            PinvCoef cx) {
  return __dadd_rn(A[x * ld + x], __dmul_rn(cx.dt, A[x * ld + cx.partner]));
}

// The rotation that zeroes a_pq: t = tan(theta) is the smaller root of
// t^2 + 2 tau t - 1 = 0, tau = (a_qq - a_pp) / (2 a_pq), through
// cos(2 theta) = |d| / r and sin(2 theta) = sign(d) 2 a_pq / r, r =
// hypot(d, 2 a_pq): c^2 = (1 + cos(2 theta)) / 2 >= 1/2, so no cancellation
// and no divide. (r^2 cannot overflow: the entries stay within ||V||_F of
// f32 inputs; it underflows to 0 only for |a_pq| < 1e-154, left alone.)
__device__ __forceinline__ void pinv_rotation(double app, double aqq,
                                              double apq, double* c,
                                              double* s, double* t) {
  *c = 1.0;
  *s = 0.0;
  *t = 0.0;
  const double d = aqq - app, two = 2.0 * apq;
  const double rr = d * d + two * two;
  if (apq != 0.0 && rr > 0.0) {
    const double rho = rsqrt(rr);
    const double h = 0.5 + 0.5 * (fabs(d) * rho);
    const double ic = rsqrt(h);  // 1 / c
    const double sin2 = (d >= 0.0 ? two : -two) * rho;
    *c = h * ic;
    *s = 0.5 * sin2 * ic;
    *t = *s * ic;
  }
}

// The sum of every thread's `x` in a fixed order, the same bits in every
// thread. `red` holds PINV_WARPS doubles; free again when this returns.
__device__ double pinv_block_sum(double x, double* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < PINV_WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Pair k's rotation for round `rn` into `out`, from A as it will be after
// round r (rd: round r's rotations; nullptr: A is already that matrix).
__device__ __forceinline__ void pinv_lookahead(const double* A, int ld,
                                               int m, int r,
                                               const PinvRound* rd, int rn,
                                               int k, PinvRound* out) {
  int p, q;
  pinv_pair(rn, k, m, &p, &q);
  double app = A[p * ld + p], aqq = A[q * ld + q], apq = A[p * ld + q];
  if (rd != nullptr) {
    int pp, pq;
    const int kp = pinv_pair_of(r, p, m, &pp), kq = pinv_pair_of(r, q, m, &pq);
    const PinvCoef cp = pinv_coef(*rd, kp, p, pp);
    const PinvCoef cq = pinv_coef(*rd, kq, q, pq);
    app = pinv_diag(A, ld, p, cp);
    aqq = pinv_diag(A, ld, q, cq);
    apq = kp == kq ? 0.0 : pinv_rot_elem(A, ld, p, cp, q, cq);
  }
  pinv_rotation(app, aqq, apq, &out->c[k], &out->s[k], &out->t[k]);
}

// R up to PINV_SMEM_R.
__global__ void __launch_bounds__(PINV_THREADS)
    pinv_psd_kernel(PinvGrams G, int ngrams, int R, double rcond,
                    float* __restrict__ out, int* __restrict__ sweeps_out) {
  extern __shared__ double smem[];
  __shared__ PinvRound rounds[2];
  __shared__ double red[PINV_WARPS];
  const int m = R + (R & 1);
  const int ld = m + 1;  // an odd row stride spreads a column over banks
  const int np = m / 2;
  double* A = smem;
  double* B = A + m * ld;
  double* U = B + m * ld;
  const int tid = threadIdx.x;

  // 1. V in f32, left to right, from the lower triangle; then fp64; U = I
  double fro = 0.0;
  for (int e = tid; e < m * ld; e += PINV_THREADS) {
    const int i = e / ld, j = e % ld;
    double a = 0.0;
    if (i < R && j < R) {
      const int f = i >= j ? i * R + j : j * R + i;
      float v = G.g[0][f];
      for (int w = 1; w < ngrams; ++w) v = __fmul_rn(v, G.g[w][f]);
      a = (double)v;
    }
    A[e] = a;
    U[e] = (i == j) ? 1.0 : 0.0;
    fro += a * a;
  }
  // Each worker's tasks, the same every round, kept in registers: the upper
  // blocks (P, Q), P <= Q, as P << 8 | Q, then the (column pair Q, row i)
  // tasks of U, Q-major so that a warp walks a column (no bank conflicts),
  // as 1 << 16 | Q << 8 | i; -1 past the end.
  int task[PINV_TASKS];
  {
    const int nblocks = np * (np + 1) / 2, ntasks = nblocks + np * m;
#pragma unroll
    for (int u = 0; u < PINV_TASKS; ++u) {
      int b = tid - 32 + u * PINV_WORKERS, code = -1;
      if (tid >= 32 && b < nblocks) {
        int P = 0;
        while (b >= np - P) b -= np - P++;
        code = P << 8 | (P + b);
      } else if (tid >= 32 && b < ntasks) {
        b -= nblocks;
        code = 1 << 16 | (b / m) << 8 | (b % m);
      }
      task[u] = code;
    }
  }
  // (the sum's barriers also publish A and U)
  const double tol2 = DBL_EPSILON * DBL_EPSILON * pinv_block_sum(fro, red);
  if (tid < np) pinv_lookahead(A, ld, m, 0, nullptr, 0, tid, &rounds[0]);

  // 2. cyclic Jacobi sweeps in tournament order
  int sweep = 0, g = 0;
  for (;;) {
    double off = 0.0;
    for (int e = tid; e < m * ld; e += PINV_THREADS) {
      const int i = e / ld, j = e % ld;
      if (i != j && j < m) off += A[e] * A[e];
    }
    // (publishes round 0's rotations too); !(off > tol): a NaN stops it
    if (!(pinv_block_sum(off, red) > tol2) || sweep == PINV_MAX_SWEEPS)
      break;
    for (int r = 0; r < m - 1; ++r, ++g) {
      const PinvRound& rd = rounds[g & 1];
      if (tid < 32) {
        if (tid < np)
          pinv_lookahead(A, ld, m, r, &rd, r + 1 == m - 1 ? 0 : r + 1, tid,
                         &rounds[(g & 1) ^ 1]);
      } else {
#pragma unroll
        for (int u = 0; u < PINV_TASKS; ++u) {
          const int code = task[u];
          if (code < 0) break;
          const int Q = (code >> 8) & 255;
          int pQ, qQ;
          pinv_pair(r, Q, m, &pQ, &qQ);
          if (code >> 16) {  // U = U J: row i, columns pQ and qQ
            const int i = code & 255;
            const double c = rd.c[Q], s = rd.s[Q];
            const double up = U[i * ld + pQ], uq = U[i * ld + qQ];
            U[i * ld + pQ] = __dsub_rn(__dmul_rn(c, up), __dmul_rn(s, uq));
            U[i * ld + qQ] = __dadd_rn(__dmul_rn(s, up), __dmul_rn(c, uq));
            continue;
          }
          const int P = code & 255;
          int pP, qP;
          pinv_pair(r, P, m, &pP, &qP);
          const PinvCoef cpP = pinv_coef(rd, P, pP, qP);
          const PinvCoef cqP = pinv_coef(rd, P, qP, pP);
          if (P == Q) {
            B[pP * ld + pP] = pinv_diag(A, ld, pP, cpP);
            B[qP * ld + qP] = pinv_diag(A, ld, qP, cqP);
            B[pP * ld + qP] = 0.0;
            B[qP * ld + pP] = 0.0;
            continue;
          }
          const PinvCoef cpQ = pinv_coef(rd, Q, pQ, qQ);
          const PinvCoef cqQ = pinv_coef(rd, Q, qQ, pQ);
          const double e00 = pinv_rot_elem(A, ld, pP, cpP, pQ, cpQ);
          const double e01 = pinv_rot_elem(A, ld, pP, cpP, qQ, cqQ);
          const double e10 = pinv_rot_elem(A, ld, qP, cqP, pQ, cpQ);
          const double e11 = pinv_rot_elem(A, ld, qP, cqP, qQ, cqQ);
          B[pP * ld + pQ] = e00;
          B[pQ * ld + pP] = e00;
          B[pP * ld + qQ] = e01;
          B[qQ * ld + pP] = e01;
          B[qP * ld + pQ] = e10;
          B[pQ * ld + qP] = e10;
          B[qP * ld + qQ] = e11;
          B[qQ * ld + qP] = e11;
        }
      }
      __syncthreads();
      double* sw = A;
      A = B;
      B = sw;
    }
    ++sweep;
  }

  // 3. the cut, from the eigenvalues on A's diagonal (every thread reads
  //    them all, in order: the same max everywhere); w+ goes into the free
  //    A buffer
  double wmax = 0.0;
  for (int k = 0; k < R; ++k) wmax = fmax(wmax, fabs(A[k * ld + k]));
  if (tid < R) {
    const double w = A[tid * ld + tid];
    B[tid] = (w > rcond * wmax) ? 1.0 / w : 0.0;
  }
  __syncthreads();

  // 4. V+ = U diag(w+) U^T, fp64 sums over k in order, rounded once
  for (int e = tid; e < R * R; e += PINV_THREADS) {
    const int i = e / R, j = e % R;
    double s = 0.0;
    for (int k = 0; k < R; ++k)
      s = __fma_rn(__dmul_rn(U[i * ld + k], U[j * ld + k]), B[k], s);
    out[e] = __double2float_rn(s);
  }
  if (sweeps_out != nullptr && tid == 0) *sweeps_out = sweep;
}

// Packed index of A's entry (i, j) in its upper triangle, by rows.
__device__ __forceinline__ int pinv_up(int i, int j, int m) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * m - i * (i - 1) / 2 + (j - i);
}

// R from PINV_SMEM_R + 1 to PINV_MAX_R (item 0 above): the same rotations,
// the same 2 x 2 block arithmetic and the same stop, cut and V+, with A's
// upper triangle updated in place and two barriers a round.
__global__ void __launch_bounds__(PINV_THREADS)
    pinv_psd_packed_kernel(PinvGrams G, int ngrams, int R, double rcond,
                           float* __restrict__ out,
                           int* __restrict__ sweeps_out) {
  extern __shared__ double smem[];
  __shared__ PinvRound rd;
  __shared__ double red[PINV_WARPS];
  const int m = R + (R & 1);
  const int ld = m + 1;
  const int np = m / 2;
  const int nblocks = np * (np + 1) / 2, ntasks = nblocks + np * m;
  double* A = smem;                  // m (m + 1) / 2
  double* U = A + m * (m + 1) / 2;   // m x ld
  double* winv = U + m * ld;         // m
  // the upper 2 x 2 blocks (P, Q), P <= Q, as P << 8 | Q
  unsigned short* blk = reinterpret_cast<unsigned short*>(winv + m);
  const int tid = threadIdx.x;

  // 1. V in f32, left to right, from the lower triangle; then fp64; U = I
  double fro = 0.0;
  for (int e = tid; e < m * m; e += PINV_THREADS) {
    const int i = e / m, j = e % m;
    if (i > j) continue;
    double a = 0.0;
    if (j < R) {
      const int f = j * R + i;
      float v = G.g[0][f];
      for (int w = 1; w < ngrams; ++w) v = __fmul_rn(v, G.g[w][f]);
      a = (double)v;
    }
    A[pinv_up(i, j, m)] = a;
    fro += (i == j ? 1.0 : 2.0) * (a * a);
  }
  for (int e = tid; e < m * ld; e += PINV_THREADS)
    U[e] = (e / ld == e % ld) ? 1.0 : 0.0;
  for (int b = tid; b < nblocks; b += PINV_THREADS) {
    int P = 0, q = b;
    while (q >= np - P) q -= np - P++;
    blk[b] = (unsigned short)(P << 8 | (P + q));
  }
  const double tol2 = DBL_EPSILON * DBL_EPSILON * pinv_block_sum(fro, red);

  // 2. cyclic Jacobi sweeps in tournament order
  int sweep = 0;
  for (;;) {
    double off = 0.0;
    for (int e = tid; e < m * m; e += PINV_THREADS) {
      const int i = e / m, j = e % m;
      if (i < j) {
        const double a = A[pinv_up(i, j, m)];
        off += 2.0 * (a * a);
      }
    }
    if (!(pinv_block_sum(off, red) > tol2) || sweep == PINV_MAX_SWEEPS)
      break;
    for (int r = 0; r < m - 1; ++r) {
      if (tid < np) {
        int p, q;
        pinv_pair(r, tid, m, &p, &q);
        pinv_rotation(A[pinv_up(p, p, m)], A[pinv_up(q, q, m)],
                      A[pinv_up(p, q, m)], &rd.c[tid], &rd.s[tid],
                      &rd.t[tid]);
      }
      __syncthreads();
      // the U tasks Q-major, so that a warp walks a column
      for (int b = tid; b < ntasks; b += PINV_THREADS) {
        if (b >= nblocks) {  // U = U J: row i, columns pQ and qQ
          const int Q = (b - nblocks) / m, i = (b - nblocks) % m;
          int pQ, qQ;
          pinv_pair(r, Q, m, &pQ, &qQ);
          const double c = rd.c[Q], s = rd.s[Q];
          const double up = U[i * ld + pQ], uq = U[i * ld + qQ];
          U[i * ld + pQ] = __dsub_rn(__dmul_rn(c, up), __dmul_rn(s, uq));
          U[i * ld + qQ] = __dadd_rn(__dmul_rn(s, up), __dmul_rn(c, uq));
          continue;
        }
        const int P = blk[b] >> 8, Q = blk[b] & 255;
        int pP, qP, pQ, qQ;
        pinv_pair(r, P, m, &pP, &qP);
        pinv_pair(r, Q, m, &pQ, &qQ);
        const PinvCoef cpP = pinv_coef(rd, P, pP, qP);
        const PinvCoef cqP = pinv_coef(rd, P, qP, pP);
        if (P == Q) {
          const int ipp = pinv_up(pP, pP, m), iqq = pinv_up(qP, qP, m);
          const int ipq = pinv_up(pP, qP, m);
          const double apq = A[ipq];
          A[ipp] = __dadd_rn(A[ipp], __dmul_rn(cpP.dt, apq));
          A[iqq] = __dadd_rn(A[iqq], __dmul_rn(cqP.dt, apq));
          A[ipq] = 0.0;
          continue;
        }
        const PinvCoef cpQ = pinv_coef(rd, Q, pQ, qQ);
        const PinvCoef cqQ = pinv_coef(rd, Q, qQ, pQ);
        const int i00 = pinv_up(pP, pQ, m), i01 = pinv_up(pP, qQ, m);
        const int i10 = pinv_up(qP, pQ, m), i11 = pinv_up(qP, qQ, m);
        const double a00 = A[i00], a01 = A[i01], a10 = A[i10], a11 = A[i11];
        A[i00] = pinv_rot4(a00, a01, a10, a11, cpP, cpQ);
        A[i01] = pinv_rot4(a01, a00, a11, a10, cpP, cqQ);
        A[i10] = pinv_rot4(a10, a11, a00, a01, cqP, cpQ);
        A[i11] = pinv_rot4(a11, a10, a01, a00, cqP, cqQ);
      }
      __syncthreads();
    }
    ++sweep;
  }

  // 3. the cut, as pinv_psd_kernel's
  double wmax = 0.0;
  for (int k = 0; k < R; ++k) wmax = fmax(wmax, fabs(A[pinv_up(k, k, m)]));
  if (tid < R) {
    const double w = A[pinv_up(tid, tid, m)];
    winv[tid] = (w > rcond * wmax) ? 1.0 / w : 0.0;
  }
  __syncthreads();

  // 4. V+ = U diag(w+) U^T, as pinv_psd_kernel's
  for (int e = tid; e < R * R; e += PINV_THREADS) {
    const int i = e / R, j = e % R;
    double s = 0.0;
    for (int k = 0; k < R; ++k)
      s = __fma_rn(__dmul_rn(U[i * ld + k], U[j * ld + k]), winv[k], s);
    out[e] = __double2float_rn(s);
  }
  if (sweeps_out != nullptr && tid == 0) *sweeps_out = sweep;
}

// Dynamic shared memory at R (m = R rounded up to even): A, B and U of
// pinv_psd_kernel, 3 m (m + 1) doubles, or the packed kernel's triangle, U
// and w+, m (m + 1) / 2 + m (m + 1) + m doubles, and its block table,
// m / 2 (m / 2 + 1) / 2 shorts.
static size_t pinv_smem_bytes(int R) {
  const size_t m = R + (R & 1);
  if (R <= PINV_SMEM_R) return 3 * m * (m + 1) * sizeof(double);
  return (m * (m + 1) / 2 + m * (m + 1) + m) * sizeof(double) +
         m / 2 * (m / 2 + 1) / 2 * sizeof(unsigned short);
}

// Set each kernel's dynamic shared memory attribute once a card, for the
// largest R it takes (a race sets it twice, which is harmless).
#define PINV_CARDS 64
static unsigned char pinv_attr_set[PINV_CARDS];

static cudaError_t pinv_allow_smem(const void* kernel, int bit, int R) {
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card < PINV_CARDS && (pinv_attr_set[card] & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pinv_smem_bytes(R));
  if (e == cudaSuccess && card < PINV_CARDS) pinv_attr_set[card] |= bit;
  return e;
}

// grams: a host array of `ngrams` device pointers, each to a contiguous
// R x R f32 matrix; out: R x R f32; sweeps: one int, or null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for an R or ngrams out of range).
extern "C" int pinv_psd_launch(const float* const* grams, int ngrams, int R,
                               double rcond, float* out, int* sweeps,
                               void* stream) {
  if (R < 1 || R > PINV_MAX_R || ngrams < 1 || ngrams > PINV_MAX_GRAMS)
    return cudaErrorInvalidValue;
  PinvGrams G = {};
  for (int w = 0; w < ngrams; ++w) G.g[w] = grams[w];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool packed = R > PINV_SMEM_R;
  cudaError_t e =
      packed ? pinv_allow_smem((const void*)pinv_psd_packed_kernel, 2,
                               PINV_MAX_R)
             : pinv_allow_smem((const void*)pinv_psd_kernel, 1, PINV_SMEM_R);
  if (e != cudaSuccess) return e;
  if (packed)
    pinv_psd_packed_kernel<<<1, PINV_THREADS, pinv_smem_bytes(R), s>>>(
        G, ngrams, R, rcond, out, sweeps);
  else
    pinv_psd_kernel<<<1, PINV_THREADS, pinv_smem_bytes(R), s>>>(
        G, ngrams, R, rcond, out, sweeps);
  return cudaGetLastError();
}

// The message of a CUDA error code: every library _build loads exports it.
extern "C" const char* ec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
