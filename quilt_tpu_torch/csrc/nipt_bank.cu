// Forward bank of the NIPT within-block relabelling move.
//
// No Pallas kernel stands behind it: the JAX package runs this recursion as
// an XLA scan over the grids (quilt_tpu/kernels/gibbs.py, nipt_block_within,
// scan_step). In PyTorch the same scan is a Python loop of ~25 small launches
// a grid; this kernel takes its place on the card (the loop stays as the
// plain version, kernels/nipt_bank.py:bank_scan_plain).
//
// What it computes, per chain b: the forward recursion of the 6 relabellings
// of the 3 latent rows, restarted at every block end of the chain. Row i of
// relabelling r runs under the emissions of row INVS[r][i], so the 18 bank
// rows are 9 distinct ones: bank[i][j] = alpha of row i advanced under the
// emissions of row j since the block's start. Per grid g, with e[g][j] =
// exp(lemg[g][j] - max over the real haplotypes of lemg[g][j]), 0 at the pad
// haplotypes (k >= K_real):
//   a[i][j]   = e[g][j] * ((t0 * sc[i][j]) * a_prev[i][j] + jump),
//   s[i][j]   = sum_k a,   lg[i][j] += log s,   sc[i][j] = 1 / max(s, 1e-30)
//   junction  J[i][j] = sc[i][j] * sum_k a[i][j] * beta[g][i]   (block ends only)
// where sc carries the normalisation into the next step (the bank is kept
// raw). Where the chain's block ends at g, the relabelling is drawn from
//   lw[r] = sum_i (log max(J[i][INVS[r][i]], 1e-30) + lg[i][INVS[r][i]]) + ht[g][r]
// (ht: the block's class-count term, an input), softmax with a floor of
// -100 under the maximum, the mask of allowed relabellings, inverse CDF
// against the block's uniform; the bank collapses to the drawn rows
// (a[i][*] = a[i][INVS[r][i]], sc likewise) and lg restarts at 0.
// Inputs lemg / beta [G, 3B, K] (state row j*B + b) as the sweeps leave them,
// trans [2, G], ht [G, B, 6], u [G, B], is_end [G, B] i32, perm_mask [6];
// outputs chosen [G, B] i32 (0 where no block ends) and probs [G, B, 6] (0
// there). The per-(grid, row) shift of lemg does not change the result
// (it scales s[i][j] for every i by one constant, which the normalised bank,
// the junctions and the softmax cancel); the maximum is taken so that e is
// the value the plain version computes.
//
// What bounds it on the H100: the dependent chain over the grids. Bytes
// (lemg's real haplotypes once, beta at the block ends) are ~0.03 ms at the
// full-width shape;
// a grid step is one block reduction plus ~10 register operations per bank
// entry. Design, per step:
//   * the 9 bank rows of a thread's columns live in registers (CPT columns
//     a thread, K <= NT * CPT); the normalisation is folded into the next
//     step, so the bank is touched once a step; the collapse at a block end
//     is an unrolled choice over the 6 relabellings, each arm with constant
//     register indices;
//   * operands ahead of the chain: lemg of grid g + 2 is loaded into
//     registers while grid g is stepped (two buffers by grid parity, the
//     loop unrolled by two), beta of grid g + 1 where its block ends, and
//     the transition terms and block ends of the whole chain are staged in
//     shared memory at the start;
//   * the three row maxima of grid g + 1 ride in grid g's reduction as
//     maxima beside its sums, so e of the next grid is ready when the step
//     ends and no pass over the planes runs first;
//   * one reduction a step: a transposing butterfly per warp over 16 slots
//     (9 sums, 3 maxima) or, at a block end, 32 (18 sums, 3 maxima), one
//     record per warp in shared memory double-buffered by step parity, one
//     barrier, and every thread adds the records in warp order, so all
//     threads take the same decision from the same sums.
// A general form (the bank in shared memory, operands read in the step)
// serves K above the register forms. Where its bank outgrows a block's
// shared memory (K > 6,257 at 512 grids), the cluster form takes the chain:
// a thread-block cluster of 16 blocks, each a register form over its slice
// of the columns, whose steps exchange their 12 (at a block end 21) values
// over distributed shared memory (cluster_xchg.cuh), up to K = 16,384. Its
// global form (the bank and the staged scalars in a global scratch plane)
// takes any K and G past that, and past the grids whose staged scalars fit
// a block (about 19,000). The previous form is nipt_bank_prev.cu.
#include <cuda_runtime.h>
#include <math.h>

#include "cluster_xchg.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
// threads a chain: timed in turn at the nipt shape (28 chains x K = 640 x
// 512 grids), 128 threads took 0.872 ms, 256 threads 0.923 and one warp
// (20 columns a lane, 2.7 KB a thread spilled) 11.447 (PERF.md)
constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int RW = 24;            // a warp's record: 18 sums, 3 maxima, padding
constexpr int SMEM_LIMIT = 232448;
// the cluster form: blocks a chain (16, a non-portable cluster: timed in
// turn at 512 grids x 4 chains x K = 6,272, 16 blocks of 392 columns took
// 1.498 ms, 8 blocks of 784 1.955; chip_smoke.py, PERF.md) and its capacity
constexpr int CLUSTER_C = 16;
constexpr int CLUSTER_COLS = CLUSTER_C * NT * 8;

__host__ __device__ constexpr int r4(int n) { return (n + 3) & ~3; }

// INVS[r][i] of quilt_tpu_torch/kernels/nipt.py: the old latent row whose
// planes move into row i under relabelling r ({0,1,2}, {0,2,1}, {1,0,2},
// {1,2,0}, {2,0,1}, {2,1,0}), two bits an entry, so that it folds to a
// constant in the unrolled loops.
__device__ constexpr int invs(int r, int i) {
  return (int)((0x192261624ULL >> (2 * (3 * r + i))) & 3ULL);
}

// ---- the reduction ---------------------------------------------------------

// Slots >= MAXLO combine by maximum, the others by sum.
template <int MAXLO>
__device__ __forceinline__ float combine(float a, float b, int slot) {
  return slot >= MAXLO ? fmaxf(a, b) : a + b;
}

// One round of a transposing butterfly over N slots (fb_common.cuh
// transpose_round), each slot a sum or a maximum: lanes with bit O set keep
// the upper half of their 2*O values, the others the lower half.
template <int N, int O, int MAXLO>
__device__ __forceinline__ void mixed_round(float (&v)[N], int lane) {
  const bool upper = lane & O;
  const int base = lane & (N - 1) & ~(O - 1);     // the slot of v[0] after this round
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? v[j] : v[j + O];
    const float keep = upper ? v[j + O] : v[j];
    v[j] = combine<MAXLO>(keep, __shfl_xor_sync(FULL, send, O), base + j);
  }
}

// Leaves lane l with the warp's result of slot l % N in v[0].
template <int N, int MAXLO>
__device__ __forceinline__ void warp_mixed(float (&v)[N], int lane) {
  if constexpr (N >= 32) mixed_round<N, 16, MAXLO>(v, lane);
  mixed_round<N, 8, MAXLO>(v, lane);
  mixed_round<N, 4, MAXLO>(v, lane);
  mixed_round<N, 2, MAXLO>(v, lane);
  mixed_round<N, 1, MAXLO>(v, lane);
#pragma unroll
  for (int o = N; o < 32; o <<= 1)
    v[0] = combine<MAXLO>(v[0], __shfl_xor_sync(FULL, v[0], o), lane & (N - 1));
}

// The step's reduction over the block. v: slots 0..NSUM-1 the thread's sums
// (NSUM = 9 normalisers, or 18 with the junctions), slots MAXLO..MAXLO+2 its
// maxima of the next grid's three rows, the others 0. tot receives the
// block's sums in 0..NSUM-1 and its maxima in 18..20, the same in every
// thread. recs: this step's parity of the warps' records.
template <int N, int NSUM, int MAXLO>
__device__ __forceinline__ void reduce_step(float (&v)[N], float* recs, float (&tot)[21]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_mixed<N, MAXLO>(v, lane);
  const int slot = lane & (N - 1);
  if (lane < N) {
    if (slot < NSUM) recs[warp * RW + slot] = v[0];
    else if (slot >= MAXLO && slot < MAXLO + 3) recs[warp * RW + 18 + slot - MAXLO] = v[0];
  }
  __syncthreads();
  const float4* rp = reinterpret_cast<const float4*>(recs);
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
#pragma unroll
    for (int q4 = 0; q4 < 6; ++q4) {
      if (NSUM == 9 && q4 == 3) continue;               // slots 12..15: unused
      const float4 x = rp[w * (RW / 4) + q4];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int q = 4 * q4 + t;
        if (q >= 21 || (q < 18 && q >= NSUM)) continue;
        tot[q] = w == 0 ? xs[t] : (q >= 18 ? fmaxf(tot[q], xs[t]) : tot[q] + xs[t]);
      }
    }
  }
}

// A step's reduction: the thread's sums v (0..8 the normalisers' and, at a
// block end, 9..17 the junctions') and its maxima m of the next grid's
// rows, over 16 slots or, at a block end, 32.
__device__ __forceinline__ void reduce_sums_maxima(bool end, const float (&v)[18],
                                                   const float (&m)[3], float* recs,
                                                   float (&tot)[21]) {
  if (end) {
    float w[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) w[q] = q < 18 ? v[q] : q >= 28 && q < 31 ? m[q - 28] : 0.f;
    w[31] = -INFINITY;
    reduce_step<32, 18, 28>(w, recs, tot);
  } else {
    float w[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) w[q] = q < 9 ? v[q] : q >= 12 && q < 15 ? m[q - 12] : 0.f;
    w[15] = -INFINITY;
    reduce_step<16, 9, 12>(w, recs, tot);
  }
}

// ---- the decision at the end of a step -----------------------------------

// From the step's sums: the normalisers' inverses (inv) and the running log
// normalisers; where the block ends, the relabelling drawn (returned; 0
// elsewhere) from the class-count terms htv and the uniform uu, its
// probabilities written, the log normalisers restarted. Lane q < 9 of each
// warp takes normaliser q (its inverse, its running log lg_q) and shares
// them by shuffles, so no thread computes nine logarithms a step. Every
// thread takes the same decision; thread 0 of the writer (a cluster form's
// rank 0, the only block of the other forms) writes.
__device__ __forceinline__ int decide(const float (&tot)[21], bool end, float& lg_q,
                                      float (&inv)[9], const float (&htv)[6], float uu,
                                      const float (&mask)[6], int* __restrict__ chosen_out,
                                      float* __restrict__ probs_out, size_t gb, bool writer) {
  const int lane = threadIdx.x & 31;
  float s = tot[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) s = lane == q ? tot[q] : s;
  s = fmaxf(s, 1e-30f);
  const float inv_q = 1.f / s;
  lg_q += logf(s);
#pragma unroll
  for (int ij = 0; ij < 9; ++ij) inv[ij] = __shfl_sync(FULL, inv_q, ij);
  int chosen = 0;
  if (end) {
    float lg[9];
#pragma unroll
    for (int ij = 0; ij < 9; ++ij) lg[ij] = __shfl_sync(FULL, lg_q, ij);
    float lw[6], m = -INFINITY;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float x = htv[r];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int ij = i * 3 + invs(r, i);
        x += logf(fmaxf(tot[9 + ij] * inv[ij], 1e-30f)) + lg[ij];
      }
      lw[r] = x;
      m = fmaxf(m, x);
    }
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      lw[r] = expf(fmaxf(lw[r] - m, -100.f)) * mask[r];
      sum += lw[r];
    }
    float cum = 0.f;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float p = lw[r] / sum;
      cum += p;
      chosen += cum <= uu ? 1 : 0;
      if (writer && threadIdx.x == 0) probs_out[gb * 6 + r] = p;
    }
    chosen = chosen < 5 ? chosen : 5;
    lg_q = 0.f;
  } else if (writer && threadIdx.x < 6) {
    probs_out[gb * 6 + threadIdx.x] = 0.f;
  }
  if (writer && threadIdx.x == 0) chosen_out[gb] = chosen;
  return chosen;
}

// ---- the register form ----------------------------------------------------

template <int CPT>
struct Bank {
  float a[9][CPT];        // raw bank, row i*3 + j, the thread's columns
  float sc[9];            // 1 / the normaliser that a carries
  float lg;               // lane q < 9: the block's running log normaliser q
  float e[3][CPT];        // emissions of the grid being stepped
  float L[2][3][CPT];     // lemg of the next two grids, by grid parity (pads -inf)
  float bt[3][CPT];       // beta of the grid being stepped, at a block end (pads 0)
};

// The bank collapses to relabelling R's rows: a[i][*] = a[i][INVS[R][i]].
template <int R, int CPT>
__device__ __forceinline__ void collapse(Bank<CPT>& st, const float (&inv)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int s = i * 3 + invs(R, i);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float v = st.a[s][c];
#pragma unroll
      for (int j = 0; j < 3; ++j) st.a[i * 3 + j][c] = v;
    }
    const float x = inv[s];
#pragma unroll
    for (int j = 0; j < 3; ++j) st.sc[i * 3 + j] = x;
  }
}

template <int CPT>
__device__ __forceinline__ void load_rows(float (&dst)[3][CPT], const float* __restrict__ src,
                                          size_t step, int K_real, float pad) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = threadIdx.x + c * NT;
      dst[j][c] = k < K_real ? __ldg(src + j * step + k) : pad;
    }
  }
}

struct Chain {
  const float* lemg;      // row j of grid g: lemg + g * gstride + j * step
  const float* beta;
  size_t gstride, step;
  const float* stay;      // staged: stay, jump (grid 0: + 1, over K_real), block ends
  const float* jump;
  const int* ends;
  const float* ht;
  const float* u;
  int* chosen_out;
  float* probs_out;
  int G, B, b, K_real;    // K_real: the block's real columns
  bool writer;            // writes the chain's outputs
  float mask[6];
};

// A cluster form's exchange: a record of 21 values (18 sums, 3 maxima) at a
// block end, 12 (9 sums, 3 maxima) elsewhere.
using BankInbox = cluster_xchg::Inbox<24>;
using BankExchange = cluster_xchg::Exchange<24>;

// The cluster's values of a step from the block's (tot as reduce_step
// leaves it), in every block the same.
__device__ __forceinline__ void cluster_tot(BankExchange& xc, bool end, float (&tot)[21]) {
  if (end) {
    xc.combine<21, 18>(tot, threadIdx.x);
  } else {
    float w[12];
#pragma unroll
    for (int q = 0; q < 9; ++q) w[q] = tot[q];
#pragma unroll
    for (int j = 0; j < 3; ++j) w[9 + j] = tot[18 + j];
    xc.combine<12, 9>(w, threadIdx.x);
#pragma unroll
    for (int q = 0; q < 9; ++q) tot[q] = w[q];
#pragma unroll
    for (int j = 0; j < 3; ++j) tot[18 + j] = w[9 + j];
  }
}

// The class-count terms and the uniform of the block that ends at a grid,
// loaded at the step's start so that they arrive before its decision.
__device__ __forceinline__ void load_block_end(const Chain& ch, bool end, size_t gb,
                                               float (&htv)[6], float& uu) {
#pragma unroll
  for (int r = 0; r < 6; ++r) htv[r] = end ? __ldg(ch.ht + gb * 6 + r) : 0.f;
  uu = end ? __ldg(ch.u + gb) : 0.f;
}

template <bool JUNCTION, int CPT>
__device__ __forceinline__ void step_cols(Bank<CPT>& st, const float (&f)[9], float jp,
                                          float (&v)[18]) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ij = i * 3 + j;
        const float a = __fmul_rn(st.e[j][c], __fadd_rn(__fmul_rn(f[ij], st.a[ij][c]), jp));
        st.a[ij][c] = a;
        v[ij] += a;
        if constexpr (JUNCTION) v[9 + ij] = __fmaf_rn(a, st.bt[i][c], v[9 + ij]);
      }
    }
  }
}

// The thread's maxima of three rows held in registers (pads -inf).
template <int CPT>
__device__ __forceinline__ void row_max(const float (&x)[3][CPT], float (&m)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    m[j] = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPT; ++c) m[j] = fmaxf(m[j], x[j][c]);
  }
}

// Grid g of the register form; PAR = g & 1 (L[PAR ^ 1] holds grid g + 1,
// L[PAR] receives grid g + 2). CL: a cluster form's block, whose sums go
// through the cluster exchange xc.
template <int CPT, int PAR, bool CL>
__device__ __forceinline__ void reg_step(Bank<CPT>& st, const Chain& ch, int g, float* red,
                                         BankExchange& xc) {
  const bool end = ch.ends[g] != 0;
  const float t0 = ch.stay[g], jp = ch.jump[g];
  const size_t gb = (size_t)g * ch.B + ch.b;
  float htv[6], uu;
  load_block_end(ch, end, gb, htv, uu);
  float f[9];
#pragma unroll
  for (int ij = 0; ij < 9; ++ij) f[ij] = __fmul_rn(t0, st.sc[ij]);
  float v[18];
#pragma unroll
  for (int q = 0; q < 18; ++q) v[q] = 0.f;
  // the step: a = e * (f * a + jump), its sums and, at a block end, the
  // junctions' (slots 9..17)
  if (end) step_cols<true>(st, f, jp, v);
  else step_cols<false>(st, f, jp, v);
  // operands ahead of the chain: lemg of grid g + 2, beta of grid g + 1
  if (g + 2 < ch.G)
    load_rows<CPT>(st.L[PAR], ch.lemg + (size_t)(g + 2) * ch.gstride, ch.step, ch.K_real,
                   -INFINITY);
  if (g + 1 < ch.G && ch.ends[g + 1])
    load_rows<CPT>(st.bt, ch.beta + (size_t)(g + 1) * ch.gstride, ch.step, ch.K_real, 0.f);
  // the next grid's row maxima ride in this step's reduction
  float m[3], tot[21];
  row_max(st.L[PAR ^ 1], m);
  reduce_sums_maxima(end, v, m, red + (g & 1) * NWARP * RW, tot);
  if constexpr (CL) cluster_tot(xc, end, tot);
  float inv[9];
  const int chosen = decide(tot, end, st.lg, inv, htv, uu, ch.mask, ch.chosen_out,
                            ch.probs_out, gb, ch.writer);
  // e of grid g + 1
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) st.e[j][c] = expf(st.L[PAR ^ 1][j][c] - tot[18 + j]);
  }
  if (!end) {
#pragma unroll
    for (int ij = 0; ij < 9; ++ij) st.sc[ij] = inv[ij];
  } else {
    switch (chosen) {
      case 0: collapse<0>(st, inv); break;
      case 1: collapse<1>(st, inv); break;
      case 2: collapse<2>(st, inv); break;
      case 3: collapse<3>(st, inv); break;
      case 4: collapse<4>(st, inv); break;
      default: collapse<5>(st, inv); break;
    }
  }
}

// Stages the chain's transition terms and block ends; returns chain b,
// whose block owns the columns k0 .. k0 + K_real - 1 of the real ones.
__device__ __forceinline__ Chain make_chain(
    const float* lemg, const float* beta, const float* trans, const float* ht, const float* u,
    const int* is_end, const float* perm_mask, int* chosen_out, float* probs_out, int G, int B,
    int K, int K_real, float invK, float* staged, int b, int k0 = 0, bool writer = true) {
  Chain ch;
  float* stay = staged;
  float* jump = staged + G;
  int* ends = reinterpret_cast<int*>(staged + 2 * G);
  for (int g = threadIdx.x; g < G; g += NT) {
    stay[g] = trans[g];
    jump[g] = (trans[G + g] + (g == 0 ? 1.f : 0.f)) * invK;
    ends[g] = is_end[(size_t)g * B + b];
  }
  ch.step = (size_t)B * K;
  ch.gstride = 3 * ch.step;
  ch.lemg = lemg + (size_t)b * K + k0;
  ch.beta = beta + (size_t)b * K + k0;
  ch.stay = stay;
  ch.jump = jump;
  ch.ends = ends;
  ch.ht = ht;
  ch.u = u;
  ch.chosen_out = chosen_out;
  ch.probs_out = probs_out;
  ch.G = G;
  ch.B = B;
  ch.b = b;
  ch.K_real = K_real;
  ch.writer = writer;
#pragma unroll
  for (int r = 0; r < 6; ++r) ch.mask[r] = perm_mask[r];
  return ch;
}

// The chain of the register form: NT threads, thread t owns the block's
// columns t + c*NT. CL: the block is rank blockIdx.x of chain blockIdx.y's
// cluster and owns the columns k0 = rank * KS .. k0 + KS - 1; each step's
// sums go through the cluster exchange, and rank 0 writes.
template <int CPT, bool CL>
__device__ __forceinline__ void bank_chain(
    const float* __restrict__ lemg, const float* __restrict__ beta,
    const float* __restrict__ trans, const float* __restrict__ ht,
    const float* __restrict__ u, const int* __restrict__ is_end,
    const float* __restrict__ perm_mask, int* __restrict__ chosen_out,
    float* __restrict__ probs_out, int G, int B, int K, int K_real, float invK, int KS,
    BankInbox* box) {
  extern __shared__ float4 smem4[];
  __shared__ float4 red4[2 * NWARP * RW / 4];
  float* red = reinterpret_cast<float*>(red4);
  BankExchange xc(box);
  const int k0 = CL ? blockIdx.x * KS : 0;
  if (CL && threadIdx.x == 0) xc.init();
  const Chain ch = make_chain(lemg, beta, trans, ht, u, is_end, perm_mask, chosen_out, probs_out,
                              G, B, K, CL ? max(0, min(KS, K_real - k0)) : K_real, invK,
                              reinterpret_cast<float*>(smem4), CL ? blockIdx.y : blockIdx.x, k0,
                              !CL || blockIdx.x == 0);
  Bank<CPT> st;
  st.lg = 0.f;
#pragma unroll
  for (int ij = 0; ij < 9; ++ij) {
    st.sc[ij] = 1.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) st.a[ij][c] = 0.f;
  }
  // grid 0's maxima by a reduction of its own (records of parity 1), grid 1
  // in flight; beta of grid 0 where a block ends there
  load_rows<CPT>(st.L[0], ch.lemg, ch.step, ch.K_real, -INFINITY);
  if (G > 1) load_rows<CPT>(st.L[1], ch.lemg + ch.gstride, ch.step, ch.K_real, -INFINITY);
  __syncthreads();                                        // the staged chain
  if constexpr (CL) cluster_xchg::cluster_sync_all();     // and every block's inbox
  if (ch.ends[0]) load_rows<CPT>(st.bt, ch.beta, ch.step, ch.K_real, 0.f);
  {
    float v[18] = {}, m[3], tot[21];
    row_max(st.L[0], m);
    reduce_sums_maxima(false, v, m, red + NWARP * RW, tot);
    if constexpr (CL) cluster_tot(xc, false, tot);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) st.e[j][c] = expf(st.L[0][j][c] - tot[18 + j]);
    }
  }
  for (int g = 0; g < G; g += 2) {
    reg_step<CPT, 0, CL>(st, ch, g, red, xc);
    if (g + 1 < G) reg_step<CPT, 1, CL>(st, ch, g + 1, red, xc);
  }
}

// One block of NT threads per chain.
template <int CPT>
__global__ void __launch_bounds__(NT, 1) nipt_bank_kernel(
    const float* __restrict__ lemg, const float* __restrict__ beta,
    const float* __restrict__ trans, const float* __restrict__ ht,
    const float* __restrict__ u, const int* __restrict__ is_end,
    const float* __restrict__ perm_mask, int* __restrict__ chosen_out,
    float* __restrict__ probs_out, int G, int B, int K, int K_real, float invK) {
  bank_chain<CPT, false>(lemg, beta, trans, ht, u, is_end, perm_mask, chosen_out, probs_out, G, B,
                         K, K_real, invK, 0, nullptr);
}

// The cluster form: one chain on a cluster of C blocks (grid (C, B)), each
// block a register form over its KS columns (a multiple of 4, at most
// NT * CPT), the 3G staged scalars in every block's shared memory.
template <int CPT>
__global__ void __launch_bounds__(NT, 1) nipt_bank_cluster_kernel(
    const float* __restrict__ lemg, const float* __restrict__ beta,
    const float* __restrict__ trans, const float* __restrict__ ht,
    const float* __restrict__ u, const int* __restrict__ is_end,
    const float* __restrict__ perm_mask, int* __restrict__ chosen_out,
    float* __restrict__ probs_out, int G, int B, int K, int K_real, float invK, int KS) {
  __shared__ BankInbox box;
  bank_chain<CPT, true>(lemg, beta, trans, ht, u, is_end, perm_mask, chosen_out, probs_out, G, B,
                        K, K_real, invK, KS, &box);
}

// ---- the general form: the bank in shared memory --------------------------
// GLOBAL (the global form, any K and G): the staged scalars and the bank in
// the chain's region of a global scratch plane, [B][r4(3G) + 9K] floats,
// where they do not fit a block's shared memory. Each thread touches only
// its own columns of the bank, so the same code serves both.

template <bool GLOBAL>
__global__ void __launch_bounds__(NT, 1) nipt_bank_general_kernel(
    const float* __restrict__ lemg, const float* __restrict__ beta,
    const float* __restrict__ trans, const float* __restrict__ ht,
    const float* __restrict__ u, const int* __restrict__ is_end,
    const float* __restrict__ perm_mask, int* __restrict__ chosen_out,
    float* __restrict__ probs_out, int G, int B, int K, int K_real, float invK,
    float* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  __shared__ float4 red4[2 * NWARP * RW / 4];
  float* red = reinterpret_cast<float*>(red4);
  float* staged = GLOBAL ? scratch + (size_t)blockIdx.x * (r4(3 * G) + 9 * (size_t)K)
                         : reinterpret_cast<float*>(smem4);
  float* bank = staged + r4(3 * G);                         // [9][K], row i*3 + j
  const Chain ch = make_chain(lemg, beta, trans, ht, u, is_end, perm_mask, chosen_out, probs_out,
                              G, B, K, K_real, invK, staged, blockIdx.x);
  const int tid = threadIdx.x;
  for (int c = tid; c < 9 * K; c += NT) bank[c] = 0.f;
  float sc[9], mx[3], lg = 0.f;
#pragma unroll
  for (int ij = 0; ij < 9; ++ij) sc[ij] = 1.f;
  __syncthreads();
  // the maxima of grid gn's rows over the thread's real columns
  auto grid_max = [&](int gn, float (&m)[3]) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m[j] = -INFINITY;
    if (gn >= G) return;
    const float* p = ch.lemg + (size_t)gn * ch.gstride;
    for (int k = tid; k < K_real; k += NT) {
#pragma unroll
      for (int j = 0; j < 3; ++j) m[j] = fmaxf(m[j], __ldg(p + j * ch.step + k));
    }
  };
  {
    float v[18] = {}, m[3], tot[21];
    grid_max(0, m);
    reduce_sums_maxima(false, v, m, red + NWARP * RW, tot);
#pragma unroll
    for (int j = 0; j < 3; ++j) mx[j] = tot[18 + j];
  }
  for (int g = 0; g < G; ++g) {
    const bool end = ch.ends[g] != 0;
    const float t0 = ch.stay[g], jp = ch.jump[g];
    const size_t gb = (size_t)g * B + ch.b;
    float htv[6], uu;
    load_block_end(ch, end, gb, htv, uu);
    const float* lg_g = ch.lemg + (size_t)g * ch.gstride;
    const float* bt_g = ch.beta + (size_t)g * ch.gstride;
    float f[9];
#pragma unroll
    for (int ij = 0; ij < 9; ++ij) f[ij] = __fmul_rn(t0, sc[ij]);
    float v[18];
#pragma unroll
    for (int q = 0; q < 18; ++q) v[q] = 0.f;
    for (int k = tid; k < K; k += NT) {
      float e[3], bt[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        e[j] = k < K_real ? expf(__ldg(lg_g + j * ch.step + k) - mx[j]) : 0.f;
        bt[j] = end && k < K_real ? __ldg(bt_g + j * ch.step + k) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int ij = i * 3 + j;
          float* p = bank + ij * K + k;
          const float a = __fmul_rn(e[j], __fadd_rn(__fmul_rn(f[ij], *p), jp));
          *p = a;
          v[ij] += a;
          if (end) v[9 + ij] = __fmaf_rn(a, bt[i], v[9 + ij]);
        }
      }
    }
    float m[3], tot[21];
    grid_max(g + 1, m);
    reduce_sums_maxima(end, v, m, red + (g & 1) * NWARP * RW, tot);
    float inv[9];
    const int chosen = decide(tot, end, lg, inv, htv, uu, ch.mask, ch.chosen_out,
                              ch.probs_out, gb, true);
#pragma unroll
    for (int j = 0; j < 3; ++j) mx[j] = tot[18 + j];
    if (!end) {
#pragma unroll
      for (int ij = 0; ij < 9; ++ij) sc[ij] = inv[ij];
    } else {
      // each thread collapses its own columns: no barrier
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int s = i * 3 + invs(chosen, i);
        for (int k = tid; k < K; k += NT) {
          const float x = bank[s * K + k];
#pragma unroll
          for (int j = 0; j < 3; ++j) bank[(i * 3 + j) * K + k] = x;
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) sc[i * 3 + j] = inv[s];
      }
    }
  }
}

// The floor of a bank step: `steps` reductions of a step without a block
// end (16 slots) by NT threads a block and nothing else.
__global__ void __launch_bounds__(NT, 1) nipt_bank_floor_kernel(float* out, int steps) {
  __shared__ float4 red4[2 * NWARP * RW / 4];
  float* red = reinterpret_cast<float*>(red4);
  float acc = 0.f;
  for (int i = 0; i < steps; ++i) {
    float w[16], tot[21];
#pragma unroll
    for (int q = 0; q < 16; ++q) w[q] = acc + q;
    reduce_step<16, 9, 12>(w, red + (i & 1) * NWARP * RW, tot);
    acc = (tot[0] + tot[20]) * 1e-9f;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// The floor of a cluster form's step: the same reductions, each followed by
// the cluster exchange of its 12 values, on clusters of C blocks.
__global__ void __launch_bounds__(NT, 1) nipt_bank_cluster_floor_kernel(float* out, int steps) {
  __shared__ float4 red4[2 * NWARP * RW / 4];
  __shared__ BankInbox box;
  float* red = reinterpret_cast<float*>(red4);
  BankExchange xc(&box);
  if (threadIdx.x == 0) xc.init();
  __syncthreads();
  cluster_xchg::cluster_sync_all();
  float acc = 0.f;
  for (int i = 0; i < steps; ++i) {
    float w[16], tot[21];
#pragma unroll
    for (int q = 0; q < 16; ++q) w[q] = acc + q;
    reduce_step<16, 9, 12>(w, red + (i & 1) * NWARP * RW, tot);
    cluster_tot(xc, false, tot);
    acc = (tot[0] + tot[20]) * 1e-9f;
  }
  if (threadIdx.x == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

}  // namespace

constexpr int ERR_INVALID = (int)cudaErrorInvalidValue;

namespace {

template <class Kern, class... Extra>
int launch(Kern kernel, int B, size_t smem, cudaStream_t st, const void* lemg,
           const void* beta, const void* trans, const void* ht, const void* u,
           const void* is_end, const void* perm_mask, void* chosen_out, void* probs_out, int G,
           int K, int K_real, float invK, Extra... extra) {
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute((const void*)kernel,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err) return err;
  }
  kernel<<<B, NT, smem, st>>>((const float*)lemg, (const float*)beta, (const float*)trans,
                              (const float*)ht, (const float*)u, (const int*)is_end,
                              (const float*)perm_mask, (int*)chosen_out, (float*)probs_out, G,
                              B, K, K_real, invK, extra...);
  return (int)cudaGetLastError();
}

}  // namespace

// The bank scan of B chains. cpt names the form (kernels/nipt_bank.py:
// bank_form chooses it, in the sweeps' codes): columns a thread in registers
// (2, 5 or 8, K <= 128 * cpt, the 3G staged scalars in shared memory), -1
// the general form (the bank and the staged scalars in shared memory), -2
// the global form (both in scratch, [B][r4(3G) + 9K] floats; scratch is
// unread otherwise), -3 the cluster form (CLUSTER_C blocks a chain, each
// a register form over KS = ceil(K / CLUSTER_C) columns rounded up to 4, at
// most 1,024; the 3G staged scalars in every block's shared memory). Each
// register form beats the next wider one and the general form where it holds
// K (chip_smoke.py's "bank forms" lines, 28 chains x 512 grids on the H100:
// at K = 256 <2> 0.563 ms, <5> 0.769, <8> 1.138, general 1.262; at K = 1,024
// <8> 1.174, general 3.019). Returns cudaErrorInvalidValue for a form
// without an instantiation or one whose shared memory exceeds a block's,
// cudaErrorInvalidConfiguration for a cluster the card cannot schedule.
extern "C" int nipt_bank(const void* lemg, const void* beta, const void* trans,
                         const void* ht, const void* u, const void* is_end,
                         const void* perm_mask, void* chosen_out, void* probs_out,
                         int G, int B, int K, int K_real, int cpt, float invK, void* scratch,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || B < 1 || K_real < 1 || K_real > K || (cpt > 0 && NT * cpt < K))
    return ERR_INVALID;
  const size_t staged = 4 * (size_t)r4(3 * G);
  if (cpt == -3) {
    if (staged > SMEM_LIMIT - 8192) return ERR_INVALID;
    const int KS = ((K + CLUSTER_C - 1) / CLUSTER_C + 3) & ~3;
#define BANK_CLUSTER(CPT_)                                                                       \
  cluster_xchg::launch_clusters(nipt_bank_cluster_kernel<CPT_>, CLUSTER_C, B, NT, staged, st,    \
                                (const float*)lemg, (const float*)beta, (const float*)trans,     \
                                (const float*)ht, (const float*)u, (const int*)is_end,           \
                                (const float*)perm_mask, (int*)chosen_out, (float*)probs_out, G, \
                                B, K, K_real, invK, KS)
    if (KS <= NT * 2) return BANK_CLUSTER(2);
    if (KS <= NT * 5) return BANK_CLUSTER(5);
    if (KS <= NT * 8) return BANK_CLUSTER(8);
#undef BANK_CLUSTER
    return ERR_INVALID;
  }
  if (cpt == -2) {
    if (scratch == nullptr) return ERR_INVALID;
    return launch(nipt_bank_general_kernel<true>, B, 0, st, lemg, beta, trans, ht, u, is_end,
                  perm_mask, chosen_out, probs_out, G, K, K_real, invK, (float*)scratch);
  }
  if (cpt == -1) {
    const size_t smem = staged + 4 * 9 * (size_t)K;
    if (smem > SMEM_LIMIT - 1024) return ERR_INVALID;
    return launch(nipt_bank_general_kernel<false>, B, smem, st, lemg, beta, trans, ht, u,
                  is_end, perm_mask, chosen_out, probs_out, G, K, K_real, invK,
                  (float*)nullptr);
  }
  if (staged > SMEM_LIMIT - 4096) return ERR_INVALID;
#define BANK(CPT_)                                                                          \
  launch(nipt_bank_kernel<CPT_>, B, staged, st, lemg, beta, trans, ht, u, is_end, perm_mask, \
         chosen_out, probs_out, G, K, K_real, invK)
  switch (cpt) {
    case 2: return BANK(2);
    case 5: return BANK(5);
    case 8: return BANK(8);
    default: return ERR_INVALID;
  }
#undef BANK
}

// `steps` reductions of a bank step in each of B blocks.
extern "C" int nipt_bank_floor(void* out, int B, int steps, void* stream) {
  nipt_bank_floor_kernel<<<B, NT, 0, (cudaStream_t)stream>>>((float*)out, steps);
  return (int)cudaGetLastError();
}

// `steps` of the cluster form's steps (the reduction, then the exchange) in
// each of B clusters of CLUSTER_C blocks; out [B * CLUSTER_C] floats.
extern "C" int nipt_bank_cluster_floor(void* out, int B, int steps, void* stream) {
  return cluster_xchg::launch_clusters(nipt_bank_cluster_floor_kernel, CLUSTER_C, B, NT, 0,
                                       (cudaStream_t)stream, (float*)out, steps);
}
