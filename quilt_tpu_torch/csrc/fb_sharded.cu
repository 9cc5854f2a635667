// The segment-fused full-panel FB of one panel shard: the kernels a
// segment of L = 8 grids of the panel-sharded FB (kernels/fb_sharded.py,
// which holds the algebra, the plain versions and the exchanges).
//
// No Pallas kernel is their counterpart: they replace the XLA body
// quilt_tpu/kernels/fb_full.py:_fb_core_segmented (:440), which the JAX
// package runs under shard_map over the mesh's panel axis
// (quilt_tpu/dist/mesh.py:ShardedFB). A call runs, on each shard,
// seg_fwd_local once, seg_fwd_step once a segment, seg_bwd_local once and
// seg_bwd_step once a segment, an exchange of the local sums between each
// launch and the next:
//   seg_fwd_local <- fwd_seg's local reductions of the first segment: h_i =
//                    sum_k R(0,i) a0 and P(l,i) = sum_k R(l,i), R(l,i) =
//                    T_l ... T_i, T = stay e;
//   seg_fwd_step  <- fwd_seg's mass solve M_1..M_L and reconstruction of
//                    segment c, then the local reductions of segment c + 1
//                    from its last alpha, held in a register: of the
//                    segment's alphas only that last one is stored (the
//                    checkpoint plane), with the solve's c_l M_l and M_{i+1}
//                    (the scalar plane) and log M_L;
//   seg_bwd_local <- bwd_seg's local reductions q_j, NR, Qr(j,l) of the last
//                    segment;
//   seg_bwd_step  <- bwd_seg's mass solve N_j and reconstruction B_j of
//                    segment c; its alphas rebuilt from checkpoint c - 1 and
//                    the scalar plane by the forward's own code (seg_alphas),
//                    so bit for bit; of the gamma numerators alpha_j B_j
//                    (scaled by M_{j+1} / M_L, gamma_scale):
//                    their sum and bit-masked sums (the dosage), the K_top
//                    largest at thinned grids (global indices, lowest first
//                    on ties), the capture; the carry B_0 / N_0 (N_0 = sum_k
//                    e_0 B_0, from the solve: no exchange of its own); then
//                    the local reductions of segment c - 1 from that carry,
//                    held in a register. The gamma normalisers wait for the
//                    one exchange at the end of the call.
// The previous form, kept for timing only (kernels/fb_sharded.py
// sharded_core(_prev=True)), ran seg_fwd_local / seg_bwd_local at every
// segment beside seg_fwd_apply / seg_bwd_apply, every alpha kept in a
// [Gp, B, K_shard] plane.
//
// What bounds them on the H100: a launch reads the segment's panel words
// and one or two [B, K_shard] planes and writes at most one; per (row,
// haplotype) it does 8-17 emission logits (8 table lookups and 7 adds
// each), as many exps and ~100-200 products and sums, ~10 operations a byte
// moved, under the card's ~20 float32 operations a byte of HBM: bytes bound
// at the QUILT1 shape, with the reductions' shuffles and barriers on top.
//
// Design: one 512-thread block a (tile of TILE = 512 haplotypes, row), one
// thread a haplotype, so B x ceil(K_shard / 512) blocks (280 at the dist
// path's 56 rows x 2,560). The grids' emission tables of both segments a
// step touches are staged in shared memory at once (fb_common.cuh
// stage_chunk / logit: the plain version's _tile_logits bit for bit). The
// scalar solve runs on thread 0 while the other warps compute their
// emissions. A step's sums leave the per-grid barrier chain: each warp
// reduces its values with transposing butterflies (lane l keeps the sum of
// value l: 31 shuffles for 32 values), the 8 grids' 33 gamma sums and the
// next segment's local sums together, writes one record to shared memory,
// and after the segment's one barrier the records are added in warp order
// into the tile's partial. Top-K at a thinned grid is built per warp
// (__reduce_max_sync and a ballot a round, no barrier) and the 16 warps'
// sorted lists are merged once, past that barrier, by one warp a grid. The
// tiles' partials are summed by a torch reduction and the shards' in the
// group's shard order, so two launches give the same bits (no float
// atomics). Products and sums that mirror the plain version are written with
// the _rn intrinsics, which the compiler does not contract into fused
// multiply-adds, so kernel and plain version part only by the order of the
// sums over haplotypes.
#include <cuda_runtime.h>

#include "fb_common.cuh"

namespace {

constexpr int L = 8;
constexpr int TILE = NT;
constexpr int NTRI = L * (L + 1) / 2;
constexpr int FWD_V = L + NTRI;           // h, P
constexpr int BWD_V = L + 1 + NTRI;       // q, NR, Qr
constexpr int GRID_V = 33;                // a grid's 32 bit-masked gamma sums, then its sum
constexpr int REC_V = L * GRID_V + BWD_V; // a warp's record in seg_bwd_step
// the floor of the masses and normalisers: float32's least normal value (a
// segment's masses are products of up to 8 grids' and fall below 1e-30, the
// JAX body's floor, with every SNP informative at K = 16,384)
constexpr float TINY = 1.17549435e-38f;
constexpr int MAX_KTOP = 32;
constexpr int ERR_INVALID = (int)cudaErrorInvalidValue;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float MUL(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float ADD(float a, float b) { return __fadd_rn(a, b); }

// Position of (l, i), l <= i, in the l-major list of pairs.
__host__ __device__ constexpr int tri(int l, int i) { return l * L - l * (l - 1) / 2 + (i - l); }

// Sums each of the V values over the block; thread i < V writes the sum of
// value i to out[i]. Warp butterflies, then the warps' records in order
// (the local passes').
template <int V>
__device__ __forceinline__ void block_sums(float (&v)[V], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    if (lane == 0) red[warp * V + i] = x;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float r = red[threadIdx.x];
    for (int w = 1; w < NWARP; ++w) r += red[w * V + threadIdx.x];
    out[threadIdx.x] = r;
  }
}

// ---- transposing warp sums ------------------------------------------------

// One round on lane bit O: lanes with the bit set keep the upper half of
// v[0 .. 2 O), the others the lower half, each adding its partner's copy.
template <int O, int N>
__device__ __forceinline__ void tround(float (&v)[N], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? v[j] : v[j + O];
    const float keep = upper ? v[j + O] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// Lane l ends with the warp's sum of v[l & (P - 1)] in v[0] (P a power of
// two up to 32: P - 1 shuffles, then one a remaining lane bit).
template <int P, int N>
__device__ __forceinline__ void warp_tsum(float (&v)[N], int lane) {
  static_assert(P <= N && P <= 32 && (P & (P - 1)) == 0, "P: a power of two <= 32");
  if constexpr (P >= 32) tround<16>(v, lane);
  if constexpr (P >= 16) tround<8>(v, lane);
  if constexpr (P >= 8) tround<4>(v, lane);
  if constexpr (P >= 4) tround<2>(v, lane);
  if constexpr (P >= 2) tround<1>(v, lane);
#pragma unroll
  for (int o = P; o < 32; o <<= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
}

// The warp's sums of v[O .. V) into rec[O .. V): chunks of 32 values, the
// last padded to a power of two.
template <int V, int O = 0>
__device__ __forceinline__ void warp_sums(const float (&v)[V], float* rec, int lane) {
  constexpr int R = V - O < 32 ? V - O : 32;
  constexpr int P = R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32;
  float x[P];
#pragma unroll
  for (int j = 0; j < P; ++j) x[j] = j < R ? v[O + j] : 0.f;
  warp_tsum<P>(x, lane);
  if (lane < R) rec[O + lane] = x[0];
  if constexpr (O + 32 < V) warp_sums<V, O + 32>(v, rec, lane);
}

// block_sums by transposing warp sums: one record a warp, one barrier,
// the records added in warp order.
template <int V>
__device__ __forceinline__ void block_sums_t(const float (&v)[V], float* rec, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sums(v, rec + warp * V, lane);
  __syncthreads();
  if (threadIdx.x < V) {
    float r = rec[threadIdx.x];
    for (int w = 1; w < NWARP; ++w) r += rec[w * V + threadIdx.x];
    out[threadIdx.x] = r;
  }
}

// ---- the segment's algebra ------------------------------------------------

// The emissions e[0..n) of this thread's haplotype k at grids g0 .. g0+n-1
// from the staged tables em (grid g0 + j at em + j * EMF): exp(logit - mx),
// 0 past the shard's K_loc.
template <int N>
__device__ __forceinline__ void emissions(const unsigned* __restrict__ words,
                                          const float* __restrict__ mx, const float* em,
                                          int g0, int n, int KS, int B, int b, int k, int K_loc,
                                          float (&e)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    e[j] = 0.f;
    if (j < n && k < K_loc) {
      const float x = logit(__ldg(words + (size_t)(g0 + j) * KS + k), em, j);
      e[j] = expf(x - __ldg(mx + (size_t)(g0 + j) * B + b));
    }
  }
}

// The forward's lower-triangular mass solve of the segment at g0 from the
// summed sums sv (M_0 = 1: a0 enters normalised): cm[l] = c_l M_l and
// M[i] = M_{i+1}.
__device__ __forceinline__ void fwd_solve(const float* __restrict__ trans2, int Gp, int g0, int K,
                                          const float* sv, float* cm, float* M) {
  float cl[L], Mr[L + 1];
  Mr[0] = 1.f;
  for (int l = 0; l < L; ++l)
    cl[l] = __fdiv_rn(trans2[Gp + g0 + l], MUL((float)K, fmaxf(trans2[g0 + l], TINY)));
  for (int i = 0; i < L; ++i) {
    float acc = sv[i];
    for (int l = 0; l <= i; ++l) acc = ADD(acc, MUL(MUL(cl[l], Mr[l]), sv[L + tri(l, i)]));
    Mr[i + 1] = acc;
  }
  for (int l = 0; l < L; ++l) cm[l] = MUL(cl[l], Mr[l]);
  for (int i = 0; i < L; ++i) M[i] = Mr[i + 1];
}

// The segment's alphas from its entering alpha a0 and the solve's scalars:
// alpha_i = (R(0,i) a0 + sum_{l<=i} cm_l R(l,i)) / max(M_i, TINY). The
// forward and the backward's rebuild run this same code on the same
// inputs, so the rebuilt alphas are the forward's bit for bit.
__device__ __forceinline__ void seg_alphas(const float (&e)[L], const float* __restrict__ trans2,
                                           int g0, float a0, const float* cm, const float* M,
                                           float (&a)[L]) {
  float Rl[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float Ti = MUL(__ldg(trans2 + g0 + i), e[i]);
#pragma unroll
    for (int l = 0; l < i; ++l) Rl[l] = MUL(Rl[l], Ti);
    Rl[i] = Ti;
    float A = MUL(Rl[0], a0);
#pragma unroll
    for (int l = 0; l <= i; ++l) A = ADD(A, MUL(cm[l], Rl[l]));
    a[i] = __fdiv_rn(A, fmaxf(M[i], TINY));
  }
}

// The forward's local sums of a segment entered with a0: h_0..h_7, then
// P(l, i) l-major.
__device__ __forceinline__ void fwd_local_vals(const float (&e)[L], const float* __restrict__ trans2,
                                               int g0, float a0, float (&v)[FWD_V]) {
  float T[L];
#pragma unroll
  for (int i = 0; i < L; ++i) T[i] = MUL(__ldg(trans2 + g0 + i), e[i]);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float U = T[l];
    v[L + tri(l, l)] = U;
    if (l == 0) v[0] = MUL(U, a0);
#pragma unroll
    for (int i = l + 1; i < L; ++i) {
      U = MUL(U, T[i]);
      v[L + tri(l, i)] = U;
      if (l == 0) v[i] = MUL(U, a0);
    }
  }
}

// The backward's per-haplotype terms of a segment: e_j, e_R, T_j = stay_{j+1}
// e_{j+1}; at the last segment e_R = 1 and the next grid's stay 1.
struct BwdTerms {
  float e[L], eR, T[L];
};

// From the emissions of the segment's grids and (not last) the grid right
// of it.
__device__ __forceinline__ void bwd_terms(const float (&e9)[L + 1], const float* __restrict__ trans2,
                                          int g0, bool last, bool in_shard, BwdTerms& s) {
#pragma unroll
  for (int j = 0; j < L; ++j) s.e[j] = e9[j];
  s.eR = last ? (in_shard ? 1.f : 0.f) : e9[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool edge = j == L - 1;
    const float t0 = edge ? (last ? 1.f : __ldg(trans2 + g0 + L)) : __ldg(trans2 + g0 + j + 1);
    s.T[j] = MUL(t0, edge ? s.eR : e9[j + 1]);
  }
}

__device__ __forceinline__ float next_jump(const float* trans2, int Gp, int g0, int j, bool last) {
  if (j == L - 1) return last ? 0.f : trans2[Gp + g0 + L];
  return trans2[Gp + g0 + j + 1];
}

// The backward's local sums from the carry bR: q_0..q_7, NR, Qr(j, l) j-major.
__device__ __forceinline__ void bwd_local_vals(const BwdTerms& s, float bR, float (&v)[BWD_V]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float U = s.T[j];
    v[L + 1 + tri(j, j)] = s.e[j];
#pragma unroll
    for (int l = j + 1; l < L; ++l) {
      v[L + 1 + tri(j, l)] = MUL(s.e[j], U);
      U = MUL(U, s.T[l]);
    }
    v[j] = MUL(MUL(s.e[j], U), bR);
  }
  v[L] = MUL(s.eR, bR);
}

// The descending mass solve: cbN[l] = cb_l N_{l+1}, *N0 = max(N_0, TINY).
__device__ __forceinline__ void bwd_solve(const float* __restrict__ trans2, int Gp, int g0, int K,
                                          bool last, const float* sv, float* cbN, float* N0) {
  float cb[L], N[L + 1];
  for (int l = 0; l < L; ++l) cb[l] = __fdiv_rn(next_jump(trans2, Gp, g0, l, last), (float)K);
  N[L] = sv[L];
  for (int j = L - 1; j >= 0; --j) {
    float acc = sv[j];
    for (int l = j; l < L; ++l) acc = ADD(acc, MUL(MUL(cb[l], N[l + 1]), sv[L + 1 + tri(j, l)]));
    N[j] = acc;
  }
  for (int l = 0; l < L; ++l) cbN[l] = MUL(cb[l], N[l + 1]);
  *N0 = fmaxf(N[0], TINY);
}

// The scale of grid j's gamma numerators, M_{j+1} / M_L from the
// forward's scalars M[i] = M_{i+1}: alpha_j B_j sums to Z / M_{j+1} over the
// panel (Z the segment's own mass, the same at every grid), so the scaled
// numerators sum to Z / M_L = sum_k alpha_{L-1} B_{L-1} >= jump_R / K at
// every grid of the segment. Unscaled, that sum is the product of up to 7
// grids' masses and can fall below float32's range (below 1e-30 at K =
// 98,304 with every SNP informative). A per-(row, grid) factor, the same on
// every shard: the outputs, normalised at the end of the call, do not move.
__device__ __forceinline__ void gamma_scale(const float* M, float* s) {
  const float ML = fmaxf(M[L - 1], TINY);
  for (int j = 0; j < L; ++j) s[j] = __fdiv_rn(fmaxf(M[j], TINY), ML);
}

// B_j = Rb(j, L-1) bn + cbN_j + sum_{l>j} cbN_l Rb(j, l-1), in the plain
// version's order.
__device__ __forceinline__ void bwd_B(const BwdTerms& s, float bn, const float* cbN,
                                      float (&Bv)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float u[L];   // u[m] = Rb(j, m), m >= j
#pragma unroll
    for (int m = 0; m < L; ++m)
      u[m] = m == j ? s.T[j] : (m > j ? MUL(u[m > 0 ? m - 1 : 0], s.T[m]) : 0.f);
    float Bj = ADD(MUL(u[L - 1], bn), cbN[j]);
#pragma unroll
    for (int l = j + 1; l < L; ++l) Bj = ADD(Bj, MUL(cbN[l], u[l - 1]));
    Bv[j] = Bj;
  }
}

// ---- the path's kernels ---------------------------------------------------

// part [B, nt, FWD_V]; a0 [B, KS] the alpha entering the segment (null: 0).
__global__ void __launch_bounds__(NT) seg_fwd_local_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx,
    const float* __restrict__ a0p, float* __restrict__ part, int Gp, int KS, int B, int K_loc,
    int c) {
  __shared__ float dls_s[L * 32];
  __shared__ float em[L * EMF];
  __shared__ float red[NWARP * FWD_V];
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  stage_chunk(dl + (size_t)b * Gp * 32, g0, L, dls_s, em);
  float e[L], v[FWD_V];
  emissions(words, mx, em, g0, L, KS, B, b, k, K_loc, e);
  const float a0 = (a0p != nullptr && k < KS) ? a0p[(size_t)b * KS + k] : 0.f;
  fwd_local_vals(e, trans2, g0, a0, v);
  block_sums(v, red, part + ((size_t)b * gridDim.x + t) * FWD_V);
}

// Segment c from the summed sums tot [B, FWD_V]: the solve, the alphas (the
// last into ckpt[c], all into aout [L, B, KS] where given), the scalars
// into scal[c], log M_L into logm[c]; then, below the last segment, the
// local sums of segment c + 1 into part.
__global__ void __launch_bounds__(NT) seg_fwd_step_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx, const float* __restrict__ tot,
    float* __restrict__ ckpt, float* __restrict__ scal, float* __restrict__ logm,
    float* __restrict__ part, float* __restrict__ aout, int Gp, int KS, int B, int K_loc, int K,
    int c) {
  __shared__ float dls_s[2 * L * 32];
  __shared__ float em[2 * L * EMF];
  __shared__ float sv[FWD_V];
  __shared__ float cm_s[L], M_s[L];
  __shared__ float rec[NWARP * FWD_V];
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  const bool nxt = c + 1 < Gp / L;
  const size_t plane = (size_t)B * KS, at = (size_t)b * KS + k;
  if (threadIdx.x < FWD_V) sv[threadIdx.x] = tot[(size_t)b * FWD_V + threadIdx.x];
  stage_chunk(dl + (size_t)b * Gp * 32, g0, nxt ? 2 * L : L, dls_s, em);   // ends with a barrier
  if (threadIdx.x == 0) {
    fwd_solve(trans2, Gp, g0, K, sv, cm_s, M_s);
    if (t == 0) {
      float* sc = scal + ((size_t)c * B + b) * 2 * L;
      for (int i = 0; i < L; ++i) {
        sc[i] = cm_s[i];
        sc[L + i] = M_s[i];
      }
      if (logm != nullptr) logm[(size_t)c * B + b] = logf(fmaxf(M_s[L - 1], TINY));
    }
  }
  float e[L];
  emissions(words, mx, em, g0, L, KS, B, b, k, K_loc, e);
  const float a0 = (c > 0 && k < KS) ? ckpt[(size_t)(c - 1) * plane + at] : 0.f;
  __syncthreads();
  float a[L];
  seg_alphas(e, trans2, g0, a0, cm_s, M_s, a);
  if (k < KS) {
    ckpt[(size_t)c * plane + at] = a[L - 1];
    if (aout != nullptr) {
#pragma unroll
      for (int i = 0; i < L; ++i) aout[i * plane + at] = a[i];
    }
  }
  if (!nxt) return;
  float en[L], v[FWD_V];
  emissions(words, mx, em + L * EMF, g0 + L, L, KS, B, b, k, K_loc, en);
  fwd_local_vals(en, trans2, g0 + L, k < KS ? a[L - 1] : 0.f, v);
  block_sums_t(v, rec, part + ((size_t)b * gridDim.x + t) * FWD_V);
}

// part [B, nt, BWD_V]; beta [B, KS] the carry (ones at the last segment).
__global__ void __launch_bounds__(NT) seg_bwd_local_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx,
    const float* __restrict__ beta, float* __restrict__ part, int Gp, int KS, int B, int K_loc,
    int c) {
  __shared__ float dls_s[(L + 1) * 32];
  __shared__ float em[(L + 1) * EMF];
  __shared__ float red[NWARP * BWD_V];
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  const bool last = c == Gp / L - 1;
  stage_chunk(dl + (size_t)b * Gp * 32, g0, last ? L : L + 1, dls_s, em);
  float e9[L + 1];
  emissions(words, mx, em, g0, last ? L : L + 1, KS, B, b, k, K_loc, e9);
  BwdTerms s;
  bwd_terms(e9, trans2, g0, last, k < KS, s);
  const float bR = k < KS ? beta[(size_t)b * KS + k] : 0.f;
  float v[BWD_V];
  bwd_local_vals(s, bR, v);
  block_sums(v, red, part + ((size_t)b * gridDim.x + t) * BWD_V);
}

// Segment c from the summed sums tot [B, BWD_V] and the carry beta (left
// as B_0 / N_0): the gamma numerators' per-tile sums into gnp / dpart, the
// tile's top-K lists into tvp / tip, the capture into gcap, the rebuilt
// alphas into aout [L, B, KS] where given; then, above the first segment,
// the local sums of segment c - 1 into part. Dynamic shared memory: the
// warps' top-K lists, NWARP x L x K_top keys and as many lanes.
__global__ void __launch_bounds__(NT) seg_bwd_step_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx,
    const float* __restrict__ ckpt, const float* __restrict__ scal,
    const float* __restrict__ tot, const int* __restrict__ thin, float* __restrict__ beta,
    float* __restrict__ part, float* __restrict__ dpart, float* __restrict__ gnp,
    float* __restrict__ tvp, int* __restrict__ tip, float* __restrict__ gcap,
    float* __restrict__ aout, int Gp, int KS, int B, int K_loc, int K, int k0, int K_top,
    int cap_grid, int c) {
  extern __shared__ unsigned tops[];
  __shared__ float dls_s[(2 * L + 1) * 32];
  __shared__ float em[(2 * L + 1) * EMF];
  __shared__ float sv[BWD_V];
  __shared__ float fsc[2 * L];   // the forward's c_l M_l and M_{i+1} of the segment
  __shared__ float cbN_s[L], gsc_s[L];
  __shared__ float N0_s;
  __shared__ float rec[NWARP * REC_V];
  unsigned* tk = tops;                                      // [NWARP][L][K_top] keys
  int* tl = (int*)(tops + NWARP * L * K_top);               // their lanes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  const int S = Gp * 32;
  const bool last = c == Gp / L - 1, prv = c > 0;
  // staged: segment c - 1's grids, then segment c's and the grid right of it
  const int off = prv ? L : 0;
  const size_t plane = (size_t)B * KS, at = (size_t)b * KS + k;
  if (threadIdx.x < BWD_V) sv[threadIdx.x] = tot[(size_t)b * BWD_V + threadIdx.x];
  else if (threadIdx.x < BWD_V + 2 * L)
    fsc[threadIdx.x - BWD_V] = scal[((size_t)c * B + b) * 2 * L + threadIdx.x - BWD_V];
  stage_chunk(dl + (size_t)b * S, g0 - off, off + (last ? L : L + 1), dls_s, em);
  if (threadIdx.x == 0) {
    bwd_solve(trans2, Gp, g0, K, last, sv, cbN_s, &N0_s);
    gamma_scale(fsc + L, gsc_s);
  }
  float e9[L + 1];
  emissions(words, mx, em + off * EMF, g0, last ? L : L + 1, KS, B, b, k, K_loc, e9);
  const float a0 = (prv && k < KS) ? ckpt[(size_t)(c - 1) * plane + at] : 0.f;
  const float bn = k < KS ? beta[at] : 0.f;
  __syncthreads();
  float gam[L], carry;
  {
    BwdTerms s;
    bwd_terms(e9, trans2, g0, last, k < KS, s);
    float a[L], Bv[L];
    seg_alphas(s.e, trans2, g0, a0, fsc, fsc + L, a);
    bwd_B(s, bn, cbN_s, Bv);
    carry = __fdiv_rn(Bv[0], N0_s);
#pragma unroll
    for (int j = 0; j < L; ++j) gam[j] = MUL(MUL(a[j], Bv[j]), gsc_s[j]);
    if (k < KS) {
      beta[at] = carry;
      if (aout != nullptr) {
#pragma unroll
        for (int j = 0; j < L; ++j) aout[j * plane + at] = a[j];
      }
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (g0 + j == cap_grid) gcap[at] = gam[j];
    }
  }
  float* rw = rec + warp * REC_V;
  // each grid's 32 bit-masked gamma sums, then the 8 grids' gamma sums
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const unsigned w = k < KS ? __ldg(words + (size_t)(g0 + j) * KS + k) : 0u;
    float x[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) x[q] = ((w >> q) & 1u) ? gam[j] : 0.f;
    warp_tsum<32>(x, lane);
    rw[j * GRID_V + lane] = x[0];
  }
  {
    float x[L];
#pragma unroll
    for (int j = 0; j < L; ++j) x[j] = gam[j];
    warp_tsum<L>(x, lane);
    if (lane < L) rw[lane * GRID_V + 32] = x[0];
  }
  // the warp's K_top largest at each thinned grid, as sortable keys: a real
  // haplotype's gamma bits + 2, a pad 1, one already taken 0; the lowest
  // lane first among equal keys
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (__ldg(thin + g0 + j) < 0) continue;
    unsigned key = k < K_loc ? __float_as_uint(gam[j]) + 2u : 1u, mk = 0u;
    int ml = 0;
    for (int r = 0; r < K_top; ++r) {
      const unsigned m = __reduce_max_sync(FULL, key);
      const int src = __ffs(__ballot_sync(FULL, key == m)) - 1;
      if (lane == r) {
        mk = m;
        ml = src;
      }
      if (lane == src) key = 0u;
    }
    if (lane < K_top) {
      tk[(warp * L + j) * K_top + lane] = mk;
      tl[(warp * L + j) * K_top + lane] = ml;
    }
  }
  // segment c - 1's local sums from the carry
  if (prv) {
    float ep[L + 1];
    emissions(words, mx, em, g0 - L, L, KS, B, b, k, K_loc, ep);
    ep[L] = e9[0];
    BwdTerms sp;
    bwd_terms(ep, trans2, g0 - L, false, k < KS, sp);
    float v[BWD_V];
    bwd_local_vals(sp, k < KS ? carry : 0.f, v);
    warp_sums(v, rw + L * GRID_V, lane);
  }
  __syncthreads();
  // the warps' records, added in warp order
  if (threadIdx.x < (prv ? REC_V : L * GRID_V)) {
    const int i = threadIdx.x;
    float r = rec[i];
    for (int w = 1; w < NWARP; ++w) r += rec[w * REC_V + i];
    if (i < L * GRID_V) {
      const int g = g0 + i / GRID_V, q = i % GRID_V;
      if (q < 32) dpart[((size_t)t * B + b) * S + (size_t)g * 32 + q] = r;
      else gnp[((size_t)t * Gp + g) * B + b] = r;
    } else {
      part[((size_t)b * gridDim.x + t) * BWD_V + i - L * GRID_V] = r;
    }
  }
  // the warps' lists merged by warp j for grid j: lane w < NWARP holds the
  // head of warp w's list; equal keys go to the lowest warp, which holds
  // the lowest indices
  if (warp < L) {
    const int g = g0 + warp;
    const size_t o = (((size_t)t * Gp + g) * B + b) * K_top;
    if (__ldg(thin + g) >= 0) {
      int p = 0;
      for (int r = 0; r < K_top; ++r) {
        const bool has = lane < NWARP && p < K_top;
        const int h = (lane * L + warp) * K_top + p;
        const unsigned key = has ? tk[h] : 0u;
        const unsigned m = __reduce_max_sync(FULL, key);
        const int src = __ffs(__ballot_sync(FULL, key == m)) - 1;
        const int wl = __shfl_sync(FULL, has ? tl[h] : 0, src);
        if (lane == 0) {
          tvp[o + r] = m >= 2u ? __uint_as_float(m - 2u) : 0.f;
          tip[o + r] = m >= 2u ? k0 + t * TILE + src * 32 + wl : 0;
        }
        if (lane == src) ++p;
      }
    } else if (lane < K_top) {
      tvp[o + lane] = 0.f;
      tip[o + lane] = 0;
    }
  }
}

// ---- the previous form's apply passes (timing only) -----------------------

// tot [B, FWD_V]; a0 [B, KS] (null: 0); writes the segment's alphas into
// alphas [L, B, KS] and log M_L into logm[c] where given.
__global__ void __launch_bounds__(NT) seg_fwd_apply_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx, const float* __restrict__ tot,
    const float* __restrict__ a0p, float* __restrict__ alphas, float* __restrict__ logm, int Gp,
    int KS, int B, int K_loc, int K, int c) {
  __shared__ float dls_s[L * 32];
  __shared__ float em[L * EMF];
  __shared__ float sv[FWD_V];
  __shared__ float M_s[L], cm_s[L];
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  if (threadIdx.x < FWD_V) sv[threadIdx.x] = tot[(size_t)b * FWD_V + threadIdx.x];
  stage_chunk(dl + (size_t)b * Gp * 32, g0, L, dls_s, em);   // ends with a barrier
  if (threadIdx.x == 0) {
    fwd_solve(trans2, Gp, g0, K, sv, cm_s, M_s);
    if (logm != nullptr && t == 0) logm[(size_t)c * B + b] = logf(fmaxf(M_s[L - 1], TINY));
  }
  __syncthreads();
  float e[L], a[L];
  emissions(words, mx, em, g0, L, KS, B, b, k, K_loc, e);
  const float a0 = (a0p != nullptr && k < KS) ? a0p[(size_t)b * KS + k] : 0.f;
  seg_alphas(e, trans2, g0, a0, cm_s, M_s, a);
  if (k < KS) {
#pragma unroll
    for (int i = 0; i < L; ++i) alphas[((size_t)i * B + b) * KS + k] = a[i];
  }
}

// tot [B, BWD_V]; alphas [L, B, KS] the segment's; a grid at a time, each
// behind block reductions.
__global__ void __launch_bounds__(NT) seg_bwd_apply_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx,
    const float* __restrict__ alphas, const float* __restrict__ tot, const int* __restrict__ thin,
    float* __restrict__ beta, float* __restrict__ dpart, float* __restrict__ gnp,
    float* __restrict__ tvp, int* __restrict__ tip, float* __restrict__ gcap, int Gp, int KS,
    int B, int K_loc, int K, int k0, int K_top, int cap_grid, int c) {
  __shared__ float dls_s[(L + 1) * 32];
  __shared__ float em[(L + 1) * EMF];
  __shared__ float sv[BWD_V];
  __shared__ float cbN_s[L];
  __shared__ float N0_s;
  __shared__ float red[NWARP * 32];
  __shared__ float rv[NWARP];
  __shared__ int ri[NWARP];
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  const int S = Gp * 32;
  const bool last = c == Gp / L - 1;
  if (threadIdx.x < BWD_V) sv[threadIdx.x] = tot[(size_t)b * BWD_V + threadIdx.x];
  stage_chunk(dl + (size_t)b * Gp * 32, g0, last ? L : L + 1, dls_s, em);
  if (threadIdx.x == 0) bwd_solve(trans2, Gp, g0, K, last, sv, cbN_s, &N0_s);
  __syncthreads();
  float e9[L + 1];
  emissions(words, mx, em, g0, last ? L : L + 1, KS, B, b, k, K_loc, e9);
  BwdTerms s;
  bwd_terms(e9, trans2, g0, last, k < KS, s);
  const float bn = k < KS ? beta[(size_t)b * KS + k] : 0.f;
  const bool do_cap = cap_grid >= g0 && cap_grid < g0 + L;
  float B0 = 0.f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int g = g0 + j;
    float u[L];   // u[m] = Rb(j, m), m >= j
#pragma unroll
    for (int m = 0; m < L; ++m)
      u[m] = m == j ? s.T[j] : (m > j ? MUL(u[m > 0 ? m - 1 : 0], s.T[m]) : 0.f);
    float Bj = ADD(MUL(u[L - 1], bn), cbN_s[j]);
#pragma unroll
    for (int l = j + 1; l < L; ++l) Bj = ADD(Bj, MUL(cbN_s[l], u[l - 1]));
    if (j == 0) B0 = Bj;
    const float a = k < KS ? alphas[((size_t)j * B + b) * KS + k] : 0.f;
    const float gam = MUL(a, Bj);
    // the normaliser's and the dosage's partial sums of this tile
    const float gs = block_reduce(gam, red, SumOp());
    if (threadIdx.x == 0) gnp[((size_t)t * Gp + g) * B + b] = gs;
    const unsigned w = k < KS ? __ldg(words + (size_t)g * KS + k) : 0u;
    float v[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) v[q] = ((w >> q) & 1u) ? gam : 0.f;
    const float ds = block_reduce32(v, red);
    if (threadIdx.x < 32) dpart[((size_t)t * B + b) * S + (size_t)g * 32 + threadIdx.x] = ds;
    // this tile's K_top largest at a thinned grid
    const size_t o = (((size_t)t * Gp + g) * B + b) * K_top;
    if (__ldg(thin + g) >= 0) {
      float wv = k < K_loc ? gam : -1.f;
      for (int r = 0; r < K_top; ++r) {
        float bv = wv;
        int bi = threadIdx.x;
        block_argmax(bv, bi, rv, ri);
        if (threadIdx.x == 0) {
          tvp[o + r] = bv >= 0.f ? bv : 0.f;
          tip[o + r] = bv >= 0.f ? k0 + t * TILE + bi : 0;
        }
        if (threadIdx.x == bi) wv = -2.f;
      }
    } else if (threadIdx.x < K_top) {
      tvp[o + threadIdx.x] = 0.f;
      tip[o + threadIdx.x] = 0;
    }
    if (do_cap && g == cap_grid && k < KS) gcap[(size_t)b * KS + k] = gam;
  }
  if (k < KS) beta[(size_t)b * KS + k] = __fdiv_rn(B0, N0_s);
}

// ---- the seg step split (timing only) -------------------------------------

// `steps` repetitions, in every block of a segment kernel's launch shape,
// of one piece of a segment kernel's work and nothing else (WHICH: 0 the
// previous backward apply's per-grid gamma reductions, block_reduce and
// block_reduce32; 1 one block_argmax round; 2 thread 0's backward mass
// solve and the barrier behind it; 3 the forward's; 4 a local pass's
// block_sums of 45 values; 5 seg_bwd_step's reductions of a segment: the
// 8 grids' transposing gamma sums, its local half's 45, the one barrier and
// the records added in warp order; 6 its top-K at one thinned grid: K_top
// rounds a warp and the merge of the warps' lists). Each step feeds the
// next, so none is hoisted.
template <int WHICH>
__global__ void __launch_bounds__(NT) seg_split_kernel(float* __restrict__ out,
                                                       const float* __restrict__ trans2,
                                                       int steps, int K_top, int Gp, int K) {
  __shared__ float rec[NWARP * REC_V];
  __shared__ float sv[BWD_V], cs[L], Ms[L], res[REC_V];
  __shared__ float rv[NWARP];
  __shared__ int ri[NWARP];
  __shared__ unsigned tk[NWARP * MAX_KTOP];
  __shared__ int tl[NWARP * MAX_KTOP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 1e-3f * (float)(threadIdx.x & 63);
  if (threadIdx.x < BWD_V) sv[threadIdx.x] = 1.f + 0.01f * threadIdx.x;
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    if constexpr (WHICH == 0) {
      const float gam = acc + 1.f;
      const float gs = block_reduce(gam, rec, SumOp());
      float v[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) v[q] = ((threadIdx.x * 2654435761u >> q) & 1u) ? gam : 0.f;
      const float ds = block_reduce32(v, rec + NWARP);
      acc = (gs + ds) * 1e-9f;
    } else if constexpr (WHICH == 1) {
      float bv = acc + (float)((threadIdx.x * 37) & 511);
      int bi = threadIdx.x;
      block_argmax(bv, bi, rv, ri);
      acc = bv * 1e-12f + (threadIdx.x == bi ? 1e-9f : 0.f);
    } else if constexpr (WHICH == 2 || WHICH == 3) {
      if (threadIdx.x == 0) {
        sv[0] += acc;
        if constexpr (WHICH == 2) bwd_solve(trans2, Gp, 0, K, false, sv, cs, Ms);
        else fwd_solve(trans2, Gp, 0, K, sv, cs, Ms);
        acc = Ms[0] * 1e-12f;
      }
      __syncthreads();
    } else if constexpr (WHICH == 4) {
      float v[BWD_V];
#pragma unroll
      for (int i = 0; i < BWD_V; ++i) v[i] = acc + i;
      block_sums(v, rec, res);
      __syncthreads();
      acc = res[threadIdx.x % BWD_V] * 1e-12f;
    } else if constexpr (WHICH == 5) {
      float* rw = rec + warp * REC_V;
      float gam[L];
#pragma unroll
      for (int j = 0; j < L; ++j) gam[j] = acc + j;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const unsigned w = (threadIdx.x + j) * 2654435761u;
        float x[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) x[q] = ((w >> q) & 1u) ? gam[j] : 0.f;
        warp_tsum<32>(x, lane);
        rw[j * GRID_V + lane] = x[0];
      }
      float x[L];
#pragma unroll
      for (int j = 0; j < L; ++j) x[j] = gam[j];
      warp_tsum<L>(x, lane);
      if (lane < L) rw[lane * GRID_V + 32] = x[0];
      float v[BWD_V];
#pragma unroll
      for (int i = 0; i < BWD_V; ++i) v[i] = acc * i;
      warp_sums(v, rw + L * GRID_V, lane);
      __syncthreads();
      if (threadIdx.x < REC_V) {
        float r = rec[threadIdx.x];
        for (int w = 1; w < NWARP; ++w) r += rec[w * REC_V + threadIdx.x];
        res[threadIdx.x] = r;
      }
      __syncthreads();
      acc = res[threadIdx.x % REC_V] * 1e-12f;
    } else {
      unsigned key = __float_as_uint(acc + (float)((threadIdx.x * 37) & 511)) + 2u, mk = 0u;
      int ml = 0;
      for (int r = 0; r < K_top; ++r) {
        const unsigned m = __reduce_max_sync(FULL, key);
        const int src = __ffs(__ballot_sync(FULL, key == m)) - 1;
        if (lane == r) {
          mk = m;
          ml = src;
        }
        if (lane == src) key = 0u;
      }
      if (lane < K_top) {
        tk[warp * K_top + lane] = mk;
        tl[warp * K_top + lane] = ml;
      }
      __syncthreads();
      if (warp == 0) {
        int p = 0;
        for (int r = 0; r < K_top; ++r) {
          const bool has = lane < NWARP && p < K_top;
          const unsigned kk = has ? tk[lane * K_top + p] : 0u;
          const unsigned m = __reduce_max_sync(FULL, kk);
          const int src = __ffs(__ballot_sync(FULL, kk == m)) - 1;
          const int wl = __shfl_sync(FULL, has ? tl[lane * K_top + p] : 0, src);
          if (lane == src) ++p;
          if (lane == 0) res[r] = __uint_as_float(m - 2u) + wl;
        }
      }
      __syncthreads();
      acc = res[0] * 1e-12f;
    }
  }
  if (threadIdx.x == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

bool bad_args(int Gp, int KS, int B, int K_loc, int c) {
  return Gp < L || Gp % L || KS < 1 || B < 1 || B > 65535 || K_loc < 0 || K_loc > KS || c < 0 ||
         c >= Gp / L;
}

dim3 blocks(int KS, int B) { return dim3((KS + TILE - 1) / TILE, B); }

// seg_bwd_step's dynamic shared memory: the warps' top-K lists
size_t bwd_step_smem(int K_top) { return (size_t)NWARP * L * K_top * (sizeof(unsigned) + sizeof(int)); }
// what fits beside its ~31 KB of static arrays without opting in (K_top <= 12)
constexpr size_t BWD_STEP_SMEM_FREE = 12 * 1024;

}  // namespace

// part [B, nt, FWD_VALS]: per row and tile h_0..h_7, then P(l, i) l-major.
// a0 [B, KS]: the alpha entering segment c (null: zero, the first segment).
extern "C" int seg_fwd_local(const void* words, const void* dl, const void* trans2,
                             const void* mx, const void* a0, void* part, int Gp, int KS,
                             int B, int K_loc, int c, void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c)) return ERR_INVALID;
  seg_fwd_local_kernel<<<blocks(KS, B), NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)a0, (float*)part, Gp, KS, B, K_loc, c);
  return (int)cudaGetLastError();
}

// tot [B, FWD_VALS] the summed sums of segment c; ckpt [Gp/L, B, KS]
// (reads c - 1, writes c); scal [Gp/L, B, 2L] (writes c); logm [Gp/L, B]
// or null; part [B, nt, FWD_VALS] segment c + 1's local sums (unused at the
// last segment); aout [L, B, KS] or null.
extern "C" int seg_fwd_step(const void* words, const void* dl, const void* trans2,
                            const void* mx, const void* tot, void* ckpt, void* scal, void* logm,
                            void* part, void* aout, int Gp, int KS, int B, int K_loc, int K,
                            int c, void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c) || K < 1) return ERR_INVALID;
  seg_fwd_step_kernel<<<blocks(KS, B), NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)tot, (float*)ckpt, (float*)scal, (float*)logm, (float*)part, (float*)aout,
      Gp, KS, B, K_loc, K, c);
  return (int)cudaGetLastError();
}

// part [B, nt, BWD_VALS]: per row and tile q_0..q_7, NR, Qr(j, l) j-major.
// beta [B, KS]: the carry (ones at the last segment).
extern "C" int seg_bwd_local(const void* words, const void* dl, const void* trans2,
                             const void* mx, const void* beta, void* part, int Gp, int KS,
                             int B, int K_loc, int c, void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c)) return ERR_INVALID;
  seg_bwd_local_kernel<<<blocks(KS, B), NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)beta, (float*)part, Gp, KS, B, K_loc, c);
  return (int)cudaGetLastError();
}

// ckpt / scal as seg_fwd_step left them; tot [B, BWD_VALS]; thin [Gp];
// beta [B, KS] the carry, left as this segment's B_0 / N_0; part [B, nt,
// BWD_VALS] segment c - 1's local sums (unused at c = 0); dpart [nt, B,
// Gp*32], gnp [nt, Gp, B], tvp / tip [nt, Gp, B, K_top] written at the
// segment's grids; gcap [B, KS] (or null) at cap_grid (-1: none); aout
// [L, B, KS] or null.
extern "C" int seg_bwd_step(const void* words, const void* dl, const void* trans2,
                            const void* mx, const void* ckpt, const void* scal, const void* tot,
                            const void* thin, void* beta, void* part, void* dpart, void* gnp,
                            void* tvp, void* tip, void* gcap, void* aout, int Gp, int KS, int B,
                            int K_loc, int K, int k0, int K_top, int cap_grid, int c,
                            void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c) || K < 1 || K_top < 1 || K_top > MAX_KTOP ||
      cap_grid >= Gp || (cap_grid >= 0 && gcap == nullptr))
    return ERR_INVALID;
  const size_t smem = bwd_step_smem(K_top);
  if (smem > BWD_STEP_SMEM_FREE) {
    // past 48 KB a block with the static arrays: opt in (on the current card)
    const cudaError_t err = cudaFuncSetAttribute(
        seg_bwd_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  seg_bwd_step_kernel<<<blocks(KS, B), NT, smem, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)ckpt, (const float*)scal, (const float*)tot, (const int*)thin, (float*)beta,
      (float*)part, (float*)dpart, (float*)gnp, (float*)tvp, (int*)tip, (float*)gcap,
      (float*)aout, Gp, KS, B, K_loc, K, k0, K_top, cap_grid, c);
  return (int)cudaGetLastError();
}

// The previous form. tot [B, FWD_VALS]; a0 [B, KS] or null; writes the
// segment's alphas into alphas [L, B, KS] and, where logm [Gp/L, B] is
// given, log M_L into its row c.
extern "C" int seg_fwd_apply(const void* words, const void* dl, const void* trans2,
                             const void* mx, const void* tot, const void* a0, void* alphas,
                             void* logm, int Gp, int KS, int B, int K_loc, int K, int c,
                             void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c) || K < 1) return ERR_INVALID;
  seg_fwd_apply_kernel<<<blocks(KS, B), NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)tot, (const float*)a0, (float*)alphas, (float*)logm, Gp, KS, B, K_loc, K, c);
  return (int)cudaGetLastError();
}

// The previous form. alphas [L, B, KS] the segment's; the rest as
// seg_bwd_step's.
extern "C" int seg_bwd_apply(const void* words, const void* dl, const void* trans2,
                             const void* mx, const void* alphas, const void* tot,
                             const void* thin, void* beta, void* dpart, void* gnp, void* tvp,
                             void* tip, void* gcap, int Gp, int KS, int B, int K_loc, int K,
                             int k0, int K_top, int cap_grid, int c, void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c) || K < 1 || K_top < 1 || K_top > MAX_KTOP ||
      cap_grid >= Gp || (cap_grid >= 0 && gcap == nullptr))
    return ERR_INVALID;
  seg_bwd_apply_kernel<<<blocks(KS, B), NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)alphas, (const float*)tot, (const int*)thin, (float*)beta, (float*)dpart,
      (float*)gnp, (float*)tvp, (int*)tip, (float*)gcap, Gp, KS, B, K_loc, K, k0, K_top,
      cap_grid, c);
  return (int)cudaGetLastError();
}

// The seg step split's piece `which` (seg_split_kernel), `steps` times in
// each of the (nt, B) blocks; out [B * nt]; trans2 [2, Gp] for the solves.
extern "C" int seg_split(void* out, const void* trans2, int which, int nt, int B, int steps,
                         int K_top, int Gp, int K, void* stream) {
  if (nt < 1 || B < 1 || B > 65535 || steps < 1 || K_top < 1 || K_top > MAX_KTOP || Gp < 2 * L ||
      K < 1)
    return ERR_INVALID;
  const dim3 grid(nt, B);
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  const float* tr = (const float*)trans2;
  switch (which) {
    case 0: seg_split_kernel<0><<<grid, NT, 0, st>>>(o, tr, steps, K_top, Gp, K); break;
    case 1: seg_split_kernel<1><<<grid, NT, 0, st>>>(o, tr, steps, K_top, Gp, K); break;
    case 2: seg_split_kernel<2><<<grid, NT, 0, st>>>(o, tr, steps, K_top, Gp, K); break;
    case 3: seg_split_kernel<3><<<grid, NT, 0, st>>>(o, tr, steps, K_top, Gp, K); break;
    case 4: seg_split_kernel<4><<<grid, NT, 0, st>>>(o, tr, steps, K_top, Gp, K); break;
    case 5: seg_split_kernel<5><<<grid, NT, 0, st>>>(o, tr, steps, K_top, Gp, K); break;
    case 6: seg_split_kernel<6><<<grid, NT, 0, st>>>(o, tr, steps, K_top, Gp, K); break;
    default: return ERR_INVALID;
  }
  return (int)cudaGetLastError();
}
