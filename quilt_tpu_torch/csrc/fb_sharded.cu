// The segment-fused full-panel FB of one panel shard: the four passes a
// segment of L = 8 grids of the panel-sharded FB (kernels/fb_sharded.py,
// which holds the algebra, the plain versions and the exchanges).
//
// No Pallas kernel is their counterpart: they replace the XLA body
// quilt_tpu/kernels/fb_full.py:_fb_core_segmented (:440), which the JAX
// package runs under shard_map over the mesh's panel axis
// (quilt_tpu/dist/mesh.py:ShardedFB):
//   seg_fwd_local <- fwd_seg's local reductions: h_i = sum_k R(0,i) a0 and
//                    P(l,i) = sum_k R(l,i), R(l,i) = T_l ... T_i, T = stay e;
//   seg_fwd_apply <- fwd_seg's mass solve M_1..M_L and reconstruction: the
//                    segment's alphas into the shard's alpha plane, log M_L;
//   seg_bwd_local <- bwd_seg's local reductions q_j, NR, Qr(j,l);
//   seg_bwd_apply <- bwd_seg's mass solve N_j and reconstruction B_j; of the
//                    gamma numerators alpha_j B_j: their sum and bit-masked
//                    sums (the dosage), the K_top largest at thinned grids
//                    (global indices, lowest first on ties), the capture; the
//                    next carry B_0 / N_0 (N_0 = sum_k e_0 B_0, from the
//                    solve: no exchange of its own). The gamma normalisers
//                    wait for the one exchange at the end of the call.
//
// What bounds them on the H100: a pass reads the segment's panel words and
// one or two [B, K_shard] planes and writes at most 8; per (row, haplotype)
// it does 8-9 emission logits (8 table lookups and 7 adds each), as many
// exps and ~40-100 products and sums, ~8 operations a byte moved, under the
// card's ~20 float32 operations a byte of HBM: bytes bound at the QUILT1
// shape, with the reductions' shuffles and barriers on top.
//
// Design (a simple, right first form): one 512-thread block a (tile of
// TILE = 512 haplotypes, row), one thread a haplotype, so B x ceil(K_shard
// / 512) blocks fill the card (560 at 112 rows x 2,560). The segment's
// grids' emission tables are staged in shared memory (fb_common.cuh
// stage_chunk / logit: the plain version's _tile_logits bit for bit). A
// block's sums are reduced by a xor butterfly in each warp and the warps'
// records added in warp order into its tile's partial; the tiles' partials
// are summed by a torch reduction and the shards' in the group's shard
// order, so two launches give the same bits (no float atomics). The scalar
// solves run on thread 0 into shared memory. Products and sums that mirror
// the plain version are written with the _rn intrinsics, which the compiler
// does not contract into fused multiply-adds, so kernel and plain version
// part only by the order of the sums over haplotypes.
#include <cuda_runtime.h>

#include "fb_common.cuh"

namespace {

constexpr int L = 8;
constexpr int TILE = NT;
constexpr int NTRI = L * (L + 1) / 2;
constexpr int FWD_V = L + NTRI;           // h, P
constexpr int BWD_V = L + 1 + NTRI;       // q, NR, Qr
constexpr float TINY = 1e-30f;
constexpr int MAX_KTOP = 32;
constexpr int ERR_INVALID = (int)cudaErrorInvalidValue;

__device__ __forceinline__ float MUL(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float ADD(float a, float b) { return __fadd_rn(a, b); }

// Position of (l, i), l <= i, in the l-major list of pairs.
__host__ __device__ constexpr int tri(int l, int i) { return l * L - l * (l - 1) / 2 + (i - l); }

// Sums each of the V values over the block; thread i < V writes the sum of
// value i to out[i]. Warp butterflies, then the warps' records in order.
template <int V>
__device__ __forceinline__ void block_sums(float (&v)[V], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp * V + i] = x;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float r = red[threadIdx.x];
    for (int w = 1; w < NWARP; ++w) r += red[w * V + threadIdx.x];
    out[threadIdx.x] = r;
  }
}

// The emissions e[0..n) of this thread's haplotype k at grids g0 .. g0+n-1
// from the staged tables: exp(logit - mx), 0 past the shard's K_loc.
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

// The alpha of this thread's haplotype entering segment c (the last grid
// of segment c - 1; zero at c = 0).
__device__ __forceinline__ float fwd_a0(const float* __restrict__ alphas, int c, int B, int KS,
                                        int b, int k) {
  return (c > 0 && k < KS) ? alphas[((size_t)(c * L - 1) * B + b) * KS + k] : 0.f;
}

__global__ void __launch_bounds__(NT) seg_fwd_local_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx,
    const float* __restrict__ alphas, float* __restrict__ part, int Gp, int KS, int B, int K_loc,
    int c) {
  __shared__ float dls_s[L * 32];
  __shared__ float em[L * EMF];
  __shared__ float red[NWARP * FWD_V];
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  stage_chunk(dl + (size_t)b * Gp * 32, g0, L, dls_s, em);
  float e[L], T[L], v[FWD_V];
  emissions(words, mx, em, g0, L, KS, B, b, k, K_loc, e);
  const float a0 = fwd_a0(alphas, c, B, KS, b, k);
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
  block_sums(v, red, part + ((size_t)b * gridDim.x + t) * FWD_V);
}

__global__ void __launch_bounds__(NT) seg_fwd_apply_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx, const float* __restrict__ tot,
    float* __restrict__ alphas, float* __restrict__ logm, int Gp, int KS, int B, int K_loc, int K,
    int c) {
  __shared__ float dls_s[L * 32];
  __shared__ float em[L * EMF];
  __shared__ float sv[FWD_V];
  __shared__ float M_s[L + 1], cm_s[L];
  const int t = blockIdx.x, b = blockIdx.y, k = t * TILE + threadIdx.x, g0 = c * L;
  if (threadIdx.x < FWD_V) sv[threadIdx.x] = tot[(size_t)b * FWD_V + threadIdx.x];
  stage_chunk(dl + (size_t)b * Gp * 32, g0, L, dls_s, em);   // ends with a barrier
  if (threadIdx.x == 0) {
    // the lower-triangular mass solve (M_0 = 1: a0 enters normalised)
    float cl[L], M[L + 1];
    M[0] = 1.f;
    for (int l = 0; l < L; ++l)
      cl[l] = __fdiv_rn(trans2[Gp + g0 + l], MUL((float)K, fmaxf(trans2[g0 + l], TINY)));
    for (int i = 0; i < L; ++i) {
      float acc = sv[i];
      for (int l = 0; l <= i; ++l) acc = ADD(acc, MUL(MUL(cl[l], M[l]), sv[L + tri(l, i)]));
      M[i + 1] = acc;
    }
    for (int l = 0; l < L; ++l) cm_s[l] = MUL(cl[l], M[l]);
    for (int i = 0; i <= L; ++i) M_s[i] = M[i];
    if (logm != nullptr && t == 0) logm[(size_t)c * B + b] = logf(fmaxf(M[L], TINY));
  }
  __syncthreads();
  float e[L];
  emissions(words, mx, em, g0, L, KS, B, b, k, K_loc, e);
  const float a0 = fwd_a0(alphas, c, B, KS, b, k);
  float Rl[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float Ti = MUL(__ldg(trans2 + g0 + i), e[i]);
#pragma unroll
    for (int l = 0; l < i; ++l) Rl[l] = MUL(Rl[l], Ti);
    Rl[i] = Ti;
    float A = MUL(Rl[0], a0);
#pragma unroll
    for (int l = 0; l <= i; ++l) A = ADD(A, MUL(cm_s[l], Rl[l]));
    if (k < KS)
      alphas[((size_t)(g0 + i) * B + b) * KS + k] = __fdiv_rn(A, fmaxf(M_s[i + 1], TINY));
  }
}

// The backward's per-haplotype terms of segment c: e_j, e_R, T_j = stay_{j+1}
// e_{j+1} and the next grid's jump; at the last segment e_R = 1 and the
// next grid's (stay, jump) = (1, 0).
struct BwdTerms {
  float e[L], eR, T[L];
};

__device__ __forceinline__ void bwd_terms(const unsigned* __restrict__ words,
                                          const float* __restrict__ trans2,
                                          const float* __restrict__ mx, const float* em, int Gp,
                                          int KS, int B, int b, int k, int K_loc, int c, bool last,
                                          BwdTerms& s) {
  const int g0 = c * L;
  float e9[L + 1];
  emissions(words, mx, em, g0, last ? L : L + 1, KS, B, b, k, K_loc, e9);
#pragma unroll
  for (int j = 0; j < L; ++j) s.e[j] = e9[j];
  s.eR = last ? (k < KS ? 1.f : 0.f) : e9[L];
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
  BwdTerms s;
  bwd_terms(words, trans2, mx, em, Gp, KS, B, b, k, K_loc, c, last, s);
  const float bR = k < KS ? beta[(size_t)b * KS + k] : 0.f;
  float v[BWD_V];
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
  block_sums(v, red, part + ((size_t)b * gridDim.x + t) * BWD_V);
}

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
  if (threadIdx.x == 0) {
    // the descending mass solve
    float cb[L], N[L + 1];
    for (int l = 0; l < L; ++l) cb[l] = __fdiv_rn(next_jump(trans2, Gp, g0, l, last), (float)K);
    N[L] = sv[L];
    for (int j = L - 1; j >= 0; --j) {
      float acc = sv[j];
      for (int l = j; l < L; ++l) acc = ADD(acc, MUL(MUL(cb[l], N[l + 1]), sv[L + 1 + tri(j, l)]));
      N[j] = acc;
    }
    for (int l = 0; l < L; ++l) cbN_s[l] = MUL(cb[l], N[l + 1]);
    N0_s = fmaxf(N[0], TINY);
  }
  __syncthreads();
  BwdTerms s;
  bwd_terms(words, trans2, mx, em, Gp, KS, B, b, k, K_loc, c, last, s);
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
    const float a = k < KS ? alphas[((size_t)g * B + b) * KS + k] : 0.f;
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

bool bad_args(int Gp, int KS, int B, int K_loc, int c) {
  return Gp < L || Gp % L || KS < 1 || B < 1 || B > 65535 || K_loc < 0 || K_loc > KS || c < 0 ||
         c >= Gp / L;
}

dim3 blocks(int KS, int B) { return dim3((KS + TILE - 1) / TILE, B); }

}  // namespace

// part [B, nt, FWD_V]: per row and tile h_0..h_7, then P(l, i) l-major.
// alphas [Gp, B, KS]: the alphas before the segment (read at grid c*L - 1).
extern "C" int seg_fwd_local(const void* words, const void* dl, const void* trans2,
                             const void* mx, const void* alphas, void* part, int Gp, int KS,
                             int B, int K_loc, int c, void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c)) return ERR_INVALID;
  seg_fwd_local_kernel<<<blocks(KS, B), NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)alphas, (float*)part, Gp, KS, B, K_loc, c);
  return (int)cudaGetLastError();
}

// tot [B, FWD_V] the summed sums; writes the segment's alphas into alphas
// and, where logm [Gp/L, B] is given, log M_L into its row c.
extern "C" int seg_fwd_apply(const void* words, const void* dl, const void* trans2,
                             const void* mx, const void* tot, void* alphas, void* logm, int Gp,
                             int KS, int B, int K_loc, int K, int c, void* stream) {
  if (bad_args(Gp, KS, B, K_loc, c) || K < 1) return ERR_INVALID;
  seg_fwd_apply_kernel<<<blocks(KS, B), NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (const float*)trans2, (const float*)mx,
      (const float*)tot, (float*)alphas, (float*)logm, Gp, KS, B, K_loc, K, c);
  return (int)cudaGetLastError();
}

// part [B, nt, BWD_V]: per row and tile q_0..q_7, NR, Qr(j, l) j-major.
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

// tot [B, BWD_V] the summed sums; thin [Gp]; beta [B, KS] the carry, left
// as this segment's B_0 / N_0; dpart [nt, B, Gp*32], gnp [nt, Gp, B], tvp / tip
// [nt, Gp, B, K_top] written at the segment's grids; gcap [B, KS] (or
// null) at cap_grid (-1: none).
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
