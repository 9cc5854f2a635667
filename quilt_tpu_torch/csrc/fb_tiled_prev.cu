// The K-split FB kernels as they were before their redesign in
// fb_tiled.cu, kept beside it so that chip_smoke.py can time each new form
// in turn with its previous form on one card. Measurement-only: the package
// reaches them only through the private `_prev=True` of kernels/fb.py's
// fb_forward_tiled and fb_backward_tiled. fb_tiled.cu says what they compute.
//   * the backward: a remat kernel and a backward kernel launched in turn on
//     each chunk of CG grids (2 x Gp/CG launches an FB call), the chunk's
//     normalised alphas and the e*beta carry passing through device memory,
//     emissions by 32 bit-selects (fb_common.cuh emission_logit), three block
//     reductions and a top-K by K_top block-wide argmax rounds a reverse
//     step (counterparts of quilt_tpu/kernels/fb_pallas.py
//     _remat_kernel_tiled and _bwd_kernel_tiled + _merge_topk);
//   * the forward: the row's alpha in a global scratch row, each grid's
//     words, maximum and transition terms loaded inside its step, a block
//     reduction (two barriers) then the cluster exchange of one value a
//     block (counterpart of fb_pallas.py _fwd_kernel_tiled);
//   * the emission maximum: one block per (grid, K split), the rows looped
//     inside with a staging barrier, a block maximum and an atomic a row,
//     each logit built bit by bit from the grid's 32 log-ratios
//     (fb_common.cuh logit_direct, in the nibble order of the other
//     kernels; counterpart of fb_pallas.py _max_kernel_tiled).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "cluster_xchg.cuh"
#include "fb_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SPLITS = 8;
constexpr int MAX_KTOP = 32;
constexpr int MAX_CG = 32;

// One forward step of one haplotype, with explicit roundings so that the
// forward and the remat kernel cannot be contracted differently.
__device__ __forceinline__ float alpha_step(float a_prev, float inv_sprev,
                                            float stay, float jumpK, float e) {
  return __fmul_rn(__fmaf_rn(stay, __fmul_rn(a_prev, inv_sprev), jumpK), e);
}

// Order-free float maximum on a cell initialised to -inf.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f) {
    atomicMax((int*)addr, __float_as_int(v));
  } else {
    atomicMin((unsigned int*)addr, __float_as_uint(v));
  }
}

// ---- emission maximum. One block per (grid, K split), rows looped inside
// so the split's words stay in L1; partial maxima of the splits combine
// with an atomic maximum.
__global__ void __launch_bounds__(NT) fb_max_tiled_prev_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    float* __restrict__ mx, int Gp, int K, int K_pad, int B, int KS) {
  __shared__ float dls[32];
  __shared__ float red[NWARP];
  const int g = blockIdx.x;
  const int k0 = blockIdx.y * KS, k1 = k0 + KS;
  const size_t S = (size_t)Gp * 32;
  const int* wg = words + (size_t)g * K_pad;
  for (int b = 0; b < B; ++b) {
    if (threadIdx.x < 32) dls[threadIdx.x] = dl[(size_t)b * S + (size_t)g * 32 + threadIdx.x];
    __syncthreads();
    float m = NEG;
    for (int k = k0 + threadIdx.x; k < k1; k += NT) {
      const float x = logit_direct((unsigned)wg[k], dls);
      m = fmaxf(m, (k < K) ? x : NEG);
    }
    m = block_reduce(m, red, MaxOp());
    if (threadIdx.x == 0) atomic_max_float(mx + (size_t)g * B + b, m);
  }
}

// ---- the remat of chunk ci. Grid (splits, B), no cluster: each
// thread carries its own haplotypes through the chunk's CG grids.
__global__ void __launch_bounds__(NT) fb_remat_tiled_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ ckpt_c, const float* __restrict__ trans2,
    const float* __restrict__ mx, const float* __restrict__ ssum,
    float* __restrict__ alphas, int Gp, int K, int K_pad, int B, int CG,
    int ci, int KS, float invK) {
  __shared__ float dls[MAX_CG][32];
  __shared__ float mxs[MAX_CG], stay[MAX_CG], jumpK[MAX_CG], inv_s[MAX_CG + 1];
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * KS, k1 = k0 + KS;
  const int cs = ci * CG;
  const size_t S = (size_t)Gp * 32;
  for (int i = threadIdx.x; i < CG * 32; i += NT)
    dls[i >> 5][i & 31] = dl[(size_t)b * S + (size_t)cs * 32 + i];
  for (int j = threadIdx.x; j <= CG; j += NT) {
    const int gp = cs + j - 1;   // the grid whose S normalises the alpha entering cs + j
    inv_s[j] = (gp >= 0) ? 1.f / ssum[(size_t)gp * B + b] : 1.f;
    if (j < CG) {
      mxs[j] = mx[(size_t)(cs + j) * B + b];
      stay[j] = trans2[cs + j];
      jumpK[j] = trans2[Gp + cs + j] * invK;
    }
  }
  __syncthreads();
  for (int k = k0 + threadIdx.x; k < k1; k += NT) {
    float a = ckpt_c[(size_t)b * K_pad + k];
    for (int j = 0; j < CG; ++j) {
      float x = emission_logit((unsigned)words[(size_t)(cs + j) * K_pad + k], dls[j]);
      x = (k < K) ? x : NEG;
      a = alpha_step(a, inv_s[j], stay[j], jumpK[j], expf(x - mxs[j]));
      alphas[((size_t)j * B + b) * K_pad + k] = a * inv_s[j + 1];
    }
  }
}

// What one block tells its cluster about one grid step.
struct Post {
  float ab, e;
  float dos[32];
  float tv[MAX_KTOP];
  int ti[MAX_KTOP];
};

// ---- the backward of chunk ci. Grid (splits, B), cluster (splits,
// 1, 1). eb_in / e_in carry e*beta [B, K_pad] and E [B] of the grid after
// the chunk; eb_out / e_out receive those of the chunk's first grid.
__global__ void __launch_bounds__(NT) fb_bwd_tiled_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ alphas, const float* __restrict__ trans2,
    const int* __restrict__ thin, const float* __restrict__ mx,
    const float* __restrict__ eb_in, const float* __restrict__ e_in,
    float* __restrict__ dos, float* __restrict__ tv, int* __restrict__ ti,
    float* __restrict__ eb_out, float* __restrict__ e_out,
    float* __restrict__ work_scr, int Gp, int K, int K_pad, int B, int CG,
    int ci, int K_top, int KS, float invK, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float dls[32];
  __shared__ float red[NWARP * 32];
  __shared__ float rv[NWARP];
  __shared__ int ri[NWARP];
  __shared__ Post post[2];
  __shared__ float cand_v[MAX_SPLITS * MAX_KTOP];
  __shared__ int cand_i[MAX_SPLITS * MAX_KTOP];
  const int b = blockIdx.y;
  const unsigned rank = cluster.block_rank(), NS = cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = rank * KS, k1 = k0 + KS;
  const int cs = ci * CG;
  const size_t S = (size_t)Gp * 32;
  float* eo = eb_out + (size_t)b * K_pad;
  float* work = work_scr + (size_t)b * K_pad;
  float e_prev = e_in[b];
  for (int p = 0; p < CG; ++p) {
    const int j = CG - 1 - p, g = cs + j;
    Post* mine = &post[p & 1];
    const bool last = (g == Gp - 1);             // beta = 1: no successor
    const float stay_n = last ? 1.f : trans2[g + 1];
    const float jumpK_n = last ? 0.f : trans2[Gp + g + 1] * invK;
    const float inv_e = 1.f / fmaxf(e_prev, 1e-30f);
    const float* en = (p == 0) ? eb_in + (size_t)b * K_pad : eo;
    const float* aj = alphas + ((size_t)j * B + b) * K_pad;
    const int* wg = words + (size_t)g * K_pad;
    const bool thinned = thin[g] >= 0;
    if (threadIdx.x < 32) dls[threadIdx.x] = dl[(size_t)b * S + (size_t)g * 32 + threadIdx.x];
    __syncthreads();
    const float mxg = mx[(size_t)g * B + b];
    float sab = 0.f, se = 0.f;
    float part[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) part[t] = 0.f;
    for (int k = k0 + threadIdx.x; k < k1; k += NT) {
      const float beta = last ? 1.f : stay_n * (en[k] * inv_e) + jumpK_n;
      const float gu = aj[k] * beta;
      sab += gu;
      const unsigned w = (unsigned)wg[k];
#pragma unroll
      for (int t = 0; t < 32; ++t) part[t] += ((w >> t) & 1u) ? gu : 0.f;
      if (thinned) work[k] = (k < K) ? gu : -1.f;
      float x = emission_logit(w, dls);
      x = (k < K) ? x : NEG;
      const float etb = expf(x - mxg) * beta;
      eo[k] = etb;
      se += etb;
    }
    sab = block_reduce(sab, red, SumOp());
    se = block_reduce(se, red, SumOp());
    const float d = block_reduce32(part, red);
    if (threadIdx.x == 0) {
      mine->ab = sab;
      mine->e = se;
    }
    if (threadIdx.x < 32) mine->dos[threadIdx.x] = d;
    if (thinned) {
      // the split's own top K_top, by masked argmax (lowest index on ties)
      for (int t = 0; t < K_top; ++t) {
        float v = -INFINITY;
        int idx = INT_MAX;
        for (int k = k0 + threadIdx.x; k < k1; k += NT) {
          if (work[k] > v || (work[k] == v && k < idx)) {
            v = work[k];
            idx = k;
          }
        }
        block_argmax(v, idx, rv, ri);
        if (threadIdx.x == 0) {
          mine->tv[t] = v;
          mine->ti[t] = idx;
        }
        if ((idx - k0) % NT == (int)threadIdx.x) work[idx] = -2.f;   // owner masks it
      }
    }
    cluster.sync();
    float ab = 0.f, e = 0.f;
    for (unsigned q = 0; q < NS; ++q) {
      const Post* theirs = cluster.map_shared_rank(mine, q);
      ab += theirs->ab;
      e += theirs->e;
    }
    e_prev = e;
    if (rank == 0) {
      const float inv_ab = 1.f / fmaxf(ab, 1e-30f);
      if (threadIdx.x < 32) {
        float dsum = 0.f;
        for (unsigned q = 0; q < NS; ++q) dsum += cluster.map_shared_rank(mine, q)->dos[threadIdx.x];
        dos[((size_t)b * CG + j) * 32 + threadIdx.x] = eps + (1.f - 2.f * eps) * dsum * inv_ab;
      }
      float* tvr = tv + ((size_t)j * B + b) * K_top;
      int* tir = ti + ((size_t)j * B + b) * K_top;
      if (thinned && warp == 0) {
        // merge the splits' lists: value descending, lowest index on ties
        const int n = NS * K_top;
        for (int c = lane; c < n; c += 32) {
          const Post* theirs = cluster.map_shared_rank(mine, c / K_top);
          cand_v[c] = theirs->tv[c % K_top];
          cand_i[c] = theirs->ti[c % K_top];
        }
        __syncwarp();
        for (int t = 0; t < K_top; ++t) {
          float v = -INFINITY;
          int idx = INT_MAX, pos = -1;
          for (int c = lane; c < n; c += 32) {
            if (cand_v[c] > v || (cand_v[c] == v && cand_i[c] < idx)) {
              v = cand_v[c];
              idx = cand_i[c];
              pos = c;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, o);
            const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
            const int op = __shfl_xor_sync(0xffffffffu, pos, o);
            if (ov > v || (ov == v && oi < idx)) {
              v = ov;
              idx = oi;
              pos = op;
            }
          }
          if (lane == 0) {
            tvr[t] = v * inv_ab;
            tir[t] = idx;
            cand_v[pos] = -3.f;
          }
          __syncwarp();
        }
      } else if (!thinned && threadIdx.x < K_top) {
        tvr[threadIdx.x] = 0.f;
        tir[threadIdx.x] = 0;
      }
    }
  }
  cluster.sync();   // no block leaves while its posts may still be read
  if (rank == 0 && threadIdx.x == 0) e_out[b] = e_prev;
}

// ---- the previous forward. Grid (splits, B), cluster (splits, 1, 1). The
// row's alpha lives in the global scratch row, each thread at its own columns.
constexpr int FWD_MAX_CG = 16;

__global__ void __launch_bounds__(NT) fb_fwd_tiled_prev_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx,
    float* __restrict__ ckpt, float* __restrict__ ssum,
    float* __restrict__ logs, float* __restrict__ scratch, int Gp, int K,
    int K_pad, int B, int CG, int KS, float invK) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float dls_s[FWD_MAX_CG * 32];
  __shared__ float em[FWD_MAX_CG * EMF];
  __shared__ float red[NWARP];
  __shared__ float part[2];
  const int b = blockIdx.y;
  const unsigned rank = cluster.block_rank(), NS = cluster.num_blocks();
  const int k0 = rank * KS, k1 = k0 + KS;
  const float* dlr = dl + (size_t)b * Gp * 32;
  float* alpha = scratch + (size_t)b * K_pad;
  for (int k = k0 + threadIdx.x; k < k1; k += NT) alpha[k] = 0.f;
  float acc = 0.f, inv_sprev = 1.f;
  for (int g = 0; g < Gp; ++g) {
    const int j = g % CG;
    if (j == 0) {
      float* c = ckpt + ((size_t)(g / CG) * B + b) * K_pad;
      for (int k = k0 + threadIdx.x; k < k1; k += NT) c[k] = alpha[k];
      stage_chunk(dlr, g, CG, dls_s, em);
    }
    const float mxg = mx[(size_t)g * B + b];
    const float stay = trans2[g], jumpK = trans2[Gp + g] * invK;
    const int* wg = words + (size_t)g * K_pad;
    float s = 0.f;
    for (int k = k0 + threadIdx.x; k < k1; k += NT) {
      const float x = (k < K) ? logit((unsigned)wg[k], em, j) : NEG;
      const float a = alpha_step(alpha[k], inv_sprev, stay, jumpK, expf(x - mxg));
      alpha[k] = a;
      s += a;
    }
    s = block_reduce(s, red, SumOp());
    if (threadIdx.x == 0) part[g & 1] = s;
    cluster.sync();
    float tot = 0.f;
    for (unsigned q = 0; q < NS; ++q) tot += *cluster.map_shared_rank(&part[g & 1], q);
    inv_sprev = 1.f / tot;
    acc = acc + logf(tot) + mxg;
    if (rank == 0 && threadIdx.x == 0) ssum[(size_t)g * B + b] = tot;
  }
  cluster.sync();   // no block leaves while its partial may still be read
  if (rank == 0 && threadIdx.x == 0) logs[b] = acc;
}

bool bad_split(int splits, int K_pad, int KS) {
  return splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) ||
         (long long)splits * KS != K_pad;
}

}  // namespace

constexpr int ERR_INVALID = (int)cudaErrorInvalidValue;

// mx [Gp, B], initialised to -inf by the caller.
extern "C" int fb_max_tiled_prev(const void* words, const void* dl, void* mx, int Gp, int K,
                                 int K_pad, int B, int splits, void* stream) {
  if (splits < 1 || K_pad % splits) return (int)cudaErrorInvalidValue;
  fb_max_tiled_prev_kernel<<<dim3(Gp, splits), NT, 0, (cudaStream_t)stream>>>(
      (const int*)words, (const float*)dl, (float*)mx, Gp, K, K_pad, B, K_pad / splits);
  return (int)cudaGetLastError();
}

extern "C" int fb_remat_tiled_prev(const void* words, const void* dl,
                                   const void* ckpt_c, const void* trans2,
                                   const void* mx, const void* ssum, void* alphas,
                                   int Gp, int K, int K_pad, int B, int CG, int ci,
                                   int splits, float invK, void* stream) {
  if (splits < 1 || K_pad % splits || CG > MAX_CG) return ERR_INVALID;
  fb_remat_tiled_kernel<<<dim3(splits, B), NT, 0, (cudaStream_t)stream>>>(
      (const int*)words, (const float*)dl, (const float*)ckpt_c,
      (const float*)trans2, (const float*)mx, (const float*)ssum,
      (float*)alphas, Gp, K, K_pad, B, CG, ci, K_pad / splits, invK);
  return (int)cudaGetLastError();
}

extern "C" int fb_backward_tiled_prev(const void* words, const void* dl,
                                      const void* alphas, const void* trans2,
                                      const void* thin, const void* mx,
                                      const void* eb_in, const void* e_in,
                                      void* dos, void* tv, void* ti, void* eb_out,
                                      void* e_out, void* work, int Gp, int K,
                                      int K_pad, int B, int CG, int ci, int K_top,
                                      int splits, float invK, float eps,
                                      void* stream) {
  const int KS = K_pad / (splits > 0 ? splits : 1);
  if (bad_split(splits, K_pad, KS) || K_top > MAX_KTOP || K_top > KS) return ERR_INVALID;
  return cluster_xchg::launch_clusters(
      fb_bwd_tiled_kernel, splits, B, NT, 0, (cudaStream_t)stream,
      (const int*)words, (const float*)dl, (const float*)alphas,
      (const float*)trans2, (const int*)thin, (const float*)mx,
      (const float*)eb_in, (const float*)e_in, (float*)dos, (float*)tv,
      (int*)ti, (float*)eb_out, (float*)e_out, (float*)work, Gp, K, K_pad, B,
      CG, ci, K_top, KS, invK, eps);
}

extern "C" int fb_forward_tiled_prev(const void* words, const void* dl, const void* trans2,
                                     const void* mx, void* ckpt, void* ssum, void* logs,
                                     void* scratch, int Gp, int K, int K_pad, int B, int CG,
                                     int splits, float invK, void* stream) {
  const int KS = K_pad / (splits > 0 ? splits : 1);
  if (bad_split(splits, K_pad, KS) || CG < 1 || CG > FWD_MAX_CG || Gp % CG) return ERR_INVALID;
  return cluster_xchg::launch_clusters(
      fb_fwd_tiled_prev_kernel, splits, B, NT, 0, (cudaStream_t)stream,
      (const int*)words, (const float*)dl, (const float*)trans2,
      (const float*)mx, (float*)ckpt, (float*)ssum, (float*)logs,
      (float*)scratch, Gp, K, K_pad, B, CG, KS, invK);
}
