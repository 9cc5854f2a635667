// The fused full-panel FB kernels as they were before their redesign (one
// 512-thread block a row, every per-row plane in global scratch, separate
// max and sum reductions, top-K by K_top block-wide argmax rounds), kept
// beside the redesign in fb.cu so that chip_smoke.py can time the two in
// turn on one card. Measurement-only: the package reaches them only through the private
// `_prev=True` of kernels/fb.py:fb_forward / fb_backward.
#include <cuda_runtime.h>
#include <math.h>

#include "fb_common.cuh"

namespace {

// Emission logits of grid g into lm[] (NEG at padded haplotypes) and
// their maximum. dls holds the grid's 32 GL log-ratios.
__device__ __forceinline__ float emission_logits(
    const int* __restrict__ words, const float* dls, float* lm, int g, int K,
    int K_pad, float* red) {
  float m = NEG;
  for (int k = threadIdx.x; k < K_pad; k += NT) {
    float x = emission_logit((unsigned)words[(size_t)g * K_pad + k], dls);
    x = (k < K) ? x : NEG;
    lm[k] = x;
    m = fmaxf(m, x);
  }
  return block_reduce(m, red, MaxOp());
}

__global__ void __launch_bounds__(NT) fb_fwd_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, float* __restrict__ ckpt,
    float* __restrict__ logs, float* __restrict__ scratch, int Gp, int K,
    int K_pad, int B, int CG, float invK) {
  __shared__ float dls[32];
  __shared__ float red[NWARP];
  const int b = blockIdx.x;
  const size_t S = (size_t)Gp * 32;
  float* alpha = scratch + (size_t)b * 2 * K_pad;
  float* lm = alpha + K_pad;
  for (int k = threadIdx.x; k < K_pad; k += NT) alpha[k] = 0.f;
  float acc = 0.f;
  for (int g = 0; g < Gp; ++g) {
    if (g % CG == 0) {
      float* c = ckpt + ((size_t)(g / CG) * B + b) * K_pad;
      for (int k = threadIdx.x; k < K_pad; k += NT) c[k] = alpha[k];
    }
    if (threadIdx.x < 32) dls[threadIdx.x] = dl[b * S + (size_t)g * 32 + threadIdx.x];
    __syncthreads();
    const float mx = emission_logits(words, dls, lm, g, K, K_pad, red);
    const float stay = trans2[g], jump = trans2[Gp + g];
    float s = 0.f;
    for (int k = threadIdx.x; k < K_pad; k += NT) {
      const float a = (stay * alpha[k] + jump * invK) * expf(lm[k] - mx);
      alpha[k] = a;
      s += a;
    }
    const float ssum = block_reduce(s, red, SumOp());
    for (int k = threadIdx.x; k < K_pad; k += NT) alpha[k] = alpha[k] / ssum;
    acc = acc + logf(ssum) + mx;
  }
  if (threadIdx.x == 0) logs[b] = acc;
}

__global__ void __launch_bounds__(NT) fb_bwd_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ ckpt, const float* __restrict__ trans2,
    const int* __restrict__ thin, float* __restrict__ dos,
    float* __restrict__ tv, int* __restrict__ ti, float* __restrict__ scratch,
    const float* __restrict__ cap, float* __restrict__ gcap,
    int Gp, int K, int K_pad, int B, int CG, int K_top, float invK,
    float eps) {
  __shared__ float dls[32];
  __shared__ float red[NWARP * 32];
  __shared__ float rv[NWARP];
  __shared__ int ri[NWARP];
  const int b = blockIdx.x;
  const int NSC = Gp / CG;
  const size_t S = (size_t)Gp * 32;
  float* alphas = scratch + (size_t)b * (2 * CG + 3) * K_pad;   // [CG][K_pad]
  float* es = alphas + (size_t)CG * K_pad;                      // [CG][K_pad]
  float* beta = es + (size_t)CG * K_pad;
  float* enext = beta + K_pad;
  float* work = enext + K_pad;
  for (int s = 0; s < NSC; ++s) {
    const int ci = NSC - 1 - s;
    // ---- rematerialise the chunk's alphas (same ops as the forward) ----
    for (int j = 0; j < CG; ++j) {
      const int g = ci * CG + j;
      float* ej = es + (size_t)j * K_pad;
      float* aj = alphas + (size_t)j * K_pad;
      const float* prev = (j == 0) ? ckpt + ((size_t)ci * B + b) * K_pad
                                   : alphas + (size_t)(j - 1) * K_pad;
      if (threadIdx.x < 32) dls[threadIdx.x] = dl[b * S + (size_t)g * 32 + threadIdx.x];
      __syncthreads();
      const float mx = emission_logits(words, dls, ej, g, K, K_pad, red);
      const float stay = trans2[g], jump = trans2[Gp + g];
      float sa = 0.f;
      for (int k = threadIdx.x; k < K_pad; k += NT) {
        const float e = expf(ej[k] - mx);
        ej[k] = e;
        const float a = (stay * prev[k] + jump * invK) * e;
        aj[k] = a;
        sa += a;
      }
      const float ssum = block_reduce(sa, red, SumOp());
      for (int k = threadIdx.x; k < K_pad; k += NT) aj[k] = aj[k] / ssum;
    }
    if (s == 0) {
      for (int k = threadIdx.x; k < K_pad; k += NT) {
        beta[k] = 1.f;
        enext[k] = 1.f;
      }
    }
    // ---- reverse sweep: beta, gamma, dosage, top-K ----
    for (int j = CG - 1; j >= 0; --j) {
      const int g = ci * CG + j;
      const float* en = (j == CG - 1) ? enext : es + (size_t)(j + 1) * K_pad;
      const int gn = (j == CG - 1) ? min((ci + 1) * CG, NSC * CG - 1) : g + 1;
      const float stay_n = trans2[gn], jump_n = trans2[Gp + gn];
      float se = 0.f;
      for (int k = threadIdx.x; k < K_pad; k += NT) se += en[k] * beta[k];
      const float sm = block_reduce(se, red, SumOp());
      const bool last = (j == CG - 1) && (s == 0);   // global last grid
      float mb = -INFINITY;
      for (int k = threadIdx.x; k < K_pad; k += NT) {
        const float bn = last ? 1.f : stay_n * (en[k] * beta[k]) + (jump_n * invK) * sm;
        beta[k] = bn;
        mb = fmaxf(mb, bn);
      }
      const float bmax = fmaxf(block_reduce(mb, red, MaxOp()), 1e-30f);
      const float* aj = alphas + (size_t)j * K_pad;
      float sg = 0.f;
      for (int k = threadIdx.x; k < K_pad; k += NT) {
        const float bk = beta[k] / bmax;
        beta[k] = bk;
        sg += aj[k] * bk;
      }
      const float gsum = block_reduce(sg, red, SumOp());
      float* gcr = (cap != nullptr && cap[g] > 0.f) ? gcap + (size_t)b * K_pad : nullptr;
      float part[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) part[t] = 0.f;
      for (int k = threadIdx.x; k < K_pad; k += NT) {
        const float gm = (aj[k] * beta[k]) / gsum;
        work[k] = (k < K) ? gm : -1.f;
        if (gcr != nullptr && k < K) gcr[k] += gm;
        const unsigned w = (unsigned)words[(size_t)g * K_pad + k];
#pragma unroll
        for (int t = 0; t < 32; ++t) part[t] += ((w >> t) & 1u) ? gm : 0.f;
      }
      const float d = block_reduce32(part, red);
      if (threadIdx.x < 32)
        dos[b * S + (size_t)g * 32 + threadIdx.x] = eps + (1.f - 2.f * eps) * d;
      float* tvr = tv + ((size_t)g * B + b) * K_top;
      int* tir = ti + ((size_t)g * B + b) * K_top;
      if (thin[g] >= 0) {
        for (int t = 0; t < K_top; ++t) {
          float v = -INFINITY;
          int idx = K_pad;
          for (int k = threadIdx.x; k < K_pad; k += NT) {
            if (work[k] > v || (work[k] == v && k < idx)) {
              v = work[k];
              idx = k;
            }
          }
          block_argmax(v, idx, rv, ri);
          if (threadIdx.x == 0) {
            tvr[t] = v;
            tir[t] = idx;
          }
          if (idx % NT == threadIdx.x) work[idx] = -2.f;   // owner masks it
        }
      } else if (threadIdx.x < K_top) {
        tvr[threadIdx.x] = 0.f;
        tir[threadIdx.x] = 0;
      }
    }
    for (int k = threadIdx.x; k < K_pad; k += NT) enext[k] = es[k];
  }
}

}  // namespace

extern "C" int fb_forward_prev(const void* words, const void* dl,
                          const void* trans2, void* ckpt, void* logs,
                          void* scratch, int Gp, int K, int K_pad, int B,
                          int CG, float invK, void* stream) {
  fb_fwd_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const int*)words, (const float*)dl, (const float*)trans2,
      (float*)ckpt, (float*)logs, (float*)scratch, Gp, K, K_pad, B, CG, invK);
  return (int)cudaGetLastError();
}

extern "C" int fb_backward_prev(const void* words, const void* dl,
                           const void* ckpt, const void* trans2,
                           const void* thin, void* dos, void* tv, void* ti,
                           void* scratch, const void* cap, void* gcap, int Gp,
                           int K, int K_pad, int B, int CG, int K_top,
                           float invK, float eps, void* stream) {
  fb_bwd_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const int*)words, (const float*)dl, (const float*)ckpt,
      (const float*)trans2, (const int*)thin, (float*)dos, (float*)tv,
      (int*)ti, (float*)scratch, (const float*)cap, (float*)gcap, Gp, K,
      K_pad, B, CG, K_top, invK, eps);
  return (int)cudaGetLastError();
}
