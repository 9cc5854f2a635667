// Full-panel haploid forward-backward over the packed reference panel.
//
// Replaces two Pallas TPU kernels of quilt_tpu/kernels/fb_pallas.py
// (both launched by fb_pallas_core):
//   fb_fwd <- _fwd_kernel: per grid, the emission logit is the 32-term dot
//             of the GL log-ratio with the grid's panel bits; then
//             alpha <- (stay*alpha + jump/K) * e, normalised; keeps the
//             log-likelihood and one alpha checkpoint per chunk of CG grids;
//   fb_bwd <- _bwd_kernel: rebuilds a chunk's alphas from its checkpoint,
//             runs the max-normalised beta, and emits gamma's dosage
//             eps + (1-2eps) * sum_k gamma_k bit_k,s and, at thinned grids,
//             the top-K_top gammas (lowest index first on ties, as
//             _topk_extract); at the grids that the optional `cap` flags
//             (the HLA run's gene grid), it adds the normalised gamma of
//             every haplotype into gcap [B, K_pad] (Pallas gcap_ref). One
//             block owns one row, so the capture needs no atomics, and a
//             call without capture passes no flags and does no extra work.
//
// What bounds it on the H100: each of the B rows is a 512-step dependent
// recursion over K = 5,120 haplotypes; per grid a row does ~32 FMAs per
// haplotype for the emission (and 32 more for the dosage) and a handful of
// block-wide reductions. The panel words (10 MB at full width) stay in L2,
// so the rows are bounded by reduction latency and by the FMA work of one
// SM each, not by device memory. With few rows and a large panel (a few
// dozen rows x K = 40,960) most SMs would idle while each block walks its
// whole row: fb_tiled.cu splits a row's haplotypes over a cluster of blocks
// for that case, and kernels/fb.py:fb_plan chooses between the two.
//
// Simple design: one thread block per row, haplotypes across the threads,
// the grid loop inside the block. Emissions are plain float32 sums of the
// set bits' GL log-ratios (the TPU kernel's bf16 hi/lo split only kept f32
// accuracy on its matrix unit). The per-row planes (alpha, the chunk's
// rematerialised alphas and emissions, beta) live in a global scratch
// buffer that each thread touches only at its own columns; the forward and
// the rematerialisation share one emission routine, so the rebuilt alphas
// equal the forward's bit for bit.
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

extern "C" int fb_forward(const void* words, const void* dl,
                          const void* trans2, void* ckpt, void* logs,
                          void* scratch, int Gp, int K, int K_pad, int B,
                          int CG, float invK, void* stream) {
  fb_fwd_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const int*)words, (const float*)dl, (const float*)trans2,
      (float*)ckpt, (float*)logs, (float*)scratch, Gp, K, K_pad, B, CG, invK);
  return (int)cudaGetLastError();
}

extern "C" int fb_backward(const void* words, const void* dl,
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
