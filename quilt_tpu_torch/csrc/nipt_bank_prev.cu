// The forward bank of the NIPT within-block relabelling move as it was
// before its redesign in nipt_bank.cu: it reads the two [G, 3B, K] planes
// e = exp(lemg - row max) * mask and bk = beta * mask that its wrapper
// builds, keeps the 9 bank rows in shared memory (touched twice a step:
// the step, then a normalising pass), and reduces a step's 18 sums by 18
// separate butterflies. Kept beside the redesign so that chip_smoke.py can
// time the two in turn on one card. Measurement-only: the package reaches
// it only through the private `_prev=True` of
// kernels/nipt_bank.py:bank_scan. nipt_bank.cu says what it computes.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int NV = 18;   // 9 normalisers + 9 junctions

// INVS[r][i] of quilt_tpu_torch/kernels/nipt.py: the old latent row whose
// planes move into row i under relabelling r ({0,1,2}, {0,2,1}, {1,0,2},
// {1,2,0}, {2,0,1}, {2,1,0}), two bits an entry, so that it folds to a
// constant in the unrolled loops and needs no memory for a drawn r.
__device__ constexpr int invs(int r, int i) {
  return (int)((0x192261624ULL >> (2 * (3 * r + i))) & 3ULL);
}

// Sums NV values over the block; every thread receives the same results,
// added in the same order.
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) red[warp * NV + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float r = red[j];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) r += red[w * NV + j];
    v[j] = r;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) nipt_bank_prev_kernel(
    const float* __restrict__ e, const float* __restrict__ bk,
    const float* __restrict__ trans, const float* __restrict__ ht,
    const float* __restrict__ u, const int* __restrict__ is_end,
    const float* __restrict__ perm_mask, int* __restrict__ chosen_out,
    float* __restrict__ probs_out, int G, int B, int K, float invK) {
  extern __shared__ float bank[];   // [9][K], row i*3 + j
  __shared__ float red[NWARP * NV];
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int c = tid; c < 9 * K; c += NT) bank[c] = 0.f;
  __syncthreads();
  float lg[9];
#pragma unroll
  for (int ij = 0; ij < 9; ++ij) lg[ij] = 0.f;
  float mask[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) mask[r] = perm_mask[r];

  for (int g = 0; g < G; ++g) {
    const float t0 = trans[g];
    const float jump = (trans[G + g] + (g == 0 ? 1.f : 0.f)) * invK;
    const size_t row0 = ((size_t)g * 3 * B + b) * K;       // row j: + j * B * K
    const size_t step = (size_t)B * K;
    float acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = 0.f;
    for (int c = tid; c < K; c += NT) {
      float ev[3], bv[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        ev[j] = e[row0 + j * step + c];
        bv[j] = bk[row0 + j * step + c];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float a = ev[j] * (t0 * bank[(i * 3 + j) * K + c] + jump);
          bank[(i * 3 + j) * K + c] = a;
          acc[i * 3 + j] += a;
          acc[9 + i * 3 + j] += a * bv[i];
        }
      }
    }
    block_sum(acc, red);
    float inv[9], J[9];
#pragma unroll
    for (int ij = 0; ij < 9; ++ij) {
      const float s = fmaxf(acc[ij], 1e-30f);
      inv[ij] = 1.f / s;
      lg[ij] += logf(s);
      J[ij] = acc[9 + ij] * inv[ij];
    }
    const bool end = is_end[(size_t)g * B + b] != 0;       // the same in every thread
    int chosen = 0;
    if (end) {
      float lw[6], m = -INFINITY;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        float x = ht[((size_t)g * B + b) * 6 + r];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int ij = i * 3 + invs(r, i);
          x += logf(fmaxf(J[ij], 1e-30f)) + lg[ij];
        }
        lw[r] = x;
        m = fmaxf(m, x);
      }
      float tot = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        lw[r] = expf(fmaxf(lw[r] - m, -100.f)) * mask[r];
        tot += lw[r];
      }
      const float uu = u[(size_t)g * B + b];
      float cum = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const float p = lw[r] / tot;
        cum += p;
        chosen += cum <= uu ? 1 : 0;
        if (tid == 0) probs_out[((size_t)g * B + b) * 6 + r] = p;
      }
      chosen = chosen < 5 ? chosen : 5;
#pragma unroll
      for (int ij = 0; ij < 9; ++ij) lg[ij] = 0.f;
    } else if (tid < 6) {
      probs_out[((size_t)g * B + b) * 6 + tid] = 0.f;
    }
    if (tid == 0) chosen_out[(size_t)g * B + b] = chosen;
    // normalise the thread's columns; at a block end they collapse to the
    // drawn relabelling's rows
    for (int c = tid; c < K; c += NT) {
      if (end) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int ij = i * 3 + invs(chosen, i);
          const float v = bank[ij * K + c] * inv[ij];
#pragma unroll
          for (int j = 0; j < 3; ++j) bank[(i * 3 + j) * K + c] = v;
        }
      } else {
#pragma unroll
        for (int ij = 0; ij < 9; ++ij) bank[ij * K + c] *= inv[ij];
      }
    }
  }
}

}  // namespace

extern "C" int nipt_bank_prev(const void* e, const void* bk, const void* trans,
                              const void* ht, const void* u, const void* is_end,
                              const void* perm_mask, void* chosen_out, void* probs_out,
                              int G, int B, int K, float invK, void* stream) {
  const size_t smem = 9 * (size_t)K * sizeof(float);
  if (smem > 227 * 1024 - 4096) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)nipt_bank_prev_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  nipt_bank_prev_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      (const float*)e, (const float*)bk, (const float*)trans, (const float*)ht,
      (const float*)u, (const int*)is_end, (const float*)perm_mask,
      (int*)chosen_out, (float*)probs_out, G, B, K, invK);
  return (int)cudaGetLastError();
}
