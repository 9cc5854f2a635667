// Per-grid haplotype dosages of a Gibbs call from its final forward /
// backward state.
//
// Replaces the Pallas TPU kernel quilt_tpu/kernels/gibbs_pallas.py:
//   gibbs_dos <- _make_dos_kernel (launched by _dosage_sweep): per grid g
//                and state row, gamma = alpha * beta over the row's real
//                haplotypes (k < K_real), normalised (floor 1e-30), then for
//                each of the grid's 32 SNPs t
//                hd[t] = sum_k gamma_k * (bit_k,t * (1 - 2 eps) + eps),
//                the bits unpacked from the packed subset words.
// Layouts are the JAX function's: alphas / beta [G, nl*B, K] (state row
// h*B + b), words_T [G, B, K] int32, hd [G, nl*B, 32].
//
// What bounds it on the H100: device memory. Every alpha, beta and word is
// read once and used for ~32 FMAs, far below the card's ~20 FLOPs per byte
// of float32 balance; at the full-width shape (G=512, B=56, K=640) a call
// reads ~370 MB.
//
// Simple design: one thread block per (grid g, chain b) serves both latent
// rows h*B + b, so row b's words are read once for both. Threads own
// haplotype columns (reads along K coalesce); each keeps alpha*beta of its
// columns in shared memory for the second pass, one block reduction gives
// the two normalisers, then each thread holds 32 per-SNP partial sums per
// latent row, which reduce with a transposing warp butterfly (31 shuffles
// for 32 values) and one shared-memory pass across warps.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;
constexpr int NWARP = NT / 32;

// Sums N values over the block; every thread receives the results.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[warp * N + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float r = red[j];
    for (int w = 1; w < NWARP; ++w) r += red[w * N + j];
    v[j] = r;
  }
  __syncthreads();
}

// Sums 32 values over the block; thread t < 32 returns the sum of value t.
// Within a warp, a transposing butterfly leaves lane l with the warp's sum
// of value l.
__device__ __forceinline__ float block_sum32(float (&v)[32], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16, n = 32; o > 0; o >>= 1, n >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const float send = upper ? v[j] : v[j + n / 2];
      const float keep = upper ? v[j + n / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  red[warp * 32 + lane] = v[0];
  __syncthreads();
  float r = 0.f;
  if (threadIdx.x < 32) {
    r = red[threadIdx.x];
    for (int w = 1; w < NWARP; ++w) r += red[w * 32 + threadIdx.x];
  }
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(NT) gibbs_dos_kernel(
    const float* __restrict__ alphas, const float* __restrict__ beta,
    const int* __restrict__ words_T, float* __restrict__ hd, int B, int K,
    int K_real, float eps) {
  extern __shared__ float ab[];   // [2][K] alpha * beta, owned per column
  __shared__ float red[NWARP * 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int BN = 2 * B;
  const size_t r0 = ((size_t)g * BN + b) * K;
  const size_t r1 = ((size_t)g * BN + B + b) * K;
  const int* w = words_T + ((size_t)g * B + b) * K;

  float s[2] = {0.f, 0.f};
  for (int k = threadIdx.x; k < K; k += NT) {
    const bool real = k < K_real;
    const float x0 = real ? alphas[r0 + k] * beta[r0 + k] : 0.f;
    const float x1 = real ? alphas[r1 + k] * beta[r1 + k] : 0.f;
    ab[k] = x0;
    ab[K + k] = x1;
    s[0] += x0;
    s[1] += x1;
  }
  block_sum(s, red);
  const float q0 = 1.f / fmaxf(s[0], 1e-30f), q1 = 1.f / fmaxf(s[1], 1e-30f);
  const float hi = 1.f - eps;   // bit * (1 - 2 eps) + eps at a set bit

  float p0[32], p1[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) p0[t] = p1[t] = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    const unsigned word = (unsigned)w[k];
    const float g0 = ab[k] * q0, g1 = ab[K + k] * q1;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const float e = ((word >> t) & 1u) ? hi : eps;
      p0[t] += g0 * e;
      p1[t] += g1 * e;
    }
  }
  const float d0 = block_sum32(p0, red);
  const float d1 = block_sum32(p1, red);
  if (threadIdx.x < 32) {
    hd[((size_t)g * BN + b) * 32 + threadIdx.x] = d0;
    hd[((size_t)g * BN + B + b) * 32 + threadIdx.x] = d1;
  }
}

}  // namespace

extern "C" int gibbs_dos(const void* alphas, const void* beta,
                         const void* words_T, void* hd, int G, int B, int K,
                         int K_real, float eps, void* stream) {
  const size_t smem = 2 * (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)gibbs_dos_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  // grids on x: a long region has more grids than the 65,535 blocks y allows
  gibbs_dos_kernel<<<dim3(G, B), NT, smem, (cudaStream_t)stream>>>(
      (const float*)alphas, (const float*)beta, (const int*)words_T,
      (float*)hd, B, K, K_real, eps);
  return (int)cudaGetLastError();
}
