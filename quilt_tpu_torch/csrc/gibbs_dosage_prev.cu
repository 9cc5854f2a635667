// The Gibbs dosage kernel as it was before its redesign in gibbs_dosage.cu,
// kept beside it so that chip_smoke.py can time the new form in turn with
// it on one card. Measurement-only: the package reaches it only through the
// private `_prev=True` of kernels/gibbs_dosage.py:dosage_sweep, and it takes
// K only while NL x K floats fit a block's shared memory.
//
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
// h*B + b), words_T [G, B, K] int32, hd [G, nl*B, 32]; nl = 2 (diploid) or
// 3 (NIPT), a template parameter.
//
// What bounds it on the H100: device memory. Every alpha, beta and word is
// read once and used for ~32 FMAs, far below the card's ~20 FLOPs per byte
// of float32 balance; at the full-width shape (G=512, B=56, K=640) a call
// reads ~370 MB.
//
// Simple design: one thread block per (grid g, chain b) serves all its latent
// rows h*B + b, so row b's words are read once for them. Threads own
// haplotype columns (reads along K coalesce); each keeps alpha*beta of its
// columns in shared memory for the second pass, one block reduction gives
// the rows' normalisers, then each thread holds 32 per-SNP partial sums per
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

// NL latent rows a chain: 2 (diploid) or 3 (NIPT).
template <int NL>
__global__ void __launch_bounds__(NT) gibbs_dos_kernel(
    const float* __restrict__ alphas, const float* __restrict__ beta,
    const int* __restrict__ words_T, float* __restrict__ hd, int B, int K,
    int K_real, float eps) {
  extern __shared__ float ab[];   // [NL][K] alpha * beta, owned per column
  __shared__ float red[NWARP * 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int BN = NL * B;
  size_t r[NL];
#pragma unroll
  for (int h = 0; h < NL; ++h) r[h] = ((size_t)g * BN + h * B + b) * K;
  const int* w = words_T + ((size_t)g * B + b) * K;

  float s[NL];
#pragma unroll
  for (int h = 0; h < NL; ++h) s[h] = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    const bool real = k < K_real;
#pragma unroll
    for (int h = 0; h < NL; ++h) {
      const float x = real ? alphas[r[h] + k] * beta[r[h] + k] : 0.f;
      ab[h * K + k] = x;
      s[h] += x;
    }
  }
  block_sum(s, red);
  float q[NL];
#pragma unroll
  for (int h = 0; h < NL; ++h) q[h] = 1.f / fmaxf(s[h], 1e-30f);
  const float hi = 1.f - eps;   // bit * (1 - 2 eps) + eps at a set bit

  float p[NL][32];
#pragma unroll
  for (int h = 0; h < NL; ++h) {
#pragma unroll
    for (int t = 0; t < 32; ++t) p[h][t] = 0.f;
  }
  for (int k = threadIdx.x; k < K; k += NT) {
    const unsigned word = (unsigned)w[k];
    float gk[NL];
#pragma unroll
    for (int h = 0; h < NL; ++h) gk[h] = ab[h * K + k] * q[h];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const float e = ((word >> t) & 1u) ? hi : eps;
#pragma unroll
      for (int h = 0; h < NL; ++h) p[h][t] += gk[h] * e;
    }
  }
#pragma unroll
  for (int h = 0; h < NL; ++h) {
    const float d = block_sum32(p[h], red);
    if (threadIdx.x < 32) hd[((size_t)g * BN + h * B + b) * 32 + threadIdx.x] = d;
  }
}

template <int NL>
int launch_dos(const float* alphas, const float* beta, const int* words_T,
               float* hd, int G, int B, int K, int K_real, float eps,
               cudaStream_t stream) {
  const size_t smem = NL * (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)gibbs_dos_kernel<NL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  // grids on x: a long region has more grids than the 65,535 blocks y allows
  gibbs_dos_kernel<NL><<<dim3(G, B), NT, smem, stream>>>(alphas, beta, words_T, hd,
                                                        B, K, K_real, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gibbs_dos_prev(const void* alphas, const void* beta,
                         const void* words_T, void* hd, int G, int B, int K,
                         int K_real, int nl, float eps, void* stream) {
  const float* a = (const float*)alphas;
  const float* bt = (const float*)beta;
  const int* w = (const int*)words_T;
  cudaStream_t s = (cudaStream_t)stream;
  if (nl == 2) return launch_dos<2>(a, bt, w, (float*)hd, G, B, K, K_real, eps, s);
  if (nl == 3) return launch_dos<3>(a, bt, w, (float*)hd, G, B, K, K_real, eps, s);
  return (int)cudaErrorInvalidValue;
}
