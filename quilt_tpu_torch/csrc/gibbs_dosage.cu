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
// read once; at the full-width shape (G = 512, B = 56, K = 640) a call
// reads ~370 MB (0.11 ms at 3.35 TB/s) and needs ~0.06 ms of arithmetic.
//
// Design (the previous form, gibbs_dosage_prev.cu, took a block of 128
// threads per (grid, chain), two passes through an NL x K shared-memory
// plane, 2 + 2 NL block barriers and NL 32-value butterflies):
//   * One pass, the normalisation deferred: with s = sum_k ab_k and
//     X_t = sum over the haplotypes whose bit t is set of ab_k,
//     hd[t] = ((1 - 2 eps) X_t + eps s) / max(s, 1e-30). An all-zero row
//     gives 0, as normalising first does. No plane is kept, so K is bounded
//     by nothing but device memory.
//   * A warp owns a (grid, chain) pair: no block barrier in the kernel. Its
//     lanes load 128 haplotypes at a time, 16 bytes a lane a row (alpha,
//     beta, words), and stage ab and the words in the warp's 2 KB of shared
//     memory; 8 warps a block and up to 8 blocks an SM keep the loads of
//     many pairs in flight.
//   * Lane t owns SNP t: it reads the staged haplotypes four at a time (one
//     broadcast 16-byte load a row) and adds ab_k to X_t where bit t of the
//     word is set, so the 32 per-SNP sums need no butterfly; only s takes
//     one warp reduction at the end. X is summed in four parts a chunk,
//     then chunk by chunk, so that no float32 sum runs long (a sum over all
//     K in one register is ~10x further from the plain version's).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int CHUNK = 128;   // haplotypes a warp stages at a time, 4 a lane

// NL latent rows a chain: 2 (diploid) or 3 (NIPT). VEC: 16-byte loads (K a
// multiple of 4, 16-byte aligned planes).
template <int NL, bool VEC>
__global__ void __launch_bounds__(NT) gibbs_dos_kernel(
    const float* __restrict__ alphas, const float* __restrict__ beta,
    const unsigned* __restrict__ words_T, float* __restrict__ hd, int G, int B, int K,
    int K_real, float eps) {
  __shared__ __align__(16) float stage[NWARP][NL + 1][CHUNK];   // ab rows, then the words
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * NWARP + warp;
  if (pair >= (long long)G * B) return;
  const int g = (int)(pair / B), b = (int)(pair % B);
  const int BN = NL * B;
  const float* ar[NL];
  const float* br[NL];
#pragma unroll
  for (int h = 0; h < NL; ++h) {
    ar[h] = alphas + ((size_t)g * BN + h * B + b) * K;
    br[h] = beta + ((size_t)g * BN + h * B + b) * K;
  }
  const unsigned* wr = words_T + ((size_t)g * B + b) * K;
  float(*st)[CHUNK] = stage[warp];
  unsigned* sw = reinterpret_cast<unsigned*>(st[NL]);
  const unsigned bit = 1u << lane;
  float x[NL], s[NL];   // X of SNP `lane`; the lane's share of s
#pragma unroll
  for (int h = 0; h < NL; ++h) x[h] = s[h] = 0.f;

  for (int k0 = 0; k0 < K; k0 += CHUNK) {
    const int k = k0 + 4 * lane;
    float ab[NL][4];
    unsigned w[4];
    if (VEC && k < K) {
      const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(wr + k));
      w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
#pragma unroll
      for (int h = 0; h < NL; ++h) {
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(ar[h] + k));
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(br[h] + k));
        ab[h][0] = k < K_real ? a4.x * b4.x : 0.f;
        ab[h][1] = k + 1 < K_real ? a4.y * b4.y : 0.f;
        ab[h][2] = k + 2 < K_real ? a4.z * b4.z : 0.f;
        ab[h][3] = k + 3 < K_real ? a4.w * b4.w : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k + j;
        w[j] = kk < K ? __ldg(wr + kk) : 0u;
#pragma unroll
        for (int h = 0; h < NL; ++h)
          ab[h][j] = kk < K_real ? __ldg(ar[h] + kk) * __ldg(br[h] + kk) : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < NL; ++h) {
      s[h] += (ab[h][0] + ab[h][1]) + (ab[h][2] + ab[h][3]);
      *reinterpret_cast<float4*>(&st[h][4 * lane]) =
          make_float4(ab[h][0], ab[h][1], ab[h][2], ab[h][3]);
    }
    *reinterpret_cast<uint4*>(&sw[4 * lane]) = make_uint4(w[0], w[1], w[2], w[3]);
    __syncwarp();
    // every lane walks the staged haplotypes (beyond K: ab 0, word 0) into
    // four sums a row, one per place in a group of four, which the chunk's
    // total then adds: no sum runs over more than 32 terms of a chunk
    const int n = K - k0 < CHUNK ? K - k0 : CHUNK;
    float xc[NL][4];
#pragma unroll
    for (int h = 0; h < NL; ++h) xc[h][0] = xc[h][1] = xc[h][2] = xc[h][3] = 0.f;
    for (int j = 0; j < n; j += 4) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(&sw[j]);
#pragma unroll
      for (int h = 0; h < NL; ++h) {
        const float4 a4 = *reinterpret_cast<const float4*>(&st[h][j]);
        if (w4.x & bit) xc[h][0] += a4.x;
        if (w4.y & bit) xc[h][1] += a4.y;
        if (w4.z & bit) xc[h][2] += a4.z;
        if (w4.w & bit) xc[h][3] += a4.w;
      }
    }
#pragma unroll
    for (int h = 0; h < NL; ++h) x[h] += (xc[h][0] + xc[h][1]) + (xc[h][2] + xc[h][3]);
    __syncwarp();
  }
  const float hi = 1.f - 2.f * eps;
#pragma unroll
  for (int h = 0; h < NL; ++h) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
    hd[((size_t)g * BN + h * B + b) * 32 + lane] = (hi * x[h] + eps * s[h]) / fmaxf(s[h], 1e-30f);
  }
}

template <int NL>
int launch_dos(const float* alphas, const float* beta, const unsigned* words_T, float* hd,
               int G, int B, int K, int K_real, float eps, cudaStream_t stream) {
  const long long pairs = (long long)G * B;
  const long long blocks = (pairs + NWARP - 1) / NWARP;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && ((uintptr_t)alphas & 15) == 0 && ((uintptr_t)beta & 15) == 0 &&
                   ((uintptr_t)words_T & 15) == 0;
  if (vec)
    gibbs_dos_kernel<NL, true><<<(unsigned)blocks, NT, 0, stream>>>(alphas, beta, words_T, hd,
                                                                    G, B, K, K_real, eps);
  else
    gibbs_dos_kernel<NL, false><<<(unsigned)blocks, NT, 0, stream>>>(alphas, beta, words_T, hd,
                                                                     G, B, K, K_real, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gibbs_dos(const void* alphas, const void* beta,
                         const void* words_T, void* hd, int G, int B, int K,
                         int K_real, int nl, float eps, void* stream) {
  const float* a = (const float*)alphas;
  const float* bt = (const float*)beta;
  const unsigned* w = (const unsigned*)words_T;
  cudaStream_t s = (cudaStream_t)stream;
  if (nl == 2) return launch_dos<2>(a, bt, w, (float*)hd, G, B, K, K_real, eps, s);
  if (nl == 3) return launch_dos<3>(a, bt, w, (float*)hd, G, B, K, K_real, eps, s);
  return (int)cudaErrorInvalidValue;
}
