// Gibbs forward and backward sweeps of the diploid per-read sampler.
//
// Replaces two Pallas TPU kernels of quilt_tpu/kernels/gibbs_pallas.py:
//   gibbs_fwd  <- _make_fwd_kernel (launched by _fwd_sweep): alpha advance
//                 into each grid, then sequential resampling of the grid's
//                 reads from pre-drawn uniforms, with the alpha / pC /
//                 lemg / label-count updates of every flip;
//   gibbs_bwd  <- _make_bwd_kernel (launched by _bwd_sweep): the reverse
//                 max-normalised beta recursion over grids.
// Layouts are the JAX functions' nl-major ones (state row h*B + b).
//
// What bounds it on the H100: latency, not bytes or FLOPs. Every read is a
// sequential step whose candidate weights need sums over all K haplotypes
// of both latent rows, and each flip changes the state the next read sees;
// a sweep at the full-width shape (G=512 grids, ~3 reads per grid, K=640)
// moves only ~0.6 GB but is ~10^4 dependent block-wide reductions long.
//
// Simple design: one thread block per chain b holds both latent rows
// (the candidate weights couple them), K across the block's threads, the
// grid loop and the in-grid read loop inside the block (alpha carries
// across grids). Each thread owns the same haplotype columns throughout,
// so the per-row planes in shared memory need no barriers; the only
// barriers are those of the block reductions, each of which reduces all
// the sums one step needs at once (4 for the candidate weights, 2 for the
// renormalisation). All arithmetic, including the per-read emissions
// (lem_pad), is float32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr float NEG = -1e30f;

struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Reduces N values over the block; every thread receives the same result
// (the xor butterfly and the shared-memory pass use one order for all).
template <int N, class Op>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* red, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[j] = op(v[j], __shfl_xor_sync(0xffffffffu, v[j], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[warp * N + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float r = red[j];
    for (int w = 1; w < NWARP; ++w) r = op(r, red[w * N + j]);
    v[j] = r;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) gibbs_fwd_kernel(
    const float* __restrict__ lemg, const float* __restrict__ beta,
    const float* __restrict__ lem_pad, const int* __restrict__ slots,
    const int* __restrict__ first_read, const float* __restrict__ lab_init,
    const float* __restrict__ trans, const int* __restrict__ cnt_max,
    float* __restrict__ lemg_out, float* __restrict__ alpha_out,
    int* __restrict__ h_out, float* __restrict__ logc_out,
    float* __restrict__ uf_out, float* __restrict__ lab_out,
    int G, int B, int W, int K, int K_real, int it_mode, int want_alpha,
    float invK) {
  extern __shared__ float smem[];
  float* alpha = smem;          // [2][K] running alpha of both latent rows
  float* bet = smem + 2 * K;    // [2][K] beta of the current grid
  float* lg = smem + 4 * K;     // [2][K] lemg of the current grid (updated)
  __shared__ float red[NWARP * 4];

  const int b = blockIdx.x;
  const int BN = 2 * B;
  const size_t WB = (size_t)W * B;
  const int first = first_read[b];
  float logc0 = 0.f, logc1 = 0.f;
  float lab0 = lab_init[2 * b], lab1 = lab_init[2 * b + 1];
  float pc0 = 0.f, pc1 = 0.f;
  bool uf = false;
  for (int k = threadIdx.x; k < K; k += NT) {
    alpha[k] = 0.f;
    alpha[K + k] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    // ---- alpha advance into grid g ----
    const float t0 = trans[g], t1 = trans[G + g];
    const float isf = (g == 0) ? 1.f : 0.f;
    const size_t r0 = ((size_t)g * BN + b) * K;
    const size_t r1 = ((size_t)g * BN + B + b) * K;
    float mx[2] = {NEG, NEG};
    for (int k = threadIdx.x; k < K; k += NT) {
      const float x0 = lemg[r0 + k], x1 = lemg[r1 + k];
      lg[k] = x0;
      lg[K + k] = x1;
      bet[k] = beta[r0 + k];
      bet[K + k] = beta[r1 + k];
      if (k < K_real) {
        mx[0] = fmaxf(mx[0], x0);
        mx[1] = fmaxf(mx[1], x1);
      }
    }
    block_reduce(mx, red, MaxOp());
    float s[2] = {0.f, 0.f};
    for (int k = threadIdx.x; k < K; k += NT) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float e = (k < K_real) ? expf(lg[h * K + k] - mx[h]) : 0.f;
        const float a = e * (t0 * alpha[h * K + k] + (t1 + isf) * invK);
        alpha[h * K + k] = a;
        s[h] += a;
      }
    }
    block_reduce(s, red, SumOp());
    uf = uf || !isfinite(s[0]) || s[0] <= 0.f || !isfinite(s[1]) ||
         s[1] <= 0.f;
    const float ss0 = s[0] > 0.f ? s[0] : 1.f;
    const float ss1 = s[1] > 0.f ? s[1] : 1.f;
    const float q0 = 1.f / ss0, q1 = 1.f / ss1;
    float pc[2] = {0.f, 0.f};
    for (int k = threadIdx.x; k < K; k += NT) {
      const float a0 = alpha[k] * q0, a1 = alpha[K + k] * q1;
      alpha[k] = a0;
      alpha[K + k] = a1;
      pc[0] += a0 * bet[k];
      pc[1] += a1 * bet[K + k];
    }
    block_reduce(pc, red, SumOp());
    pc0 = pc[0];
    pc1 = pc[1];
    logc0 = logc0 + logf(ss0) + mx[0];
    logc1 = logc1 + logf(ss1) + mx[1];

    // ---- sequential resampling of the grid's reads ----
    const int n = cnt_max[g];
    for (int i = 0; i < n; ++i) {
      const size_t sl = ((size_t)g * 4 * W + i) * B + b;   // plane 0
      const float u = __int_as_float(slots[sl]);
      const int hC = slots[sl + WB];
      const bool skip = slots[sl + 2 * WB] > 0;
      const int rg = slots[sl + 3 * WB];
      const float* lem = lem_pad + (((size_t)g * W + i) * B + b) * K;
      float q[4] = {0.f, 0.f, 0.f, 0.f};   // gain0, gain1, lose0, lose1
      for (int k = threadIdx.x; k < K; k += NT) {
        const float l = lem[k];
        const float em = expf(l), iv = expf(-l);
        const float ab0 = alpha[k] * bet[k], ab1 = alpha[K + k] * bet[K + k];
        q[0] += ab0 * em;
        q[1] += ab1 * em;
        q[2] += ab0 * iv;
        q[3] += ab1 * iv;
      }
      block_reduce(q, red, SumOp());
      const float gain0 = q[0], gain1 = q[1];
      bool doing_pass = false, doing_init = false;
      if (it_mode == 0) {
        doing_pass = rg < first;
        doing_init = rg >= first;
      } else if (it_mode == 1) {
        doing_init = rg < first;
      }
      const bool normal = !doing_init;
      const bool oh0 = hC == 0, oh1 = hC == 1;
      const float lose_C = oh1 ? q[3] : q[2];
      // candidate weights w[n] = prior[n] * prod_m term(n, m)
      // (reference: sample_reads_in_grid, gibbs-nipt.cpp:733-1341)
      const float w0 = (doing_init ? gain0 : (oh0 ? pc0 : gain0)) *
                       (doing_init ? pc1 : (oh0 ? pc1 : (oh1 ? lose_C : pc1))) *
                       0.5f;
      const float w1 = (doing_init ? pc0 : (oh1 ? pc0 : (oh0 ? lose_C : pc0))) *
                       (doing_init ? gain1 : (oh1 ? pc1 : gain1)) * 0.5f;
      const float wsum = w0 + w1;
      const bool badv = !isfinite(wsum) || wsum <= 0.f;
      uf = uf || (badv && !skip);
      const float wss = wsum > 0.f ? wsum : 1.f;
      const float cum = badv ? 0.5f : w0 / wss;
      const int h_new = (cum <= u) ? 1 : 0;
      const bool active = !skip && !doing_pass && !badv;
      const bool flip = active && (h_new != hC || doing_init);
      const float fl = flip ? 1.f : 0.f;
      const float d0 = ((h_new == 0 ? 1.f : 0.f) - (oh0 ? 1.f : 0.f) * (normal ? 1.f : 0.f)) * fl;
      const float d1 = ((h_new == 1 ? 1.f : 0.f) - (oh1 ? 1.f : 0.f) * (normal ? 1.f : 0.f)) * fl;
      float sn[2] = {0.f, 0.f};
      for (int k = threadIdx.x; k < K; k += NT) {
        float a0 = alpha[k], a1 = alpha[K + k];
        if (flip) {
          const float l = lem[k];
          const float em = expf(l), iv = expf(-l);
          a0 *= (h_new == 0 ? em : 1.f) * ((oh0 && normal) ? iv : 1.f);
          a1 *= (h_new == 1 ? em : 1.f) * ((oh1 && normal) ? iv : 1.f);
          lg[k] += d0 * l;
          lg[K + k] += d1 * l;
        }
        alpha[k] = a0;
        alpha[K + k] = a1;
        if (k < K_real) {
          sn[0] += a0;
          sn[1] += a1;
        }
      }
      block_reduce(sn, red, SumOp());
      // pC after the move: the winner gets gain; (normal) the previous
      // label gets lose_C; the other keeps its value
      if (flip) {
        const float n0 = (h_new == 0) ? gain0 : ((oh0 && normal) ? lose_C : pc0);
        const float n1 = (h_new == 1) ? gain1 : ((oh1 && normal) ? lose_C : pc1);
        pc0 = n0;
        pc1 = n1;
        lab0 += ((h_new == 0 ? 1.f : 0.f) - (oh0 ? 1.f : 0.f));
        lab1 += ((h_new == 1 ? 1.f : 0.f) - (oh1 ? 1.f : 0.f));
      }
      const float z0 = sn[0] > 0.f ? sn[0] : 1.f;
      const float z1 = sn[1] > 0.f ? sn[1] : 1.f;
      const float rs0 = 1.f / z0, rs1 = 1.f / z1;
      for (int k = threadIdx.x; k < K; k += NT) {
        alpha[k] *= rs0;
        alpha[K + k] *= rs1;
      }
      logc0 += logf(z0);
      logc1 += logf(z1);
      pc0 *= rs0;
      pc1 *= rs1;
      if (threadIdx.x == 0)
        h_out[((size_t)g * W + i) * B + b] = flip ? h_new : hC;
    }
    for (int i = n + threadIdx.x; i < W; i += NT)
      h_out[((size_t)g * W + i) * B + b] = slots[((size_t)g * 4 * W + i) * B + b + WB];
    for (int k = threadIdx.x; k < K; k += NT) {
      lemg_out[r0 + k] = lg[k];
      lemg_out[r1 + k] = lg[K + k];
      if (want_alpha) {
        alpha_out[r0 + k] = alpha[k];
        alpha_out[r1 + k] = alpha[K + k];
      }
    }
  }
  if (threadIdx.x == 0) {
    logc_out[b] = logc0;
    logc_out[B + b] = logc1;
    uf_out[b] = uf ? 1.f : 0.f;
    lab_out[2 * b] = lab0;
    lab_out[2 * b + 1] = lab1;
  }
}

__global__ void __launch_bounds__(NT) gibbs_bwd_kernel(
    const float* __restrict__ lemg, const float* __restrict__ trans,
    float* __restrict__ beta_out, int G, int BN, int K, int K_real,
    float invK) {
  extern __shared__ float bs[];   // [K] beta of the row, owned per column
  __shared__ float red[NWARP];
  const int row = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += NT) {
    bs[k] = 1.f;
    beta_out[((size_t)(G - 1) * BN + row) * K + k] = 1.f;
  }
  for (int g = G - 2; g >= 0; --g) {
    const int gn = g + 1;
    const float* lr = lemg + ((size_t)gn * BN + row) * K;
    float m[1] = {NEG};
    for (int k = threadIdx.x; k < K_real; k += NT) m[0] = fmaxf(m[0], lr[k]);
    block_reduce(m, red, MaxOp());
    float sm[1] = {0.f};
    for (int k = threadIdx.x; k < K; k += NT) {
      const float e = (k < K_real) ? expf(lr[k] - m[0]) : 0.f;
      const float etb = e * bs[k];
      bs[k] = etb;
      sm[0] += etb;
    }
    block_reduce(sm, red, SumOp());
    const float t0 = trans[gn];
    const float c = trans[G + gn] * sm[0] * invK;
    float mb[1] = {-INFINITY};
    for (int k = threadIdx.x; k < K; k += NT) {
      const float bn = t0 * bs[k] + c;
      bs[k] = bn;
      mb[0] = fmaxf(mb[0], bn);
    }
    block_reduce(mb, red, MaxOp());
    const float d = mb[0] > 0.f ? mb[0] : 1.f;
    for (int k = threadIdx.x; k < K; k += NT) {
      const float v = bs[k] / d;
      bs[k] = v;
      beta_out[((size_t)g * BN + row) * K + k] = v;
    }
  }
}

int set_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

}  // namespace

extern "C" int gibbs_fwd(
    const void* lemg, const void* beta, const void* lem_pad,
    const void* slots, const void* first_read, const void* lab_init,
    const void* trans, const void* cnt_max, void* lemg_out, void* alpha_out,
    void* h_out, void* logc_out, void* uf_out, void* lab_out, int G, int B,
    int W, int K, int K_real, int it_mode, int want_alpha, float invK,
    void* stream) {
  const size_t smem = 6 * (size_t)K * sizeof(float);
  int err = set_smem((const void*)gibbs_fwd_kernel, smem);
  if (err) return err;
  gibbs_fwd_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      (const float*)lemg, (const float*)beta, (const float*)lem_pad,
      (const int*)slots, (const int*)first_read, (const float*)lab_init,
      (const float*)trans, (const int*)cnt_max, (float*)lemg_out,
      (float*)alpha_out, (int*)h_out, (float*)logc_out, (float*)uf_out,
      (float*)lab_out, G, B, W, K, K_real, it_mode, want_alpha, invK);
  return (int)cudaGetLastError();
}

extern "C" int gibbs_bwd(const void* lemg, const void* trans, void* beta_out,
                         int G, int BN, int K, int K_real, float invK,
                         void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  int err = set_smem((const void*)gibbs_bwd_kernel, smem);
  if (err) return err;
  gibbs_bwd_kernel<<<BN, NT, smem, (cudaStream_t)stream>>>(
      (const float*)lemg, (const float*)trans, (float*)beta_out, G, BN, K,
      K_real, invK);
  return (int)cudaGetLastError();
}
