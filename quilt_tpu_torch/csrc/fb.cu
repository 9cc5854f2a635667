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
// recursion over K = 5,120 haplotypes, one block a row, so a step has one
// SM. Measured (PERF.md section 6), a step's reductions are 0.7-1.7
// us of the 3.9 (forward) and ~10.5 (backward) it takes; the rest is the
// per-haplotype work of that one SM: the emission tables' lookups and the
// dosage's 32 bit tests and adds (integer-pipe heavy), with 16 warps to
// hide their latency.
//
// Design (one 512-thread block a row, haplotypes k = tid + c*NT, c < CPT):
//   * Row state on chip. alpha (forward, remat), beta and e of the next
//     grid (backward) stay in registers for K_pad <= 16*NT (CPT a template
//     parameter); the chunk's rematerialised alphas live in dynamic shared
//     memory, one plane a grid (SMEM = true), where CG planes fit the 227
//     KB, else (large K_pad) one plane a grid in a global scratch row. A
//     thread reads and writes only its own columns of every plane, so no
//     plane needs a barrier. The general instantiation (CPT = 0, any K_pad)
//     keeps the register state in global planes instead.
//   * Few dependent reductions a step. Forward and remat reduce the pair
//     (m, s) of the online softmax: a thread takes the maximum of its own
//     logits and the sum of its alphas scaled by it, and the pairs combine
//     as m = max(m1, m2), s = s1 e^(m1-m) + s2 e^(m2-m); each thread then
//     rescales its alphas by e^(m_t - m) / s. The reverse step, with
//     etb = e_{g+1} beta, c = jump/K and se = sum etb, has beta' = stay etb
//     + c se (its maximum stay max(etb) + c se, as fma is monotone) and
//     gamma = alpha beta' / sum(alpha beta'). It takes two reductions:
//     (se, max etb), then the gamma sum and its 32 bit-masked sums. (One
//     reduction of 68 values, which adds 32 sums a haplotype and spills at
//     10 haplotypes a thread, was slower on the H100: PERF.md section 6.)
//     A reduction is a butterfly per warp (transposing for the 32 sums),
//     one shared-memory record per warp double-buffered by parity, one
//     barrier. The global last grid (beta = 1) is the case stay = 0,
//     c se = 1.
//   * No es planes: the reverse step at grid g computes e_g from the bits
//     of words[g] that its dosage sums extract anyway and the maximum
//     mx_g that the remat kept, one float a grid.
//   * Top-K off the chain: once grid j's alphas are read, their plane takes
//     the grid's gammas; at a thinned grid each warp takes its own top K_top
//     from it by shuffles (lowest index first on ties), one barrier, and
//     warp 0 merges the 16 lists while the other warps go on to the next
//     step.
//   * Operands ahead of the chain: the panel words of the next step are
//     loaded into registers before the current step's reduction, and a
//     chunk's GL log-ratios (and the emission tables) are staged in shared
//     memory once a chunk.
//   * Emissions: once a chunk, eight 16-entry tables a grid of the partial
//     sums of the grid's log-ratios over each nibble of a panel word, so a
//     logit is 8 conflict-free shared-memory lookups (adding the set bits'
//     log-ratios one at a time was slower on the H100: PERF.md section 6;
//     fb_common.cuh stage_chunk / logit, shared with fb_tiled.cu).
//     The forward and the remat call one step routine, so the rebuilt
//     alphas equal the forward's bit for bit.
//   * The wrapper (kernels/fb.py) chooses the storage and the columns a
//     thread holds in registers, and sizes the scratch rows for them; the
//     entry points only check that an instantiation exists for its choice.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fb_common.cuh"

namespace {

constexpr int RW = 33;               // floats of a warp's record in the gamma reduction
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may take

// Dynamic shared memory of the backward kernel in floats, region by region
// (kernels/fb.py:_bwd_smem_bytes mirrors it): the two reduction buffers,
// the chunk's maxima, the top-K candidate lists, the chunk's log-ratios and
// emission tables, and (SMEM storage) the chunk's alpha planes.
__host__ __device__ inline int bwd_smem_floats(int CG, int K_pad, int K_top, bool planes) {
  return r4(2 * NWARP * RW) + r4(4 * NWARP) + r4(CG) + 2 * r4(NWARP * K_top) +
         r4(CG * 32) + CG * EMF + (planes ? CG * K_pad : 0);
}
__host__ __device__ inline int fwd_smem_floats(int CG) {
  return r4(4 * NWARP) + r4(CG * 32) + CG * EMF;
}

template <int CPT>
__device__ __forceinline__ int ncols(int K_pad) {
  return CPT > 0 ? CPT : (K_pad + NT - 1) / NT;
}

// ---------------------------------------------------------------------------
// reductions (every thread ends with the same values: the warps' partials
// are combined in one order by all)
// ---------------------------------------------------------------------------

// (m, s) of the online softmax: the warp's maximum by a butterfly, then
// the sum of s e^(m - warp max) by a butterfly; after one barrier every
// thread takes the block maximum M of the warps' maxima and adds the warps'
// s_w e^(m_w - M) in warp order (16 independent exponentials, no chain).
// red: 2 x NWARP x 2 floats, double-buffered by `par`.
__device__ __forceinline__ void reduce_ms(float& m, float& s, float* red, int& par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mw = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  float sw = s * expf(m - mw);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sw += __shfl_xor_sync(0xffffffffu, sw, o);
  float2* buf = reinterpret_cast<float2*>(red) + par * NWARP;
  par ^= 1;
  if (lane == 0) buf[warp] = make_float2(mw, sw);
  __syncthreads();
  float2 v[NWARP];
#pragma unroll
  for (int w = 0; w < NWARP; ++w) v[w] = buf[w];
  m = v[0].x;
#pragma unroll
  for (int w = 1; w < NWARP; ++w) m = fmaxf(m, v[w].x);
  s = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) s += v[w].y * expf(v[w].x - m);
}

// A sum and a maximum (the reverse step's first reduction): red is the
// remat's buffer, 2 x NWARP float2, shared with reduce_ms and its parity.
__device__ __forceinline__ void reduce_sum_max(float& s, float& m, float* red, int& par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  float2* buf = reinterpret_cast<float2*>(red) + par * NWARP;
  par ^= 1;
  if (lane == 0) buf[warp] = make_float2(s, m);
  __syncthreads();
  float2 v = buf[0];
  s = v.x;
  m = v.y;
#pragma unroll
  for (int w = 1; w < NWARP; ++w) {
    v = buf[w];
    s += v.x;
    m = fmaxf(m, v.y);
  }
}

// The gamma sum G to every thread and the 32 bit-masked sums D to thread
// t < 32 as d (the reverse step's second reduction). red: 2 x NWARP x RW
// floats, a warp's record its 32 sums and G, double-buffered by `par`.
__device__ __forceinline__ void reduce_gamma(float& G, float (&D)[32], float* red, int& par,
                                             float& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_transpose_sum(D);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) G += __shfl_xor_sync(0xffffffffu, G, o);
  float* buf = red + par * NWARP * RW;
  par ^= 1;
  buf[warp * RW + lane] = D[0];
  if (lane == 0) buf[warp * RW + 32] = G;
  __syncthreads();
  G = buf[32];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) G += buf[w * RW + 32];
  if (threadIdx.x < 32) {
    d = buf[lane];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) d += buf[w * RW + lane];
  }
}

// ---------------------------------------------------------------------------
// the forward step, shared by the forward and the remat
// ---------------------------------------------------------------------------

// Loads the words of grid g at the thread's columns (register forms only).
template <int CPT>
__device__ __forceinline__ void load_words(Cols<CPT, unsigned>& w, const int* __restrict__ words,
                                           int g, int K_pad) {
  if constexpr (CPT > 0) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = threadIdx.x + c * NT;
      w[c] = k < K_pad ? (unsigned)__ldg(words + (size_t)g * K_pad + k) : 0u;
    }
  }
}

template <int CPT>
__device__ __forceinline__ unsigned word_at(Cols<CPT, unsigned>& w, int c,
                                            const int* __restrict__ words, int g, int K_pad) {
  if constexpr (CPT > 0) return w[c];
  else return (unsigned)__ldg(words + (size_t)g * K_pad + threadIdx.x + c * NT);
}

// One grid of the forward recursion: alpha (normalised) <- the normalised
// (stay alpha + cj) e of grid g (local index j of the staged chunk); w holds
// the words of grid g and, on return, those of grid g_next (if >= 0).
// Returns the grid's logit maximum mx and normaliser ssum.
template <int CPT>
__device__ __forceinline__ void fwd_step(Cols<CPT>& alpha, Cols<CPT>& x, Cols<CPT, unsigned>& w,
                                         const int* __restrict__ words, int g, int g_next, int j,
                                         const float* em, float stay,
                                         float cj, int K, int K_pad, float* red, int& par,
                                         float& mx, float& ssum) {
  const int nc = ncols<CPT>(K_pad);
  float m = NEG;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int k = threadIdx.x + c * NT;
    if (k < K) {
      const float v = logit(word_at<CPT>(w, c, words, g, K_pad), em, j);
      x[c] = v;
      m = fmaxf(m, v);
    }
  }
  if (g_next >= 0) load_words<CPT>(w, words, g_next, K_pad);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int k = threadIdx.x + c * NT;
    if (k < K) {
      const float a = __fmul_rn(__fmaf_rn(stay, alpha[c], cj), expf(x[c] - m));
      alpha[c] = a;
      s += a;
    } else if (k < K_pad) {
      alpha[c] = 0.f;
    }
  }
  const float mt = m;
  reduce_ms(m, s, red, par);
  const float r = expf(mt - m) / s;
#pragma unroll
  for (int c = 0; c < nc; ++c)
    if (threadIdx.x + c * NT < K) alpha[c] = alpha[c] * r;
  mx = m;
  ssum = s;
}

template <int CPT>
__global__ void __launch_bounds__(NT, 1) fb_fwd_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, float* __restrict__ ckpt,
    float* __restrict__ logs, float* __restrict__ scratch, int Gp, int K,
    int K_pad, int B, int CG, float invK) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  float* dls_s = red + r4(4 * NWARP);
  float* em = dls_s + r4(CG * 32);
  const int b = blockIdx.x;
  const int nc = ncols<CPT>(K_pad);
  const float* dlr = dl + (size_t)b * Gp * 32;
  Cols<CPT> alpha, x;
  Cols<CPT, unsigned> w;
  if constexpr (CPT == 0) {
    alpha.p = scratch + (size_t)b * 2 * K_pad;
    x.p = alpha.p + K_pad;
  }
#pragma unroll
  for (int c = 0; c < nc; ++c)
    if (threadIdx.x + c * NT < K_pad) alpha[c] = 0.f;
  load_words<CPT>(w, words, 0, K_pad);
  float acc = 0.f;
  int par = 0;
  for (int g0 = 0; g0 < Gp; g0 += CG) {
    float* cr = ckpt + ((size_t)(g0 / CG) * B + b) * K_pad;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int k = threadIdx.x + c * NT;
      if (k < K_pad) cr[k] = alpha[c];
    }
    stage_chunk(dlr, g0, CG, dls_s, em);
    for (int j = 0; j < CG; ++j) {
      const int g = g0 + j;
      float mx, ssum;
      fwd_step<CPT>(alpha, x, w, words, g, g + 1 < Gp ? g + 1 : -1, j, em, trans2[g],
                    trans2[Gp + g] * invK, K, K_pad, red, par, mx, ssum);
      acc = acc + logf(ssum) + mx;
    }
  }
  if (threadIdx.x == 0) logs[b] = acc;
}

// ---------------------------------------------------------------------------
// the backward kernel
// ---------------------------------------------------------------------------

// Per-warp top K_top of the plane v (the thread's own columns; lowest
// index first on ties) into the warp's candidate list; taken entries are
// set to -inf.
template <int CPT>
__device__ __forceinline__ void warp_topk(float* v, int K_pad, int K_top, float* cv, int* ci) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = ncols<CPT>(K_pad);
  for (int t = 0; t < K_top; ++t) {
    float bv = -INFINITY;
    int bi = 0x7fffffff, cb = -1;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int k = threadIdx.x + c * NT;
      if (k < K_pad && v[k] > bv) {   // columns ascend: the first maximum has the lowest index
        bv = v[k];
        bi = k;
        cb = c;
      }
    }
    const int mine = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (cb >= 0 && bi == mine) v[bi] = -INFINITY;
    if (lane == 0) {
      cv[warp * K_top + t] = bv;
      ci[warp * K_top + t] = bi;
    }
  }
}

// Warp 0 merges the NWARP candidate lists into the row's top K_top.
__device__ __forceinline__ void merge_topk(float* cv, int* ci, int K_top, float* tvr, int* tir) {
  const int lane = threadIdx.x & 31;
  const int n = NWARP * K_top;
  for (int t = 0; t < K_top; ++t) {
    float bv = -INFINITY;
    int bi = 0x7fffffff, bp = -1;
    for (int q = lane; q < n; q += 32) {
      const float v = cv[q];
      const int i = ci[q];
      if (v > bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
        bp = q;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const int op = __shfl_xor_sync(0xffffffffu, bp, o);
      if (ov > bv || (ov == bv && (oi < bi || (oi == bi && op < bp)))) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (lane == 0) {
      tvr[t] = bv;
      tir[t] = bi;
      if (bp >= 0) cv[bp] = -INFINITY;
    }
    __syncwarp();
  }
}

template <int CPT, bool SMEM>
__global__ void __launch_bounds__(NT, 1) fb_bwd_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ ckpt, const float* __restrict__ trans2,
    const int* __restrict__ thin, float* __restrict__ dos,
    float* __restrict__ tv, int* __restrict__ ti, float* __restrict__ scratch,
    const float* __restrict__ cap, float* __restrict__ gcap,
    int Gp, int K, int K_pad, int B, int CG, int K_top, float invK,
    float eps) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);            // reverse reduction
  float* red_ms = red + r4(2 * NWARP * RW);                // remat reduction
  float* mxs = red_ms + r4(4 * NWARP);                     // the chunk's logit maxima
  float* cv = mxs + r4(CG);                                // top-K candidates
  int* ci = reinterpret_cast<int*>(cv + r4(NWARP * K_top));
  float* dls_s = cv + 2 * r4(NWARP * K_top);
  float* em = dls_s + r4(CG * 32);
  float* planes = em + CG * EMF;                           // SMEM storage: [CG][K_pad]
  const int b = blockIdx.x;
  const int nc = ncols<CPT>(K_pad);
  const int NSC = Gp / CG;
  const size_t S = (size_t)Gp * 32;
  const float* dlr = dl + b * S;
  Cols<CPT> alpha, x, beta, en;
  Cols<CPT, unsigned> w;
  float* row = scratch + (size_t)b * ((CPT == 0 ? 4 : 0) + (SMEM ? 0 : CG)) * K_pad;
  if constexpr (CPT == 0) {
    alpha.p = row;
    x.p = row + K_pad;
    beta.p = row + 2 * K_pad;
    en.p = row + 3 * K_pad;
  }
  if constexpr (!SMEM) planes = row + (CPT == 0 ? 4 : 0) * K_pad;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    if (threadIdx.x + c * NT < K_pad) {
      beta[c] = 1.f;
      en[c] = 1.f;
    }
  }
  int par = 0, par_ms = 0;
  load_words<CPT>(w, words, (NSC - 1) * CG, K_pad);
  for (int s = 0; s < NSC; ++s) {
    const int cidx = NSC - 1 - s, g0 = cidx * CG;
    stage_chunk(dlr, g0, CG, dls_s, em);
    // ---- rematerialise the chunk's alphas (the forward's step) ----
    const float* ck = ckpt + ((size_t)cidx * B + b) * K_pad;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int k = threadIdx.x + c * NT;
      if (k < K_pad) alpha[c] = ck[k];
    }
    // a grid's maximum goes to mxs[j] (thread 0) and is read in the reverse
    // step of grid j, after a later barrier; the chunk's last one has no
    // barrier between, so every thread keeps it in mx_last
    float mx_last = 0.f;
    for (int j = 0; j < CG; ++j) {
      const int g = g0 + j;
      float mx, ssum;
      // the reverse sweep starts on the chunk's last grid: keep its words
      fwd_step<CPT>(alpha, x, w, words, g, j + 1 < CG ? g + 1 : -1, j, em, trans2[g],
                    trans2[Gp + g] * invK, K, K_pad, red_ms, par_ms, mx, ssum);
      mx_last = mx;
      float* pj = planes + (size_t)j * K_pad;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = threadIdx.x + c * NT;
        if (k < K_pad) pj[k] = alpha[c];
      }
      if (threadIdx.x == 0) mxs[j] = mx;
    }
    // ---- reverse sweep: beta, gamma, dosage, top-K, capture ----
    for (int j = CG - 1; j >= 0; --j) {
      const int g = g0 + j;
      const bool last = g == Gp - 1;                 // beta = 1: stay 0, c*se 1
      const float stay = last ? 0.f : trans2[g + 1];
      const float jn = last ? 0.f : trans2[Gp + g + 1] * invK;
      const float mxg = j == CG - 1 ? mx_last : mxs[j];
      // alpha of grid j; once read, the plane takes the grid's gammas (pads
      // -1) for the top-K and the capture
      float* pj = planes + (size_t)j * K_pad;
      float* gcr = (cap != nullptr && cap[g] > 0.f) ? gcap + (size_t)b * K_pad : nullptr;
      const bool topk = thin[g] >= 0;
      float* dosr = dos + b * S + (size_t)g * 32;
      // two reductions: (se, max etb), then the gamma sum and its 32
      // bit-masked sums
      float se = 0.f, M = 0.f;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = threadIdx.x + c * NT;
        if (k < K_pad) {
          const float etb = __fmul_rn(en[c], beta[c]);
          en[c] = k < K ? expf(logit(word_at<CPT>(w, c, words, g, K_pad), em, j) - mxg) : 0.f;
          beta[c] = etb;
          se += etb;
          M = fmaxf(M, etb);
        }
      }
      reduce_sum_max(se, M, red_ms, par_ms);
      const float cse = last ? 1.f : jn * se;
      const float ib = 1.f / fmaxf(__fmaf_rn(stay, M, cse), 1e-30f);
      const bool keep = topk || gcr != nullptr;
      float D[32], G = 0.f;
#pragma unroll
      for (int t = 0; t < 32; ++t) D[t] = 0.f;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int k = threadIdx.x + c * NT;
        if (k < K_pad) {
          const unsigned wd = word_at<CPT>(w, c, words, g, K_pad);
          const float num = __fmaf_rn(stay, beta[c], cse);
          beta[c] = num * ib;
          const float gr = __fmul_rn(pj[k], num);
          G += gr;
          if (keep) pj[k] = k < K ? gr : -1.f;
#pragma unroll
          for (int t = 0; t < 32; ++t)
            if ((wd >> t) & 1u) D[t] += gr;
        }
      }
      if (j > 0) load_words<CPT>(w, words, g - 1, K_pad);
      else if (cidx > 0) load_words<CPT>(w, words, g0 - CG, K_pad);
      float d;
      reduce_gamma(G, D, red, par, d);
      if (threadIdx.x < 32) dosr[threadIdx.x] = eps + (1.f - 2.f * eps) * (d / G);
      if (keep) {
#pragma unroll
        for (int c = 0; c < nc; ++c) {
          const int k = threadIdx.x + c * NT;
          if (k < K) {
            const float gm = pj[k] / G;
            pj[k] = gm;
            if (gcr != nullptr) gcr[k] += gm;
          }
        }
      }
      float* tvr = tv + ((size_t)g * B + b) * K_top;
      int* tir = ti + ((size_t)g * B + b) * K_top;
      if (topk) {
        warp_topk<CPT>(pj, K_pad, K_top, cv, ci);
        __syncthreads();
        if (threadIdx.x < 32) merge_topk(cv, ci, K_top, tvr, tir);
      } else {
        for (int t = threadIdx.x; t < K_top; t += NT) {
          tvr[t] = 0.f;
          tir[t] = 0;
        }
      }
    }
  }
}

// The chain floor: `steps` dependent reductions of the kind a step takes
// (which = 0: the forward's (m, s) pair; 1: the reverse step's two, a sum and
// maximum, then the gamma sum and its 32 bit-masked sums) by NT threads a
// block and nothing else.
template <int WHICH>
__global__ void __launch_bounds__(NT, 1) fb_floor_kernel(float* out, int steps) {
  __shared__ __align__(16) float red[2 * NWARP * RW];
  __shared__ __align__(16) float red2[4 * NWARP];
  int par = 0, par2 = 0;
  float acc = 0.f;
  for (int i = 0; i < steps; ++i) {
    if constexpr (WHICH == 0) {
      float m = (float)(threadIdx.x & 7) + acc, s = 1.f;
      reduce_ms(m, s, red, par);
      acc = s * 1e-9f;
    } else {
      float se = acc + 1.f, M = acc;
      reduce_sum_max(se, M, red2, par2);
      float D[32], G = se, d = 0.f;
#pragma unroll
      for (int t = 0; t < 32; ++t) D[t] = M + t;
      reduce_gamma(G, D, red, par, d);
      acc = (G + d) * 1e-9f;
    }
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// An instantiation exists for cpt columns a thread in registers (0: the
// general form, any K_pad).
bool cpt_ok(int cpt, int K_pad) {
  switch (cpt) {
    case 0: return true;
    case 1: case 2: case 4: case 8: case 10: case 16: return cpt * NT >= K_pad;
    default: return false;
  }
}

template <int CPT>
int launch_fwd(const void* words, const void* dl, const void* trans2, void* ckpt, void* logs,
               void* scratch, int Gp, int K, int K_pad, int B, int CG, float invK,
               cudaStream_t st) {
  const int bytes = 4 * fwd_smem_floats(CG);
  cudaFuncSetAttribute(fb_fwd_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  fb_fwd_kernel<CPT><<<B, NT, bytes, st>>>(
      (const int*)words, (const float*)dl, (const float*)trans2, (float*)ckpt, (float*)logs,
      (float*)scratch, Gp, K, K_pad, B, CG, invK);
  return (int)cudaGetLastError();
}

template <int CPT, bool SMEM>
int launch_bwd(const void* words, const void* dl, const void* ckpt, const void* trans2,
               const void* thin, void* dos, void* tv, void* ti, void* scratch, const void* cap,
               void* gcap, int Gp, int K, int K_pad, int B, int CG, int K_top, float invK,
               float eps, cudaStream_t st) {
  const int bytes = 4 * bwd_smem_floats(CG, K_pad, K_top, SMEM);
  cudaFuncSetAttribute(fb_bwd_kernel<CPT, SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  fb_bwd_kernel<CPT, SMEM><<<B, NT, bytes, st>>>(
      (const int*)words, (const float*)dl, (const float*)ckpt, (const float*)trans2,
      (const int*)thin, (float*)dos, (float*)tv, (int*)ti, (float*)scratch,
      (const float*)cap, (float*)gcap, Gp, K, K_pad, B, CG, K_top, invK, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// cpt: the columns a thread holds in registers (1, 2, 4, 8, 10 or 16, at
// least K_pad / NT), or 0 for the general form, whose state is in the
// scratch row (2 planes of K_pad floats a row in the forward). Returns
// cudaErrorInvalidValue for a cpt without an instantiation or shared
// memory beyond the block's.
extern "C" int fb_forward(const void* words, const void* dl, const void* trans2, void* ckpt,
                          void* logs, void* scratch, int Gp, int K, int K_pad, int B, int CG,
                          float invK, int cpt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (4 * fwd_smem_floats(CG) > SMEM_LIMIT || Gp % CG || !cpt_ok(cpt, K_pad))
    return (int)cudaErrorInvalidValue;
#define FWD(C) launch_fwd<C>(words, dl, trans2, ckpt, logs, scratch, Gp, K, K_pad, B, CG, invK, st)
  switch (cpt) {
    case 1: return FWD(1);
    case 2: return FWD(2);
    case 4: return FWD(4);
    case 8: return FWD(8);
    case 10: return FWD(10);
    case 16: return FWD(16);
    default: return FWD(0);
  }
#undef FWD
}

// smem_planes: the chunk's alphas in shared memory (1) or in the scratch
// row (0, general form only). The scratch row of a block holds, in planes
// of K_pad floats, the general form's 4 state planes, then (smem_planes =
// 0) the chunk's CG alpha planes.
extern "C" int fb_backward(const void* words, const void* dl, const void* ckpt,
                           const void* trans2, const void* thin, void* dos, void* tv, void* ti,
                           void* scratch, const void* cap, void* gcap, int Gp, int K, int K_pad,
                           int B, int CG, int K_top, float invK, float eps, int smem_planes,
                           int cpt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (4 * bwd_smem_floats(CG, K_pad, K_top, smem_planes != 0) > SMEM_LIMIT || Gp % CG ||
      !cpt_ok(cpt, K_pad) || (!smem_planes && cpt))
    return (int)cudaErrorInvalidValue;
#define BWD(C, M)                                                                          \
  launch_bwd<C, M>(words, dl, ckpt, trans2, thin, dos, tv, ti, scratch, cap, gcap, Gp, K, K_pad, \
                   B, CG, K_top, invK, eps, st)
  if (!smem_planes) return BWD(0, false);
  switch (cpt) {
    case 1: return BWD(1, true);
    case 2: return BWD(2, true);
    case 4: return BWD(4, true);
    case 8: return BWD(8, true);
    case 10: return BWD(10, true);
    case 16: return BWD(16, true);
    default: return BWD(0, true);
  }
#undef BWD
}

extern "C" int fb_chain_floor(void* out, int blocks, int steps, int which, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 0) fb_floor_kernel<0><<<blocks, NT, 0, st>>>((float*)out, steps);
  else fb_floor_kernel<1><<<blocks, NT, 0, st>>>((float*)out, steps);
  return (int)cudaGetLastError();
}
