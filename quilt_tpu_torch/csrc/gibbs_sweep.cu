// Gibbs forward and backward sweeps of the per-read sampler: diploid (two
// latent rows a chain) and NIPT (three: mother's two and the fetus's third).
//
// Replaces two Pallas TPU kernels of quilt_tpu/kernels/gibbs_pallas.py:
//   gibbs_fwd  <- _make_fwd_kernel (launched by _fwd_sweep): alpha advance
//                 into each grid, then sequential resampling of the grid's
//                 reads from pre-drawn uniforms, with the alpha / pC /
//                 lemg / label-count updates of every flip;
//   gibbs_bwd  <- _make_bwd_kernel (launched by _bwd_sweep): the reverse
//                 max-normalised beta recursion over grids.
// Layouts are the JAX functions' nl-major ones (state row h*B + b). All
// arithmetic, including the per-read emissions (lem_pad), is float32.
//
// What bounds them on the H100: neither bytes nor operations but the
// dependent chain. A chain's sweep is one step per grid (the alpha or beta
// advance) plus one per live read slot, each step needs sums over all K
// haplotypes before the next can start, and a flip changes the state the
// next read sees. The time of a sweep is (steps) x (latency of one step);
// the batch only decides how many SMs run such a chain side by side.
//
// What the design does about it: nothing but registers, shared memory and
// one reduction sits between two dependent steps.
//   * Warp specialisation. In gibbs_fwd a producer warp walks the grids
//     ahead of the chain: it copies lemg[g+1], beta[g] and the emission row
//     of every live read slot into shared-memory rings with cp.async (whose
//     completion arrives on an mbarrier), hands the slot's words (uniform,
//     label, read id) over beside the row, and writes the unchanged label of
//     every skipped slot. In gibbs_bwd eight preparation warps compute the
//     row maximum and e = exp(lemg - max) of the coming grids, which depend
//     on the input alone, into a ring. The chain's (consumer) warps never
//     wait for device memory unless the producers fall behind, and the
//     forward chain takes the next read's row (and its exponentials) out of
//     the ring one step ahead of its use.
//   * State in registers. Each consumer thread owns the same haplotype
//     columns (tid, tid + NT, ...) of all latent rows for the whole sweep:
//     alpha, beta, lemg and the read's exp(+-lem) live in registers when
//     K <= NT * CPT for an instantiated (NT, CPT), else (general variant,
//     same code, loops not unrolled) in per-thread local arrays.
//   * One reduction per step. Forward, per live slot: the gain / lose sums
//     of the candidate weights and the sums that alpha will have after a
//     flip (sum(alpha*em) for the row that gains the read, sum(alpha*iv) for
//     the row that loses it) travel through one reduction, so the flip, the
//     renormalisation and the lemg update are one elementwise pass with no
//     reduction behind it; a row that the slot does not change keeps its
//     alpha untouched (its sum is 1 within rounding). Forward, per grid:
//     sum(a_raw) and sum(a_raw*beta) together with the row maxima of the
//     NEXT grid's lemg (an input, already prefetched), so pC = sum(a_raw *
//     beta) / sum(a_raw) and no separate max reduction exists. Backward,
//     per grid: sum(e*beta) and max(e*beta) together; since t0 >= 0 and a
//     float fma is monotone, max(t0*etb + c) = fma(t0, max(etb), c).
//   * One barrier per reduction: a reduce-scatter over the warp's lanes (9
//     shuffles for 8 values), one shared-memory slot per warp, double-
//     buffered by parity, and one named barrier over the chain's warps
//     only. Every thread adds the warps' partials in the same order, so all
//     threads take the same label decision unbroadcast.
//   * No division and no logarithm on a read's step: the label is drawn by
//     comparing the cumulative weight with u * (sum of weights), the
//     renormalisers are fast reciprocals taken ahead of the decision, and
//     logc carries the product of the reads' normalisers, whose log is
//     taken only when it nears the float range.
//   * Skipped slots (empty, or uninformative reads) cost nothing: the
//     producer never queues them. They cannot flip and touch no state; the
//     renormalisation the TPU kernel still performs there (by a sum that is
//     1 within rounding) is dropped, in the plain version too.
// The latent row count NL is a template parameter that every loop of the
// forward kernel runs over, instantiated for 2 (diploid) and 3 (NIPT); the
// label prior comes from the caller. At NL = 3 a grid's advance reduces 9
// values and a read's step 12: they go as two reductions of at most 8
// values (two butterflies, two barriers), which on the card is the faster of
// the two forms; the WIDE form, one reduction in a slot of 16 floats (one
// more butterfly round), exists to be timed beside it. The backward kernel
// works on a state row and never sees NL.
// Past the general variant (K > 10,240, or at NL = 3 once one grid stage and
// one read row outgrow shared memory, K > 8,155), the forward sweep runs a
// chain on a thread-block cluster (gibbs_fwd_cluster_kernel, below): each
// of its 8 blocks is the register form above over an eighth of the columns,
// with its own producer warp and rings, and each dependent step adds the
// blocks' sums in rank order over distributed shared memory
// (cluster_xchg.cuh), up to K = 16,384 (12,288 at NL = 3); the backward
// runs a state row on a cluster the same way up to 16,384
// (gibbs_bwd_cluster_kernel, "the backward's cluster form"). Past that, a
// global form of each kernel takes any K that device memory holds: no
// producer, no ring, the state in a global scratch plane (below, "the
// global forms"). The caller (kernels/gibbs_sweep.py) names the form.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_xchg.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_DS = 4;        // ring depth: grid stages (lemg[g+1] + beta[g])
constexpr int MAX_DR = 16;       // ring depth: read-slot emission rows
constexpr int MAX_DE = 16;       // ring depth: backward e rows
constexpr int BWD_PREP = 8;      // preparation warps of the backward kernel
constexpr int GENERAL_NT = 256;  // general variant: threads and column capacity
constexpr int GENERAL_CPT = 40;
constexpr int GLOBAL_NT = 512;   // global forms: threads a chain (any K)
// the cluster form: blocks a chain (the portable cluster size) and chain
// threads a block, with CPT 8 (NL = 2) or 6 (NL = 3). Timed in turn on the
// H100 at 32 grids x 8 chains x K = 10,368 (chip_smoke.py, PERF.md): 8 x 256
// 0.313 ms at NL = 2 and 0.432 at NL = 3; 16 blocks x 128 0.459 / 0.499,
// 16 x 256 0.534 / 0.566.
constexpr int CLUSTER_C = 8;
constexpr int CLUSTER_NT = 256;
constexpr int SMEM_LIMIT = 227 * 1024 - 4096;   // dynamic part; statics fit the rest

// ---------------------------------------------------------------------------
// mbarrier, cp.async and the chain's reduction
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// One probe of the barrier's phase (the hardware may suspend the thread for
// a while before it answers).
__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase differs from `parity`. A wait that never
// ends (a broken pipeline) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try(addr, parity)) return;   // the producers run ahead: the usual case
  const long long t_start = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - t_start > 40000000000LL) __trap();   // ~20 s, not a sweep's ms
}

// The executing thread's earlier cp.async copies arrive on the barrier when
// they complete (the barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One row of K floats, global -> shared, by one warp; 16-byte copies when
// K and the pointers allow (vec), else 4-byte ones.
__device__ __forceinline__ void copy_row(float* dst, const float* src, int K,
                                         bool vec, int lane) {
  if (vec) {
    for (int k = lane * 4; k < K; k += 128)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(dst + k)),
                   "l"(src + k)
                   : "memory");
  } else {
    for (int k = lane; k < K; k += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_addr(dst + k)),
                   "l"(src + k)
                   : "memory");
  }
}

// Position in a ring of `depth` stages; `phase` flips at every wrap. A
// consumer waits full[stage] on `phase`, a producer empty[stage] on
// `phase ^ 1` (the first pass over a fresh ring does not block).
struct Ring {
  int depth, stage;
  uint32_t phase;
  __device__ Ring(int d) : depth(d), stage(0), phase(0) {}
  __device__ void next() {
    if (++stage == depth) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A warp releases a ring stage once all its lanes have read it.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Reduces NS sums followed by NM maxima over the chain's NT threads (warps
// 0 .. NT/32-1 of the block). Within a warp the values are reduced and
// scattered at once: each round halves the values a lane still carries (it
// keeps one half and sends the other to its partner), so 8 values take 9
// shuffles, not 40, and end as one total in each group of 4 lanes. One lane
// per group writes it to the warp's shared-memory slot in the buffer of
// this call's parity; after one named barrier every thread adds the warps'
// slots in the same order, so all threads hold the same values. A slot
// holds SLOT (8 or 16) floats and `red` 2 x (NT/32) x SLOT; a buffer is
// written again two calls later, after a barrier that every reader of this
// call has passed, so every call of one kernel uses the same SLOT.
template <int NT, int NS, int NM, int SLOT = 8>
__device__ __forceinline__ void chain_reduce(float (&v)[NS + NM], float* red,
                                             int& par) {
  constexpr int NV = NS + NM, NW = NT / 32;
  constexpr int NP = NV <= 2 ? 2 : (NV <= 4 ? 4 : (NV <= 8 ? 8 : 16));   // a power of two
  constexpr int LOG = NP == 2 ? 1 : (NP == 4 ? 2 : (NP == 8 ? 3 : 4));
  static_assert(SLOT == 8 || SLOT == 16, "a reduction slot holds 8 or 16 values");
  static_assert(NV <= SLOT, "more values than the reduction slot holds");
  static_assert(NW > 1, "the chain has at least two warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = red + par * NW * SLOT;
  par ^= 1;
  if (NV <= 2) {
    // two values: a plain butterfly on both is as short, and free of selects
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float x = __shfl_xor_sync(0xffffffffu, v[j], o);
        v[j] = j < NS ? v[j] + x : fmaxf(v[j], x);
      }
    }
    if (lane < NV) buf[warp * SLOT + lane] = lane == 0 ? v[0] : v[NV - 1];
  } else {
    float t[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) t[j] = j < NV ? v[j] : 0.f;
    int base = 0;   // index of the value this lane carries in t[0]
#pragma unroll
    for (int r = 0; r < LOG; ++r) {
      const int o = 16 >> r, half = NP >> (r + 1);
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = upper ? t[j] : t[j + half];
        const float keep = upper ? t[j + half] : t[j];
        const float x = __shfl_xor_sync(0xffffffffu, send, o);
        if (NM == 0)
          t[j] = keep + x;
        else
          t[j] = base + j + (upper ? half : 0) < NS ? keep + x : fmaxf(keep, x);
      }
      if (upper) base += half;
    }
#pragma unroll
    for (int o = 16 >> LOG; o > 0; o >>= 1) {
      const float x = __shfl_xor_sync(0xffffffffu, t[0], o);
      t[0] = (NM == 0 || base < NS) ? t[0] + x : fmaxf(t[0], x);
    }
    if ((lane & (32 / NP - 1)) == 0) buf[warp * SLOT + base] = t[0];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
  const float4* buf4 = reinterpret_cast<const float4*>(buf);
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    float s[SLOT];
#pragma unroll
    for (int q = 0; q < (NV + 3) / 4; ++q) {
      const float4 x = buf4[w * (SLOT / 4) + q];
      s[4 * q] = x.x, s[4 * q + 1] = x.y, s[4 * q + 2] = x.z, s[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
      v[j] = w == 0 ? s[j] : (j < NS ? v[j] + s[j] : fmaxf(v[j], s[j]));
  }
}

// chain_reduce of any number of values: more than a slot holds go as two
// reductions, the first SLOT values and then the rest.
template <int NT, int NS, int NM, int SLOT>
__device__ __forceinline__ void chain_reduce_n(float (&v)[NS + NM], float* red,
                                               int& par) {
  if constexpr (NS + NM <= SLOT) {
    chain_reduce<NT, NS, NM, SLOT>(v, red, par);
  } else {
    constexpr int NS1 = NS < SLOT ? NS : SLOT, NM1 = SLOT - NS1;
    constexpr int NS2 = NS - NS1, NM2 = NM - NM1;
    float a[SLOT], b[NS2 + NM2];
#pragma unroll
    for (int j = 0; j < SLOT; ++j) a[j] = v[j];
#pragma unroll
    for (int j = 0; j < NS2 + NM2; ++j) b[j] = v[SLOT + j];
    chain_reduce<NT, NS1, NM1, SLOT>(a, red, par);
    chain_reduce<NT, NS2, NM2, SLOT>(b, red, par);
#pragma unroll
    for (int j = 0; j < SLOT; ++j) v[j] = a[j];
#pragma unroll
    for (int j = 0; j < NS2 + NM2; ++j) v[SLOT + j] = b[j];
  }
}

// ---------------------------------------------------------------------------
// forward sweep
// ---------------------------------------------------------------------------

struct FwdCommon {
  const float *lemg, *beta, *lem_pad;
  const int *slots, *first_read;
  const float *lab_init, *trans;
  const int* cnt_max;
  float *lemg_out, *alpha_out;
  int* h_out;
  float *logc_out, *uf_out, *lab_out;
  float* scratch;    // global form: the chains' alpha, [B][NL][K]
  int G, B, W, K, K_real, it_mode, want_alpha;
  int KS;            // cluster form: columns a block (a multiple of 4)
  int vec, DS, DR;   // 16-byte copies allowed; ring depths
  float invK;
};

template <int NL>
struct FwdArgs : FwdCommon {
  float prior[NL];   // label prior of the NL latent rows
};

struct SlotWords {
  int u, h, skip, rg, cnt;   // the four planes of slot (g, i, b) and cnt_max[g]
  float t0, t1;              // trans[:, g]
};

__device__ __forceinline__ SlotWords load_words(const FwdCommon& a, int g, int i,
                                                int b) {
  SlotWords w = {0, 0, 1, 0, a.cnt_max[g], a.trans[g], a.trans[a.G + g]};
  if (i < a.W) {
    const size_t WB = (size_t)a.W * a.B;
    const size_t sl = ((size_t)g * 4 * a.W + i) * a.B + b;
    w.u = a.slots[sl];
    w.h = a.slots[sl + WB];
    w.skip = a.slots[sl + 2 * WB];
    w.rg = a.slots[sl + 3 * WB];
  }
  return w;
}

// The producer warp of chain b. Grid stage s (s = 0 .. G) holds lemg[s]
// (s < G) and, for s >= 1, beta[s-1] with trans[s-1] and the number of live
// slots of grid s-1; the chain consumes stage g+1 when it advances into
// grid g. The live slots of grid g follow in the row ring, in slot order.
// A block of a cluster form copies its own columns k0 .. k0 + KL - 1 into
// rings of row stride RS (the others: k0 = 0, KL = RS = K); only the
// writer (the cluster's rank 0) writes the labels of skipped slots.
template <int NL>
__device__ void fwd_producer(const FwdArgs<NL>& a, float* stage_buf, float* row_buf,
                             float (*smeta)[4], int (*rmeta)[4],
                             uint64_t* full_s, uint64_t* empty_s,
                             uint64_t* full_r, uint64_t* empty_r, int b, int k0, int KL,
                             int RS, bool writer) {
  const int lane = threadIdx.x & 31;
  const int K = a.K, BN = NL * a.B;
  const size_t stage_floats = (size_t)2 * NL * RS;
  Ring S(a.DS), R(a.DR);
  mbar_wait(&empty_s[0], 1);
  for (int h = 0; h < NL; ++h)
    copy_row(stage_buf + h * RS, a.lemg + ((size_t)h * a.B + b) * K + k0, KL, a.vec, lane);
  cp_async_arrive(&full_s[0]);
  if (lane == 0) mbar_arrive(&full_s[0]);
  S.next();
  SlotWords cur = load_words(a, 0, lane, b);
  for (int g = 0; g < a.G; ++g) {
    const SlotWords nxt = g + 1 < a.G ? load_words(a, g + 1, lane, b) : cur;
    mbar_wait(&empty_s[S.stage], S.phase ^ 1);
    float* sb = stage_buf + S.stage * stage_floats;
    for (int h = 0; h < NL; ++h) {
      if (g + 1 < a.G)
        copy_row(sb + h * RS, a.lemg + ((size_t)(g + 1) * BN + h * a.B + b) * K + k0, KL,
                 a.vec, lane);
      copy_row(sb + (NL + h) * RS, a.beta + ((size_t)g * BN + h * a.B + b) * K + k0, KL,
               a.vec, lane);
    }
    const int n = cur.cnt;
    int nlive = 0;
    for (int i0 = 0; i0 < a.W; i0 += 32) {
      const SlotWords w = i0 == 0 ? cur : load_words(a, g, i0 + lane, b);
      const bool live = i0 + lane < n && i0 + lane < a.W && w.skip == 0;
      nlive += __popc(__ballot_sync(0xffffffffu, live));
    }
    if (lane == 0) {
      smeta[S.stage][0] = cur.t0;
      smeta[S.stage][1] = cur.t1;
      smeta[S.stage][2] = __int_as_float(nlive);
    }
    cp_async_arrive(&full_s[S.stage]);
    if (lane == 0) mbar_arrive(&full_s[S.stage]);
    S.next();
    for (int i0 = 0; i0 < a.W; i0 += 32) {
      const SlotWords w = i0 == 0 ? cur : load_words(a, g, i0 + lane, b);
      const int i = i0 + lane;
      const bool live = i < n && i < a.W && w.skip == 0;
      if (writer && i < a.W && !live) a.h_out[((size_t)g * a.W + i) * a.B + b] = w.h;
      unsigned mask = __ballot_sync(0xffffffffu, live);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const int u = __shfl_sync(0xffffffffu, w.u, src);
        const int hC = __shfl_sync(0xffffffffu, w.h, src);
        const int rg = __shfl_sync(0xffffffffu, w.rg, src);
        mbar_wait(&empty_r[R.stage], R.phase ^ 1);
        copy_row(row_buf + (size_t)R.stage * RS,
                 a.lem_pad + (((size_t)g * a.W + i0 + src) * a.B + b) * K + k0, KL, a.vec,
                 lane);
        if (lane == 0) {
          rmeta[R.stage][0] = u;
          rmeta[R.stage][1] = hC;
          rmeta[R.stage][2] = rg;
          rmeta[R.stage][3] = i0 + src;
        }
        cp_async_arrive(&full_r[R.stage]);
        if (lane == 0) mbar_arrive(&full_r[R.stage]);
        R.next();
      }
    }
    cur = nxt;
  }
}

// logc gathers the logs of the chain's normalisers. The product of the
// read slots' normalisers is carried in `prod` and its log taken only when
// it nears the float range, so no logf sits on a read's step.
__device__ __forceinline__ void carry_log(float& logc, float& prod, float z) {
  prod *= z;
  if (prod > 1e30f || prod < 1e-30f) {
    logc += logf(prod);
    prod = 1.f;
  }
}

// A live read slot as the chain holds it: the thread's columns of the
// emission row with exp(+-lem), and the slot's words. fetch() takes the
// next entry of the row ring. The chain takes a grid's first live read
// while it advances into the grid and every later one a step ahead of its
// use, never one of a grid it has not advanced into: the producer queues a
// grid's reads only after the stage that the advance consumes.
template <int CPT>
struct ReadRow {
  float l[CPT], em[CPT], iv[CPT];
  float u;
  int hC, rg, slot;

  template <int NT, int UNROLL>
  __device__ __forceinline__ void fetch(const float* row_buf, int (*rmeta)[4],
                                        uint64_t* full_r, uint64_t* empty_r,
                                        Ring& R, int RS, int K, int ncol) {
    mbar_wait(&full_r[R.stage], R.phase);
    const float* rb = row_buf + (size_t)R.stage * RS;
    u = __int_as_float(rmeta[R.stage][0]);
    hC = rmeta[R.stage][1];
    rg = rmeta[R.stage][2];
    slot = rmeta[R.stage][3];
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      const int c = threadIdx.x + m * NT;
      l[m] = c < K ? rb[c] : 0.f;
    }
    release(&empty_r[R.stage]);
    R.next();
  }

  template <int UNROLL>
  __device__ __forceinline__ void take(const ReadRow& o, int ncol) {
    u = o.u, hC = o.hC, rg = o.rg, slot = o.slot;
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) l[m] = o.l[m], em[m] = o.em[m], iv[m] = o.iv[m];
  }

  template <int UNROLL>
  __device__ __forceinline__ void exponentials(int ncol) {
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      em[m] = expf(l[m]);
      iv[m] = expf(-l[m]);
    }
  }
};

// The label draw of a live read slot, the same in every thread of the chain:
// the global forms'. The register forms keep the same code inline: factored
// out, their NL = 3 instantiation compiled to a slower kernel on the H100.
// q: the step's sums, gain[h] = sum(alpha*beta*em), lose[h] =
// sum(alpha*beta*iv), then the sums alpha has after gaining (alpha*em) or
// losing (alpha*iv) the read; pc: the rows' pC. z / rs: what a flip would
// renormalise the gaining rows (0..NL-1) and the losing rows (NL..) by, and
// its inverse, taken ahead of the decision.
template <int NL>
struct Draw {
  float z[2 * NL], rs[2 * NL];
  float lose_C;
  int h_new;
  bool flip, normal;
};

template <int NL>
__device__ __forceinline__ Draw<NL> draw_label(const FwdArgs<NL>& a, const float (&q)[4 * NL],
                                               const float (&pc)[NL], float u, int hC, int rg,
                                               int first, bool& uf) {
  Draw<NL> d;
#pragma unroll
  for (int j2 = 0; j2 < 2 * NL; ++j2) {
    d.z[j2] = q[2 * NL + j2] > 0.f ? q[2 * NL + j2] : 1.f;
    d.rs[j2] = __fdividef(1.f, d.z[j2]);
  }
  bool doing_pass = false, doing_init = false;
  if (a.it_mode == 0) {
    doing_pass = rg < first;
    doing_init = rg >= first;
  } else if (a.it_mode == 1) {
    doing_init = rg < first;
  }
  d.normal = !doing_init;
  d.lose_C = q[NL];
#pragma unroll
  for (int h = 1; h < NL; ++h)
    if (hC == h) d.lose_C = q[NL + h];
  // candidate weights w[n] = prior[n] * prod_m term(n, m)
  // (reference: sample_reads_in_grid, gibbs-nipt.cpp:733-1341)
  float w[NL], wsum = 0.f;
#pragma unroll
  for (int n = 0; n < NL; ++n) {
    float prod = 1.f;
#pragma unroll
    for (int m = 0; m < NL; ++m) {
      float term;
      if (m == n)
        term = (doing_init || hC != n) ? q[n] : pc[m];
      else
        term = (doing_init || hC == n || hC != m) ? pc[m] : d.lose_C;
      prod = m == 0 ? term : prod * term;
    }
    w[n] = prod * a.prior[n];
    wsum = n == 0 ? w[n] : wsum + w[n];
  }
  const bool badv = !isfinite(wsum) || wsum <= 0.f;
  uf = uf || badv;
  // h_new = number of candidates whose cumulative probability <= u
  // (compared as cumulative weight <= u * wsum: no division on the
  // chain; a bad wsum never flips, whatever h_new is)
  const float uw = u * wsum;
  float cum = 0.f;
  int h_new = 0;
#pragma unroll
  for (int n = 0; n < NL - 1; ++n) {
    cum += w[n];
    h_new += cum <= uw ? 1 : 0;
  }
  d.h_new = h_new;
  d.flip = !doing_pass && !badv && (h_new != hC || doing_init);
  return d;
}

// The record of a cluster form's exchange: at most 4 NL = 12 values a step.
using FwdInbox = cluster_xchg::Inbox<12>;

// NT consumer threads (the chain) and one producer warp. FAST: K <= NT*CPT
// and the column loops unroll over CPT registers; otherwise CPT is the
// capacity of per-thread local arrays and the loops run ceil(K/NT) times.
// WIDE (NL = 3 only): a reduction slot of 16 values, so that no reduction
// of a step goes as two. CLUSTER: the block is rank r of chain b's cluster
// (grid (C, B)) and owns the columns r*KS .. r*KS + KS - 1 (FAST over them);
// after each block reduction the cluster exchanges the block's values
// (cluster_xchg.cuh, through `box`), and rank 0 alone writes the chain's
// labels and scalars.
template <int NT, int CPT, bool FAST, int NL, bool WIDE, bool CLUSTER>
__device__ __forceinline__ void fwd_chain(const FwdArgs<NL>& a, FwdInbox* box) {
  constexpr int SLOT = (NL > 2 && WIDE) ? 16 : 8;
  extern __shared__ __align__(16) float dyn[];
  __shared__ uint64_t bars[2 * MAX_DS + 2 * MAX_DR];
  __shared__ float smeta[MAX_DS][4];
  __shared__ int rmeta[MAX_DR][4];
  __shared__ __align__(16) float red[2 * (NT / 32) * SLOT];
  uint64_t* full_s = bars;
  uint64_t* empty_s = bars + MAX_DS;
  uint64_t* full_r = bars + 2 * MAX_DS;
  uint64_t* empty_r = bars + 2 * MAX_DS + MAX_DR;
  // the chain, the block's first column, its columns (all of them real up to
  // K_real) and the ring's row stride: the whole row but in a cluster form
  const int b = CLUSTER ? blockIdx.y : blockIdx.x;
  const int k0 = CLUSTER ? blockIdx.x * a.KS : 0;
  const int K = CLUSTER ? max(0, min(a.KS, a.K - k0)) : a.K;
  const int K_real = CLUSTER ? max(0, min(a.KS, a.K_real - k0)) : a.K_real;
  const int RS = CLUSTER ? a.KS : a.K;
  const bool writer = !CLUSTER || blockIdx.x == 0;
  cluster_xchg::Exchange<12> xc(box);
  float* stage_buf = dyn;
  float* row_buf = dyn + (size_t)a.DS * 2 * NL * RS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.DS; ++s) {
      mbar_init(&full_s[s], 33);        // 32 cp.async arrivals + lane 0's
      mbar_init(&empty_s[s], NT / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < a.DR; ++s) {
      mbar_init(&full_r[s], 33);
      mbar_init(&empty_r[s], NT / 32);
    }
    if constexpr (CLUSTER) xc.init();
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (CLUSTER) cluster_xchg::cluster_sync_all();   // every block's inbox is ready
  if (threadIdx.x >= NT) {
    fwd_producer(a, stage_buf, row_buf, smeta, rmeta, full_s, empty_s, full_r,
                 empty_r, b, k0, K, RS, writer);
    return;
  }

  // ---- the chain ----
  const int tid = threadIdx.x;
  const int BN = NL * a.B;
  const int ncol = FAST ? CPT : (K + NT - 1) / NT;
  constexpr int UNROLL = FAST ? CPT : 1;
  const int first = a.first_read[b];
  const size_t stage_floats = (size_t)2 * NL * RS;
  // alpha, beta and lemg of the current grid; lemg of the next one and
  // e = exp(lemg - rowmax) of the grid the chain advances into next
  float alpha[NL][CPT], bet[NL][CPT], lg[NL][CPT], lgn[NL][CPT], e[NL][CPT];
  ReadRow<CPT> cur, nxt;
  float pc[NL], logc[NL], zprod[NL], lab[NL];
  bool uf = false;
  int par = 0;
  Ring S(a.DS), R(a.DR);
#pragma unroll
  for (int h = 0; h < NL; ++h) {
    logc[h] = 0.f;
    zprod[h] = 1.f;
    pc[h] = 0.f;
    lab[h] = a.lab_init[NL * b + h];
  }

  // stage 0: lemg of grid 0, its row maxima (the one reduction outside the
  // per-grid and per-slot ones) and e
  float mx[NL];
  {
    mbar_wait(&full_s[0], 0);
#pragma unroll
    for (int h = 0; h < NL; ++h) mx[h] = NEG;
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      const int c = tid + m * NT;
#pragma unroll
      for (int h = 0; h < NL; ++h) {
        alpha[h][m] = 0.f;
        lg[h][m] = c < K ? stage_buf[h * RS + c] : 0.f;
        if (c < K_real) mx[h] = fmaxf(mx[h], lg[h][m]);
      }
    }
    release(&empty_s[0]);
    S.next();
    chain_reduce<NT, 0, NL, SLOT>(mx, red, par);
    if constexpr (CLUSTER) xc.template combine<NL, 0>(mx, tid);
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
#pragma unroll
      for (int h = 0; h < NL; ++h)
        e[h][m] = tid + m * NT < K_real ? expf(lg[h][m] - mx[h]) : 0.f;
    }
  }

  for (int g = 0; g < a.G; ++g) {
    // ---- alpha advance into grid g: one reduction ----
    mbar_wait(&full_s[S.stage], S.phase);
    const float* sb = stage_buf + S.stage * stage_floats;
    const float t0 = smeta[S.stage][0], t1 = smeta[S.stage][1];
    const int nlive = __float_as_int(smeta[S.stage][2]);
    const bool has_next = g + 1 < a.G;
    const float jump = (t1 + (g == 0 ? 1.f : 0.f)) * a.invK;
    float v[3 * NL];   // sum(a_raw), sum(a_raw*beta) | max of the next lemg
#pragma unroll
    for (int h = 0; h < NL; ++h) v[h] = v[NL + h] = 0.f, v[2 * NL + h] = NEG;
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      const int c = tid + m * NT;
#pragma unroll
      for (int h = 0; h < NL; ++h) {
        bet[h][m] = c < K ? sb[(NL + h) * RS + c] : 0.f;
        lgn[h][m] = (has_next && c < K) ? sb[h * RS + c] : 0.f;
        if (c < K_real) v[2 * NL + h] = fmaxf(v[2 * NL + h], lgn[h][m]);
        const float ar = e[h][m] * (t0 * alpha[h][m] + jump);
        alpha[h][m] = ar;
        v[h] += ar;
        v[NL + h] += ar * bet[h][m];
      }
    }
    release(&empty_s[S.stage]);
    S.next();
    if (nlive > 0) {
      nxt.template fetch<NT, UNROLL>(row_buf, rmeta, full_r, empty_r, R, RS, K, ncol);
      nxt.template exponentials<UNROLL>(ncol);
    }
    chain_reduce_n<NT, 2 * NL, NL, SLOT>(v, red, par);
    if constexpr (CLUSTER) xc.template combine<3 * NL, 2 * NL>(v, tid);
#pragma unroll
    for (int h = 0; h < NL; ++h) {
      const float s = v[h];
      uf = uf || !isfinite(s) || s <= 0.f;
      const float ss = s > 0.f ? s : 1.f;
      const float q = __fdividef(1.f, ss);
#pragma unroll UNROLL
      for (int m = 0; m < ncol; ++m) {
        alpha[h][m] *= q;
        // e of the next grid: its lemg is an input and its maximum is known now
        e[h][m] = tid + m * NT < K_real ? expf(lgn[h][m] - v[2 * NL + h]) : 0.f;
      }
      pc[h] = v[NL + h] * q;
      logc[h] = logc[h] + logf(ss) + mx[h];   // once a grid; the slots carry theirs
      mx[h] = v[2 * NL + h];
    }

    // ---- sequential resampling of the grid's live reads: one reduction
    // each; the next read's row and exponentials are taken ahead of it ----
    for (int j = 0; j < nlive; ++j) {
      cur.template take<UNROLL>(nxt, ncol);
      if (j + 1 < nlive)
        nxt.template fetch<NT, UNROLL>(row_buf, rmeta, full_r, empty_r, R, RS, K, ncol);
      // q: gain[h] = sum(alpha*beta*em), lose[h] = sum(alpha*beta*iv), then
      // the sums alpha has after gaining (alpha*em) or losing (alpha*iv) the read
      float q[4 * NL];
#pragma unroll
      for (int j2 = 0; j2 < 4 * NL; ++j2) q[j2] = 0.f;
#pragma unroll UNROLL
      for (int m = 0; m < ncol; ++m) {
#pragma unroll
        for (int h = 0; h < NL; ++h) {
          const float ab = alpha[h][m] * bet[h][m];
          q[h] += ab * cur.em[m];
          q[NL + h] += ab * cur.iv[m];
          q[2 * NL + h] += alpha[h][m] * cur.em[m];
          q[3 * NL + h] += alpha[h][m] * cur.iv[m];
        }
      }
      if (j + 1 < nlive) nxt.template exponentials<UNROLL>(ncol);
      chain_reduce_n<NT, 4 * NL, 0, SLOT>(q, red, par);
      if constexpr (CLUSTER) xc.template combine<4 * NL, 4 * NL>(q, tid);

      const float u = cur.u;
      const int hC = cur.hC, rg = cur.rg;
      // what a flip would renormalise by, ahead of the decision
      float z[2 * NL], rs[2 * NL];
#pragma unroll
      for (int j2 = 0; j2 < 2 * NL; ++j2) {
        z[j2] = q[2 * NL + j2] > 0.f ? q[2 * NL + j2] : 1.f;
        rs[j2] = __fdividef(1.f, z[j2]);
      }
      bool doing_pass = false, doing_init = false;
      if (a.it_mode == 0) {
        doing_pass = rg < first;
        doing_init = rg >= first;
      } else if (a.it_mode == 1) {
        doing_init = rg < first;
      }
      const bool normal = !doing_init;
      float lose_C = q[NL];
#pragma unroll
      for (int h = 1; h < NL; ++h)
        if (hC == h) lose_C = q[NL + h];
      // candidate weights w[n] = prior[n] * prod_m term(n, m)
      // (reference: sample_reads_in_grid, gibbs-nipt.cpp:733-1341)
      float w[NL], wsum = 0.f;
#pragma unroll
      for (int n = 0; n < NL; ++n) {
        float prod = 1.f;
#pragma unroll
        for (int m = 0; m < NL; ++m) {
          float term;
          if (m == n)
            term = (doing_init || hC != n) ? q[n] : pc[m];
          else
            term = (doing_init || hC == n || hC != m) ? pc[m] : lose_C;
          prod = m == 0 ? term : prod * term;
        }
        w[n] = prod * a.prior[n];
        wsum = n == 0 ? w[n] : wsum + w[n];
      }
      const bool badv = !isfinite(wsum) || wsum <= 0.f;
      uf = uf || badv;
      // h_new = number of candidates whose cumulative probability <= u
      // (compared as cumulative weight <= u * wsum: no division on the
      // chain; a bad wsum never flips, whatever h_new is)
      const float uw = u * wsum;
      float cum = 0.f;
      int h_new = 0;
#pragma unroll
      for (int n = 0; n < NL - 1; ++n) {
        cum += w[n];
        h_new += cum <= uw ? 1 : 0;
      }
      const bool flip = !doing_pass && !badv && (h_new != hC || doing_init);
      if (flip) {
        // the winner takes the read (em), the previous label (a normal
        // move) gives it up (iv); any other row keeps alpha, pC and lemg
#pragma unroll
        for (int h = 0; h < NL; ++h) {
          const bool gains = h_new == h, loses = hC == h && normal;
          if (gains || loses) {
            const float r = gains ? rs[h] : rs[NL + h];
            const float d = gains ? 1.f : -1.f;
#pragma unroll UNROLL
            for (int m = 0; m < ncol; ++m) {
              alpha[h][m] = alpha[h][m] * (gains ? cur.em[m] : cur.iv[m]) * r;
              lg[h][m] += d * cur.l[m];
            }
            pc[h] = (gains ? q[h] : lose_C) * r;
            carry_log(logc[h], zprod[h], gains ? z[h] : z[NL + h]);
          }
          lab[h] += (h_new == h ? 1.f : 0.f) - (hC == h ? 1.f : 0.f);
        }
      }
      if (writer && tid == 0)
        a.h_out[((size_t)g * a.W + cur.slot) * a.B + b] = flip ? h_new : hC;
    }

    // ---- the grid's outputs, then the next grid's lemg takes its place ----
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      const int c = tid + m * NT;
#pragma unroll
      for (int h = 0; h < NL; ++h) {
        const size_t r = ((size_t)g * BN + h * a.B + b) * a.K + k0 + c;
        if (c < K) {
          a.lemg_out[r] = lg[h][m];
          if (a.want_alpha) a.alpha_out[r] = alpha[h][m];
        }
        lg[h][m] = lgn[h][m];
      }
    }
  }
  if (writer && tid == 0) {
#pragma unroll
    for (int h = 0; h < NL; ++h) {
      a.logc_out[h * a.B + b] = logc[h] + logf(zprod[h]);
      a.lab_out[NL * b + h] = lab[h];
    }
    a.uf_out[b] = uf ? 1.f : 0.f;
  }
}

template <int NT, int CPT, bool FAST, int NL, bool WIDE>
__global__ void __launch_bounds__(NT + 32) gibbs_fwd_kernel(const FwdArgs<NL> a) {
  fwd_chain<NT, CPT, FAST, NL, WIDE, false>(a, nullptr);
}

// The cluster form: one chain on a cluster of C blocks (grid (C, B)), each
// block a register form over its KS = K / C columns (rounded up to 4) with
// its own producer warp and rings.
template <int NT, int CPT, int NL>
__global__ void __launch_bounds__(NT + 32, 1) gibbs_fwd_cluster_kernel(const FwdArgs<NL> a) {
  __shared__ FwdInbox box;
  fwd_chain<NT, CPT, true, NL, false, true>(a, &box);
}


// ---------------------------------------------------------------------------
// backward sweep
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float *lemg, *trans;
  float* beta_out;
  float* split;                     // cluster form, SPLIT: 4 counts a block
  int G, BN, K, K_real, DE, prep;   // ring depth; active preparation warps
  int ahead;                        // the look-ahead form of the chain's step
  int KS, vec;                      // cluster form: columns a block; 16-byte copies allowed
  float invK;
};

// NT consumer threads (the chain of state row blockIdx.x) and BWD_PREP
// preparation warps. Step n (n = 0 .. G-2) takes beta from grid gn = G-1-n
// to grid gn-1; its ring stage holds e = exp(lemg[gn] - rowmax) and
// trans[:, gn]. Stage n % DE is always filled by warp n % prep (the
// launcher keeps DE a multiple of prep), so its fills stay in order.
// AHEAD is a second form of the chain's step, kept to be timed beside the
// default: it takes the next grid's e row out of the ring before the
// reduction instead of at the step's start, and multiplies by a reciprocal
// instead of dividing. At 128 chain threads it is the slower of the two.
template <int NT, int CPT, bool FAST, bool AHEAD>
__global__ void __launch_bounds__(NT + 32 * BWD_PREP) gibbs_bwd_kernel(
    const BwdArgs a) {
  extern __shared__ __align__(16) float dyn[];   // [DE][K] e rows
  __shared__ uint64_t bars[2 * MAX_DE];
  __shared__ float meta[MAX_DE][2];
  __shared__ __align__(16) float red[2 * (NT / 32) * 8];
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_DE;
  const int K = a.K, K_real = a.K_real, G = a.G, row = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.DE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NT) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x - NT) >> 5;
    if (warp >= a.prep) return;
    for (int n = warp; n < G - 1; n += a.prep) {
      const int gn = G - 1 - n, stage = n % a.DE;
      const float* lr = a.lemg + ((size_t)gn * a.BN + row) * K;
      float m = NEG;
      for (int k = lane; k < K_real; k += 32) m = fmaxf(m, lr[k]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      mbar_wait(&empty[stage], ((n / a.DE) & 1) ^ 1);
      float* eb = dyn + (size_t)stage * K;
      for (int k = lane; k < K; k += 32)
        eb[k] = k < K_real ? expf(lr[k] - m) : 0.f;
      if (lane == 0) {
        meta[stage][0] = a.trans[gn];
        meta[stage][1] = a.trans[G + gn];
      }
      release(&full[stage]);
    }
    return;
  }

  // ---- the chain: one reduction per grid ----
  const int tid = threadIdx.x;
  const int ncol = FAST ? CPT : (K + NT - 1) / NT;
  constexpr int UNROLL = FAST ? CPT : 1;
  float bs[CPT], etb[CPT], en[CPT];
  float t0n = 0.f, t1n = 0.f;
  int par = 0;
  Ring E(a.DE);
  auto fetch = [&]() {
    mbar_wait(&full[E.stage], E.phase);
    const float* eb = dyn + (size_t)E.stage * K;
    t0n = meta[E.stage][0], t1n = meta[E.stage][1];
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      const int c = tid + m * NT;
      en[m] = c < K ? eb[c] : 0.f;
    }
    release(&empty[E.stage]);
    E.next();
  };
#pragma unroll UNROLL
  for (int m = 0; m < ncol; ++m) {
    const int c = tid + m * NT;
    bs[m] = 1.f;
    if (c < K) a.beta_out[((size_t)(G - 1) * a.BN + row) * K + c] = 1.f;
  }
  if (AHEAD && G > 1) fetch();
  for (int g = G - 2; g >= 0; --g) {
    if (!AHEAD) fetch();
    const float t0 = t0n, t1 = t1n;
    float v[2] = {0.f, 0.f};   // sum(e*beta) | max(e*beta)
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      etb[m] = en[m] * bs[m];
      v[0] += etb[m];
      v[1] = fmaxf(v[1], etb[m]);
    }
    if (AHEAD && g > 0) fetch();
    chain_reduce<NT, 1, 1>(v, red, par);
    const float c0 = t1 * v[0] * a.invK;
    const float top = fmaf(t0, v[1], c0);   // = max_k fma(t0, etb_k, c0)
    const float d = top > 0.f ? top : 1.f;
    const float inv = 1.f / d;
#pragma unroll UNROLL
    for (int m = 0; m < ncol; ++m) {
      const int c = tid + m * NT;
      bs[m] = AHEAD ? fmaf(t0, etb[m], c0) * inv : fmaf(t0, etb[m], c0) / d;
      if (c < K) a.beta_out[((size_t)g * a.BN + row) * K + c] = bs[m];
    }
  }
}

// ---------------------------------------------------------------------------
// the global forms: any K
// ---------------------------------------------------------------------------
// Where no other form holds K (more columns than the general variant's
// GENERAL_NT x GENERAL_CPT, or, forward, not even one grid stage and one
// read row of shared memory for the producer's rings), a block of
// GLOBAL_NT threads walks the chain with no producer and no ring: each
// thread reads its columns of lemg, beta and the read rows straight from
// device memory. The forward keeps alpha in a global scratch plane
// [B][NL][K] and takes its lemg output row as its working lemg; the
// backward keeps e*beta in its beta output row until the step's sums are
// known. A thread touches only its own columns (tid + m * GLOBAL_NT) of
// every plane, so the chain's reductions are the only barriers. The steps
// are the register forms' (the same sums in the same reductions, the same
// draw); the row maxima of the next grid's lemg ride in the current grid's
// reduction, as there.

template <int NL>
__global__ void __launch_bounds__(GLOBAL_NT) gibbs_fwd_global_kernel(const FwdArgs<NL> a) {
  constexpr int NT = GLOBAL_NT, SLOT = 8;
  __shared__ __align__(16) float red[2 * (NT / 32) * SLOT];
  const int tid = threadIdx.x, b = blockIdx.x, K = a.K, K_real = a.K_real;
  const int BN = NL * a.B, first = a.first_read[b];
  float* alpha = a.scratch + (size_t)b * NL * K;   // row h at alpha + h * K
  // row h of chain b in grid g of a [G, NL*B, K] plane
  auto at = [&](auto* p, int g, int h) { return p + ((size_t)g * BN + h * a.B + b) * K; };
  float pc[NL], logc[NL], zprod[NL], lab[NL], mx[NL];
  bool uf = false;
  int par = 0;
#pragma unroll
  for (int h = 0; h < NL; ++h) {
    logc[h] = 0.f;
    zprod[h] = 1.f;
    pc[h] = 0.f;
    lab[h] = a.lab_init[NL * b + h];
    mx[h] = NEG;
  }
  for (int c = tid; c < K; c += NT) {
#pragma unroll
    for (int h = 0; h < NL; ++h) {
      alpha[h * K + c] = 0.f;
      if (c < K_real) mx[h] = fmaxf(mx[h], at(a.lemg, 0, h)[c]);
    }
  }
  chain_reduce<NT, 0, NL, SLOT>(mx, red, par);

  for (int g = 0; g < a.G; ++g) {
    // ---- alpha advance into grid g: one reduction ----
    const float t0 = a.trans[g], t1 = a.trans[a.G + g];
    const bool has_next = g + 1 < a.G;
    const float jump = (t1 + (g == 0 ? 1.f : 0.f)) * a.invK;
    float v[3 * NL];   // sum(a_raw), sum(a_raw*beta) | max of the next lemg
#pragma unroll
    for (int h = 0; h < NL; ++h) v[h] = v[NL + h] = 0.f, v[2 * NL + h] = NEG;
    for (int c = tid; c < K; c += NT) {
#pragma unroll
      for (int h = 0; h < NL; ++h) {
        const float l = at(a.lemg, g, h)[c];
        at(a.lemg_out, g, h)[c] = l;
        if (has_next && c < K_real) v[2 * NL + h] = fmaxf(v[2 * NL + h], at(a.lemg, g + 1, h)[c]);
        const float e = c < K_real ? expf(l - mx[h]) : 0.f;
        const float ar = e * (t0 * alpha[h * K + c] + jump);
        alpha[h * K + c] = ar;
        v[h] += ar;
        v[NL + h] += ar * at(a.beta, g, h)[c];
      }
    }
    chain_reduce_n<NT, 2 * NL, NL, SLOT>(v, red, par);
    float q[NL];
#pragma unroll
    for (int h = 0; h < NL; ++h) {
      const float s = v[h];
      uf = uf || !isfinite(s) || s <= 0.f;
      const float ss = s > 0.f ? s : 1.f;
      q[h] = __fdividef(1.f, ss);
      pc[h] = v[NL + h] * q[h];
      logc[h] = logc[h] + logf(ss) + mx[h];
      mx[h] = v[2 * NL + h];
    }
    for (int c = tid; c < K; c += NT) {
#pragma unroll
      for (int h = 0; h < NL; ++h) alpha[h * K + c] *= q[h];
    }

    // ---- the grid's read slots in order: one reduction a live one ----
    for (int i = 0; i < a.W; ++i) {
      const SlotWords w = load_words(a, g, i, b);
      if (i >= w.cnt || w.skip != 0) {   // the same in every thread
        if (tid == 0) a.h_out[((size_t)g * a.W + i) * a.B + b] = w.h;
        continue;
      }
      const float* lr = a.lem_pad + (((size_t)g * a.W + i) * a.B + b) * K;
      float qs[4 * NL];
#pragma unroll
      for (int j2 = 0; j2 < 4 * NL; ++j2) qs[j2] = 0.f;
      for (int c = tid; c < K; c += NT) {
        const float l = lr[c], em = expf(l), iv = expf(-l);
#pragma unroll
        for (int h = 0; h < NL; ++h) {
          const float al = alpha[h * K + c];
          const float ab = al * at(a.beta, g, h)[c];
          qs[h] += ab * em;
          qs[NL + h] += ab * iv;
          qs[2 * NL + h] += al * em;
          qs[3 * NL + h] += al * iv;
        }
      }
      chain_reduce_n<NT, 4 * NL, 0, SLOT>(qs, red, par);
      const int hC = w.h;
      const Draw<NL> dr = draw_label(a, qs, pc, __int_as_float(w.u), hC, w.rg, first, uf);
      const int h_new = dr.h_new;
      if (dr.flip) {
#pragma unroll
        for (int h = 0; h < NL; ++h) {
          const bool gains = h_new == h, loses = hC == h && dr.normal;
          if (gains || loses) {
            const float r = gains ? dr.rs[h] : dr.rs[NL + h];
            const float d = gains ? 1.f : -1.f;
            float* lo = at(a.lemg_out, g, h);
            for (int c = tid; c < K; c += NT) {
              const float l = lr[c];
              alpha[h * K + c] = alpha[h * K + c] * (gains ? expf(l) : expf(-l)) * r;
              lo[c] += d * l;
            }
            pc[h] = (gains ? qs[h] : dr.lose_C) * r;
            carry_log(logc[h], zprod[h], gains ? dr.z[h] : dr.z[NL + h]);
          }
          lab[h] += (h_new == h ? 1.f : 0.f) - (hC == h ? 1.f : 0.f);
        }
      }
      if (tid == 0) a.h_out[((size_t)g * a.W + i) * a.B + b] = dr.flip ? h_new : hC;
    }
    if (a.want_alpha) {
      for (int c = tid; c < K; c += NT) {
#pragma unroll
        for (int h = 0; h < NL; ++h) at(a.alpha_out, g, h)[c] = alpha[h * K + c];
      }
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < NL; ++h) {
      a.logc_out[h * a.B + b] = logc[h] + logf(zprod[h]);
      a.lab_out[NL * b + h] = lab[h];
    }
    a.uf_out[b] = uf ? 1.f : 0.f;
  }
}

// The backward of state row blockIdx.x: e*beta of a grid goes into its beta
// output row, then, once the step's sum and maximum are known, the row is
// rewritten as the grid's beta.
__global__ void __launch_bounds__(GLOBAL_NT) gibbs_bwd_global_kernel(const BwdArgs a) {
  constexpr int NT = GLOBAL_NT;
  __shared__ __align__(16) float red[2 * (NT / 32) * 8];
  const int tid = threadIdx.x, K = a.K, K_real = a.K_real, G = a.G;
  auto at = [&](auto* p, int g) { return p + ((size_t)g * a.BN + blockIdx.x) * K; };
  int par = 0;
  float m[1] = {NEG};   // the row maximum of the grid the next step reads
  for (int c = tid; c < K; c += NT) {
    at(a.beta_out, G - 1)[c] = 1.f;
    if (c < K_real && G > 1) m[0] = fmaxf(m[0], at(a.lemg, G - 1)[c]);
  }
  if (G > 1) chain_reduce<NT, 0, 1>(m, red, par);
  for (int g = G - 2; g >= 0; --g) {
    const float t0 = a.trans[g + 1], t1 = a.trans[G + g + 1];
    const float* lr = at(a.lemg, g + 1);
    const float* bn = at(a.beta_out, g + 1);
    float* bo = at(a.beta_out, g);
    float v[3] = {0.f, 0.f, NEG};   // sum(e*beta) | max(e*beta), max of lemg[g]
    for (int c = tid; c < K; c += NT) {
      const float etb = (c < K_real ? expf(lr[c] - m[0]) : 0.f) * bn[c];
      bo[c] = etb;
      v[0] += etb;
      v[1] = fmaxf(v[1], etb);
      if (g > 0 && c < K_real) v[2] = fmaxf(v[2], at(a.lemg, g)[c]);
    }
    chain_reduce<NT, 1, 2>(v, red, par);
    const float c0 = t1 * v[0] * a.invK;
    const float top = fmaf(t0, v[1], c0);   // = max_k fma(t0, etb_k, c0)
    const float d = top > 0.f ? top : 1.f;
    for (int c = tid; c < K; c += NT) bo[c] = fmaf(t0, bo[c], c0) / d;
    m[0] = v[2];
  }
}

// ---------------------------------------------------------------------------
// the backward's cluster form
// ---------------------------------------------------------------------------
// Past the general variant (K > 10,240) the backward runs each state row on
// a thread-block cluster of C blocks (grid (C, BN)); block r owns the
// columns r*KS .. r*KS + KS - 1 (KS = ceil(K / C) rounded up to 4) and holds
// their beta in registers, NT chain threads x CPT columns, as the register
// forms do. A producer warp copies each coming grid's lemg slice into a
// shared-memory ring of DE stages with cp.async, ahead of the chain. A grid
// step is one block reduction and one cluster exchange (cluster_xchg.cuh,
// records of 4 floats); beta is written once a grid, coalesced, by the
// block that owns the columns. Decisions:
//   * The row maximum spans the cluster: it rides in the step's record.
//     The record is {sum(e*beta), max(e*beta), max of the next grid's
//     lemg}, as in the global form's reduction, so the ring holds raw lemg
//     and the chain takes e = exp(lemg - max) once the exchange has given
//     the maximum (CPT exponentials a thread a step). Every block holds the
//     same maximum bit for bit, and the arithmetic is bwd_sweep_plain's (a
//     global maximum, no per-block shift): the plain version stays its
//     plain version, and the form differs from the others in the order of
//     its sums only.
//   * Waves: C = CLUSTER_C (8); the shape (NT, CPT) and the ring's depth
//     are chosen by the launcher from the state rows and what
//     cudaOccupancyMaxActiveClusters says the card holds at once: the least
//     whole waves of clusters, then the first shape of BWD_SHAPES, then the
//     deepest ring (plan_bwd_cluster). On an H100 80GB HBM3 at 700 W the
//     card holds 45 clusters of <256, 8> at once and 62 of <128, 16>, so
//     112 rows take two waves of the second against three of the first
//     (chip_smoke.py's "gibbs_bwd_cluster shapes" lines time both); at 512
//     grids x 16 rows x 10,368 the form takes 1.189 ms against the global
//     form's 4.826, at 112 rows 3.085 against 5.333 (PERF.md). It is the
//     faster at every row count timed (16 to 112), so bwd_form takes it by
//     K alone. A shape of 16 blocks (256 x 4) was slower where tried and is
//     not built.
//   * Columns that are not a multiple of C x 4: the last block owns fewer
//     (K = 10,241 at C = 8: 1,284 a block, the last 1,253); columns at or
//     past K_real give e = 0, columns past K are neither read nor written,
//     and the copies go 4 bytes at a time unless K is a multiple of 4.
//   * The exchange header is shared: the record is an Inbox<4>, a width the
//     header already takes; the forward sweep and the bank are untouched.
// SPLIT (measurement only) has chain thread 0 of every block count the
// clock cycles of the whole chain, of its ring waits, its block reductions
// and its exchanges into split[4 x block].
using BwdInbox = cluster_xchg::Inbox<4>;

template <int NT, int CPT, bool SPLIT>
__global__ void __launch_bounds__(NT + 32) gibbs_bwd_cluster_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float dyn[];   // [DE][KS] lemg slices
  __shared__ uint64_t bars[2 * MAX_DE];
  __shared__ __align__(16) float red[2 * (NT / 32) * 8];
  __shared__ BwdInbox box;
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_DE;
  const int G = a.G, KS = a.KS, row = blockIdx.y, k0 = blockIdx.x * KS;
  const int Kb = max(0, min(KS, a.K - k0)), Kr = max(0, min(KS, a.K_real - k0));
  cluster_xchg::Exchange<4> xc(&box);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.DE; ++s) {
      mbar_init(&full[s], 33);        // 32 cp.async arrivals + lane 0's
      mbar_init(&empty[s], NT / 32);  // one arrival per chain warp
    }
    xc.init();
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_xchg::cluster_sync_all();   // every block's inbox is ready
  if (threadIdx.x >= NT) {
    // the producer: stage j holds lemg[G-1-j], j = 0 .. G-2 (lemg[0] is never read)
    const int lane = threadIdx.x & 31;
    Ring E(a.DE);
    for (int j = 0; j + 1 < G; ++j) {
      mbar_wait(&empty[E.stage], E.phase ^ 1);
      copy_row(dyn + (size_t)E.stage * KS,
               a.lemg + ((size_t)(G - 1 - j) * a.BN + row) * a.K + k0, Kb, a.vec, lane);
      cp_async_arrive(&full[E.stage]);
      if (lane == 0) mbar_arrive(&full[E.stage]);
      E.next();
    }
    return;
  }

  // ---- the chain: one reduction and one exchange a grid ----
  const int tid = threadIdx.x;
  const size_t plane = (size_t)a.BN * a.K;
  float* out = a.beta_out + (size_t)row * a.K + k0;   // + g * plane: beta[g] of the row
  float bs[CPT], lc[CPT];   // beta of the grid above; raw lemg of the grid exponentiated next
  int par = 0;
  Ring E(a.DE);
  long long t_all = 0, t_ring = 0, t_red = 0, t_xch = 0, t_s = 0;
  const bool timer = SPLIT && tid == 0;
  if (timer) t_all = clock64();
  // stage j's columns into lc, with their maximum over the real columns
  auto take = [&](float& mx) {
    if (timer) t_s = clock64();
    mbar_wait(&full[E.stage], E.phase);
    if (timer) t_ring += clock64() - t_s;
    const float* st = dyn + (size_t)E.stage * KS;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = tid + m * NT;
      lc[m] = c < Kb ? st[c] : 0.f;
      if (c < Kr) mx = fmaxf(mx, lc[m]);
    }
    release(&empty[E.stage]);
    E.next();
  };
  // the block's values, then the cluster's
  auto reduce = [&](auto& v, auto ns) {
    constexpr int NV = sizeof(v) / sizeof(float), NS = decltype(ns)::value;
    if (timer) t_s = clock64();
    chain_reduce<NT, NS, NV - NS>(v, red, par);
    if (timer) t_red += clock64() - t_s, t_s = clock64();
    xc.template combine<NV, NS>(v, tid);
    if (timer) t_xch += clock64() - t_s;
  };
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int c = tid + m * NT;
    bs[m] = 1.f;
    lc[m] = 0.f;
    if (c < Kb) out[(size_t)(G - 1) * plane + c] = 1.f;
  }
  float mrow = NEG;   // the row maximum of the grid the next step exponentiates
  if (G > 1) {
    float v[1] = {NEG};
    take(v[0]);
    reduce(v, std::integral_constant<int, 0>());
    mrow = v[0];
  }
  for (int g = G - 2; g >= 0; --g) {
    const float t0 = __ldg(&a.trans[g + 1]), t1 = __ldg(&a.trans[G + g + 1]);
    float v[3] = {0.f, 0.f, NEG};   // sum(e*beta) | max(e*beta), max of lemg[g]
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const float e = tid + m * NT < Kr ? expf(lc[m] - mrow) : 0.f;
      bs[m] = e * bs[m];
      v[0] += bs[m];
      v[1] = fmaxf(v[1], bs[m]);
    }
    if (g > 0) take(v[2]);
    reduce(v, std::integral_constant<int, 1>());
    const float c0 = t1 * v[0] * a.invK;
    const float top = fmaf(t0, v[1], c0);   // = max_k fma(t0, etb_k, c0)
    const float d = top > 0.f ? top : 1.f;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = tid + m * NT;
      bs[m] = fmaf(t0, bs[m], c0) / d;
      if (c < Kb) out[(size_t)g * plane + c] = bs[m];
    }
    mrow = v[2];
  }
  if (timer) {
    float* sp = a.split + 4 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
    sp[0] = (float)(clock64() - t_all);
    sp[1] = (float)t_ring;
    sp[2] = (float)t_red;
    sp[3] = (float)t_xch;
  }
}

// ---------------------------------------------------------------------------
// the least a dependent step can take: the chain's reduction alone
// ---------------------------------------------------------------------------

template <int NT, int NV>
__global__ void __launch_bounds__(NT) chain_floor_kernel(float* out, int steps) {
  __shared__ __align__(16) float red[2 * (NT / 32) * NV];
  float v[NV];
  int par = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = 1e-3f * (threadIdx.x + j);
  for (int s = 0; s < steps; ++s) {
    chain_reduce<NT, NV, 0, NV>(v, red, par);
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = v[j] * 1e-3f + 1e-3f * threadIdx.x;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v[0] + v[NV - 1];
}

// The same on clusters of C blocks: each reduction (of NV = 8 or 12 values,
// as a read slot's step at NL = 2 or 3: one or two block reductions of at
// most 8) followed by the cluster exchange of its values.
template <int NT, int NV>
__global__ void __launch_bounds__(NT, 1) cluster_floor_kernel(float* out, int steps) {
  __shared__ __align__(16) float red[2 * (NT / 32) * 8];
  __shared__ FwdInbox box;
  cluster_xchg::Exchange<12> xc(&box);
  if (threadIdx.x == 0) xc.init();
  __syncthreads();
  cluster_xchg::cluster_sync_all();
  float v[NV];
  int par = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = 1e-3f * (threadIdx.x + j);
  for (int s = 0; s < steps; ++s) {
    chain_reduce_n<NT, NV, 0, 8>(v, red, par);
    xc.template combine<NV, NV>(v, threadIdx.x);
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = v[j] * 1e-3f + 1e-3f * threadIdx.x;
  }
  if (threadIdx.x == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = v[0] + v[NV - 1];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int set_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int NT, int CPT, bool FAST, bool WIDE = false, int NL>
int launch_fwd(const FwdArgs<NL>& a, cudaStream_t stream) {
  const size_t smem =
      ((size_t)a.DS * 2 * NL + a.DR) * a.K * sizeof(float);
  int err = set_smem((const void*)gibbs_fwd_kernel<NT, CPT, FAST, NL, WIDE>, smem);
  if (err) return err;
  gibbs_fwd_kernel<NT, CPT, FAST, NL, WIDE><<<a.B, NT + 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT, int CPT, bool FAST, bool AHEAD>
int launch_bwd_form(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.DE * a.K * sizeof(float);
  int err = set_smem((const void*)gibbs_bwd_kernel<NT, CPT, FAST, AHEAD>, smem);
  if (err) return err;
  gibbs_bwd_kernel<NT, CPT, FAST, AHEAD>
      <<<a.BN, NT + 32 * BWD_PREP, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The look-ahead form is built for the shape it is timed at only.
template <int NT, int CPT, bool FAST>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  if (a.ahead) {
    if constexpr (NT == 128 && CPT == 5)
      return launch_bwd_form<NT, CPT, FAST, true>(a, stream);
    return (int)cudaErrorInvalidValue;
  }
  return launch_bwd_form<NT, CPT, FAST, false>(a, stream);
}

// The instantiated (threads, columns a thread) pairs, smallest first per
// thread count. The caller names the form (kernels/gibbs_sweep.py:fwd_form
// and bwd_form choose it): a thread count (64, 128 or 256) takes the first
// of its pairs that holds K; -1 the general variant; -2 the global form.
// <64, 10> and <256, 3> are reached by an explicit count only: they exist to
// be timed at K = 640 beside the default. A form that does not hold K is
// refused, never replaced by another.
#define SWEEP_DISPATCH(LAUNCH, LAUNCH_GLOBAL, K, threads, a, stream)           \
  do {                                                                         \
    const int k_ = (K), t_ = (threads);                                        \
    if (t_ == 64 && k_ <= 64 * 10) return LAUNCH<64, 10, true>(a, stream);     \
    if (t_ == 128) {                                                           \
      if (k_ <= 128 * 2) return LAUNCH<128, 2, true>(a, stream);               \
      if (k_ <= 128 * 4) return LAUNCH<128, 4, true>(a, stream);               \
      if (k_ <= 128 * 5) return LAUNCH<128, 5, true>(a, stream);               \
      if (k_ <= 128 * 8) return LAUNCH<128, 8, true>(a, stream);               \
    }                                                                          \
    if (t_ == 256) {                                                           \
      if (k_ <= 256 * 3) return LAUNCH<256, 3, true>(a, stream);               \
      if (k_ <= 256 * 8) return LAUNCH<256, 8, true>(a, stream);               \
    }                                                                          \
    if (t_ == -1 && k_ <= GENERAL_NT * GENERAL_CPT)                            \
      return LAUNCH<GENERAL_NT, GENERAL_CPT, false>(a, stream);                \
    if (t_ == -2) return LAUNCH_GLOBAL(a, stream);                             \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)

template <int NL>
int launch_fwd_global(const FwdArgs<NL>& a, cudaStream_t stream) {
  if (a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  gibbs_fwd_global_kernel<NL><<<a.B, GLOBAL_NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_bwd_global(const BwdArgs& a, cudaStream_t stream) {
  gibbs_bwd_global_kernel<<<a.BN, GLOBAL_NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The backward's cluster shapes (chain threads, columns a thread; CLUSTER_C
// blocks a cluster), numbered from 1 in the order plan_bwd_cluster prefers
// them, and the ring depths it tries, deepest first.
struct BwdShape {
  int nt, cpt;
};
constexpr BwdShape BWD_SHAPES[] = {{256, 8}, {128, 16}};
constexpr int N_BWD_SHAPES = sizeof(BWD_SHAPES) / sizeof(BWD_SHAPES[0]);
constexpr int BWD_DEPTHS[] = {8, 4, 2};

// Launches shape <NT, CPT> on clusters of C blocks with a ring of DE
// stages, or, with `active`, only reads how many such clusters the card
// holds at once. Refuses a K past C x NT x CPT.
template <int NT, int CPT, bool SPLIT>
int run_bwd_cluster(BwdArgs a, int DE, cudaStream_t stream, int* active) {
  constexpr int C = CLUSTER_C;
  a.KS = ((a.K + C - 1) / C + 3) & ~3;
  if (a.KS > NT * CPT || DE < 1 || DE > MAX_DE) return (int)cudaErrorInvalidValue;
  a.DE = DE;
  const size_t smem = (size_t)DE * a.KS * sizeof(float);
  auto* kernel = gibbs_bwd_cluster_kernel<NT, CPT, SPLIT>;
  if (active) {   // at a grid of more rows than any wave holds: the card's own limit
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    return cluster_xchg::active_clusters(kernel, C, 4096, NT + 32, smem, stream, &cfg, attr,
                                         active);
  }
  return cluster_xchg::launch_clusters(kernel, C, a.BN, NT + 32, smem, stream, a);
}

template <bool SPLIT>
int bwd_cluster_shape(const BwdArgs& a, int shape, int DE, cudaStream_t s, int* active) {
  switch (shape) {
    case 1: return run_bwd_cluster<256, 8, SPLIT>(a, DE, s, active);
    case 2: return run_bwd_cluster<128, 16, SPLIT>(a, DE, s, active);
  }
  return (int)cudaErrorInvalidValue;
}

// The clusters of `shape` at ring depth DE and a.K that the card holds at
// once; kept a launch to the next (a query takes microseconds of the host).
int bwd_cluster_active(const BwdArgs& a, int shape, int DE, cudaStream_t s, int* active) {
  constexpr int ND = sizeof(BWD_DEPTHS) / sizeof(BWD_DEPTHS[0]);
  static long long seen[N_BWD_SHAPES + 1][ND + 1];   // (K + 1) << 32 | active
  int d = 0;
  while (d < ND && BWD_DEPTHS[d] != DE) ++d;
  long long* slot = shape >= 1 && shape <= N_BWD_SHAPES ? &seen[shape][d] : nullptr;
  if (slot) {
    const long long v = *(volatile long long*)slot;
    if ((v >> 32) == (long long)a.K + 1) {
      *active = (int)(v & 0xffffffff);
      return 0;
    }
  }
  const int err = bwd_cluster_shape<false>(a, shape, DE, s, active);
  if (!err && slot) *(volatile long long*)slot = (((long long)a.K + 1) << 32) | (unsigned)*active;
  return err;
}

// The launcher's choice at a.K and a.BN rows: the least whole waves of
// clusters (ceil(BN / active)), then the first shape, then the deepest ring.
// cudaErrorInvalidValue if no shape holds K, cudaErrorInvalidConfiguration
// if the card holds none of those that do.
int plan_bwd_cluster(const BwdArgs& a, cudaStream_t s, int* shape, int* DE, int* active) {
  int best = 0, held = 0;
  *shape = 0;
  for (int sh = 1; sh <= N_BWD_SHAPES; ++sh) {
    for (int de : BWD_DEPTHS) {
      int act = 0;
      if (bwd_cluster_active(a, sh, de, s, &act) != 0) break;   // the shape does not hold K
      held = 1;
      if (act < 1) continue;
      const int waves = (a.BN + act - 1) / act;
      if (*shape == 0 || waves < best) best = waves, *shape = sh, *DE = de, *active = act;
    }
  }
  if (*shape) return 0;
  return held ? (int)cudaErrorInvalidConfiguration : (int)cudaErrorInvalidValue;
}

// -3: the plan's shape, or (code = shape * 100 + DE, timings only) that one.
template <bool SPLIT>
int launch_bwd_cluster(const BwdArgs& a, int code, cudaStream_t s) {
  int shape = code / 100, DE = code % 100, active = 0;
  if (code == 0) {
    const int err = plan_bwd_cluster(a, s, &shape, &DE, &active);
    if (err) return err;
  }
  return bwd_cluster_shape<SPLIT>(a, shape, DE, s, nullptr);
}

// The forward sweep of the diploid sampler: every pair of SWEEP_DISPATCH.
int dispatch_fwd(const FwdArgs<2>& a, int threads, int wide, cudaStream_t stream) {
  if (wide) return (int)cudaErrorInvalidValue;
  SWEEP_DISPATCH(launch_fwd, launch_fwd_global<2>, a.K, threads, a, stream);
}

// The forward sweep at NL = 3 holds half as many more registers a column,
// so it is not built for the pairs that exist only to be timed, and the
// WIDE form only at the shape it is timed at (128 threads, K in (512, 640]).
int dispatch_fwd(const FwdArgs<3>& a, int threads, int wide, cudaStream_t stream) {
  const int K = a.K;
  if (wide) {
    if (threads == 128 && K > 128 * 4 && K <= 128 * 5)
      return launch_fwd<128, 5, true, true>(a, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (threads == 128) {
    if (K <= 128 * 2) return launch_fwd<128, 2, true>(a, stream);
    if (K <= 128 * 4) return launch_fwd<128, 4, true>(a, stream);
    if (K <= 128 * 5) return launch_fwd<128, 5, true>(a, stream);
    if (K <= 128 * 8) return launch_fwd<128, 8, true>(a, stream);
  }
  if (threads == 256 && K <= 256 * 8) return launch_fwd<256, 8, true>(a, stream);
  if (threads == -1 && K <= GENERAL_NT * GENERAL_CPT)
    return launch_fwd<GENERAL_NT, GENERAL_CPT, false>(a, stream);
  if (threads == -2) return launch_fwd_global<3>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// The rings shrink, not K: rows first, then grid stages, down to one each.
template <int NL>
bool size_rings(FwdArgs<NL>& a, int row_floats) {
  a.DS = MAX_DS, a.DR = MAX_DR;
  const size_t row = (size_t)row_floats * sizeof(float);
  while (((size_t)a.DS * 2 * NL + a.DR) * row > (size_t)SMEM_LIMIT) {
    if (a.DR > 1) a.DR /= 2;
    else if (a.DS > 1) a.DS -= 1;
    else return false;
  }
  return true;
}

// The cluster form (-3): CLUSTER_C blocks a chain of CLUSTER_NT chain
// threads, each block KS = ceil(K / CLUSTER_C) columns rounded up to 4, held
// in registers (CPT 8, or 6 at NL = 3, where 8 spill). A K beyond
// CLUSTER_C x CLUSTER_NT x CPT is refused; so is a shape the card cannot
// schedule (launch_clusters).
template <int NL>
int launch_fwd_cluster(FwdArgs<NL>& a, cudaStream_t stream) {
  constexpr int CPT = NL == 2 ? 8 : 6;
  a.KS = ((a.K + CLUSTER_C - 1) / CLUSTER_C + 3) & ~3;
  if (a.KS > CLUSTER_NT * CPT || !size_rings(a, a.KS)) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)a.DS * 2 * NL + a.DR) * a.KS * sizeof(float);
  return cluster_xchg::launch_clusters(gibbs_fwd_cluster_kernel<CLUSTER_NT, CPT, NL>, CLUSTER_C,
                                       a.B, CLUSTER_NT + 32, smem, stream, a);
}

template <int NL>
int run_fwd(const FwdCommon& c, const float* prior, int threads, int wide,
            cudaStream_t stream) {
  FwdArgs<NL> a;
  static_cast<FwdCommon&>(a) = c;
  for (int h = 0; h < NL; ++h) a.prior[h] = prior[h];
  if (threads == -3) return wide ? (int)cudaErrorInvalidValue : launch_fwd_cluster(a, stream);
  // the global form has no ring
  if (threads == -2) a.DS = a.DR = 0;
  else if (!size_rings(a, a.K)) return (int)cudaErrorInvalidValue;
  return dispatch_fwd(a, threads, wide, stream);
}

template <int NT>
int launch_floor(float* out, int blocks, int steps, int values, cudaStream_t s) {
  if (values == 8) chain_floor_kernel<NT, 8><<<blocks, NT, 0, s>>>(out, steps);
  else if (values == 16) chain_floor_kernel<NT, 16><<<blocks, NT, 0, s>>>(out, steps);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// nl: 2 (diploid) or 3 (NIPT) latent rows a chain, with the label prior
// p0..p2 (p2 unread at nl = 2). threads: the form, as SWEEP_DISPATCH reads
// it (64 / 128 / 256 chain threads, -1 the general variant, -2 the global
// form, which takes scratch [B, nl, K] floats; scratch is unread otherwise),
// or -3 the cluster form (CLUSTER_C blocks a chain of CLUSTER_NT chain
// threads each); cudaErrorInvalidValue if the form does not hold K, and
// cudaErrorInvalidConfiguration if the card cannot schedule the cluster.
// wide: 0 but to time the one-reduction form of the nl = 3 steps (128
// threads, K in (512, 640]).
extern "C" int gibbs_fwd(
    const void* lemg, const void* beta, const void* lem_pad,
    const void* slots, const void* first_read, const void* lab_init,
    const void* trans, const void* cnt_max, void* lemg_out, void* alpha_out,
    void* h_out, void* logc_out, void* uf_out, void* lab_out, void* scratch, int G,
    int B, int W, int K, int K_real, int it_mode, int want_alpha, int threads,
    int nl, int wide, float invK, float p0, float p1, float p2, void* stream) {
  FwdCommon a;
  a.lemg = (const float*)lemg, a.beta = (const float*)beta;
  a.lem_pad = (const float*)lem_pad, a.slots = (const int*)slots;
  a.first_read = (const int*)first_read, a.lab_init = (const float*)lab_init;
  a.trans = (const float*)trans, a.cnt_max = (const int*)cnt_max;
  a.lemg_out = (float*)lemg_out, a.alpha_out = (float*)alpha_out;
  a.h_out = (int*)h_out, a.logc_out = (float*)logc_out;
  a.uf_out = (float*)uf_out, a.lab_out = (float*)lab_out;
  a.scratch = (float*)scratch;
  a.G = G, a.B = B, a.W = W, a.K = K, a.K_real = K_real, a.it_mode = it_mode;
  a.want_alpha = want_alpha, a.invK = invK;
  a.vec = K % 4 == 0 && aligned16(lemg) && aligned16(beta) && aligned16(lem_pad);
  a.DS = a.DR = 0;
  a.KS = 0;
  const float prior[3] = {p0, p1, p2};
  cudaStream_t st = (cudaStream_t)stream;
  if (nl == 2) return run_fwd<2>(a, prior, threads, wide, st);
  if (nl == 3) return run_fwd<3>(a, prior, threads, wide, st);
  return (int)cudaErrorInvalidValue;
}

static BwdArgs bwd_args(const void* lemg, const void* trans, void* beta_out, int G, int BN,
                        int K, int K_real, float invK) {
  BwdArgs a;
  a.lemg = (const float*)lemg, a.trans = (const float*)trans;
  a.beta_out = (float*)beta_out;
  a.split = nullptr;
  a.G = G, a.BN = BN, a.K = K, a.K_real = K_real, a.invK = invK;
  a.ahead = 0, a.KS = 0, a.prep = 0;
  a.vec = K % 4 == 0 && aligned16(lemg);
  a.DE = MAX_DE;
  return a;
}

// threads: the form, as for gibbs_fwd (the global form takes no scratch), or
// -3 the cluster form (csrc: plan_bwd_cluster chooses its shape and ring);
// cudaErrorInvalidValue past its 16,384 columns, cudaErrorInvalidConfiguration
// if the card cannot schedule it. ahead: 0 but to time the look-ahead form
// (128 threads, K in (512, 640]), or, at -3, a shape * 100 + ring depth in
// place of the plan's (timings only).
extern "C" int gibbs_bwd(const void* lemg, const void* trans, void* beta_out,
                         int G, int BN, int K, int K_real, int threads,
                         int ahead, float invK, void* stream) {
  BwdArgs a = bwd_args(lemg, trans, beta_out, G, BN, K, K_real, invK);
  if (threads == -3) return launch_bwd_cluster<false>(a, ahead, (cudaStream_t)stream);
  a.ahead = ahead;
  while (threads != -2 && (size_t)a.DE * K * sizeof(float) > (size_t)SMEM_LIMIT) {
    if (a.DE > 1) a.DE /= 2;
    else return (int)cudaErrorInvalidValue;
  }
  a.prep = a.DE < BWD_PREP ? a.DE : BWD_PREP;
  if (threads == -2 && ahead) return (int)cudaErrorInvalidValue;
  SWEEP_DISPATCH(launch_bwd, launch_bwd_global, K, threads, a, (cudaStream_t)stream);
}

// The cluster form's plan at (K, BN) rows, or (code != 0) that shape:
// out[0..5] = shape, chain threads, columns a thread, blocks a cluster, ring
// depth, clusters the card holds at once.
extern "C" int gibbs_bwd_cluster_plan(int K, int BN, int code, void* out, void* stream) {
  BwdArgs a = bwd_args(nullptr, nullptr, nullptr, 2, BN, K, K, 1.f);
  cudaStream_t s = (cudaStream_t)stream;
  int shape = code / 100, DE = code % 100, active = 0;
  const int err = code == 0 ? plan_bwd_cluster(a, s, &shape, &DE, &active)
                            : bwd_cluster_active(a, shape, DE, s, &active);
  if (err) return err;
  const BwdShape& sh = BWD_SHAPES[shape - 1];
  const int v[6] = {shape, sh.nt, sh.cpt, CLUSTER_C, DE, active};
  for (int i = 0; i < 6; ++i) ((int*)out)[i] = v[i];
  return 0;
}

// The cluster form with its SPLIT counts (measurement only): as gibbs_bwd at
// -3 (code as `ahead` there), and split [BN, C, 4] floats: each block's
// clock cycles of the whole chain, its ring waits, block reductions and
// exchanges.
extern "C" int gibbs_bwd_cluster_split(const void* lemg, const void* trans, void* beta_out,
                                       void* split, int G, int BN, int K, int K_real, int code,
                                       float invK, void* stream) {
  BwdArgs a = bwd_args(lemg, trans, beta_out, G, BN, K, K_real, invK);
  a.split = (float*)split;
  return launch_bwd_cluster<true>(a, code, (cudaStream_t)stream);
}

// `steps` dependent reductions of `values` (8 or 16) sums by `threads`
// (64 / 128 / 256) threads in each of `blocks` blocks; out [blocks] floats.
extern "C" int gibbs_chain_floor(void* out, int blocks, int steps, int threads,
                                 int values, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads == 64) return launch_floor<64>((float*)out, blocks, steps, values, s);
  if (threads == 128) return launch_floor<128>((float*)out, blocks, steps, values, s);
  if (threads == 256) return launch_floor<256>((float*)out, blocks, steps, values, s);
  return (int)cudaErrorInvalidValue;
}

// The cluster form's read steps: `steps` block reductions of `values` (8 or
// 12; 3, the backward's record) values, each followed by the cluster exchange, on `chains` clusters of
// CLUSTER_C blocks of CLUSTER_NT threads; out [chains * CLUSTER_C] floats.
extern "C" int gibbs_cluster_floor(void* out, int chains, int steps, int values, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (values == 8)
    return cluster_xchg::launch_clusters(cluster_floor_kernel<CLUSTER_NT, 8>, CLUSTER_C, chains,
                                         CLUSTER_NT, 0, s, (float*)out, steps);
  if (values == 12)
    return cluster_xchg::launch_clusters(cluster_floor_kernel<CLUSTER_NT, 12>, CLUSTER_C, chains,
                                         CLUSTER_NT, 0, s, (float*)out, steps);
  if (values == 3)
    return cluster_xchg::launch_clusters(cluster_floor_kernel<CLUSTER_NT, 3>, CLUSTER_C, chains,
                                         CLUSTER_NT, 0, s, (float*)out, steps);
  return (int)cudaErrorInvalidValue;
}
