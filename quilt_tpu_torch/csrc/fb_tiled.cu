// K-split full-panel forward-backward: one row's haplotypes spread over a
// thread-block cluster, for few rows against a large reference panel.
//
// Replaces the four K-tiled Pallas TPU kernels of
// quilt_tpu/kernels/fb_pallas.py (all launched by fb_pallas_tiled_core):
//   fb_max_tiled      <- _max_kernel_tiled: per (grid, row) the maximum over
//                        all haplotypes of the emission logit (pads -1e30),
//                        so that every block of the forward exponentiates
//                        against the same value (a block a grid, the rows'
//                        byte tables staged once; below);
//   fb_forward_tiled  <- _fwd_kernel_tiled: a_raw = (stay*a_prev/S_prev +
//                        jump/K) * exp(logit - mx), kept UNNORMALISED; only
//                        S = sum_k a_raw crosses the K splits; one alpha
//                        checkpoint per chunk of CG grids, S per grid, and
//                        the log-likelihood sum_g (log S + mx);
//   fb_backward_tiled <- _remat_kernel_tiled + _bwd_kernel_tiled +
//                        _merge_topk, ONE launch an FB call: for each chunk
//                        of CG grids from the last to the first, the chunk's
//                        alphas rebuilt from its checkpoint and the stored
//                        (S, mx), then its grids descending: beta =
//                        stay_n*etb/E + jump_n/K, gamma = alpha*beta
//                        unnormalised; across the splits AB = sum gamma, E =
//                        sum e*beta, the 32 dosage partials and the
//                        top-K_top merge (value descending, lowest haplotype
//                        index on ties). No gamma capture, as on the TPU.
//
// The TPU kernels walk a (grid, K tile) iteration space in order on one
// core and exchange the cross-tile sums through VMEM scratch. Here the K
// splits of a row are CONCURRENT blocks of one thread-block cluster
// (cluster size = number of splits, 1, 2, 4, 8 or 16; 16 is a non-portable
// size, which cluster_xchg.cuh:launch_clusters opts in to): per grid step each block
// reduces its own haplotypes, posts its partial results in its shared
// memory, the cluster synchronises once, and every block reads the others'
// partials over distributed shared memory in rank order (so S, E and AB are
// the same in every block and in every run). The posts are double-buffered
// by step parity, which is what makes one cluster barrier per step enough.
//
// What bounds it on the H100: a dependent chain over the grids (512 steps),
// each a block reduction plus one cluster barrier, and per haplotype and
// grid ~40 operations to rebuild alpha (emission, step) and ~76 in the
// reverse step (emission, beta, gamma, 32 dosage adds) on the block's SM.
// The split cuts the per-step work of a block by the cluster size and
// spreads few rows over many SMs; the chain's latency stays.
//
// Design of the forward (the previous form, fb_tiled_prev.cu, kept alpha
// in a global row and took three barriers a step):
//   * Alpha in registers for up to CPT = 24 haplotypes a thread (the
//     backward's instantiations), the general form (CPT = 0) in the row's
//     scratch plane above; the checkpoint is written from the registers.
//     At 24 a thread (the staged form, STAGED_CPT) alpha and the next
//     grid's emissions fill the registers that one block an SM leaves, so
//     the words of the grid after it go to shared memory instead: each
//     thread copies its own columns there with cp.async a grid ahead and
//     reads only those, so no barrier guards them.
//   * Operands ahead of the chain: a grid's emissions (panel words, table
//     lookups, exp) do not depend on S, so the register forms compute the
//     next grid's between their arrival at the cluster barrier and their
//     wait on it, hiding the exchange; a chunk's log-ratios, maxima, stay
//     and jump/K are loaded a chunk ahead (one value a thread) and staged in
//     shared memory with its emission tables.
//   * One barrier a step: each warp posts its shuffle sum (NWARP floats a
//     block, double-buffered by step parity), one cluster barrier, then
//     every warp reads the NS x NWARP posts over distributed shared memory,
//     a few a lane, and adds them in a fixed order, so S is the same in
//     every block and every run.
//   * The pad haplotypes of a ragged row take no step: a thread steps only
//     its columns below K (a per-thread count), and theirs stay 0.
//   * One step routine (alpha_step) and the nibble tables, as the rebuild:
//     the backward's rebuilt alphas equal the forward's bit for bit.
//
// Design of the backward (one launch an FB call; the previous form,
// fb_tiled_prev.cu, launched a remat and a backward kernel per chunk):
//   * Every chunk in one launch. Each block walks the chunks from last to
//     first; it rebuilds its own haplotypes' alphas from the checkpoint
//     (no cluster barrier: nothing crosses the splits), then runs the
//     chunk's reverse steps with one cluster exchange a step. The e*beta
//     carry and E never leave the kernel.
//   * Chunk alphas on chip: the wrapper's checkpoint interval
//     (kernels/fb.py:tiled_cg) is the largest of 16, 8, 4, 2 whose alpha
//     planes fit the block's shared memory beside the tables and posts (4 at
//     10,240 haplotypes a block); where not even two fit, CG = 16 planes in
//     a global scratch row. A thread reads and writes only its own columns
//     of a plane, so no plane needs a barrier. The planes hold the RAW
//     rebuilt alpha; the reverse step normalises it by 1/S as it reads it.
//   * Register state: e*beta of the next grid and the next grid's panel
//     words in registers for up to CPT = 20 haplotypes a thread (a template
//     parameter); the general form (CPT = 0, any block width) keeps e*beta
//     in a global plane and reads the words in the step.
//   * The staged form (CPT = STAGED_CPT = 24, up to 12,288 haplotypes a
//     block: K = 98,304 at 8 blocks a row, 196,608 at 16): e*beta and the 32
//     dosage partials take the registers of one block an SM (128 a thread;
//     the words beside them would spill), so the rebuild, which reads every
//     grid's words of the chunk anyway, leaves them in shared-memory word
//     planes beside the alpha planes, and the reverse step reads both there.
//     Both planes of a grid take 2 x KS floats, so the interval is 2
//     (kernels/fb.py:tiled_cg). Again a thread reads only its own columns.
//   * Emissions by the nibble tables of fb_common.cuh, staged once a chunk,
//     in the forward and the rebuild alike, with one step routine
//     (alpha_step): the rebuilt alphas equal the forward's bit for bit.
//   * One block reduction a reverse step: the 32 dosage partials (one
//     transposing butterfly per warp), AB and E are independent, so each
//     warp posts one record of 34 values, one barrier, and 34 threads add
//     the 16 records in warp order into the block's post. Then the cluster
//     barrier and the reads of the posts in rank order, issued 8 at a time
//     (at 16 blocks a row one remote read after another would sit on the
//     chain 16 times).
//   * Top-K off the chain: at a thinned grid the alpha plane, once read,
//     takes the grid's gammas; each warp takes its own top K_top from its
//     lanes' columns by shuffles (a lane rescans its columns only when its
//     best is taken) and posts the sorted list with the step's partials.
//     After the cluster barrier, rank 0's warp 0 merges the NS x 16 sorted
//     lists (lane l holds the heads of lists l, l+32, ..., up to 8 of them at
//     16 blocks, by their shared::cluster addresses) while the other
//     warps go on. It finishes before it reaches the next cluster barrier,
//     so no block can overwrite that parity's post (two steps later) before
//     the merge has read it.
//   * Operands ahead of the chain: the next grid's words are loaded into
//     registers before the current step's reduction; a chunk's log-ratios,
//     tables, maxima, 1/S and transition terms are staged once a chunk.
//
// Checkpoint convention (the port's, as fb.cu): checkpoint c holds the
// alpha ENTERING chunk c (zeros for c = 0), here unnormalised, to be
// divided by S of the grid before the chunk. (The Pallas kernel's block c
// held the alpha entering chunk c+1, an artefact of its output write-back.)
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "cluster_xchg.cuh"
#include "fb_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SPLITS = 16;
constexpr int MAX_KTOP = 32;
constexpr int STAGED_CPT = 24;         // the form whose words are staged in shared memory
constexpr int MAX_CG = 16;             // the largest checkpoint interval
constexpr int RW = 34;                 // a warp's record: the 32 dosage sums, AB, E
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may take
constexpr unsigned FULL = 0xffffffffu;

// One forward step of one haplotype, with explicit roundings so that the
// forward and the rebuild cannot be contracted differently.
__device__ __forceinline__ float alpha_step(float a_prev, float inv_sprev,
                                            float stay, float jumpK, float e) {
  return __fmul_rn(__fmaf_rn(stay, __fmul_rn(a_prev, inv_sprev), jumpK), e);
}

// One 4-byte copy from global to shared memory that completes
// asynchronously, and the wait for all of the thread's copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(cluster_xchg::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ int ld_cluster_s32(uint32_t a) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// The forward's exchange, after the cluster barrier: the sum of the NS x
// NWARP posts (post: this block's posts of the step's parity), lane l
// adding posts l, l + 32, ... in that order, then the warp's butterfly;
// every lane of every warp returns the same sum. BATCH remote reads are
// issued at a time: 4 where the registers allow it (one block an SM, or
// the general form), 1 in the forms that run two blocks an SM (64
// registers a thread; 4 in flight made the 8-column form spill).
template <int BATCH>
__device__ __forceinline__ float fwd_exchange(cg::cluster_group& cluster, float* post, int NS) {
  const int lane = threadIdx.x & 31;
  float tot = 0.f;
  if constexpr (BATCH == 1) {
    for (int q = lane; q < NS * NWARP; q += 32)
      tot += *cluster.map_shared_rank(post + q % NWARP, q / NWARP);
  } else {
#pragma unroll
    for (int i0 = 0; i0 < MAX_SPLITS * NWARP / 32; i0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int q = lane + 32 * (i0 + i);
        v[i] = q < NS * NWARP ? *cluster.map_shared_rank(post + q % NWARP, q / NWARP) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (lane + 32 * (i0 + i) < NS * NWARP) tot += v[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
  return tot;
}

// The backward's exchange, after the cluster barrier: AB and E (values 32
// and 33 of each block's post) summed over the NS posts in rank order, the
// remote reads issued 8 at a time.
__device__ __forceinline__ void bwd_exchange(cg::cluster_group& cluster, float* mine, int NS,
                                             float& ab, float& e) {
  ab = 0.f;
  e = 0.f;
#pragma unroll
  for (int q0 = 0; q0 < MAX_SPLITS; q0 += 8) {
    float2 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = q0 + i < NS ? *reinterpret_cast<const float2*>(cluster.map_shared_rank(mine, q0 + i) + 32)
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (q0 + i < NS) {
        ab += v[i].x;
        e += v[i].y;
      }
    }
  }
}

// Value t of the NS posts summed in rank order (thread t < 32 of rank 0:
// the dosage sums), the remote reads issued 8 at a time.
__device__ __forceinline__ float post_sum(cg::cluster_group& cluster, float* mine, int NS, int t) {
  float d = 0.f;
#pragma unroll
  for (int q0 = 0; q0 < MAX_SPLITS; q0 += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = q0 + i < NS ? cluster.map_shared_rank(mine, q0 + i)[t] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (q0 + i < NS) d += v[i];
  }
  return d;
}

// ---- emission maximum. One block per grid serves all its rows, 32 rows
// (one a lane) a pass. A pass stages the rows' byte tables once: entry
// (q, v, row) is the logit contribution of byte q of a panel word whose value
// is v, the sum of the log-ratios of v's set bits in bit order (two nibble
// sums, the low nibble's first; each thread builds 32 entries from the 8
// log-ratios in its registers), laid out [4][256][32 rows] so that the 32
// lanes reading one entry for their rows hit 32 banks. A warp then walks
// chunks of 32 haplotypes: its lanes load the chunk's words (coalesced, one
// chunk ahead), write each word's four table offsets to the warp's buffer,
// and every lane takes, for each haplotype, its row's logit as four lookups
// added in byte order and keeps a running maximum. One block reduction a
// pass; no atomics, no barrier a row.
//
// The logit adds the 8 nibble sums as ((b0 + b1) + b2) + b3 with b_q the
// sum of nibbles 2q and 2q + 1, where the forward, the backward and the
// plain versions add them in nibble order: mx differs from the largest of
// their logits by rounding only (kernels/fb.py:max_tiled_tolerance), and
// the forward and the backward both read this mx.
constexpr int MX_NT = 1024;
constexpr int MX_NWARP = MX_NT / 32;
constexpr int MX_ROWS = 32;                  // rows a pass, one a lane
constexpr int MX_TAB = 4 * 256 * MX_ROWS;    // floats of a pass's byte tables
constexpr int MX_DLS = MX_ROWS * 33;         // the pass's log-ratios, rows padded to 33
constexpr int MX_SMEM = 4 * (MX_TAB + MX_DLS + MX_NWARP * MX_ROWS + MX_NWARP * 32 * 4);

__global__ void __launch_bounds__(MX_NT, 1) fb_max_tiled_kernel(
    const unsigned* __restrict__ words, const float* __restrict__ dl, float* __restrict__ mx,
    int Gp, int K, int K_pad, int B) {
  extern __shared__ float4 mx_smem4[];
  float* tab = reinterpret_cast<float*>(mx_smem4);              // [4][256][32]
  float* dls = tab + MX_TAB;                                    // [32][33]
  float* red = dls + MX_DLS;                                    // [warps][32]
  int4* offs = reinterpret_cast<int4*>(red + MX_NWARP * MX_ROWS) + (threadIdx.x >> 5) * 32;
  const int g = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned* wg = words + (size_t)g * K_pad;
  const float* t = tab + lane;                                  // this lane's row
  for (int r0 = 0; r0 < B; r0 += MX_ROWS) {
    const int nr = B - r0 < MX_ROWS ? B - r0 : MX_ROWS;
    for (int i = threadIdx.x; i < MX_ROWS * 32; i += MX_NT) {
      const int r = i >> 5, s = i & 31;
      dls[r * 33 + s] = r < nr ? dl[((size_t)(r0 + r) * Gp + g) * 32 + s] : 0.f;
    }
    __syncthreads();
    {
      // thread (v group, byte q, row r) builds entries v0 .. v0 + 31 of table
      // q for row r from the row's 8 log-ratios in registers: the 16 sums of
      // the low nibble and the two of the high nibbles it meets
      static_assert(MX_NT == 8 * 4 * MX_ROWS, "the table build takes one thread a (v group, q, r)");
      const int r = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3, v0 = (threadIdx.x >> 7) * 32;
      float d[8], lo[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = dls[r * 33 + 8 * q + i];
#pragma unroll
      for (int v = 0; v < 16; ++v) lo[v] = nibble_sum(v, d);
      const float hi0 = nibble_sum(v0 >> 4, d + 4), hi1 = nibble_sum((v0 >> 4) + 1, d + 4);
#pragma unroll
      for (int v = 0; v < 32; ++v)
        tab[((q * 256) + v0 + v) * MX_ROWS + r] = lo[v & 15] + (v < 16 ? hi0 : hi1);
    }
    __syncthreads();
    float m = NEG;
    int kc = warp * 32;
    unsigned wn = kc + lane < K ? __ldg(wg + kc + lane) : 0u;
    for (; kc < K; kc += MX_NWARP * 32) {
      const unsigned w = wn;
      const int kn = kc + MX_NWARP * 32 + lane;
      wn = kn < K ? __ldg(wg + kn) : 0u;
      // entry (q, byte q of w) of the tables, in floats from the lane's row
      offs[lane] = make_int4((int)(w & 255u) << 5, (int)(((w >> 8) & 255u) + 256) << 5,
                             (int)(((w >> 16) & 255u) + 512) << 5, (int)((w >> 24) + 768) << 5);
      __syncwarp();
      const int n = K - kc < 32 ? K - kc : 32;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const int4 o = offs[j];
        m = fmaxf(m, ((t[o.x] + t[o.y]) + t[o.z]) + t[o.w]);
      }
      __syncwarp();
    }
    red[warp * MX_ROWS + lane] = m;
    __syncthreads();
    if (threadIdx.x < nr) {
      float r = red[threadIdx.x];
      for (int w = 1; w < MX_NWARP; ++w) r = fmaxf(r, red[w * MX_ROWS + threadIdx.x]);
      mx[(size_t)g * B + r0 + threadIdx.x] = r;
    }
  }
}

// ---------------------------------------------------------------------------
// the backward: rebuild + reverse sweep of every chunk, one launch
// ---------------------------------------------------------------------------

// Floats of a block's post (one parity): its 34 sums, then its warps' top-K
// lists, NWARP x K_top values and NWARP x K_top haplotype indices.
__host__ __device__ inline int post_floats(int K_top) { return r4(RW + 2 * NWARP * K_top); }

// Dynamic shared memory of the backward in floats, region by region
// (kernels/fb.py:_bwd_tiled_smem_bytes mirrors it; fb_backward_tiled_smem_bytes
// exports it): the warps' records, the
// two posts, the chunk's scalars (maxima, stay, jump/K, 1/S), its
// log-ratios and emission tables, and `planes` planes of KS floats a grid of
// the chunk: 0 (global storage), 1 (its CG alpha planes) or 2 (the staged
// form: the alpha planes, then CG word planes).
__host__ __device__ inline int bwd_smem_floats(int CG, int KS, int K_top, int planes) {
  return r4(NWARP * RW) + 2 * post_floats(K_top) + r4(4 * CG + 1) + r4(CG * 32) + CG * EMF +
         planes * CG * KS;
}

// The planes a grid of the chunk a form keeps in shared memory.
__host__ __device__ inline int smem_planes_of(int cpt, bool smem) {
  return smem ? (cpt == STAGED_CPT ? 2 : 1) : 0;
}

template <int CPT>
__device__ __forceinline__ int ncols(int KS) {
  return CPT > 0 ? CPT : (KS + NT - 1) / NT;
}

// The words of grid g at the thread's columns (register forms only); wb
// points at the block's first haplotype of grid 0.
template <int CPT>
__device__ __forceinline__ void load_words(Cols<CPT, unsigned>& w, const int* __restrict__ wb,
                                           int g, int K_pad, int KS) {
  if constexpr (CPT > 0) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int kl = threadIdx.x + c * NT;
      w[c] = kl < KS ? (unsigned)__ldg(wb + (size_t)g * K_pad + kl) : 0u;
    }
  }
}

template <int CPT>
__device__ __forceinline__ unsigned word_at(Cols<CPT, unsigned>& w, int c,
                                            const int* __restrict__ wb, int g, int K_pad) {
  if constexpr (CPT > 0) return w[c];
  else return (unsigned)__ldg(wb + (size_t)g * K_pad + threadIdx.x + c * NT);
}

// The cluster barrier split in two: what a thread does between its arrival
// and its wait overlaps the other blocks' arrival (writes before the arrive
// are visible to reads after the wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// ---- forward. Grid (splits, B), cluster (splits, 1, 1). Block `rank` of
// row b owns the haplotypes k0 = rank*KS .. k0+KS-1, thread t the local
// columns t + c*NT; their alphas in registers (CPT > 0) or, in the general
// form, in the row's scratch plane. Two blocks an SM (<= 64 registers a
// thread) up to 16 haplotypes a thread: at 8 blocks a row, 28 rows make one
// wave (3.068 ms an FB call against 4.040 at one block an SM, 28 x 40,960,
// measured before the split barrier, PERF.md; at 16 a thread the alphas,
// emissions and words then spill 92 B); 20 and 24 haplotypes a thread need
// one. The staged form (CPT = STAGED_CPT) keeps the words of the grid after
// the next in dynamic shared memory, NT x CPT words (fwd_words[c * NT + t]:
// thread t's column c), copied there by cp.async.
template <int CPT>
__global__ void __launch_bounds__(NT, CPT >= 20 ? 1 : 2) fb_fwd_tiled_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ trans2, const float* __restrict__ mx,
    float* __restrict__ ckpt, float* __restrict__ ssum, float* __restrict__ logs,
    float* __restrict__ scratch, int Gp, int K, int K_pad, int B, int CG, int KS,
    float invK) {
  constexpr bool STAGED = CPT == STAGED_CPT;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float dls_s[MAX_CG * 32];
  __shared__ float em[MAX_CG * EMF];
  __shared__ float sc[3 * MAX_CG];          // the chunk's maxima, stay, jump/K
  __shared__ float post[2][NWARP];          // the warps' sums, by step parity
  extern __shared__ unsigned fwd_words[];   // the staged form's words
  const int b = blockIdx.y;
  const unsigned rank = cluster.block_rank();
  const int NS = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = rank * KS;
  const int nc = ncols<CPT>(KS);
  // the thread's real haplotypes: its local columns below min(KS, K - k0);
  // the pad columns keep alpha 0 and take no step
  const int kr = min(KS, K - k0) - tid;
  const int nreal = kr > 0 ? (kr + NT - 1) / NT : 0;
  const float* dlr = dl + (size_t)b * Gp * 32;
  const int* wb = words + k0 + tid;
  Cols<CPT> alpha;
  // register forms: e of the next step's grid, and the panel words of the
  // grid after it (loaded a step ahead of their use; the staged form's in
  // fwd_words)
  float e[CPT > 0 ? CPT : 1];
  unsigned w[CPT > 0 && !STAGED ? CPT : 1];
  if constexpr (CPT == 0) alpha.p = scratch + (size_t)b * K_pad + k0;
#pragma unroll
  for (int c = 0; c < nc; ++c)
    if (tid + c * NT < KS) alpha[c] = 0.f;
  // the emissions exp(logit - max) of a grid (chunk slot j) at the thread's
  // real columns; they do not depend on S, so the register forms compute
  // the next grid's while the cluster barrier is pending
  auto emission = [&](unsigned word, int j) { return expf(logit(word, em, j) - sc[j]); };
  auto load_next = [&](int g) {
    if constexpr (STAGED) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c < nreal && g < Gp) cp_async4(fwd_words + c * NT + tid, wb + (size_t)g * K_pad + c * NT);
    } else if constexpr (CPT > 0) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c < nreal && g < Gp) w[c] = (unsigned)__ldg(wb + (size_t)g * K_pad + c * NT);
    }
  };
  auto emit_next = [&](int j) {       // e of the grid whose words w holds
    if constexpr (STAGED) {
      // the thread's own copies only; every read here comes before the
      // load_next that overwrites it
      cp_async_wait_all();
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c < nreal) e[c] = emission(fwd_words[c * NT + tid], j);
    } else if constexpr (CPT > 0) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c < nreal) e[c] = emission(w[c], j);
    }
  };
  load_next(0);
  // a chunk's log-ratios and scalars, one value a thread, loaded a chunk ahead
  auto chunk_operands = [&](int g0, float& d, float& x) {
    d = tid < CG * 32 ? __ldg(dlr + (size_t)g0 * 32 + tid) : 0.f;
    const int i = tid % CG, which = tid / CG;
    x = which == 0 ? __ldg(mx + (size_t)(g0 + i) * B + b)
        : which == 1 ? __ldg(trans2 + g0 + i)
        : which == 2 ? __ldg(trans2 + Gp + g0 + i) * invK : 0.f;
  };
  float pre_d, pre_x;
  chunk_operands(0, pre_d, pre_x);
  float acc = 0.f, inv_sprev = 1.f;
  for (int g = 0; g < Gp; ++g) {
    const int j = g % CG;
    if (j == 0) {
      // the checkpoint: the raw alpha entering the chunk, from the thread's columns
      float* ck = ckpt + ((size_t)(g / CG) * B + b) * K_pad + k0;
#pragma unroll
      for (int c = 0; c < nc; ++c)
        if (tid + c * NT < KS) ck[tid + c * NT] = alpha[c];
      // stage the chunk (every read of the previous chunk's tables and
      // scalars came before the last cluster barrier), then fetch the next
      if (tid < CG * 32) dls_s[tid] = pre_d;
      if (tid < 3 * CG) sc[tid] = pre_x;
      __syncthreads();
      for (int x = tid; x < CG * EMF; x += NT)
        em[x] = nibble_sum(x & 15, dls_s + (x >> 7) * 32 + ((x >> 4) & 7) * 4);
      __syncthreads();
      if (g + CG < Gp) chunk_operands(g + CG, pre_d, pre_x);
      emit_next(0);
      load_next(g + 1);
    }
    const float m = sc[j], st = sc[CG + j], jk = sc[2 * CG + j];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      if (c < nreal) {
        float ec;
        if constexpr (CPT > 0) ec = e[c];
        else ec = emission((unsigned)__ldg(wb + (size_t)g * K_pad + c * NT), j);
        const float a = alpha_step(alpha[c], inv_sprev, st, jk, ec);
        alpha[c] = a;
        s += a;
      }
    }
    // one exchange a step: each warp posts its sum, one cluster barrier,
    // then every warp adds the cluster's NS x NWARP posts in a fixed order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) post[g & 1][warp] = s;
    cluster_arrive();
    if (j + 1 < CG && g + 1 < Gp) {   // else the next chunk's first step, after staging
      emit_next(j + 1);
      load_next(g + 2);
    }
    cluster_wait();
    const float tot = fwd_exchange<(CPT > 0 && CPT < 20) ? 1 : 4>(cluster, post[g & 1], NS);
    inv_sprev = 1.f / tot;
    acc = acc + logf(tot) + m;
    if (rank == 0 && tid == 0) ssum[(size_t)g * B + b] = tot;
  }
  cluster.sync();   // no block leaves while its posts may still be read
  if (rank == 0 && tid == 0) logs[b] = acc;
}

// The lane's best entry of plane v among its columns (ascending, so the
// first maximum has the lowest index): value and local column, or (-inf,
// -1) when none is left.
template <int CPT>
__device__ __forceinline__ void lane_best(const float* v, int KS, float& bv, int& bk) {
  bv = -INFINITY;
  bk = -1;
#pragma unroll
  for (int c = 0; c < ncols<CPT>(KS); ++c) {
    const int kl = threadIdx.x + c * NT;
    if (kl < KS && v[kl] > bv) {
      bv = v[kl];
      bk = kl;
    }
  }
}

// The warp's top K_top of plane v over its lanes' columns into the list
// (lv, li), value descending, lowest index first on ties; indices are
// global (k0 + local column), INT_MAX after the warp's last column.
template <int CPT>
__device__ __forceinline__ void warp_topk(float* v, int KS, int k0, int K_top, float* lv,
                                          int* li) {
  const int lane = threadIdx.x & 31;
  float bv;
  int bk;
  lane_best<CPT>(v, KS, bv, bk);
  for (int t = 0; t < K_top; ++t) {
    float wv = bv;
    int wi = bk >= 0 ? k0 + bk : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, wv, o);
      const int oi = __shfl_xor_sync(FULL, wi, o);
      if (ov > wv || (ov == wv && oi < wi)) {
        wv = ov;
        wi = oi;
      }
    }
    if (lane == 0) {
      lv[t] = wv;
      li[t] = wi;
    }
    if (bk >= 0 && wi == k0 + bk) {   // this lane's entry was taken
      v[bk] = -INFINITY;
      lane_best<CPT>(v, KS, bv, bk);
    }
  }
}

// Rank 0's warp 0: the row's top K_top from the NS x NWARP sorted lists of
// the cluster's posts at `mine`'s offset, by K_top rounds of a merge whose
// lane l holds the heads of lists l, l + 32, ... (up to HL of them), each
// head by its shared::cluster address; values scaled by inv_ab. A taken
// head's successor is read only while rounds remain: by round t a list has
// given at most t + 1 of its K_top entries, so the read stays within it.
__device__ __forceinline__ void merge_lists(float* mine, int NS, int K_top, float inv_ab,
                                            float* tvr, int* tir) {
  constexpr int HL = MAX_SPLITS * NWARP / 32;
  const int lane = threadIdx.x & 31;
  const int L = NS * NWARP;
  const uint32_t base = cluster_xchg::smem_u32(mine);
  const uint32_t ioff = 4u * NWARP * K_top;        // the indices after the values
  uint32_t la[HL];
  float hv[HL];
  int hi[HL];
#pragma unroll
  for (int i = 0; i < HL; ++i) {
    const int l = lane + 32 * i;
    la[i] = 0u;
    hv[i] = -INFINITY;
    hi[i] = INT_MAX;
    if (l < L) {
      la[i] = cluster_xchg::mapa(base, (uint32_t)(l / NWARP)) + 4u * (RW + (l % NWARP) * K_top);
      hv[i] = ld_cluster_f32(la[i]);
      hi[i] = ld_cluster_s32(la[i] + ioff);
    }
  }
  for (int t = 0; t < K_top; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX, bs = -1;
#pragma unroll
    for (int i = 0; i < HL; ++i) {
      if (hv[i] > bv || (hv[i] == bv && hi[i] < bi)) {
        bv = hv[i];
        bi = hi[i];
        bs = i;
      }
    }
    float wv = bv;
    int wi = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, wv, o);
      const int oi = __shfl_xor_sync(FULL, wi, o);
      if (ov > wv || (ov == wv && oi < wi)) {
        wv = ov;
        wi = oi;
      }
    }
    if (lane == 0) {
      tvr[t] = wv * inv_ab;
      tir[t] = wi;
    }
    if (bs >= 0 && bi == wi && t + 1 < K_top) {   // the head of this lane's list bs was taken
#pragma unroll
      for (int i = 0; i < HL; ++i) {
        if (i == bs) {
          la[i] += 4u;
          hv[i] = ld_cluster_f32(la[i]);
          hi[i] = ld_cluster_s32(la[i] + ioff);
        }
      }
    }
  }
}

// Grid (splits, B), cluster (splits, 1, 1). Block `rank` of row b owns the
// haplotypes k0 = rank*KS .. k0+KS-1; thread t the local columns t + c*NT.
// scratch row of a block's row: the general form's e*beta plane (K_pad),
// then (global storage) the CG alpha planes. The staged form (CPT =
// STAGED_CPT, SMEM) keeps CG word planes of KS words after the alpha
// planes. `rebuilt` (tests only; null on every other call) receives the raw
// rebuilt alphas [Gp, B, K_pad].
template <int CPT, bool SMEM>
__global__ void __launch_bounds__(NT, 1) fb_bwd_tiled_kernel(
    const int* __restrict__ words, const float* __restrict__ dl,
    const float* __restrict__ ckpt, const float* __restrict__ trans2,
    const int* __restrict__ thin, const float* __restrict__ mx,
    const float* __restrict__ ssum, float* __restrict__ dos, float* __restrict__ tv,
    int* __restrict__ ti, float* __restrict__ scratch, float* __restrict__ rebuilt, int Gp,
    int K, int K_pad, int B, int CG, int K_top, int KS, float invK, float eps) {
  constexpr bool STAGED = CPT == STAGED_CPT;
  static_assert(!STAGED || SMEM, "the staged form keeps its planes in shared memory");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);   // the warps' records
  float* posts = red + r4(NWARP * RW);            // 2 parities
  const int PW = post_floats(K_top);
  float* sc = posts + 2 * PW;                     // the chunk's scalars
  float* mxs = sc;
  float* stay = sc + CG;
  float* jmp = sc + 2 * CG;
  float* inv_s = sc + 3 * CG;                     // CG + 1: 1/S of the grid before j
  float* dls_s = sc + r4(4 * CG + 1);
  float* em = dls_s + r4(CG * 32);
  const int b = blockIdx.y;
  const unsigned rank = cluster.block_rank();
  const int NS = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = rank * KS;
  const int nc = ncols<CPT>(KS);
  const int NSC = Gp / CG;
  const float* dlr = dl + (size_t)b * Gp * 32;
  const int* wb = words + k0;
  float* row = scratch + (size_t)b * ((CPT == 0 ? 1 : 0) + (SMEM ? 0 : CG)) * K_pad;
  // plane j, local column kl: pl[j * pstride + kl]
  float* pl = SMEM ? em + CG * EMF : row + (CPT == 0 ? K_pad : 0) + k0;
  const int pstride = SMEM ? KS : K_pad;
  // the staged form's word planes: plane j, local column kl at wpl[j * KS + kl]
  unsigned* wpl = reinterpret_cast<unsigned*>(pl + (size_t)CG * KS);
  Cols<CPT> eb;
  Cols<STAGED ? 0 : CPT, unsigned> w;
  if constexpr (CPT == 0) eb.p = row + k0;
#pragma unroll
  for (int c = 0; c < nc; ++c)
    if (threadIdx.x + c * NT < KS) eb[c] = 1.f;
  float e_prev = (float)K;
  int par = 0;
  for (int s = 0; s < NSC; ++s) {
    const int ci = NSC - 1 - s, g0 = ci * CG;
    // ---- stage the chunk (the previous chunk's last step has passed its
    // cluster barrier, so nothing reads these regions any more) ----
    for (int j = threadIdx.x; j <= CG; j += NT) {
      const int gp = g0 + j - 1;
      inv_s[j] = gp >= 0 ? 1.f / ssum[(size_t)gp * B + b] : 1.f;
      if (j < CG) {
        mxs[j] = mx[(size_t)(g0 + j) * B + b];
        stay[j] = trans2[g0 + j];
        jmp[j] = trans2[Gp + g0 + j] * invK;
      }
    }
    stage_chunk(dlr, g0, CG, dls_s, em);
    // ---- rebuild the chunk's raw alphas, the forward's step ----
    const float* ck = ckpt + ((size_t)ci * B + b) * K_pad + k0;
    for (int j = 0; j < CG; ++j) {
      const int g = g0 + j;
      const float* pp = j == 0 ? ck : pl + (size_t)(j - 1) * pstride;
      float* pj = pl + (size_t)j * pstride;
      const float isp = inv_s[j], st = stay[j], jk = jmp[j], m = mxs[j];
      // the chunk's last grid's words stay in w for the reverse sweep (the
      // staged form leaves every grid's in its word planes)
      // (all its loads issued first: the rebuild leaves registers to spare)
      Cols<STAGED ? CPT : 0, unsigned> wt;
      if constexpr (STAGED) load_words<CPT>(wt, wb, g, K_pad, KS);
      else load_words<CPT>(w, wb, g, K_pad, KS);
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int kl = threadIdx.x + c * NT;
        if (kl < KS) {
          unsigned wd;
          if constexpr (STAGED) {
            wd = wt[c];
            wpl[j * KS + kl] = wd;
          } else {
            wd = word_at<CPT>(w, c, wb, g, K_pad);
          }
          const float x = k0 + kl < K ? logit(wd, em, j) : NEG;
          const float a = alpha_step(pp[kl], isp, st, jk, expf(x - m));
          pj[kl] = a;
          if (rebuilt != nullptr) rebuilt[((size_t)g * B + b) * K_pad + k0 + kl] = a;
        }
      }
    }
    // ---- reverse sweep: beta, gamma, dosage, top-K ----
    for (int j = CG - 1; j >= 0; --j) {
      const int g = g0 + j;
      const bool last = g == Gp - 1;                 // beta = 1: no successor
      const float stay_n = last ? 1.f : trans2[g + 1];
      const float jumpK_n = last ? 0.f : trans2[Gp + g + 1] * invK;
      const float inv_e = 1.f / fmaxf(e_prev, 1e-30f);
      const float ia = inv_s[j + 1], m = mxs[j];
      const bool thinned = thin[g] >= 0;
      float* pj = pl + (size_t)j * pstride;
      float sab = 0.f, se = 0.f;
      float D[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) D[t] = 0.f;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int kl = threadIdx.x + c * NT;
        if (kl < KS) {
          const int k = k0 + kl;
          unsigned wd;
          if constexpr (STAGED) wd = wpl[j * KS + kl];
          else wd = word_at<CPT>(w, c, wb, g, K_pad);
          const float beta = last ? 1.f : stay_n * (eb[c] * inv_e) + jumpK_n;
          const float gu = (pj[kl] * ia) * beta;
          sab += gu;
#pragma unroll
          for (int t = 0; t < 32; ++t)
            if ((wd >> t) & 1u) D[t] += gu;
          if (thinned) pj[kl] = k < K ? gu : -1.f;
          const float x = k < K ? logit(wd, em, j) : NEG;
          const float etb = expf(x - m) * beta;
          eb[c] = etb;
          se += etb;
        }
      }
      if constexpr (!STAGED)
        if (j > 0) load_words<CPT>(w, wb, g - 1, K_pad, KS);
      // one block reduction of 34 values: a record per warp, one barrier
      warp_transpose_sum(D);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sab += __shfl_xor_sync(FULL, sab, o);
        se += __shfl_xor_sync(FULL, se, o);
      }
      float* rec = red + warp * RW;
      rec[lane] = D[0];
      if (lane == 0) {
        rec[32] = sab;
        rec[33] = se;
      }
      float* mine = posts + par * PW;
      if (thinned)
        warp_topk<CPT>(pj, KS, k0, K_top, mine + RW + warp * K_top,
                       reinterpret_cast<int*>(mine + RW + NWARP * K_top) + warp * K_top);
      __syncthreads();
      if (threadIdx.x < RW) {
        float v = red[threadIdx.x];
#pragma unroll
        for (int q = 1; q < NWARP; ++q) v += red[q * RW + threadIdx.x];
        mine[threadIdx.x] = v;
      }
      cluster.sync();
      float e, ab;
      bwd_exchange(cluster, mine, NS, ab, e);
      e_prev = e;
      if (rank == 0) {
        const float inv_ab = 1.f / fmaxf(ab, 1e-30f);
        if (threadIdx.x < 32) {
          const float d = post_sum(cluster, mine, NS, threadIdx.x);
          dos[(size_t)b * Gp * 32 + (size_t)g * 32 + threadIdx.x] =
              eps + (1.f - 2.f * eps) * d * inv_ab;
        }
        float* tvr = tv + ((size_t)g * B + b) * K_top;
        int* tir = ti + ((size_t)g * B + b) * K_top;
        if (thinned) {
          if (warp == 0) merge_lists(mine, NS, K_top, inv_ab, tvr, tir);
        } else if (threadIdx.x < K_top) {
          tvr[threadIdx.x] = 0.f;
          tir[threadIdx.x] = 0;
        }
      }
      par ^= 1;
    }
  }
  cluster.sync();   // no block leaves while its posts may still be read
}

// The cluster exchange's floor: `steps` steps with no haplotype work by NT
// threads a block. FWD: the forward's (each warp posts its shuffle sum, the
// cluster barrier, every warp adds the NS x NWARP posts); else the reverse
// step's (the 34-value block reduction, the post, the cluster barrier, the
// reads of the NS posts).
template <bool FWD>
__global__ void __launch_bounds__(NT, 1) fb_tiled_floor_kernel(float* out, int steps) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float red[NWARP * RW];
  __shared__ __align__(16) float posts[2 * RW];
  const int NS = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 0.f;
  for (int i = 0; i < steps; ++i) {
    float* mine = posts + (i & 1) * RW;
    if constexpr (FWD) {
      float s = acc + 1.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (lane == 0) mine[warp] = s;
      cluster.sync();
      acc = fwd_exchange<4>(cluster, mine, NS) * 1e-9f;
    } else {
      float D[32], sab = acc + 1.f, se = acc;
#pragma unroll
      for (int t = 0; t < 32; ++t) D[t] = acc + t;
      warp_transpose_sum(D);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sab += __shfl_xor_sync(FULL, sab, o);
        se += __shfl_xor_sync(FULL, se, o);
      }
      red[warp * RW + lane] = D[0];
      if (lane == 0) {
        red[warp * RW + 32] = sab;
        red[warp * RW + 33] = se;
      }
      __syncthreads();
      if (threadIdx.x < RW) {
        float v = red[threadIdx.x];
#pragma unroll
        for (int q = 1; q < NWARP; ++q) v += red[q * RW + threadIdx.x];
        mine[threadIdx.x] = v;
      }
      cluster.sync();
      float ab, e;
      bwd_exchange(cluster, mine, NS, ab, e);
      acc = (e + ab) * 1e-9f;
    }
  }
  cluster.sync();
  if (threadIdx.x == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = acc;
}

bool bad_split(int splits, int K_pad, int KS) {
  return splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) ||
         (long long)splits * KS != K_pad;
}

// An instantiation of either kernel exists for cpt haplotypes a thread in
// registers (0: the general form, any block width; STAGED_CPT: the staged
// form).
bool cpt_ok(int cpt, int KS) {
  switch (cpt) {
    case 0: return true;
    case 2: case 4: case 8: case 16: case 20: case STAGED_CPT: return cpt * NT >= KS;
    default: return false;
  }
}

template <int CPT, bool SMEM>
int launch_bwd(const void* words, const void* dl, const void* ckpt, const void* trans2,
               const void* thin, const void* mx, const void* ssum, void* dos, void* tv, void* ti,
               void* scratch, void* rebuilt, int Gp, int K, int K_pad, int B, int CG, int K_top,
               int splits, float invK, float eps, cudaStream_t st) {
  const int KS = K_pad / splits;
  return cluster_xchg::launch_clusters(
      fb_bwd_tiled_kernel<CPT, SMEM>, splits, B, NT,
      4 * bwd_smem_floats(CG, KS, K_top, smem_planes_of(CPT, SMEM)), st,
      (const int*)words, (const float*)dl, (const float*)ckpt, (const float*)trans2,
      (const int*)thin, (const float*)mx, (const float*)ssum, (float*)dos, (float*)tv, (int*)ti,
      (float*)scratch, (float*)rebuilt, Gp, K, K_pad, B, CG, K_top, KS, invK, eps);
}

}  // namespace

constexpr int ERR_INVALID = (int)cudaErrorInvalidValue;

// mx [Gp, B]: the largest emission logit of each (grid, row) over the K
// real haplotypes (words [Gp, K_pad], dl [B, Gp * 32]).
extern "C" int fb_max_tiled(const void* words, const void* dl, void* mx, int Gp, int K,
                            int K_pad, int B, void* stream) {
  if (Gp < 1 || B < 1 || K < 1 || K > K_pad) return ERR_INVALID;
  const int err = (int)cudaFuncSetAttribute(
      (const void*)fb_max_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MX_SMEM);
  if (err) return err;
  fb_max_tiled_kernel<<<Gp, MX_NT, MX_SMEM, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const float*)dl, (float*)mx, Gp, K, K_pad, B);
  return (int)cudaGetLastError();
}

// The forward of a whole FB call (checkpoint interval CG) on clusters of
// `splits` blocks (1, 2, 4, 8 or 16). cpt: haplotypes a thread in registers
// (2, 4, 8, 16, 20 or 24, at least K_pad / splits / NT; 24 the staged form)
// or 0 for the general form, whose alphas live in the scratch row [B, K_pad]
// (unread otherwise). Returns cudaErrorInvalidValue for a split, interval or
// form without an instantiation.
extern "C" int fb_forward_tiled(const void* words, const void* dl, const void* trans2,
                                const void* mx, void* ckpt, void* ssum, void* logs,
                                void* scratch, int Gp, int K, int K_pad, int B, int CG,
                                int splits, float invK, int cpt, void* stream) {
  const int KS = K_pad / (splits > 0 ? splits : 1);
  if (bad_split(splits, K_pad, KS) || CG < 1 || CG > MAX_CG || Gp % CG || !cpt_ok(cpt, KS))
    return ERR_INVALID;
  // the staged form's words: NT x cpt words of dynamic shared memory beside
  // the static tables (past 48 KB in all, so opted in here)
  const size_t words_smem = cpt == STAGED_CPT ? (size_t)4 * NT * STAGED_CPT : 0;
  if (words_smem) {
    const int err = (int)cudaFuncSetAttribute((const void*)fb_fwd_tiled_kernel<STAGED_CPT>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)words_smem);
    if (err) return err;
  }
#define FWD(C)                                                                            \
  cluster_xchg::launch_clusters(fb_fwd_tiled_kernel<C>, splits, B, NT, words_smem,        \
                                (cudaStream_t)stream, (const int*)words, (const float*)dl, \
                                (const float*)trans2, (const float*)mx, (float*)ckpt,     \
                                (float*)ssum, (float*)logs, (float*)scratch, Gp, K, K_pad, \
                                B, CG, KS, invK)
  switch (cpt) {
    case 2: return FWD(2);
    case 4: return FWD(4);
    case 8: return FWD(8);
    case 16: return FWD(16);
    case 20: return FWD(20);
    case STAGED_CPT: return FWD(STAGED_CPT);
    default: return FWD(0);
  }
#undef FWD
}

// The backward of a whole FB call from the forward's checkpoints (interval
// CG), S and the emission maxima, on clusters of `splits` blocks (1, 2, 4,
// 8 or 16). smem_planes: the chunk's alphas in shared memory (1) or in the
// scratch rows (0, general form only); cpt: haplotypes a thread in
// registers (2, 4, 8, 16, 20 or 24, at least K_pad / splits / NT; 24 the
// staged form, whose word planes share the block's memory too) or 0 for
// the general form. The scratch row of a row holds, in planes of
// K_pad floats, the general form's e*beta plane, then (smem_planes = 0) the
// CG alpha planes. Returns cudaErrorInvalidValue for a split, K_top, cpt or
// storage without an instantiation, or shared memory beyond the block's.
extern "C" int fb_backward_tiled(const void* words, const void* dl, const void* ckpt,
                                 const void* trans2, const void* thin, const void* mx,
                                 const void* ssum, void* dos, void* tv, void* ti, void* scratch,
                                 void* rebuilt, int Gp, int K, int K_pad, int B, int CG,
                                 int K_top, int splits, float invK, float eps, int smem_planes,
                                 int cpt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int KS = K_pad / (splits > 0 ? splits : 1);
  if (bad_split(splits, K_pad, KS) || K_top < 1 || K_top > MAX_KTOP || K_top > KS ||
      CG < 1 || CG > MAX_CG || Gp % CG || !cpt_ok(cpt, KS) || (!smem_planes && cpt) ||
      4 * bwd_smem_floats(CG, KS, K_top, smem_planes_of(cpt, smem_planes != 0)) > SMEM_LIMIT)
    return ERR_INVALID;
#define BWD(C, M)                                                                           \
  launch_bwd<C, M>(words, dl, ckpt, trans2, thin, mx, ssum, dos, tv, ti, scratch, rebuilt, Gp, K, \
                   K_pad, B, CG, K_top, splits, invK, eps, st)
  if (!smem_planes) return BWD(0, false);
  switch (cpt) {
    case 2: return BWD(2, true);
    case 4: return BWD(4, true);
    case 8: return BWD(8, true);
    case 16: return BWD(16, true);
    case 20: return BWD(20, true);
    case STAGED_CPT: return BWD(STAGED_CPT, true);
    default: return BWD(0, true);
  }
#undef BWD
}

// The backward's dynamic shared memory in bytes (bwd_smem_floats; planes 0,
// 1 or 2), so that the wrapper's copy of the layout
// (kernels/fb.py:_bwd_tiled_smem_bytes) can be held to it.
extern "C" int fb_backward_tiled_smem_bytes(int CG, int KS, int K_top, int planes) {
  return 4 * bwd_smem_floats(CG, KS, K_top, planes);
}

// *active: the clusters of `splits` blocks that the card holds at once for
// the backward (fwd = 0) or the forward (fwd = 1) at cpt haplotypes a thread
// (0: the general form), KS haplotypes a block and interval CG (the
// backward with its planes in shared memory, 32-entry top-K lists).
extern "C" int fb_tiled_active_clusters(int splits, int KS, int CG, int cpt, int fwd,
                                        int* active) {
  if (splits < 1 || splits > MAX_SPLITS || !cpt_ok(cpt, KS)) return ERR_INVALID;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (fwd) {
    const size_t smem = cpt == STAGED_CPT ? (size_t)4 * NT * STAGED_CPT : 0;
#define FWD_ACTIVE(C)                                                                        \
  cluster_xchg::active_clusters(fb_fwd_tiled_kernel<C>, splits, 1, NT, smem, 0, &cfg, attr, \
                                active)
    if (smem) {
      const int err = (int)cudaFuncSetAttribute((const void*)fb_fwd_tiled_kernel<STAGED_CPT>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)smem);
      if (err) return err;
    }
    switch (cpt) {
      case 2: return FWD_ACTIVE(2);
      case 4: return FWD_ACTIVE(4);
      case 8: return FWD_ACTIVE(8);
      case 16: return FWD_ACTIVE(16);
      case 20: return FWD_ACTIVE(20);
      case STAGED_CPT: return FWD_ACTIVE(STAGED_CPT);
      default: return FWD_ACTIVE(0);
    }
#undef FWD_ACTIVE
  }
  const size_t smem = 4 * (size_t)bwd_smem_floats(CG, KS, MAX_KTOP, smem_planes_of(cpt, true));
  if (smem > SMEM_LIMIT) return ERR_INVALID;
#define BWD_ACTIVE(C)                                                                        \
  cluster_xchg::active_clusters(fb_bwd_tiled_kernel<C, true>, splits, 1, NT, smem, 0, &cfg, \
                                attr, active)
  switch (cpt) {
    case 2: return BWD_ACTIVE(2);
    case 4: return BWD_ACTIVE(4);
    case 8: return BWD_ACTIVE(8);
    case 16: return BWD_ACTIVE(16);
    case 20: return BWD_ACTIVE(20);
    case STAGED_CPT: return BWD_ACTIVE(STAGED_CPT);
    default: return BWD_ACTIVE(0);
  }
#undef BWD_ACTIVE
}

// `steps` exchange steps of the backward (fwd = 0) or the forward (fwd = 1)
// on B clusters of `splits` blocks.
extern "C" int fb_tiled_chain_floor(void* out, int splits, int B, int steps, int fwd,
                                    void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1))) return ERR_INVALID;
  if (fwd)
    return cluster_xchg::launch_clusters(fb_tiled_floor_kernel<true>, splits, B, NT, 0,
                                         (cudaStream_t)stream, (float*)out, steps);
  return cluster_xchg::launch_clusters(fb_tiled_floor_kernel<false>, splits, B, NT, 0,
                                       (cudaStream_t)stream, (float*)out, steps);
}
