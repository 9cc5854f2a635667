// The exchange of the cluster forms (gibbs_sweep.cu gibbs_fwd_cluster_kernel,
// nipt_bank.cu nipt_bank_cluster_kernel): one chain runs on a thread-block
// cluster of C blocks, each block owns a slice of the chain's columns, and
// every dependent step needs the step's sums (and maxima) over all of them.
//
// A step's exchange, after the block's own reduction has left the block's
// values in every thread of the chain:
//   1. lane r < C of warp 0 pushes the block's record (NV floats, in float4
//      stores) into slot `rank` of block r's inbox, over distributed shared
//      memory, then arrives on block r's inbox barrier of this step's parity
//      (release, cluster scope);
//   2. every thread of the chain waits on its own block's barrier (acquire,
//      cluster scope): C arrivals, one from each block;
//   3. every thread adds the C records of its own inbox in rank order.
// Every block therefore holds the same sums bit for bit, and any decision
// taken from them is the same in every block.
//
// Why a pushed record and an mbarrier, not barrier.cluster: the forward
// sweep keeps its producer warp, which runs ahead of the chain and takes no
// part in its steps, and barrier.cluster waits for every thread of the
// cluster that has not exited. A pushed record also crosses the cluster
// once a step (one store and one arrival); the reads that follow are local.
//
// Reuse: the inbox and barrier of parity p are written again two steps
// later. A block sends step s + 2 only after its wait of step s + 1, which
// needs every block's arrival of step s + 1, and a block arrives there only
// after it has read its inbox of step s (its chain passed a block barrier in
// between). So one inbox and one barrier per parity suffice, and a barrier
// is never two phases ahead of its waiter.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster_xchg {

constexpr int MAXC = 16;   // the largest cluster (16: non-portable, opted in)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of the same variable in block `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float x, float y, float z, float w) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(x), "f"(y),
               "f"(z), "f"(w)
               : "memory");
}

__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The whole cluster, every thread (the producer warp too): what thread 0
// initialised before it is visible to every block after it.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// (not volatile: where the exchange is unused, so are they)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// A block's inbox: records of SLOT floats (a multiple of 4), C of them a
// parity, and one barrier a parity.
template <int SLOT>
struct __align__(16) Inbox {
  float rec[2][MAXC][SLOT];
  uint64_t full[2];
};

// One block's side of the exchange. init() by thread 0, then
// cluster_sync_all() by every thread of the block before the first step.
template <int SLOT>
struct Exchange {
  static_assert(SLOT % 4 == 0, "a record is float4 stores");
  Inbox<SLOT>* box;
  int C, rank, step;

  __device__ Exchange(Inbox<SLOT>* b) : box(b), C((int)cluster_size()), rank((int)cluster_rank()), step(0) {}

  __device__ void init() const {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(&box->full[p])),
                   "r"(C)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // v: the block's NV values, sums first (NS of them), then maxima, the
  // same in every calling thread; on return the cluster's, combined in
  // rank order. Called by the chain's threads only (tid: the thread's index
  // among them; warp 0 must be among them).
  template <int NV, int NS>
  __device__ __forceinline__ void combine(float (&v)[NV], int tid) {
    static_assert(NV <= SLOT, "more values than a record holds");
    const int par = step & 1;
    const uint32_t phase = (uint32_t)(step >> 1) & 1u;
    ++step;
    if (tid < C) {
      const uint32_t dst = mapa(smem_u32(&box->rec[par][rank][0]), (uint32_t)tid);
#pragma unroll
      for (int q = 0; q < (NV + 3) / 4; ++q) {
        float x[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) x[t] = 4 * q + t < NV ? v[4 * q + t] : 0.f;
        st_cluster4(dst + 16 * q, x[0], x[1], x[2], x[3]);
      }
      arrive_cluster(mapa(smem_u32(&box->full[par]), (uint32_t)tid));
    }
    const uint32_t bar = smem_u32(&box->full[par]);
    if (!try_wait_cluster(bar, phase)) {
      const long long t0 = clock64();
      while (!try_wait_cluster(bar, phase))
        if (clock64() - t0 > 40000000000LL) __trap();   // ~20 s: a broken exchange, not a step
    }
    for (int r = 0; r < C; ++r) {
      const float4* in = reinterpret_cast<const float4*>(&box->rec[par][r][0]);
#pragma unroll
      for (int q = 0; q < (NV + 3) / 4; ++q) {
        const float4 x = in[q];
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = 4 * q + t;
          if (j < NV) v[j] = r == 0 ? xs[t] : (j < NS ? v[j] + xs[t] : fmaxf(v[j], xs[t]));
        }
      }
    }
  }
};

// The clusters of C blocks of `threads` threads and `smem` bytes of dynamic
// shared memory each that the card can hold at once
// (cudaOccupancyMaxActiveClusters; C > 8 opts in to a non-portable cluster
// size, smem > 48 KB to that much shared memory). *cfg is left ready to
// launch B rows on `stream` (attr: its one launch attribute).
template <class... Params>
int active_clusters(void (*kernel)(Params...), int C, int B, int threads, size_t smem,
                    cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int* active) {
  if (C < 1 || C > MAXC || B < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (C > 8) {
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  *cfg = {};
  cfg->gridDim = dim3(C, B);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *active = 0;
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)kernel, cfg);
}

// Launches `kernel` on a grid (C, B) of clusters (C, 1, 1), one cluster a
// chain (the cluster forms) or a row (fb_tiled.cu's K-split FB), `threads`
// threads and `smem` bytes of dynamic shared memory a block. Every cluster
// launch of the port goes through here. Refuses, with
// cudaErrorInvalidConfiguration, a shape of which the card cannot hold one
// cluster at a time (active_clusters 0): the caller never falls back to
// another form.
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int C, int B, int threads, size_t smem,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int active = 0;
  const int err = active_clusters(kernel, C, B, threads, smem, stream, &cfg, attr, &active);
  if (err) return err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cluster_xchg
