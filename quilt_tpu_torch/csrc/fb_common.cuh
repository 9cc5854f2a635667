// Block-level helpers shared by the full-panel FB kernels (fb.cu: one block
// per row; fb_tiled.cu: one row's haplotypes split over a cluster of blocks;
// fb_prev.cu / fb_tiled_prev.cu: the previous forms, kept for timing).
// Every reduction has a fixed order, so two runs of a kernel agree exactly.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr float NEG = -1e30f;
constexpr int EMF = 128;   // floats a grid of the emission tables (8 x 16)

__host__ __device__ constexpr int r4(int n) { return (n + 3) & ~3; }

// A thread's columns tid + c*NT: in registers (CPT > 0, loops unrolled)
// or, in a general instantiation (CPT = 0), in a global plane from p.
template <int CPT, class T = float>
struct Cols {
  T r[CPT > 0 ? CPT : 1];
  T* p;
  __device__ __forceinline__ T& operator[](int c) {
    if constexpr (CPT > 0) return r[c];
    else return p[threadIdx.x + c * NT];
  }
};

struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <class Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARP; ++w) r = op(r, red[w]);
  __syncthreads();
  return r;
}

// Block argmax: largest value, lowest index among equal values.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* rv, int* ri) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    rv[warp] = v;
    ri[warp] = i;
  }
  __syncthreads();
  v = rv[0];
  i = ri[0];
  for (int w = 1; w < NWARP; ++w) {
    if (rv[w] > v || (rv[w] == v && ri[w] < i)) {
      v = rv[w];
      i = ri[w];
    }
  }
  __syncthreads();
}

// Reduces 32 values over the block; thread t < 32 returns the sum of
// value t. Within a warp, a transposing butterfly leaves lane l with the
// warp's sum of value l (31 shuffles instead of 32 x 5).
__device__ __forceinline__ float block_reduce32(float (&v)[32], float* red) {
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

// Emission logit of one haplotype in one grid, the previous forms' way: the
// plain float32 sum of the GL log-ratios dls[0..31] at the set bits of the
// haplotype's panel word, one bit at a time.
__device__ __forceinline__ float emission_logit(unsigned w, const float* dls) {
  float x = 0.f;
#pragma unroll
  for (int s = 0; s < 32; ++s) x += ((w >> s) & 1u) ? dls[s] : 0.f;
  return x;
}

// ---- emissions by nibble tables (the FB forward and backward kernels) ----
// The logit of a panel word w is the sum over its 8 nibbles q of the table
// entry T_q[(w >> 4q) & 15], T_q[v] the sum of the log-ratios of the set
// bits of v (bits 4q..4q+3, added in bit order from 0), the 8 entries added
// in nibble order. The plain versions (kernels/fb.py:_tile_logits) add in
// the same order, so kernel and plain logits are equal. (fb_tiled.cu's
// emission maximum adds the nibble sums by byte instead.)

// Entry v of the table of one nibble whose 4 log-ratios are d[0..3].
__device__ __forceinline__ float nibble_sum(unsigned v, const float* d) {
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) x += ((v >> i) & 1u) ? d[i] : 0.f;
  return x;
}

// Stages the GL log-ratios of grids g0 .. g0+n-1 of row `dlr` in dls_s and
// builds their tables in em (n x EMF floats: table q of grid j at
// em[j*EMF + q*16]). Ends with a barrier.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ dlr, int g0, int n,
                                            float* dls_s, float* em) {
  for (int i = threadIdx.x; i < n * 32; i += NT) dls_s[i] = dlr[(size_t)g0 * 32 + i];
  __syncthreads();
  for (int e = threadIdx.x; e < n * EMF; e += NT)
    em[e] = nibble_sum(e & 15, dls_s + (e >> 7) * 32 + ((e >> 4) & 7) * 4);
  __syncthreads();
}

// The logit of panel word w at grid j of the staged chunk. A 16-entry
// table spans 16 distinct banks, so the 8 lookups of a warp never conflict
// (equal entries are broadcast).
__device__ __forceinline__ float logit(unsigned w, const float* em, int j) {
  const float* t = em + j * EMF;
  float x = t[w & 15u];
#pragma unroll
  for (int q = 1; q < 8; ++q) x += t[q * 16 + ((w >> (4 * q)) & 15u)];
  return x;
}

// The same logit from the grid's 32 log-ratios, without tables (equal to
// logit() bit for bit); the previous emission maximum's (fb_tiled_prev.cu).
__device__ __forceinline__ float logit_direct(unsigned w, const float* dls) {
  float x = nibble_sum(w & 15u, dls);
#pragma unroll
  for (int q = 1; q < 8; ++q) x += nibble_sum((w >> (4 * q)) & 15u, dls + 4 * q);
  return x;
}

// ---- the transposing butterfly ------------------------------------------

// One round: lanes with bit O set keep the upper half of their O*2 values,
// the others the lower half, and each adds its partner's copy of the half
// it keeps.
template <int O>
__device__ __forceinline__ void transpose_round(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? v[j] : v[j + O];
    const float keep = upper ? v[j + O] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Within a warp, leaves lane l with the warp's sum of v[l] in v[0] (31
// shuffles for 32 values). Each round has a constant trip count, so v
// stays in registers.
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_round<16>(v, lane);
  transpose_round<8>(v, lane);
  transpose_round<4>(v, lane);
  transpose_round<2>(v, lane);
  transpose_round<1>(v, lane);
}

}  // namespace
