// Block-level helpers shared by the full-panel FB kernels (fb.cu: one block
// per row; fb_tiled.cu: one row's haplotypes split over a cluster of blocks).
// Every reduction has a fixed order, so two runs of a kernel agree exactly.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr float NEG = -1e30f;

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

// Emission logit of one haplotype in one grid: the plain float32 sum of the
// GL log-ratios dls[0..31] at the set bits of the haplotype's panel word.
// Every FB kernel takes its emissions from here, so a rematerialised alpha
// repeats the forward's arithmetic.
__device__ __forceinline__ float emission_logit(unsigned w, const float* dls) {
  float x = 0.f;
#pragma unroll
  for (int s = 0; s < 32; ++s) x += ((w >> s) & 1u) ? dls[s] : 0.f;
  return x;
}

}  // namespace
