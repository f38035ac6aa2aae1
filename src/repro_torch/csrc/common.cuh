// Shared device helpers of the port's kernels (scube.cu, fcube.cu, rfft.cu,
// quantize.cu, block_transform.cu): the bound clip, the convergence threshold,
// the conjugate-pair weight, the per-block violation-count reduction and the
// launch shapes.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;

// clip(x, -b, b) with clip's NaN propagation (a NaN compares false both ways).
__device__ __forceinline__ float clip_bound(float x, float b) {
  return x < -b ? -b : (x > b ? b : x);
}

// Convergence threshold t = d * tol1 + slack, two roundings and no fused
// multiply-add: the plain PyTorch twin rounds after the multiply too, and a
// contracted threshold would move components across it and change counts.
__device__ __forceinline__ float check_threshold(float d, float tol1, float slack) {
  return __fadd_rn(__fmul_rn(d, tol1), slack);
}

// Conjugate-pair multiplicity of half-spectrum column k of h = N/2 + 1
// columns: 1 on the k = 0 plane and, for even N, on the Nyquist plane k = h-1;
// 2 elsewhere (core/cubes.py rfft_pair_weights).
__device__ __forceinline__ int pair_weight(unsigned k, unsigned h, int nyquist) {
  return (k == 0u || (nyquist && k + 1u == h)) ? 1 : 2;
}

// Sum `v` over the block and add it to *out with one int32 atomicAdd.
// Integer sums are exact in any order, so the count is deterministic.
__device__ __forceinline__ void block_count_add(int v, int* out) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0) atomicAdd(out, v);
  }
}

// Grid size for a grid-stride loop over n elements: enough blocks to fill
// the card (132 SMs x 8 resident 256-thread blocks), no more than n needs.
inline unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 8;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// Block size for the per-pencil kernels (one block per row of h elements):
// whole warps, at most kThreads, no more than the row needs.
inline unsigned row_threads(long long h) {
  long long t = (h + 31) / 32 * 32;
  return (unsigned)(t > kThreads ? kThreads : (t < 32 ? 32 : t));
}

}  // namespace repro_torch
