// Blockwise decorrelating transform + quantize (the zfplike base compressor's
// hot loop): codes = int32(rint((blocks @ M^T) / q)) for flattened (nb, B)
// blocks and the (B, B) Kronecker-expanded separable transform M.
//
// Replaces the TPU kernel repro/kernels/block_transform/kernel.py:_bt_kernel
// (block_transform_pallas), whose one MXU GEMM per grid step is fused with the
// quantizer.
//
// Bound: at B = 64 the work is 2 B flops per 8 B moved per element, close to
// the card's balance point for float32 on the CUDA cores (bytes bound it at the
// zfplike shape; operations at B = 128).  Design (simple first): each 256-
// thread block stages M transposed in shared memory (16 KB at B = 64, 64 KB at
// B = 128, which needs the dynamic-shared-memory opt-in) once, then walks tiles
// of R = (256 / B) * 8 block rows: the tile is staged in shared memory, thread
// (g, j) computes column j of 8 consecutive rows, reading M^T[k][j] (one bank
// per lane) and broadcast tile values.  Products and sums are float32 on the
// CUDA cores, accumulated over k = 0 .. B-1 in order with __fmul_rn/__fadd_rn
// so nothing contracts to an FMA: the result is bitwise equal to the plain
// twin, which makes the same sequence of roundings.  No TF32, no tensor cores
// yet.  The quantizer divides by q in IEEE (no --use_fast_math), rounds half
// to even (rintf) and saturates the cast (__float2int_rn), as the twin does.
#include "common.cuh"

namespace {

constexpr int kRowsPerThread = 8;

template <int B>
__global__ void block_transform_kernel(const float* __restrict__ x, const float* __restrict__ mat,
                                       float q, long long nb, int* __restrict__ codes) {
  constexpr int kGroups = repro_torch::kThreads / B;
  constexpr int kTileRows = kGroups * kRowsPerThread;
  extern __shared__ float smem[];
  float* mt = smem;          // mt[k * B + j] = M[j][k]
  float* xs = smem + B * B;  // xs[r * B + k]: the tile's rows
  for (int i = threadIdx.x; i < B * B; i += blockDim.x) mt[(i % B) * B + i / B] = mat[i];
  const int j = threadIdx.x % B;
  const int g = threadIdx.x / B;
  const long long tiles = (nb + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    __syncthreads();  // the previous tile's reads are done (and mt is staged)
    for (int i = threadIdx.x; i < kTileRows * B; i += blockDim.x) {
      const long long row = row0 + i / B;
      xs[i] = row < nb ? x[row0 * B + i] : 0.0f;
    }
    __syncthreads();
    float acc[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) acc[t] = 0.0f;
    const float* xr = xs + g * kRowsPerThread * B;
    for (int k = 0; k < B; ++k) {
      const float m = mt[k * B + j];
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t)
        acc[t] = __fadd_rn(acc[t], __fmul_rn(xr[t * B + k], m));
    }
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const long long row = row0 + g * kRowsPerThread + t;
      if (row < nb) codes[row * B + j] = __float2int_rn(rintf(__fdiv_rn(acc[t], q)));
    }
  }
}

template <int B>
int launch(const float* x, const float* mat, float q, long long nb, int* codes, cudaStream_t s) {
  constexpr int kTileRows = (repro_torch::kThreads / B) * kRowsPerThread;
  const size_t smem = sizeof(float) * (size_t)(B * B + kTileRows * B);
  cudaError_t err = cudaFuncSetAttribute(block_transform_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long tiles = (nb + kTileRows - 1) / kTileRows;
  const long long cap = 132LL * 8;  // more blocks than stay resident only queue
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  block_transform_kernel<B><<<grid, repro_torch::kThreads, smem, s>>>(x, mat, q, nb, codes);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (nb, B) float32, mat: (B, B) float32, codes: (nb, B) int32; B in
// {16, 32, 64, 128}.  Returns cudaErrorInvalidValue for another B.
extern "C" int block_transform_launch(const void* x, const void* mat, float q, int B,
                                      long long nb, void* codes, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  const float* xp = (const float*)x;
  const float* mp = (const float*)mat;
  int* cp = (int*)codes;
  cudaStream_t s = (cudaStream_t)stream;
  switch (B) {
    case 16: return launch<16>(xp, mp, q, nb, cp, s);
    case 32: return launch<32>(xp, mp, q, nb, cp, s);
    case 64: return launch<64>(xp, mp, q, nb, cp, s);
    case 128: return launch<128>(xp, mp, q, nb, cp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
