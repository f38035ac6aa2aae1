// QuantizeEdits (paper Alg. 1 lines 17-18): uniform round-to-nearest codes on
// the 2^m cube grid and their nonzero flags, in one pass:
//   step  = 2 b / 2^m            (exact in float32: a power-of-two scaling)
//   codes = step == 0 ? 0 : int32(rint(v / step))
//   flags = codes != 0
//
// Replaces the TPU kernel repro/kernels/quantize/kernel.py:_quantize_kernel
// (quantize_pallas).
//
// Bound by bytes: 4 B read + 8 B written per element (scalar b), plus 4 B read
// for a pointwise b; a handful of operations per element.  Design: one
// grid-stride loop with coalesced 4-byte accesses over exactly n elements (the
// TPU's (rows, 128) padding becomes the loop bound).  Arithmetic matches the
// plain twin bit for bit: IEEE division (the build uses no --use_fast_math),
// rintf rounds half to even like torch.round and jnp.rint, and the cast is
// __float2int_rn, which saturates out-of-range values to INT32_MIN/INT32_MAX
// and maps NaN to 0 — the twin spells out the same rule.
#include "common.cuh"

namespace {

template <bool kPointwise>
__global__ void quantize_kernel(const float* __restrict__ v, const float* __restrict__ b,
                                float b_scalar, float levels, int* __restrict__ codes,
                                int* __restrict__ flags, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float bound = kPointwise ? b[i] : b_scalar;
    const float step = __fdiv_rn(__fmul_rn(2.0f, bound), levels);
    const int c = step == 0.0f ? 0 : __float2int_rn(rintf(__fdiv_rn(v[i], step)));
    codes[i] = c;
    flags[i] = c != 0;
  }
}

}  // namespace

// levels = 2^m (a normal float32); b is read only when pointwise.
extern "C" int quantize_launch(const void* v, const void* b, float b_scalar, int pointwise,
                               float levels, void* codes, void* flags, long long n,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned grid = repro_torch::grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (pointwise) {
    quantize_kernel<true><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float*)v, (const float*)b, b_scalar, levels, (int*)codes, (int*)flags, n);
  } else {
    quantize_kernel<false><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float*)v, nullptr, b_scalar, levels, (int*)codes, (int*)flags, n);
  }
  return (int)cudaGetLastError();
}
