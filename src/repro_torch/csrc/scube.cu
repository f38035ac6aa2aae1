// Fused s-cube projection (paper §IV-D ProjectOntoSCube): c = clip(x, -E, E)
// and the edit displacement c - x, in one pass.
//
// Replaces the TPU kernel repro/kernels/scube/kernel.py:_scube_kernel
// (scube_pallas).  It is also the inverse epilogue of the pack-trick loop
// (repro/kernels/rfft/kernel.py:_unpack_sclip_kernel): the half-length
// complex ifftn output, viewed as interleaved floats, already is the
// even/odd-interleaved spatial field, so the same launch clips it.
//
// Bound by bytes: 4 B read + 8 B written per element (scalar E), plus 4 B read
// for a pointwise E; no arithmetic to speak of.  Design: one grid-stride loop
// with coalesced 4-byte accesses over exactly n elements (no padding lanes:
// the tail is masked by the loop bound), E read once per element or held in a
// register when scalar.
#include "common.cuh"

namespace {

template <bool kPointwise>
__global__ void scube_kernel(const float* __restrict__ x, const float* __restrict__ e,
                             float e_scalar, float* __restrict__ out,
                             float* __restrict__ edit, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float xi = x[i];
    const float b = kPointwise ? e[i] : e_scalar;
    const float c = repro_torch::clip_bound(xi, b);
    out[i] = c;
    edit[i] = __fsub_rn(c, xi);
  }
}

}  // namespace

extern "C" int scube_launch(const void* x, const void* e, float e_scalar, int pointwise,
                            void* out, void* edit, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned grid = repro_torch::grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (pointwise) {
    scube_kernel<true><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float*)x, (const float*)e, e_scalar, (float*)out, (float*)edit, n);
  } else {
    scube_kernel<false><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float*)x, nullptr, e_scalar, (float*)out, (float*)edit, n);
  }
  return (int)cudaGetLastError();
}
