// Fused f-cube projection + CheckConvergence (paper §IV-D): clip Re and Im of
// each frequency component to +-Delta, write the clipped spectrum and the edit
// displacement, and count the components with max(|Re|,|Im|) above
// t = Delta * tol1 + slack, weighted by conjugate-pair multiplicity.
//
// Replaces the TPU kernel repro/kernels/fcube/kernel.py:_fcube_kernel
// (fcube_pallas).
//
// Bound by bytes: 8 B read + 16 B written per complex component (scalar
// Delta), plus 4 B read for a pointwise Delta.  Design: the spectrum is read
// in torch.view_as_real's interleaved float2 layout (one 8-byte load per
// component), the pair weight is computed from the last-axis index instead of
// read from an int32 plane (4 B per component saved), and the count is reduced
// per block and added with one int32 atomicAdd.  No padding lanes: the tail is
// masked by the grid-stride loop bound.
#include "common.cuh"

namespace {

template <bool kPointwise>
__global__ void fcube_kernel(const float2* __restrict__ delta, const float* __restrict__ dgrid,
                             float d_scalar, float tol1, float slack, long long h,
                             int weighted, int nyquist, float2* __restrict__ clipped,
                             float2* __restrict__ edit, int* __restrict__ viol, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned uh = (unsigned)h;  // 32-bit index math: the wrapper keeps n < 2^31
  int count = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float2 x = delta[i];
    const float d = kPointwise ? dgrid[i] : d_scalar;
    const float cr = repro_torch::clip_bound(x.x, d);
    const float ci = repro_torch::clip_bound(x.y, d);
    clipped[i] = make_float2(cr, ci);
    edit[i] = make_float2(__fsub_rn(cr, x.x), __fsub_rn(ci, x.y));
    const float t = repro_torch::check_threshold(d, tol1, slack);
    if (fabsf(x.x) > t || fabsf(x.y) > t)
      count += weighted ? repro_torch::pair_weight((unsigned)i % uh, uh, nyquist) : 1;
  }
  repro_torch::block_count_add(count, viol);
}

}  // namespace

// viol must point at a zeroed int32; h is the last-axis length of the array
// (used only for the pair weights); nyquist says the real last axis is even.
extern "C" int fcube_launch(const void* delta, const void* dgrid, float d_scalar, int pointwise,
                            float tol1, float slack, long long h, int weighted, int nyquist,
                            void* clipped, void* edit, void* viol, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned grid = repro_torch::grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (pointwise) {
    fcube_kernel<true><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float2*)delta, (const float*)dgrid, d_scalar, tol1, slack, h, weighted, nyquist,
        (float2*)clipped, (float2*)edit, (int*)viol, n);
  } else {
    fcube_kernel<false><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float2*)delta, nullptr, d_scalar, tol1, slack, h, weighted, nyquist,
        (float2*)clipped, (float2*)edit, (int*)viol, n);
  }
  return (int)cudaGetLastError();
}
