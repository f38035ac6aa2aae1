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
//
// Per-pencil mode (fcube_rows_launch; the batched pencil loop, a vmap of the
// TPU kernel over rows): the spectrum is rows independent half-spectra of h
// components, Delta is a scalar or one value per row, and the count is one
// int32 per row.  One block per row strides over its h components, so the
// row's bound sits in a register and the count is reduced per block and
// added to viol[row] once; no field-sized bound grid is built.
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

template <bool kRowVec>
__global__ void fcube_rows_kernel(const float2* __restrict__ delta, const float* __restrict__ dvec,
                                  float d_scalar, float tol1, float slack, unsigned h,
                                  int weighted, int nyquist, float2* __restrict__ clipped,
                                  float2* __restrict__ edit, int* __restrict__ viol) {
  const unsigned row = blockIdx.x;
  const long long base = (long long)row * h;
  const float d = kRowVec ? dvec[row] : d_scalar;
  const float t = repro_torch::check_threshold(d, tol1, slack);
  int count = 0;
  for (unsigned k = threadIdx.x; k < h; k += blockDim.x) {
    const long long i = base + k;
    const float2 x = delta[i];
    const float cr = repro_torch::clip_bound(x.x, d);
    const float ci = repro_torch::clip_bound(x.y, d);
    clipped[i] = make_float2(cr, ci);
    edit[i] = make_float2(__fsub_rn(cr, x.x), __fsub_rn(ci, x.y));
    if (fabsf(x.x) > t || fabsf(x.y) > t)
      count += weighted ? repro_torch::pair_weight(k, h, nyquist) : 1;
  }
  repro_torch::block_count_add(count, viol + row);
}

}  // namespace

// Per-pencil mode: delta holds rows x h components; dvec holds rows bounds
// when row_vec, else d_scalar bounds every row; viol points at rows zeroed
// int32 counts.
extern "C" int fcube_rows_launch(const void* delta, const void* dvec, float d_scalar, int row_vec,
                                 float tol1, float slack, long long rows, long long h,
                                 int weighted, int nyquist, void* clipped, void* edit, void* viol,
                                 void* stream) {
  if (rows <= 0 || h <= 0) return (int)cudaSuccess;
  const unsigned threads = repro_torch::row_threads(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (row_vec) {
    fcube_rows_kernel<true><<<(unsigned)rows, threads, 0, s>>>(
        (const float2*)delta, (const float*)dvec, d_scalar, tol1, slack, (unsigned)h, weighted,
        nyquist, (float2*)clipped, (float2*)edit, (int*)viol);
  } else {
    fcube_rows_kernel<false><<<(unsigned)rows, threads, 0, s>>>(
        (const float2*)delta, nullptr, d_scalar, tol1, slack, (unsigned)h, weighted, nyquist,
        (float2*)clipped, (float2*)edit, (int*)viol);
  }
  return (int)cudaGetLastError();
}

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
