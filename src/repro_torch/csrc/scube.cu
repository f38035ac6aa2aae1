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
//
// Per-pencil mode (the batched pencil loop, a vmap of the TPU kernel over
// rows): E is one value per row of row_len elements, read from a vector of
// rows floats (L1/L2-resident) instead of a field-sized grid.
#include "common.cuh"

namespace {

// kMode: 0 scalar E, 1 pointwise E (one per element), 2 one E per row
template <int kMode>
__global__ void scube_kernel(const float* __restrict__ x, const float* __restrict__ e,
                             float e_scalar, unsigned row_len, float* __restrict__ out,
                             float* __restrict__ edit, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float xi = x[i];
    const float b = kMode == 1 ? e[i] : (kMode == 2 ? e[(unsigned)i / row_len] : e_scalar);
    const float c = repro_torch::clip_bound(xi, b);
    out[i] = c;
    edit[i] = __fsub_rn(c, xi);
  }
}

}  // namespace

// mode: 0 scalar e_scalar, 1 e holds n bounds, 2 e holds n / row_len bounds
// (one per row of row_len contiguous elements).
extern "C" int scube_launch(const void* x, const void* e, float e_scalar, int mode,
                            long long row_len, void* out, void* edit, long long n,
                            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned grid = repro_torch::grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* ep = (const float*)e;
  const unsigned len = (unsigned)row_len;
  if (mode == 1) {
    scube_kernel<1><<<grid, repro_torch::kThreads, 0, s>>>(xp, ep, e_scalar, len, (float*)out,
                                                            (float*)edit, n);
  } else if (mode == 2) {
    scube_kernel<2><<<grid, repro_torch::kThreads, 0, s>>>(xp, ep, e_scalar, len, (float*)out,
                                                            (float*)edit, n);
  } else {
    scube_kernel<0><<<grid, repro_torch::kThreads, 0, s>>>(xp, nullptr, e_scalar, len,
                                                            (float*)out, (float*)edit, n);
  }
  return (int)cudaGetLastError();
}
