// Fused forward epilogue of the pack-trick POCS loop: one pass over the rfftn
// half-spectrum X (shape d0 x d1 x d2 x h, h = N/2 + 1, N even) that
//   1. clips Re/Im to +-Delta and writes the clipped spectrum and the edit
//      displacement (ProjectOntoFCube),
//   2. counts pair-weighted components above t = Delta * tol1 + slack
//      (CheckConvergence),
//   3. clips the Hermitian mirror X[-k0, -k1, -k2, Nh - k] against the
//      mirrored bound and applies the inverse pack twiddle, writing
//      Z = E + iO, E = (C + conj(Cm)) / 2, O = w_inv (C - conj(Cm)) / 2, over
//      the first Nh columns only: Z is written (d0, d1, d2, Nh) contiguous, the
//      input of the half-length complex ifftn that finishes the C2R inverse.
//
// Replaces the TPU kernel repro/kernels/rfft/kernel.py:_rfft_fwd_epilogue_kernel
// (rfft_fwd_epilogue_pallas).
//
// Bound by bytes: per component it reads X (8 B) and writes the clipped
// spectrum, the displacement and Z (8 B each); a pointwise Delta adds 4 B.
// The mirror read X[j] touches the same array in the reversed order, which the
// L2 cache mostly serves.  Design: the TPU wrapper materialises the mirrored
// spectrum, the mirrored bound, two full twiddle planes and an int32 weight
// plane (five extra field-sized reads); here the mirror index is computed per
// element, the twiddle is a length-(Nh + 1) vector and the pair weight comes
// from the column index.  The twiddle products are written with _rn
// intrinsics so no multiply-add is contracted: the result is bitwise equal to
// the plain PyTorch twin, which rounds after every operation.
//
// Per-pencil mode (rfft_fwd_epilogue_rows_launch; the batched pencil loop, a
// vmap of the TPU kernel over rows): X holds rows independent half-spectra of
// h components (one 1-D rfft per row), the Hermitian mirror stays inside the
// row (the leading axis is a batch, not a frequency axis), Delta is a scalar
// or one value per row, and the count is one int32 per row.  One block per
// row: the row's bound sits in a register and its count is reduced per block
// and added to viol[row] once.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned mirror(unsigned r, unsigned d) { return r ? d - r : 0u; }

template <bool kPointwise>
__global__ void rfft_fwd_epilogue_kernel(
    const float2* __restrict__ X, const float* __restrict__ dgrid, float d_scalar,
    const float2* __restrict__ w_inv, float tol1, float slack, int weighted, long long d0,
    long long d1, long long d2, long long h, float2* __restrict__ clipped,
    float2* __restrict__ edit, float2* __restrict__ Z, int* __restrict__ viol) {
  const long long n = d0 * d1 * d2 * h;
  const unsigned u0 = (unsigned)d0, u1 = (unsigned)d1, u2 = (unsigned)d2, uh = (unsigned)h;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int count = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    // 32-bit index arithmetic (the wrapper keeps n below 2^31): 64-bit
    // division is emulated and would cost more than the memory traffic
    const unsigned k = (unsigned)i % uh;
    const unsigned r = (unsigned)i / uh;
    const float2 x = X[i];
    const float d = kPointwise ? dgrid[i] : d_scalar;
    const float cr = repro_torch::clip_bound(x.x, d);
    const float ci = repro_torch::clip_bound(x.y, d);
    clipped[i] = make_float2(cr, ci);
    edit[i] = make_float2(__fsub_rn(cr, x.x), __fsub_rn(ci, x.y));
    const float t = repro_torch::check_threshold(d, tol1, slack);
    if (fabsf(x.x) > t || fabsf(x.y) > t)
      count += weighted ? repro_torch::pair_weight(k, uh, 1) : 1;
    if (k + 1u < uh) {
      const unsigned r2 = r % u2;
      const unsigned r1 = (r / u2) % u1;
      const unsigned r0 = r / (u1 * u2);
      const unsigned mr = (mirror(r0, u0) * u1 + mirror(r1, u1)) * u2 + mirror(r2, u2);
      const unsigned j = mr * uh + (uh - 1u - k);
      const float2 xm = X[j];
      const float dm = kPointwise ? dgrid[j] : d_scalar;
      const float cmr = repro_torch::clip_bound(xm.x, dm);
      const float cmi = repro_torch::clip_bound(xm.y, dm);
      const float2 w = w_inv[k];
      const float er = __fmul_rn(0.5f, __fadd_rn(cr, cmr));
      const float ei = __fmul_rn(0.5f, __fsub_rn(ci, cmi));
      const float tr = __fsub_rn(cr, cmr);
      const float ti = __fadd_rn(ci, cmi);
      const float o_r = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(w.x, tr), __fmul_rn(w.y, ti)));
      const float o_i = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(w.x, ti), __fmul_rn(w.y, tr)));
      Z[(long long)r * (uh - 1u) + k] = make_float2(__fsub_rn(er, o_i), __fadd_rn(ei, o_r));
    }
  }
  repro_torch::block_count_add(count, viol);
}

// The twiddle step of one output column k < h - 1, bitwise as above.
__device__ __forceinline__ float2 pack_twiddle(float cr, float ci, float cmr, float cmi, float2 w) {
  const float er = __fmul_rn(0.5f, __fadd_rn(cr, cmr));
  const float ei = __fmul_rn(0.5f, __fsub_rn(ci, cmi));
  const float tr = __fsub_rn(cr, cmr);
  const float ti = __fadd_rn(ci, cmi);
  const float o_r = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(w.x, tr), __fmul_rn(w.y, ti)));
  const float o_i = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(w.x, ti), __fmul_rn(w.y, tr)));
  return make_float2(__fsub_rn(er, o_i), __fadd_rn(ei, o_r));
}

template <bool kRowVec>
__global__ void rfft_fwd_epilogue_rows_kernel(
    const float2* __restrict__ X, const float* __restrict__ dvec, float d_scalar,
    const float2* __restrict__ w_inv, float tol1, float slack, int weighted, unsigned h,
    float2* __restrict__ clipped, float2* __restrict__ edit, float2* __restrict__ Z,
    int* __restrict__ viol) {
  const unsigned row = blockIdx.x;
  const long long base = (long long)row * h;
  const float d = kRowVec ? dvec[row] : d_scalar;  // the mirror's bound too
  const float t = repro_torch::check_threshold(d, tol1, slack);
  int count = 0;
  for (unsigned k = threadIdx.x; k < h; k += blockDim.x) {
    const float2 x = X[base + k];
    const float cr = repro_torch::clip_bound(x.x, d);
    const float ci = repro_torch::clip_bound(x.y, d);
    clipped[base + k] = make_float2(cr, ci);
    edit[base + k] = make_float2(__fsub_rn(cr, x.x), __fsub_rn(ci, x.y));
    if (fabsf(x.x) > t || fabsf(x.y) > t)
      count += weighted ? repro_torch::pair_weight(k, h, 1) : 1;
    if (k + 1u < h) {
      const float2 xm = X[base + (h - 1u - k)];
      const float cmr = repro_torch::clip_bound(xm.x, d);
      const float cmi = repro_torch::clip_bound(xm.y, d);
      Z[(long long)row * (h - 1u) + k] = pack_twiddle(cr, ci, cmr, cmi, w_inv[k]);
    }
  }
  repro_torch::block_count_add(count, viol + row);
}

}  // namespace

// Per-pencil mode: X holds rows x h components (h = N/2 + 1, N even), Z
// rows x (h - 1); dvec holds rows bounds when row_vec, else d_scalar bounds
// every row; viol points at rows zeroed int32 counts.
extern "C" int rfft_fwd_epilogue_rows_launch(const void* X, const void* dvec, float d_scalar,
                                             int row_vec, const void* w_inv, float tol1,
                                             float slack, int weighted, long long rows,
                                             long long h, void* clipped, void* edit, void* Z,
                                             void* viol, void* stream) {
  if (rows <= 0 || h <= 0) return (int)cudaSuccess;
  const unsigned threads = repro_torch::row_threads(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (row_vec) {
    rfft_fwd_epilogue_rows_kernel<true><<<(unsigned)rows, threads, 0, s>>>(
        (const float2*)X, (const float*)dvec, d_scalar, (const float2*)w_inv, tol1, slack,
        weighted, (unsigned)h, (float2*)clipped, (float2*)edit, (float2*)Z, (int*)viol);
  } else {
    rfft_fwd_epilogue_rows_kernel<false><<<(unsigned)rows, threads, 0, s>>>(
        (const float2*)X, nullptr, d_scalar, (const float2*)w_inv, tol1, slack, weighted,
        (unsigned)h, (float2*)clipped, (float2*)edit, (float2*)Z, (int*)viol);
  }
  return (int)cudaGetLastError();
}

// viol must point at a zeroed int32.  Leading extents d0, d1, d2 (1 for
// absent axes) and h = N/2 + 1 describe X; w_inv holds Nh + 1 complex64
// twiddles; Z holds d0 * d1 * d2 * (h - 1) complex64.
extern "C" int rfft_fwd_epilogue_launch(const void* X, const void* dgrid, float d_scalar,
                                        int pointwise, const void* w_inv, float tol1,
                                        float slack, int weighted, long long d0, long long d1,
                                        long long d2, long long h, void* clipped, void* edit,
                                        void* Z, void* viol, void* stream) {
  const long long n = d0 * d1 * d2 * h;
  if (n <= 0) return (int)cudaSuccess;
  const unsigned grid = repro_torch::grid_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (pointwise) {
    rfft_fwd_epilogue_kernel<true><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float2*)X, (const float*)dgrid, d_scalar, (const float2*)w_inv, tol1, slack,
        weighted, d0, d1, d2, h, (float2*)clipped, (float2*)edit, (float2*)Z, (int*)viol);
  } else {
    rfft_fwd_epilogue_kernel<false><<<grid, repro_torch::kThreads, 0, s>>>(
        (const float2*)X, nullptr, d_scalar, (const float2*)w_inv, tol1, slack, weighted, d0,
        d1, d2, h, (float2*)clipped, (float2*)edit, (float2*)Z, (int*)viol);
  }
  return (int)cudaGetLastError();
}
