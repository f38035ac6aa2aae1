// Causal GQA flash-attention forward: o = softmax(q k^T * scale + mask) v,
// with the online softmax of FlashAttention, in IEEE float32 arithmetic.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_flash_kernel
// (flash_attention_pallas, wrapper flash_attention/ops.py::flash_attention).
//
// Shapes: q (b, hq, sq, D), k and v (b, hkv, sk, D), out like q; all
// contiguous, float32 or bfloat16 (converted to float32 on load; the output
// is rounded to nearest in q's type).  Query head h reads kv head h / group
// (GQA by index: K/V are never repeated).  Suffix causality: query row i sits
// at kv position (sk - sq) + i and sees kv columns 0 .. (sk - sq) + i.
//
// What bounds it: operations.  4*D float32 multiply-adds per visible
// (query, key) pair against 2 bytes (bf16) per element of q, k, v and out;
// at (4, 14, 2048, 64) that is 30 GFLOP against 34 MB.
//
// Design (a first one that is right, not yet fast): one thread block of
// 16 x 16 threads per (64-row query tile, q head, batch).  The query tile and
// each 64-row K/V tile are staged through shared memory as float32 with a
// padded row stride (D + 1: the threads of a warp read 16 different rows of
// K in one instruction, which an unpadded stride would put in one bank).
// Each thread owns a 4 x 4 block of the score tile (rows ty + 16i, columns
// tx + 16j) and the matching 4 x D/16 block of the accumulator; the running
// max m and normaliser l of a row are replicated over the 16 threads that
// share it and reduced with half-warp shuffles.  P goes through shared
// memory for the second product.  The products are float32 FMAs on the CUDA
// cores (no tensor cores, no TF32).  A kv tile that lies wholly after the
// tile's last real query row is never loaded (the reference's block-level
// causal skip), and blocks start with the latest query tiles, which have the
// most kv tiles to visit.  Ragged sq and sk are masked by bounds checks:
// rows past sq are neither loaded nor stored, columns past sk score -1e30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // kv rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v alike");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

// Rows row0 .. row0+63 of a (n_rows, D) matrix into shared memory as float32
// with row stride D + 1; rows at or past n_rows read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = row0 + r < n_rows ? to_f32(src[(row0 + r) * D + c]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int hq, int hkv, int sq, int sk, float scale, int causal) {
  constexpr int LD = D + 1, LP = kBK + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x LD
  float* ks = qs + kBQ * LD;    // kBK x LD
  float* vs = ks + kBK * LD;    // kBK x LD
  float* ps = vs + kBK * LD;    // kBQ x LP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // 32-bit offsets: the wrapper keeps every operand below 2^31 elements
  const T* qp = q + (b * hq + h) * sq * D;
  const T* kp = k + (b * hkv + hk) * sk * D;
  const T* vp = v + (b * hkv + hk) * sk * D;
  T* op = out + (b * hq + h) * sq * D;

  load_tile<T, D>(qs, qp, q0, sq);

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    // the last real query row of this tile sees kv columns up to `last`
    const int last = min(q0 + kBQ, sq) - 1 + offset;
    n_tiles = min(n_tiles, last / kBK + 1);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's P V is done with ks, vs and ps
    load_tile<T, D>(ks, kp, k0, sk);
    load_tile<T, D>(vs, vp, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;  // this row's kv position
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool seen = col < sk && (!causal || col <= qpos);
        s[i][j] = seen ? s[i][j] * scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off, 16));
      const float mn = fmaxf(m[i], mc);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
        ps[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) op[row * D + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int sq, int sk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: 64 or 128.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int hq, int hkv, int sq, int sk, int d, int dtype,
                                      float scale, int causal, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || sk <= 0 || (causal && sq > sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
