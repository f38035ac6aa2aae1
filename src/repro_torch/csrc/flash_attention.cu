// Causal GQA flash-attention forward: o = softmax(q k^T * scale + mask) v,
// with the online softmax of FlashAttention.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_flash_kernel
// (flash_attention_pallas, wrapper flash_attention/ops.py::flash_attention).
//
// Shapes: q (b, hq, sq, D), k and v (b, hkv, sk, D), out like q; all
// contiguous, D in {64, 112, 128} (112 is zamba2-7b's head dim).  Query head h reads kv head h / group (GQA by
// index: K/V are never repeated).  Suffix causality: query row i sits at kv
// position (sk - sq) + i and sees kv columns 0 .. (sk - sq) + i.  A kv tile
// that lies wholly after a query tile's last real row is never loaded (the
// reference's block-level causal skip), and blocks start with the latest
// query tiles, which have the most kv tiles to visit.
//
// What bounds it: operations, 4*D multiply-adds per visible (query, key)
// pair against 2 or 4 bytes per element of q, k, v and out; at
// (4, 14, 2048, 64) that is 30 GFLOP against 34 MB (bf16).
//
// Each dtype has its own kernel, chosen by the launcher:
//
// float32 -- flash_fwd_kernel, IEEE float32 FMAs on the CUDA cores.  One
// thread block of 16 x 16 threads per (64-row query tile, q head, batch).
// The query tile and each 64-row K/V tile are staged through shared memory
// with a padded row stride (D + 1: the threads of a warp read 16 different
// rows of K in one instruction, which an unpadded stride would put in one
// bank).  Each thread owns a 4 x 4 block of the score tile (rows ty + 16i,
// columns tx + 16j) and the matching 4 x D/16 block of the accumulator; the
// running max m and normaliser l of a row are replicated over the 16 threads
// that share it and reduced with half-warp shuffles.  P goes through shared
// memory for the second product.  Ragged sq and sk are masked by bounds
// checks: rows past sq are neither loaded nor stored, columns past sk score
// -1e30.
//
// bfloat16 -- flash_fwd_sm90, on the tensor cores (wgmma) fed by TMA; see
// its own note below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // kv rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v alike");

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---- bfloat16: wgmma fed by TMA ----------------------------------------------
//
// The reference computes both products on float32 inputs with float32
// accumulation (the TPU's MXU); here the tensor cores play that role.
// bf16 x bf16 products are exact in float32, so S = Q K^T differs from the
// float32 twin's only in summation order.  P is float32 after the softmax; it
// is split as P_hi = bf16(p), P_lo = bf16(p - P_hi) and both halves go
// through the second product into the same accumulator, which keeps about 16
// mantissa bits of P for 1.5x the tensor-core work (a single bf16 P would
// move outputs by up to 2^-9 of |v|, beyond the one-ulp bar).
//
// One CTA of three warpgroups per (128-row query tile, q head, batch):
//   warpgroup 0, the producer: one thread issues every TMA load -- the query
//     tile once, then K and V tiles of kBKV rows into a ring of kStages stages
//     with full (K and V apart) and empty mbarriers -- and keeps the next
//     tiles in flight while the consumers compute (setmaxnreg: 24 registers);
//   warpgroups 1 and 2, the consumers: 64 query rows each (setmaxnreg: 240).
//     Per K/V tile: S = Q K^T by wgmma (both K-major in shared memory),
//     the online softmax in the accumulator's register layout (a thread holds
//     parts of rows 16w + lane/4 and +8; a row is reduced over the 4 lanes
//     of a quad), then O += P V by wgmma with P from registers (the S
//     fragment packed as bf16 pairs is the A-operand fragment) and V
//     MN-major in shared memory.  Scores are scaled by scale * log2(e) and
//     exponentiated by ex2.approx.ftz (2 ulp; an exponent that would give a
//     subnormal p gives 0).  The element mask runs only on tiles that cross
//     the diagonal or the ragged sk edge.
// The tensor maps are 3-D, (D, s, b*h), with boxes of (64, rows, 1) and the
// 128-byte swizzle (so D = 128 takes two boxes per row block): rows past sq or
// sk come in as zeros instead of the next head's rows.  A D that is not a
// multiple of 64 (112) is laid out in shared memory at the padded width DP
// (128): the second box's columns past D lie outside the tensor map and TMA
// fills them with zeros, so Q K^T takes D / 16 steps over real columns only
// and O = P V runs at width DP with its last DP - D columns zero, never
// stored.  The output is stored from registers as bf16 pairs, rows past sq
// masked.
namespace sm90_bf16 {

using namespace repro_torch::sm90;

constexpr int kBQ = 128;       // query rows per CTA: two consumer warpgroups of 64
// kv rows per K/V tile at D = 64 and D = 128: at D = 128 the Q tile and a
// 2-stage K/V ring take 160 KB of shared memory and ptxas spills nothing;
// 64-row tiles were no faster at either D
constexpr int kBKV = 128;
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kRowBytes = 128;  // one swizzled row of a 64-column box

template <int D>
struct Smem {
  // D rounded up to whole 64-column boxes: the width of every tile in
  // shared memory and of the P V product
  static constexpr int kDP = (D + 63) / 64 * 64;
  static constexpr int kBoxes = kDP / 64;  // 64-column boxes per row block
  static constexpr uint32_t kQ = kBQ * kDP * 2;
  static constexpr uint32_t kKV = kBKV * kDP * 2;  // one K or one V tile
  static constexpr uint32_t kBars = 8 * (1 + 3 * kStages);
  // + 1024: the dynamic base is rounded up to the swizzle atom
  static constexpr size_t kBytes = kQ + 2 * kStages * kKV + kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int hq,
               int hkv, int sq, int sk, float scale_log2, int causal) {
  using S = Smem<D>;
  constexpr int DP = S::kDP;
  static_assert(D % 16 == 0, "a wgmma k-step is 16 columns");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + S::kQ, s_v = s_k + kStages * S::kKV;
  const uint32_t bars = s_v + kStages * S::kKV;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;
  int n_tiles = (sk + kBKV - 1) / kBKV;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, sq) - 1 + offset) / kBKV + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int q_head = b * hq + h, kv_head = b * hkv + hk;
      mbar_expect_tx(q_full, S::kQ);
      for (int x = 0; x < S::kBoxes; ++x)
        tma_load_3d(s_q + x * kBQ * kRowBytes, &tq, q_full, 64 * x, q0, q_head);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(k_full(s), S::kKV);
        for (int x = 0; x < S::kBoxes; ++x)
          tma_load_3d(s_k + s * S::kKV + x * kBKV * kRowBytes, &tk, k_full(s), 64 * x, t * kBKV,
                      kv_head);
        mbar_expect_tx(v_full(s), S::kKV);
        for (int x = 0; x < S::kBoxes; ++x)
          tma_load_3d(s_v + s * S::kKV + x * kBKV * kRowBytes, &tv, v_full(s), 64 * x, t * kBKV,
                      kv_head);
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128, warp = (ct / 32) % 4, lane = ct % 32;
    const int quad = lane % 4;
    const int r0 = 64 * wg + 16 * warp + lane / 4;  // tile row of this thread's first half
    const int qpos0 = q0 + r0 + offset, qpos1 = qpos0 + 8;  // kv positions of its rows
    const int wg_first = q0 + 64 * wg + offset;  // kv position of the warpgroup's first row

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    const uint32_t s_qw = s_q + wg * 64 * kRowBytes;  // this warpgroup's 64 rows of each box
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int k0 = t * kBKV;
      const uint32_t s_kt = s_k + s * S::kKV, s_vt = s_v + s * S::kKV;

      // S = Q K^T over the D real columns in steps of 16: box kk / 4, 32
      // bytes a step inside it
      float sc[kBKV / 2];
      mbar_wait(k_full(s), parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        wgmma_ss<kBKV>(sc, desc_sw128(s_qw + (kk / 4) * kBQ * kRowBytes + step, 16, 1024),
                       desc_sw128(s_kt + (kk / 4) * kBKV * kRowBytes + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in the log2 domain; element (i) of sc sits at row
      // r0 (+8 when i & 2), column k0 + 8 * (i / 4) + 2 * quad + (i & 1)
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) sc[i] *= scale_log2;
      if (k0 + kBKV > sk || (causal && k0 + kBKV - 1 > wg_first)) {
#pragma unroll
        for (int i = 0; i < kBKV / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
          if (col >= sk || (causal && col > ((i & 2) ? qpos1 : qpos0))) sc[i] = -INFINITY;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kBKV / 2; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // a row with nothing seen yet keeps m = -inf; subtract 0 so p = 0, not NaN
      const float ref0 = mx0 == -INFINITY ? 0.0f : mx0, ref1 = mx1 == -INFINITY ? 0.0f : mx1;
      const float corr0 = ex2_approx(m0 - ref0), corr1 = ex2_approx(m1 - ref1);
      m0 = mx0;
      m1 = mx1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int i = 0; i < DP / 2; i += 4) {
        o[i] *= corr0;
        o[i + 1] *= corr0;
        o[i + 2] *= corr1;
        o[i + 3] *= corr1;
      }
      // p in float32 for l; P_hi and P_lo as the A fragments of the second
      // product, one k-step of 16 columns each: pairs (8kk + 2r, 8kk + 2r + 1)
      uint32_t p_hi[kBKV / 16][4], p_lo[kBKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float ref = (r & 1) ? ref1 : ref0;
          const float pa = ex2_approx(sc[i] - ref), pb = ex2_approx(sc[i + 1] - ref);
          if (r & 1) l1 += pa + pb; else l0 += pa + pb;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(pa - __low2float(hi), pb - __high2float(hi));
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      }

      // O += P V over the tile's kv rows in steps of 16 (two 8-row atoms)
      mbar_wait(v_full(s), parity);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        const uint64_t dv = desc_sw128(s_vt + kk * 16 * kRowBytes, kBKV * kRowBytes, 1024);
        wgmma_rs<DP>(o, p_hi[kk], dv, 1);
        wgmma_rs<DP>(o, p_lo[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: the quad's partial row sums, then O / l as bf16 pairs over
    // the D real columns
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int row0 = q0 + r0, row1 = row0 + 8;
    __nv_bfloat16* op = out + ((size_t)(b * hq + h) * sq) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row0 * D + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (row1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row1 * D + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (heads, rows, D) bf16 array as a 3-D map with (64, box_rows, 1) boxes;
// a box's columns at or past d read as zeros.
CUresult encode(PFN_cuTensorMapEncodeTiled_v12000 fn, CUtensorMap* map, const void* ptr,
                int heads, int rows, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Returns a cudaError_t, or -CUresult when a tensor map does not encode.
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int sq, int sk, float scale, int causal, cudaStream_t stream) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(fn, &tq, q, b * hq, sq, D, kBQ);
  if (r == CUDA_SUCCESS) r = encode(fn, &tk, k, b * hkv, sk, D, kBKV);
  if (r == CUDA_SUCCESS) r = encode(fn, &tv, v, b * hkv, sk, D, kBKV);
  if (r != CUDA_SUCCESS) return -(int)r;
  constexpr size_t bytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_sm90<D><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, (__nv_bfloat16*)out, hq, hkv,
                                                       sq, sk, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

}  // namespace sm90_bf16

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: 64, 112 or 128.  Returns a cudaError_t,
// or -CUresult when a bf16 operand's TMA tensor map does not encode.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int hq, int hkv, int sq, int sk, int d, int dtype,
                                      float scale, int causal, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || sk <= 0 || (causal && sq > sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // d = 16: the smoke configs' head dim (one 16-column slice a thread)
  if (dtype == 0 && d == 16) return launch<float, 16>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 0 && d == 112) return launch<float, 112>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 64)
    return sm90_bf16::launch<64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 112)
    return sm90_bf16::launch<112>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 128)
    return sm90_bf16::launch<128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
