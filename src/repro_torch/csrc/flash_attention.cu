// Causal GQA flash-attention forward: o = softmax(q k^T * scale + mask) v,
// with the online softmax of FlashAttention.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_flash_kernel
// (flash_attention_pallas, wrapper flash_attention/ops.py::flash_attention).
//
// Shapes: q (b, hq, sq, D), k and v (b, hkv, sk, D), out like q; all
// contiguous.  Query head h reads kv head h / group (GQA by index: K/V are
// never repeated).  Suffix causality: query row i sits at kv position
// (sk - sq) + i and sees kv columns 0 .. (sk - sq) + i.  A kv tile that lies
// wholly after a query tile's last real row is never loaded (the
// reference's block-level causal skip), and blocks start with the latest
// query tiles, which have the most kv tiles to visit.
//
// What bounds it: operations, 4*D multiply-adds per visible (query, key)
// pair against 2 or 4 bytes per element of q, k, v and out; at
// (4, 14, 2048, 64) that is 30 GFLOP against 34 MB (bf16).
//
// Both dtypes run on the tensor cores (wgmma) fed by TMA, one kernel each,
// chosen by the launcher: bfloat16 is flash_fwd_sm90 (D in {64, 112, 128}),
// float32 is flash_fwd_split_tf32 (D in {16, 64, 112, 128}); see their notes
// below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace repro_torch::sm90;

constexpr int kRowBytes = 128;  // one swizzled row of a box: 64 bf16 or 32 float32 values

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

// A (heads, rows, cols) array of bf16 (elem 2) or float32 (elem 4) as a 3-D
// map with boxes of one 128-byte swizzled row (64 or 32 values) by
// box_rows; a box's elements outside the array read as zeros.
CUresult encode(PFN_cuTensorMapEncodeTiled_v12000 fn, CUtensorMap* map, const void* ptr, int heads,
                int rows, int cols, int box_rows, int elem) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(kRowBytes / elem), (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

constexpr int kBQ = 128;       // query rows per CTA: two consumer warpgroups of 64
// kv rows per K/V tile at D = 64 and D = 128: at D = 128 the Q tile and a
// 2-stage K/V ring take 160 KB of shared memory and ptxas spills nothing;
// 64-row tiles were no faster at either D
constexpr int kBKV = 128;
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;

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

// Returns a cudaError_t, or -CUresult when a tensor map does not encode.
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int sq, int sk, float scale, int causal, cudaStream_t stream) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(fn, &tq, q, b * hq, sq, D, kBQ, 2);
  if (r == CUDA_SUCCESS) r = encode(fn, &tk, k, b * hkv, sk, D, kBKV, 2);
  if (r == CUDA_SUCCESS) r = encode(fn, &tv, v, b * hkv, sk, D, kBKV, 2);
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

// ---- float32: split TF32 on wgmma, fed by TMA ---------------------------------
//
// The reference computes both products in float32.  TF32 keeps 10 mantissa
// bits, so each float32 operand is split as x = hi + lo, hi = tf32_rna(x),
// lo = tf32_rna(x - hi) (x - hi is exact), and every product is summed as
// hi*hi + hi*lo + lo*hi in one float32 accumulator ("3xTF32").  hi*hi is
// exact in float32; the dropped lo*lo and the rounding of lo leave about
// 2^-21 of |x y| per product: float32 accuracy on the tensor cores at a
// third of their TF32 rate (495 / 3 TFLOP/s against the CUDA cores' 67).
//
// Operand layouts.  TF32 wgmma takes K-major operands only.  Q and K are
// K-major as stored (rows of D); V is MN-major for O = P V.  So a prologue
// kernel (flash_split_tf32_prologue) writes, into scratch the wrapper
// allocates, q and k split into hi and lo at a row width DP = D rounded up
// to 32 (zeros past D), and v transposed to (b, hkv, D, skp), split too, with
// skp = sk rounded up to 8 (zeros past sk).  The transposed V also permutes
// each group of 8 kv positions as 0 2 4 6 1 3 5 7: the wgmma A fragment
// from registers wants (row g, k t) and (g, t + 4), while the S accumulator
// holds columns 2t and 2t + 1 of each 8-column block, so P's fragment is
// read straight from the accumulator with the k index permuted, and V^T's
// columns are permuted alike (a sum over k does not care about its order).
// That extra traffic is about twice the inputs, one pass.
//
// One CTA per (kBQ-row query tile, q head, batch): warpgroup 0 is the
// producer (one thread issues every TMA load: the Q tile's hi and lo once,
// then K hi/lo and V^T hi/lo tiles of kBKV kv rows into a ring of kStages
// stages with full and empty mbarriers, as the bf16 kernel); the kWG
// consumer warpgroups own 64 query rows each.  Per K/V tile a consumer
// issues S = Q K^T as 3 D / 8 wgmmas (k-steps of 8 columns; lo*hi, hi*lo,
// hi*hi), runs the online softmax in the accumulator layout (log2 domain,
// ex2.approx.ftz, the element mask only on tiles that cross the diagonal or
// the ragged sk edge), splits P into hi and lo in registers and issues the
// tile's P V^T as 3 kBKV / 8 wgmmas a column chunk of at most 64 (D = 112:
// 64 + 48) with P from registers, each chunk into a fresh accumulator that
// is then added to O (pv_chunk: why).  Q, K and V^T
// tiles are boxes of 32 float32 columns (one 128-byte swizzled row).
//
// Shared memory: 2 kBQ DP 4 bytes of Q, and a ring stage of 2 (kBKV DP +
// D kBKV) 4 bytes.  Tiles, by head dim (ptxas spills nothing at any):
//   D = 16:  kWG 2 (kBQ 128), kBKV 64, 2 stages:  80 KB
//   D = 64:  kWG 2 (kBQ 128), kBKV 64, 2 stages: 192 KB
//   D = 112: kWG 1 (kBQ 64),  kBKV 32, 2 stages: 184 KB (DP 128)
//   D = 128: kWG 1 (kBQ 64),  kBKV 32, 2 stages: 192 KB
// At D >= 112 the Q tile's hi and lo for 128 rows would leave no room for a
// two-stage ring, so one consumer warpgroup takes 64 rows.
namespace sm90_f32 {

template <int D>
struct Tiles;
template <>
struct Tiles<16> { static constexpr int kWG = 2, kBKV = 64, kStages = 2; };
template <>
struct Tiles<64> { static constexpr int kWG = 2, kBKV = 64, kStages = 2; };
template <>
struct Tiles<112> { static constexpr int kWG = 1, kBKV = 32, kStages = 2; };
template <>
struct Tiles<128> { static constexpr int kWG = 1, kBKV = 32, kStages = 2; };

template <int D>
struct Layout {
  static constexpr int kWG = Tiles<D>::kWG, kBKV = Tiles<D>::kBKV, kStages = Tiles<D>::kStages;
  static constexpr int kBQ = 64 * kWG;
  static constexpr int kThreads = 128 * (1 + kWG);
  static constexpr int kDP = (D + 31) / 32 * 32;  // q and k row width in scratch and shared memory
  static constexpr uint32_t kQ = kBQ * kDP * 4;   // the query tile's hi (or lo) half
  static constexpr uint32_t kK = kBKV * kDP * 4;  // a K tile's half
  static constexpr uint32_t kV = D * kBKV * 4;    // a V^T tile's half
  static constexpr uint32_t kStage = 2 * (kK + kV);
  static constexpr uint32_t kBars = 8 * (1 + 3 * kStages);
  // + 1024: the dynamic base is rounded up to the swizzle atom
  static constexpr size_t kBytes = 2 * kQ + kStages * kStage + kBars + 1024;
  static_assert(D % 16 == 0 && kBKV % 32 == 0, "k-steps of 8, boxes of 32 columns");
  static_assert(kK % 1024 == 0 && kV % 1024 == 0, "every box starts on a swizzle atom");
};

// Scratch floats for one call: q and k split at width DP, v transposed and split.
template <int D>
long long scratch_floats(int b, int hq, int hkv, int sq, int sk) {
  const long long skp = (sk + 7) / 8 * 8;
  return 2 * ((long long)b * hq * sq * Layout<D>::kDP + (long long)b * hkv * sk * Layout<D>::kDP +
              (long long)b * hkv * D * skp);
}

constexpr int kChunk = 4096;  // split values a prologue block writes (q and k parts)

// x into hi and lo TF32 halves at dst[i] and dst[half + i]
__device__ __forceinline__ void split_store(float* dst, long long half, long long i, float x) {
  const float hi = __uint_as_float(tf32_rna(x));
  dst[i] = hi;
  dst[half + i] = __uint_as_float(tf32_rna(x - hi));
}

// The prologue: blocks [0, nbq) split q's rows, [nbq, nbq + nbk) k's, the
// rest transpose and split 32 x 32 tiles of v (blockDim 32 x 8).
template <int D>
__global__ void __launch_bounds__(256)
flash_split_tf32_prologue(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ q2, float* __restrict__ k2,
                          float* __restrict__ v2, long long q_rows, long long k_rows, int kv_heads,
                          int sk, int skp, int nbq, int nbk) {
  constexpr int DP = Layout<D>::kDP;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  int blk = blockIdx.x;
  if (blk < nbq + nbk) {
    const bool is_q = blk < nbq;
    const float* src = is_q ? q : k;
    float* dst = is_q ? q2 : k2;
    const long long half = (is_q ? q_rows : k_rows) * DP;
    const long long i0 = (long long)(is_q ? blk : blk - nbq) * kChunk;
    for (int e = tid; e < kChunk; e += 256) {
      const long long i = i0 + e;
      if (i >= half) break;
      const long long r = i / DP;  // DP is a power of two
      const int c = (int)(i - r * DP);
      split_store(dst, half, i, c < D ? src[r * D + c] : 0.0f);
    }
    return;
  }
  // v tile: kv positions j0 .. j0 + 31 of head h, columns c0 .. c0 + 31
  __shared__ float tile[32][33];
  blk -= nbq + nbk;
  constexpr int n_c = (D + 31) / 32;
  const int n_j = (skp + 31) / 32;
  const int h = blk / (n_j * n_c), rest = blk % (n_j * n_c);
  const int j0 = (rest / n_c) * 32, c0 = (rest % n_c) * 32;
  const float* vh = v + (long long)h * sk * D;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int row = j0 + r, col = c0 + threadIdx.x;
    tile[r][threadIdx.x] = row < sk && col < D ? vh[(long long)row * D + col] : 0.0f;
  }
  __syncthreads();
  const long long half = (long long)kv_heads * D * skp;
  const int x = threadIdx.x;
  const int from = (x & ~7) | ((x & 3) << 1) | ((x >> 2) & 1);  // 0 2 4 6 1 3 5 7 in each 8
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, j = j0 + x;
    if (c < D && j < skp) split_store(v2, half, ((long long)h * D + c) * skp + j, tile[from][r]);
  }
}

// Columns C0 .. C0 + N of one K/V tile's P V, summed over the tile's kv rows
// in a fresh accumulator and then added to O on the CUDA cores (rounded to
// nearest).  Accumulating O itself on the tensor cores across every kv tile
// loses low bits at each add (their float32 accumulation does not round to
// nearest); over thousands of kv rows, when V has a mean, that bias reached
// 6e-5 of O.  Summed a tile at a time, it stays at the tile's few adds.
template <int D, int kBKV, int C0, int N>
__device__ __forceinline__ void pv_chunk(float (&o)[D / 2], const uint32_t (&p_hi)[kBKV / 8][4],
                                         const uint32_t (&p_lo)[kBKV / 8][4], uint32_t v_hi, uint32_t v_lo) {
  float t[N / 2];
  fence_regs(t);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBKV / 8; ++kk) {
    const uint32_t ov = (kk / 4) * D * kRowBytes + (kk % 4) * 32 + C0 * kRowBytes;
    const uint64_t vh = desc_sw128(v_hi + ov, 16, 1024), vl = desc_sw128(v_lo + ov, 16, 1024);
    wgmma_rs_tf32<N>(t, p_lo[kk], vh, kk > 0);
    wgmma_rs_tf32<N>(t, p_hi[kk], vl, 1);
    wgmma_rs_tf32<N>(t, p_hi[kk], vh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[C0 / 2 + i] += t[i];
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_fwd_split_tf32(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, float* __restrict__ out, int b, int hq,
                     int hkv, int sq, int sk, float scale_log2, int causal) {
  using L = Layout<D>;
  constexpr int kWG = L::kWG, kBQ = L::kBQ, kBKV = L::kBKV, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // hi, then lo
  const uint32_t s_ring = s_q + 2 * L::kQ;
  const uint32_t bars = s_ring + kStages * L::kStage;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  // a stage: K hi, K lo, V^T hi, V^T lo
  auto k_tile = [&](int s, int half) { return s_ring + s * L::kStage + half * L::kK; };
  auto v_tile = [&](int s, int half) { return s_ring + s * L::kStage + 2 * L::kK + half * L::kV; };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest query tiles first
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;
  int n_tiles = (sk + kBKV - 1) / kBKV;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, sq) - 1 + offset) / kBKV + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    if constexpr (kWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // lo halves sit b * h heads after the hi halves
      const int q_head = bb * hq + h, kv_head = bb * hkv + hk;
      mbar_expect_tx(q_full, 2 * L::kQ);
      for (int half = 0; half < 2; ++half)
        for (int x = 0; x < L::kDP / 32; ++x)
          for (int w = 0; w < kWG; ++w)
            tma_load_3d(s_q + half * L::kQ + (x * kBQ + 64 * w) * kRowBytes, &tq, q_full, 32 * x,
                        q0 + 64 * w, q_head + half * b * hq);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(k_full(s), 2 * L::kK);
        for (int half = 0; half < 2; ++half)
          for (int x = 0; x < L::kDP / 32; ++x)
            tma_load_3d(k_tile(s, half) + x * kBKV * kRowBytes, &tk, k_full(s), 32 * x, t * kBKV,
                        kv_head + half * b * hkv);
        mbar_expect_tx(v_full(s), 2 * L::kV);
        for (int half = 0; half < 2; ++half)
          for (int x = 0; x < kBKV / 32; ++x)
            tma_load_3d(v_tile(s, half) + x * D * kRowBytes, &tv, v_full(s), t * kBKV + 32 * x, 0,
                        kv_head + half * b * hkv);
      }
    }
  } else {
    // ---- consumers ----
    if constexpr (kWG == 2) setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128, warp = (ct / 32) % 4, lane = ct % 32;
    const int quad = lane % 4;
    const int r0 = 64 * wg + 16 * warp + lane / 4;  // tile row of this thread's first half
    const int qpos0 = q0 + r0 + offset, qpos1 = qpos0 + 8;  // kv positions of its rows
    const int wg_first = q0 + 64 * wg + offset;  // kv position of the warpgroup's first row

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    const uint32_t s_qw = s_q + wg * 64 * kRowBytes;  // this warpgroup's 64 rows of each box
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int k0 = t * kBKV;

      // S = Q K^T over the D real columns in k-steps of 8: box kk / 4, 32
      // bytes a step inside it
      float sc[kBKV / 2];
      mbar_wait(k_full(s), parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t oq = (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32;
        const uint32_t ok = (kk / 4) * kBKV * kRowBytes + (kk % 4) * 32;
        const uint64_t qh = desc_sw128(s_qw + oq, 16, 1024), ql = desc_sw128(s_qw + L::kQ + oq, 16, 1024);
        const uint64_t kh = desc_sw128(k_tile(s, 0) + ok, 16, 1024);
        const uint64_t kl = desc_sw128(k_tile(s, 1) + ok, 16, 1024);
        wgmma_ss_tf32<kBKV>(sc, ql, kh, kk > 0);
        wgmma_ss_tf32<kBKV>(sc, qh, kl, 1);
        wgmma_ss_tf32<kBKV>(sc, qh, kh, 1);
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
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= corr0;
        o[i + 1] *= corr0;
        o[i + 2] *= corr1;
        o[i + 3] *= corr1;
      }
      // P's A fragments, one k-step of 8 kv positions each: the thread holds
      // columns 2 quad and 2 quad + 1 of rows r0 and r0 + 8, which V^T's
      // permutation places at k = quad and quad + 4
      uint32_t p_hi[kBKV / 8][4], p_lo[kBKV / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBKV / 8; ++kk) {
        const float p[4] = {ex2_approx(sc[4 * kk] - ref0), ex2_approx(sc[4 * kk + 2] - ref1),
                            ex2_approx(sc[4 * kk + 1] - ref0), ex2_approx(sc[4 * kk + 3] - ref1)};
        l0 += p[0] + p[2];
        l1 += p[1] + p[3];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p_hi[kk][r] = tf32_rna(p[r]);
          p_lo[kk][r] = tf32_rna(p[r] - __uint_as_float(p_hi[kk][r]));
        }
      }

      // O += P V over the tile's kv rows in k-steps of 8, in column chunks
      // of at most 64 (the chunk's fresh accumulator: pv_chunk)
      mbar_wait(v_full(s), parity);
      if constexpr (D <= 64) {
        pv_chunk<D, kBKV, 0, D>(o, p_hi, p_lo, v_tile(s, 0), v_tile(s, 1));
      } else {
        pv_chunk<D, kBKV, 0, 64>(o, p_hi, p_lo, v_tile(s, 0), v_tile(s, 1));
        pv_chunk<D, kBKV, 64, D - 64>(o, p_hi, p_lo, v_tile(s, 0), v_tile(s, 1));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: the quad's partial row sums, then O / l as float pairs
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int row0 = q0 + r0, row1 = row0 + 8;
    float* op = out + ((size_t)(bb * hq + h) * sq) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row0 < sq)
        *reinterpret_cast<float2*>(op + (size_t)row0 * D + 8 * j) = make_float2(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (row1 < sq)
        *reinterpret_cast<float2*>(op + (size_t)row1 * D + 8 * j) =
            make_float2(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// Returns a cudaError_t, or -CUresult when a tensor map does not encode.
template <int D>
int launch(const float* q, const float* k, const float* v, float* out, float* scratch,
           long long scratch_len, int b, int hq, int hkv, int sq, int sk, float scale, int causal,
           cudaStream_t stream) {
  using L = Layout<D>;
  if (scratch == nullptr || scratch_len < scratch_floats<D>(b, hq, hkv, sq, sk))
    return (int)cudaErrorInvalidValue;
  const int skp = (sk + 7) / 8 * 8;
  const long long q_rows = (long long)b * hq * sq, k_rows = (long long)b * hkv * sk;
  float* q2 = scratch;
  float* k2 = q2 + 2 * q_rows * L::kDP;
  float* v2 = k2 + 2 * k_rows * L::kDP;
  const long long nbq = (q_rows * L::kDP + kChunk - 1) / kChunk;
  const long long nbk = (k_rows * L::kDP + kChunk - 1) / kChunk;
  const long long nbv = (long long)b * hkv * ((skp + 31) / 32) * ((D + 31) / 32);
  if (nbq + nbk + nbv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_split_tf32_prologue<D><<<(unsigned)(nbq + nbk + nbv), dim3(32, 8), 0, stream>>>(
      q, k, v, q2, k2, v2, q_rows, k_rows, b * hkv, sk, skp, (int)nbq, (int)nbk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(fn, &tq, q2, 2 * b * hq, sq, L::kDP, 64, 4);
  if (r == CUDA_SUCCESS) r = encode(fn, &tk, k2, 2 * b * hkv, sk, L::kDP, L::kBKV, 4);
  if (r == CUDA_SUCCESS) r = encode(fn, &tv, v2, 2 * b * hkv, D, skp, D, 4);
  if (r != CUDA_SUCCESS) return -(int)r;
  constexpr size_t bytes = L::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_split_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + L::kBQ - 1) / L::kBQ, hq, b);
  flash_fwd_split_tf32<D><<<grid, L::kThreads, bytes, stream>>>(
      tq, tk, tv, out, b, hq, hkv, sq, sk, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

}  // namespace sm90_f32

}  // namespace

// dtype: 0 = float32 (d: 16, 64, 112 or 128), 1 = bfloat16 (d: 64, 112 or
// 128).  float32 needs `scratch`, a 16-byte aligned device buffer of at least
// flash_attention_scratch_floats(...) floats (bfloat16 takes none: NULL, 0).
// Returns a cudaError_t, or -CUresult when an operand's TMA tensor map does
// not encode.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* scratch, long long scratch_len, int b, int hq, int hkv,
                                      int sq, int sk, int d, int dtype, float scale, int causal,
                                      void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || sk <= 0 || (causal && sq > sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  float *fo = (float*)out, *fs = (float*)scratch;
  // d = 16: the smoke configs' head dim
  if (dtype == 0 && d == 16)
    return sm90_f32::launch<16>(fq, fk, fv, fo, fs, scratch_len, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 0 && d == 64)
    return sm90_f32::launch<64>(fq, fk, fv, fo, fs, scratch_len, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 0 && d == 112)
    return sm90_f32::launch<112>(fq, fk, fv, fo, fs, scratch_len, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 0 && d == 128)
    return sm90_f32::launch<128>(fq, fk, fv, fo, fs, scratch_len, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 64)
    return sm90_bf16::launch<64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 112)
    return sm90_bf16::launch<112>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  if (dtype == 1 && d == 128)
    return sm90_bf16::launch<128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of scratch a float32 call of these shapes needs (0 for bfloat16 or
// a head dim without a kernel).
extern "C" long long flash_attention_scratch_floats(int b, int hq, int hkv, int sq, int sk, int d,
                                                     int dtype) {
  if (dtype != 0) return 0;
  if (d == 16) return sm90_f32::scratch_floats<16>(b, hq, hkv, sq, sk);
  if (d == 64) return sm90_f32::scratch_floats<64>(b, hq, hkv, sq, sk);
  if (d == 112) return sm90_f32::scratch_floats<112>(b, hq, hkv, sq, sk);
  if (d == 128) return sm90_f32::scratch_floats<128>(b, hq, hkv, sq, sk);
  return 0;
}
