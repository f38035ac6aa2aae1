// Blockwise decorrelating transform + quantize (the zfplike base compressor's
// hot loop): codes = int32(rint((blocks @ M^T) / q)) for flattened (nb, B)
// blocks and the (B, B) Kronecker-expanded separable transform M.
//
// Replaces the TPU kernel repro/kernels/block_transform/kernel.py:_bt_kernel
// (block_transform_pallas), whose one MXU GEMM per grid step is fused with the
// quantizer.
//
// Bound: FP32 instruction issue without FMA.  The bar is bitwise equality with
// the twin (kernels/block_transform/ref.py), which rounds every product and
// every sum in the order k = 0 .. B-1 from 0.0f.  So no product may contract
// into an FFMA: each of the 2 nb B^2 flops is one FMUL or FADD, and the floor
// is twice the operations over the FP32 peak (0.256 ms at 262,144 x 128; at
// B = 64 its 0.064 ms lies above the byte bound).  Each SM scheduler issues one
// warp instruction a clock and its FP32 pipe takes one a clock, so every other
// instruction (a shared load, an address, the division) displaces a product.
//
// Design: a SIMT SGEMM held to that order of summation.
// - Register tiles.  Each of 256 threads owns TM x TN outputs in registers,
//   8 x 8 at B = 128 and 8 x 4 below.  Per four k it reads x[r][k..k+3] of its
//   eight rows as float4s (the lanes of a quarter warp share their rows, so
//   the reads broadcast); per k it reads its TN entries of M^T as float4s (at
//   TN = 8 two 4-wide halves B/2 apart, so each read is contiguous across
//   lanes), then issues TM TN __fmul_rn and TM TN __fadd_rn.  That is about
//   one shared load per 32 FP32 instructions, where a thread computing one
//   column made 9 per 16 and was bound by shared memory.  K is never split.
// - Persistent CTAs, as many as fit on each SM (one at B = 128, two below),
//   stage M^T once (read column-wise from L2 so that the shared writes do not
//   conflict on banks), then walk tiles of R rows, tile blockIdx.x + n gridDim.x.
// - A ring of S tile buffers (B = 128: 64 KB of M^T and S = 2 tiles of 64 KB;
//   below: S = 3 tiles of 32 KB).  R rows of blocks are one contiguous span,
//   so one thread fills a stage with a 1-D bulk copy (cp.async.bulk; no tensor
//   map), counted on the stage's mbarrier; the next tiles arrive while the
//   current one is multiplied (a tile loaded by all threads between two
//   barriers is slower: test_block_transform_ring_outruns_a_synchronous_tile_load
//   in tests/test_torch_gpu.py).  A CTA asks for its later stages only once its
//   first tile has landed, so that every CTA's first tile is served first and
//   no SM idles while the card fills all the rings at once.  A tensor map with
//   zero fill would add a host-side descriptor and buy nothing here.  The
//   ragged last tile copies only the rows that exist and masks its stores.
//   The bulk copy wants 16-byte aligned source, destination and size: the
//   sizes are (B >= 16), the wrapper hands over an aligned copy of a
//   misaligned view, and the launcher refuses one.
// - The epilogue divides by q in IEEE (__fdiv_rn; a reciprocal multiply is not
//   bitwise with the twin, which divides by a device tensor), rounds half to
//   even (rintf), saturates the cast (__float2int_rn) and stores int4s.  The
//   division is about a dozen instructions an output (MUFU.RCP, five FFMAs,
//   FCHK and its branch) against 2B for the products: a tenth at B = 64.
// Not the tensor cores: TF32 rounds the inputs to 10 mantissa bits, and 3xTF32
// or wgmma's float32 accumulation sums in the hardware's order, so neither
// gives the twin's IEEE float32 codes.
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

template <int B>
struct Tiling {
  static constexpr int kThreads = 256;
  static constexpr int kTM = 8;                                // rows a thread owns
  static constexpr int kTN = B == 128 ? 8 : 4;                 // columns a thread owns
  static constexpr int kHalf = 4 * B / kTN;                    // between its 4-wide groups
  static constexpr int kCols = B / kTN;                        // threads across the columns
  static constexpr int kRows = kThreads / kCols * kTM;         // R: rows of a tile
  static constexpr int kStages = B == 128 ? 2 : 3;             // S
  static constexpr int kTile = kRows * B;                      // floats of a tile
  static constexpr int kMinBlocks = B == 128 ? 1 : 2;          // CTAs an SM holds
  static constexpr size_t kSmem = sizeof(float) * (size_t)(kStages * kTile + B * B) +
                                  sizeof(uint64_t) * kStages;  // ring, M^T, mbarriers
};

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ int quantize(float acc, float q) {
  return __float2int_rn(rintf(__fdiv_rn(acc, q)));
}

// acc[i][j] = sum over k = 0 .. B-1, in order from 0.0f, of x[i][k] M[j][k]
// for the TM rows at xr (row-major, stride B) and the TN columns of M^T at
// mcol (g * kHalf + c, c < 4): rounded products, rounded sums, no FMA.
template <int B>
__device__ __forceinline__ void multiply_rows(const float* xr, const float* mcol,
                                              float (&acc)[Tiling<B>::kTM][Tiling<B>::kTN]) {
  using T = Tiling<B>;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int k0 = 0; k0 < B; k0 += 4) {
    float4 a[T::kTM];
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) a[i] = *reinterpret_cast<const float4*>(xr + i * B + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float m[T::kTN];
#pragma unroll
      for (int g = 0; g < T::kTN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(mcol + (k0 + kk) * B + g * T::kHalf);
        m[4 * g] = v.x, m[4 * g + 1] = v.y, m[4 * g + 2] = v.z, m[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
        const float xv = lane_of(a[i], kk);
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv, m[j]));
      }
    }
  }
}

// The codes of acc's rows row0 .. row0 + TM - 1 that exist (< nb), as int4s
// at the columns multiply_rows summed (out points at column 4 tc).
template <int B>
__device__ __forceinline__ void store_codes(const float (&acc)[Tiling<B>::kTM][Tiling<B>::kTN],
                                            float q, long long row0, long long nb, int* out) {
  using T = Tiling<B>;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const long long row = row0 + i;
    if (row >= nb) break;
#pragma unroll
    for (int g = 0; g < T::kTN / 4; ++g) {
      const int4 c = make_int4(quantize(acc[i][4 * g], q), quantize(acc[i][4 * g + 1], q),
                               quantize(acc[i][4 * g + 2], q), quantize(acc[i][4 * g + 3], q));
      *reinterpret_cast<int4*>(out + row * B + g * T::kHalf) = c;
    }
  }
}

template <int B>
__global__ void __launch_bounds__(Tiling<B>::kThreads, Tiling<B>::kMinBlocks)
block_transform_kernel(const float* __restrict__ x, const float* __restrict__ mat, float q,
                       long long nb, int* __restrict__ codes) {
  using T = Tiling<B>;
  using namespace repro_torch::sm90;
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                       // S tiles of R rows, row-major
  float* mt = smem + T::kStages * T::kTile;  // mt[k * B + j] = M[j][k]
  uint64_t* full = reinterpret_cast<uint64_t*>(mt + B * B);
  const int tid = threadIdx.x;
  const long long tiles = (nb + T::kRows - 1) / T::kRows;
  const int my_tiles = (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);  // grid <= tiles

  // Tile n of this CTA into stage n % S: only the rows that exist.
  auto load = [&](int n) {
    const long long row0 = (blockIdx.x + (long long)n * gridDim.x) * T::kRows;
    const long long rows = nb - row0 < T::kRows ? nb - row0 : T::kRows;
    const int s = n % T::kStages;
    const uint32_t bytes = (uint32_t)(rows * B * sizeof(float));
    mbar_expect_tx(smem_u32(full + s), bytes);
    bulk_load_1d(smem_u32(ring + s * T::kTile), x + row0 * B, bytes, smem_u32(full + s));
  };
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) mbar_init(smem_u32(full + s), 1);
    mbar_fence_init();
    load(0);  // the other stages after it lands: every CTA's first tile comes first
  }
  for (int i = tid; i < B * B; i += T::kThreads) mt[i] = mat[(i % B) * B + i / B];
  __syncthreads();

  const int tc = tid % T::kCols;  // columns g * kHalf + 4 tc + c
  const int tr = tid / T::kCols;  // rows tr * TM + i of the tile
  for (int n = 0; n < my_tiles; ++n) {
    const int s = n % T::kStages;
    mbar_wait(smem_u32(full + s), (n / T::kStages) & 1);
    if (n == 0 && tid == 0)
      for (int m = 1; m < T::kStages && m < my_tiles; ++m) load(m);
    float acc[T::kTM][T::kTN];
    multiply_rows<B>(ring + s * T::kTile + tr * T::kTM * B, mt + 4 * tc, acc);
    __syncthreads();  // every thread is done reading stage s
    if (tid == 0 && n + T::kStages < my_tiles) load(n + T::kStages);
    const long long row0 = (blockIdx.x + (long long)n * gridDim.x) * T::kRows + tr * T::kTM;
    store_codes<B>(acc, q, row0, nb, codes + 4 * tc);
  }
}

constexpr int kMaxDevices = 64;

template <int B>
int launch(const float* x, const float* mat, float q, long long nb, int* codes, cudaStream_t s) {
  using T = Tiling<B>;
  const auto kernel = block_transform_kernel<B>;
  // CTAs resident on the whole card (SMs x occupancy), found once per device
  // together with the opt-in to kSmem bytes of dynamic shared memory.
  static std::atomic<long long> resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev].load(std::memory_order_relaxed) == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::kThreads, T::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev].store((long long)sms * per_sm, std::memory_order_relaxed);
  }
  const long long tiles = (nb + T::kRows - 1) / T::kRows;
  const long long card = resident[dev].load(std::memory_order_relaxed);
  const unsigned grid = (unsigned)(tiles < card ? tiles : card);
  kernel<<<grid, T::kThreads, T::kSmem, s>>>(x, mat, q, nb, codes);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (nb, B) float32, mat: (B, B) float32, codes: (nb, B) int32; B in
// {16, 32, 64, 128}.  x and codes must be 16-byte aligned (the bulk copy and
// the int4 stores).  Returns cudaErrorInvalidValue for another B and
// cudaErrorMisalignedAddress for a misaligned x or codes.
extern "C" int block_transform_launch(const void* x, const void* mat, float q, int B,
                                      long long nb, void* codes, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(codes) % 16)
    return (int)cudaErrorMisalignedAddress;
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
