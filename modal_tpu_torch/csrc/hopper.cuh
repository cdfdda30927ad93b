// Hopper (sm_90a) building blocks shared by the flash-attention forward
// (flash_fwd.cu, K1) and the dK/dV backward (flash_bwd_dkv.cu, K3):
//
// - TMA: the host-side tensor map of a [B, S, H, D] bf16 operand, read
//   through its strides, tiled as rows x (one swizzle row of D), and the
//   device-side tile load that completes on an mbarrier;
// - mbarriers: init, arrive, arrive with an expected byte count, and a
//   parity wait that traps after a bounded spin instead of hanging the card;
// - wgmma: shared-memory matrix descriptors for the swizzled tiles TMA
//   writes, fence/commit/wait, and m64nNk16 bf16 products with fp32
//   accumulators in registers: A from shared memory (SS) or from registers
//   (RS), B from shared memory, K-major or MN-major;
// - setmaxnreg, to move registers from a producer warpgroup to the
//   consumer warpgroups.
//
// Tile layout. A tile of R rows of a [*, D] operand sits in shared memory as
// D / CW sub-tiles of R x CW bf16, CW = min(D, 64): one sub-tile row is one
// swizzle row (128 bytes at D >= 64, 64 bytes at D 32), which is what TMA's
// 128B / 64B swizzle and wgmma's B128 / B64 descriptors share. Every
// sub-tile starts on a 1024-byte boundary, so the descriptors' base offset
// stays 0.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

// bf16 columns per swizzle row, its bytes, and the tile's sub-tile count
template <int D>
struct Swz {
  static_assert(D == 32 || D == 64 || D == 128, "head dim must be 32, 64 or 128");
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int BYTES = CW * 2;  // 64 or 128
  static constexpr int NSUB = D / CW;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t LAYOUT = BYTES == 128 ? 1 : 2;
  // bytes of an R-row sub-tile, and of the whole tile
  template <int R>
  __host__ __device__ static constexpr int sub_bytes() { return R * BYTES; }
  template <int R>
  __host__ __device__ static constexpr int tile_bytes() { return R * D * 2; }
};

// ---------------------------------------------------------------- host side

// Error codes the C entry points return beside cudaError_t: a refused
// tensor-map encode is TMA_ENCODE_ERROR + its CUresult.
constexpr int TMA_ENCODE_ERROR = 100000;

// The driver's tensor-map encoder, through the runtime's entry-point query,
// so the library needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a [B, S, H, D] bf16 operand (element strides sb, ss, sh
// of batch, sequence and head; D contiguous), boxed as `rows` sequence rows
// by one swizzle row of D. Rows past S read as zeros.
inline int encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                       long long sb, long long ss, long long sh, int rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return TMA_ENCODE_ERROR + 999;
  const int cw = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE_ERROR + (int)r;
}

inline const char* error_string(int err) {
  if (err == TMA_ENCODE_ERROR + 999) return "cuTensorMapEncodeTiled not found in the driver";
  if (err >= TMA_ENCODE_ERROR) return "cuTensorMapEncodeTiled refused the operand (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after `p` (dynamic shared memory
// carries 1 KB of slack for it): swizzle atoms start on such boundaries.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// makes the inits visible to the async proxy (TMA) and the other threads;
// the caller follows it with __syncthreads()
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that spins
// past ~2^26 polls (seconds) traps: a lost arrival or a wrong byte count
// then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// A barrier over `threads` threads (a warpgroup: 128) under id 1..15; id 0
// is __syncthreads'.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA ----------------------------------------------------------------------

// One box of a [B, S, H, D] tensor map: columns [col, col + CW) of rows
// [row, row + rows) of head h, batch b, into `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// A whole tile of `rows` rows: its D / CW boxes, sub-tile after sub-tile.
template <int D, int ROWS>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int h, int b) {
  using S = Swz<D>;
#pragma unroll
  for (int c = 0; c < S::NSUB; ++c)
    tma_load(reinterpret_cast<char*>(dst) + c * S::template sub_bytes<ROWS>(), map, bar,
             c * S::CW, row, h, b);
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// setmaxnreg ----------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The descriptors take the tile's shared-memory address (`smem_addr`).
//
// K-major operand (rows x D, D contiguous: A of Q·Kᵀ, or B as Kᵀ's rows):
// the descriptor of k-step kk (16 columns of D) of a tile of ROWS rows whose
// wgmma rows start at `row0`. Within a swizzle row the k-steps advance by
// 32 bytes; past it, by one sub-tile. 8-row groups are one swizzle atom
// (8 swizzle rows) apart; the leading offset is unused.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0, int kk) {
  using S = Swz<D>;
  constexpr int KPS = S::CW / 16;  // k-steps per swizzle row
  const uint32_t addr = tile + (kk / KPS) * S::template sub_bytes<ROWS>() +
                        row0 * S::BYTES + (kk % KPS) * 32;
  return make_desc(addr, 16, 8 * S::BYTES, S::LAYOUT);
}

// MN-major B operand (the tile's rows are the product's K dimension, D is
// its N, contiguous: V in P·V, dO in Pᵀ·dO, Q in dSᵀ·Q): k-step kk is 16
// rows further on; along N the swizzle atoms are one sub-tile apart
// (leading offset), along K the 8-row groups one atom apart (stride offset).
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using S = Swz<D>;
  const uint32_t addr = tile + kk * 16 * S::BYTES;
  return make_desc(addr, S::template sub_bytes<ROWS>(), 8 * S::BYTES, S::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two fp32 values as one bf16x2 register (first value in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values as hi + lo bf16x2 pairs: hi = bf16(x), lo = bf16(x − hi),
// so hi + lo keeps about 16 mantissa bits of x.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack_bf16(__bfloat162float(hx), __bfloat162float(hy));
  lo = pack_bf16(x - __bfloat162float(hx), y - __bfloat162float(hy));
}

// Accumulator layout of m64nN (fp32): thread t of the warpgroup holds
// d[4i + 2j + c] = row 16·(t / 32) + (t % 32) / 4 + 8j, column 8i + 2·(t % 4) + c.
// The register A fragment of k-step kk of the next product is then
// d[8kk .. 8kk + 7], packed in pairs: no data moves between threads.

// SS m64n32k16: d += A(smem) * B(smem)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
// SS m64n64k16: d += A(smem) * B(smem)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
// RS m64n32k16: d += A(registers) * B(smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
// RS m64n64k16: d += A(registers) * B(smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
// RS m64n128k16: d += A(registers) * B(smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, acc);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, acc);
  else wgmma_rs_n128(d, a, db, acc);
}

}  // namespace hopper
