// The pieces of the dQ backward kernel (flash_bwd_dq.cu, K2), which keeps
// its first, WMMA design; the forward and dK/dV kernels use hopper.cuh:
// 16-byte tile loads read straight from the [B, S, H, D] layout through its
// strides, and the two WMMA products (mma.sync 16x16x16 bf16, fp32
// accumulate) that K2 runs on tiles in shared memory, one warp per 16 rows.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

struct Strides {
  long long b, s, h;  // element strides of batch, sequence and head
};

// rows [row0, row0 + rows) of a [S, D] slice with row stride `ss` into a
// shared tile of pitch `ld`, by a block of NT threads; rows past `limit`
// are zero-filled
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, long long ss,
                                          int row0, int rows, int limit) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// C[16 x N] = A[16 x D] · B[N x D]ᵀ for one warp (A, B bf16 row-major in
// shared memory, C fp32 row-major in shared memory)
template <int D, int N>
__device__ __forceinline__ void mma_abt(float* C, int ldc, const bf16* A, int lda, const bf16* B,
                                        int ldb) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
  for (int n = 0; n < N / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      // Bᵀ as a col-major operand: Bᵀ[d][j] = B[j][d]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + n * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < N / 16; ++n)
    wmma::store_matrix_sync(C + n * 16, acc[n], ldc, wmma::mem_row_major);
}

// C[16 x D] += A[16 x K] · B[K x D] for one warp; C fp32 in shared memory,
// A and B bf16 row-major in shared memory
template <int D, int K>
__device__ __forceinline__ void mma_acc_ab(float* C, int ldc, const bf16* A, int lda, const bf16* B,
                                           int ldb) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + n * 16, ldc, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + kk, lda);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + kk * ldb + n * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + n * 16, acc, ldc, wmma::mem_row_major);
  }
}

}  // namespace flash
