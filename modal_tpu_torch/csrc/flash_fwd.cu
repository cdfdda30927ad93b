// Flash-attention forward for Hopper (sm_90a): out and per-row logsumexp,
// causal or full, without the [S, S] score matrix in device memory.
//
// Replaces: modal_tpu/ops/attention.py:50 `_flash_kernel` (Pallas, launched
// by `_flash_forward` at :211). Same contract: q, k, v [B, S, H, D] (kv
// heads already repeated to H), out [B, S, H, D] in the input dtype, lse
// [B, H, S, 1] fp32 = m + log(l), causal rows attend kv_pos <= q_pos with q
// and k aligned at 0, the causal loop stops at the diagonal by CEILING
// division (attention.py:97), `l == 0` guarded.
//
// What bounds it on the H100: operations. At S 2048, D 128 a (b, h) pair
// does ~4*S*S*D/2 FLOP on 4*S*D*2 bytes, ~500 FLOP per byte, above the
// ~295 FLOP/byte ridge, so the bound is causal FLOPs / 989 TFLOP/s (bf16
// tensor cores).
//
// Design, simple first: one block of 4 warps per (64-row q block, head,
// batch). Q, then each 64-row K and V tile, are staged in shared memory as
// bf16 with 16-byte loads read straight from the [B, S, H, D] layout through
// its strides (no transpose copy). Q·Kᵀ and P·V run on the tensor cores via
// WMMA (mma.sync 16x16x16 bf16, fp32 accumulate); each warp owns 16 query
// rows, so the online softmax (fp32 m and l per row) needs only warp syncs.
// The fp32 output accumulator lives in shared memory and is rescaled there.
// P enters P·V as two bf16 halves (hi + lo, two MMAs), so the product keeps
// about 16 mantissa bits of the fp32 P instead of bf16's 8: at llama3-8b's
// depth a single bf16 rounding of P moves the logits more than the plain
// reference's own tolerance. l sums the fp32 P. wgmma, TMA and
// register-resident accumulators are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using flash::load_tile;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 row pitch of Q, K, V tiles
  static constexpr int LDS = BK + 4;  // fp32 row pitch of scores
  static constexpr int LDP = BK + 8;  // bf16 row pitch of P
  static constexpr int LDO = D + 4;   // fp32 row pitch of the output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BK * LDQ;
  static constexpr size_t s_off = v_off + sizeof(bf16) * BK * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int H, int Sq, int Sk, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss, long long o_sh, float scale,
                 int causal) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* Pl = reinterpret_cast<bf16*>(smem + L::s_off);  // lo half of P, over the scores
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qb * BQ;
  const bf16* qg = q + b * q_sb + h * q_sh;
  const bf16* kg = k + b * k_sb + h * k_sh;
  const bf16* vg = v + b * v_sb + h * v_sh;
  bf16* og = out + b * o_sb + h * o_sh;

  load_tile<D, NTHREADS>(Qs, L::LDQ, qg, q_ss, q0, BQ, Sq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) Os[i] = 0.f;
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = NEG;
    l_s[threadIdx.x] = 0.f;
  }

  int n_kb = (Sk + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);  // ceiling: include the diagonal

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile's readers are done (and Q/O init is visible)
    load_tile<D, NTHREADS>(Ks, L::LDQ, kg, k_ss, k0, BK, Sk);
    load_tile<D, NTHREADS>(Vs, L::LDQ, vg, v_ss, k0, BK, Sk);
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // Kᵀ as a col-major B operand: B[d][j] = K[j][d]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + n * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(sacc[n], a, bk, sacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + n * 16, sacc[n], L::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's rows; each lane owns 2 of the 64 columns
    for (int rr = 0; rr < 16; ++rr) {
      const int row = warp * 16 + rr;
      const int qpos = q0 + row;
      const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
      const bool ok0 = kp0 < Sk && (!causal || kp0 <= qpos);
      const bool ok1 = kp1 < Sk && (!causal || kp1 <= qpos);
      const float s0 = ok0 ? Ss[row * L::LDS + lane] * scale : NEG;
      const float s1 = ok1 ? Ss[row * L::LDS + lane + 32] * scale : NEG;
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      const float corr = expf(m_old - m_new);
      // P = hi + lo, both bf16: P·V then keeps ~16 mantissa bits of P
      // (the scores of this row were all read before warp_max, so the lo
      // half may overwrite them in place)
      const bf16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
      Ps[row * L::LDP + lane] = h0;
      Ps[row * L::LDP + lane + 32] = h1;
      Pl[row * 2 * L::LDS + lane] = __float2bfloat16(p0 - __bfloat162float(h0));
      Pl[row * 2 * L::LDS + lane + 32] = __float2bfloat16(p1 - __bfloat162float(h1));
      for (int d = lane; d < D; d += 32) Os[row * L::LDO + d] *= corr;
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's rows
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, Os + warp * 16 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a, a_lo;
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(a_lo, Pl + warp * 16 * 2 * L::LDS + kk, 2 * L::LDS);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * L::LDQ + n * 16, L::LDQ);
        wmma::mma_sync(o, a, bv, o);
        wmma::mma_sync(o, a_lo, bv, o);
      }
      wmma::store_matrix_sync(Os + warp * 16 * L::LDO + n * 16, o, L::LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    const int qpos = q0 + row;
    if (qpos >= Sq) break;
    const float l = l_s[row];
    const float l_safe = (l == 0.f) ? 1.f : l;
    for (int d = lane; d < D; d += 32)
      og[qpos * o_ss + d] = __float2bfloat16(Os[row * L::LDO + d] / l_safe);
    if (lane == 0) lse[((long long)blockIdx.z * H + h) * Sq + qpos] = m_s[row] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int B,
                   int H, int Sq, int Sk, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, out, lse, H, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 int64 element strides, (batch, seq, head) for q, k, v, out
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int H, int Sq, int Sk, int D, const long long* strides,
                              float scale, int causal, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(out);
  auto* lb = static_cast<float*>(lse);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(qb, kb, vb, ob, lb, B, H, Sq, Sk, strides, scale, causal, st); break;
    case 64: err = launch<64>(qb, kb, vb, ob, lb, B, H, Sq, Sk, strides, scale, causal, st); break;
    case 128: err = launch<128>(qb, kb, vb, ob, lb, B, H, Sq, Sk, strides, scale, causal, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
