// Flash-attention backward, dQ, for Hopper (sm_90a): P recomputed from the
// forward's saved logsumexp, so the [S, S] score matrix never reaches
// device memory.
//
// Replaces: modal_tpu/ops/attention.py:106 `_flash_dq_kernel` (Pallas,
// launched by `_flash_backward` at :308). Same contract: q, k, v, dO
// [B, S, H, D] (kv heads already repeated to H), lse and delta = rowsum(dO∘O)
// [B, H, Sq, 1] fp32 (delta is computed outside, as at :293), dQ [B, S, H, D]
// in the input dtype:
//     P  = exp(scale·QKᵀ − lse)        (causal: kv_pos <= q_pos, aligned at 0)
//     dS = P ∘ (dO·Vᵀ − delta) · scale
//     dQ = dS · K
// The causal loop stops at the diagonal by CEILING division (:143-145).
//
// What bounds it on the H100: operations. Three S×S×D products per
// (b, h) over the causal triangle, 2·h·d·S(S+1)/2 FLOP each; at S 2048,
// D 128 that is ~750 FLOP per byte moved, above the ~295 FLOP/byte ridge.
//
// Design, simple first (csrc/flash_common.cuh): one block of 4
// warps per (64-row q tile, head, batch); Q and dO tiles stay in shared
// memory, each 64-row K and V tile is staged with 16-byte loads straight
// from the [B, S, H, D] layout through its strides. S = QKᵀ and dP = dO·Vᵀ
// run on the tensor cores via WMMA (mma.sync 16x16x16 bf16, fp32
// accumulate); each warp owns 16 query rows, so the elementwise step needs
// only warp syncs and no atomics are needed anywhere: the block owns its
// dQ rows. The fp32 dQ accumulator lives in shared memory. dS is rounded to
// bf16 once for dS·K: at llama3-8b that keeps the grads closer to fp32
// attention than the einsum path's (PERF.md), so K1's hi + lo split of P
// is not needed here. wgmma, TMA, register-resident accumulators and a
// fused dQ/dKV kernel are later work.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::load_tile;
using flash::mma_abt;
using flash::mma_acc_ab;
using flash::Strides;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  Strides q_st, k_st, v_st, do_st, dq_st;
  int H, Sq, Sk;
  float scale;
  int causal;
};

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 row pitch of Q, dO, K, V tiles
  static constexpr int LDS = BK + 4;  // fp32 row pitch of S and dP
  static constexpr int LDP = BK + 8;  // bf16 row pitch of dS
  static constexpr int LDA = D + 4;   // fp32 row pitch of the dQ accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t k_off = do_off + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BK * LDQ;
  static constexpr size_t s_off = v_off + sizeof(bf16) * BK * LDQ;
  static constexpr size_t dp_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t ds_off = dp_off + sizeof(float) * BQ * LDS;
  static constexpr size_t acc_off = ds_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t lse_off = acc_off + sizeof(float) * BQ * LDA;
  static constexpr size_t dlt_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t bytes = dlt_off + sizeof(float) * BQ;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* acc = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dlt_s = reinterpret_cast<float*>(smem + L::dlt_off);

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qb * BQ;
  const bf16* qg = p.q + b * p.q_st.b + h * p.q_st.h;
  const bf16* dog = p.dout + b * p.do_st.b + h * p.do_st.h;
  const bf16* kg = p.k + b * p.k_st.b + h * p.k_st.h;
  const bf16* vg = p.v + b * p.v_st.b + h * p.v_st.h;
  bf16* dqg = p.dq + b * p.dq_st.b + h * p.dq_st.h;

  load_tile<D, NTHREADS>(Qs, L::LDQ, qg, p.q_st.s, q0, BQ, p.Sq);
  load_tile<D, NTHREADS>(dOs, L::LDQ, dog, p.do_st.s, q0, BQ, p.Sq);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += NTHREADS) acc[i] = 0.f;
  if (threadIdx.x < BQ) {
    const int qpos = q0 + threadIdx.x;
    const long long row = ((long long)b * p.H + h) * p.Sq + qpos;
    lse_s[threadIdx.x] = qpos < p.Sq ? p.lse[row] : 0.f;
    dlt_s[threadIdx.x] = qpos < p.Sq ? p.delta[row] : 0.f;
  }

  int n_kb = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);  // ceiling: include the diagonal

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile's readers are done (and the init is visible)
    load_tile<D, NTHREADS>(Ks, L::LDQ, kg, p.k_st.s, k0, BK, p.Sk);
    load_tile<D, NTHREADS>(Vs, L::LDQ, vg, p.v_st.s, k0, BK, p.Sk);
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ for this warp's 16 rows
    mma_abt<D, BK>(Ss + warp * 16 * L::LDS, L::LDS, Qs + warp * 16 * L::LDQ, L::LDQ, Ks, L::LDQ);
    mma_abt<D, BK>(dPs + warp * 16 * L::LDS, L::LDS, dOs + warp * 16 * L::LDQ, L::LDQ, Vs, L::LDQ);
    __syncwarp();

    // dS = P ∘ (dP − delta) · scale; each lane owns 2 of the 64 columns
    for (int rr = 0; rr < 16; ++rr) {
      const int row = warp * 16 + rr;
      const int qpos = q0 + row;
      const float lse = lse_s[row], dlt = dlt_s[row];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = lane + half * 32;
        const int kpos = k0 + col;
        const bool ok = qpos < p.Sq && kpos < p.Sk && (!p.causal || kpos <= qpos);
        const float pr = ok ? expf(Ss[row * L::LDS + col] * p.scale - lse) : 0.f;
        const float ds = pr * (dPs[row * L::LDS + col] - dlt) * p.scale;
        dSs[row * L::LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ += dS K for this warp's rows
    mma_acc_ab<D, BK>(acc + warp * 16 * L::LDA, L::LDA, dSs + warp * 16 * L::LDP, L::LDP, Ks, L::LDQ);
  }
  __syncthreads();

  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    const int qpos = q0 + row;
    if (qpos >= p.Sq) break;
    for (int d = lane; d < D; d += 32)
      dqg[qpos * p.dq_st.s + d] = __float2bfloat16(acc[row * L::LDA + d]);
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 15 int64 element strides, (batch, seq, head) for q, k, v, dO, dQ
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int H,
                                 int Sq, int Sk, int D, const long long* st, float scale,
                                 int causal, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.q_st = {st[0], st[1], st[2]};
  p.k_st = {st[3], st[4], st[5]};
  p.v_st = {st[6], st[7], st[8]};
  p.do_st = {st[9], st[10], st[11]};
  p.dq_st = {st[12], st[13], st[14]};
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(p, B, s); break;
    case 64: err = launch<64>(p, B, s); break;
    case 128: err = launch<128>(p, B, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
