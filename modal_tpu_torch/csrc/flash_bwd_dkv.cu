// Flash-attention backward, dK and dV, for Hopper (sm_90a): P recomputed
// from the forward's saved logsumexp, so the [S, S] score matrix never
// reaches device memory.
//
// Replaces: modal_tpu/ops/attention.py:152 `_flash_dkv_kernel` (Pallas,
// launched by `_flash_backward` at :327). Same contract: q, k, v, dO
// [B, S, H, D] (kv heads already repeated to H), lse and delta = rowsum(dO∘O)
// [B, H, Sq, 1] fp32, dK and dV [B, S, H, D] in the input dtype:
//     P  = exp(scale·QKᵀ − lse)        (causal: kv_pos <= q_pos, aligned at 0)
//     dS = P ∘ (dO·Vᵀ − delta) · scale
//     dV = Pᵀ · dO,  dK = dSᵀ · Q
// over the q tiles this K/V tile is visible to: causal loops start at the
// diagonal, (k0 / BQ) as at :193-196.
//
// What bounds it on the H100: operations. Four S×S×D products per (b, h)
// over the causal triangle, 2·h·d·S(S+1)/2 FLOP each; at S 2048, D 128
// that is ~1000 FLOP per byte moved, above the ~295 FLOP/byte ridge.
//
// Design, simple first (K1's pieces, csrc/flash_common.cuh): one block of 4
// warps per (64-row K/V tile, head, batch); the K and V tiles stay in
// shared memory, each 64-row Q and dO tile is staged with 16-byte loads
// straight from the [B, S, H, D] layout through its strides. The block
// computes the TRANSPOSED scores Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (WMMA mma.sync
// 16x16x16 bf16, fp32 accumulate), so each warp owns 16 K rows for every
// step: its rows of Pᵀ and dSᵀ feed its rows of dV += Pᵀ·dO and
// dK += dSᵀ·Q with only warp syncs, and no atomics are needed anywhere:
// the block owns its dK and dV rows. The fp32 dK and dV accumulators live
// in shared memory (~187 KB per block at D 128). P and dS are rounded to
// bf16 once for their products: at llama3-8b that keeps the grads closer to
// fp32 attention than the einsum path's (PERF.md), so K1's hi + lo split of
// P is not needed here. wgmma, TMA, register-resident accumulators and a
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
constexpr int NTHREADS = 128;  // 4 warps x 16 K rows

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  Strides q_st, k_st, v_st, do_st, dk_st, dv_st;
  int H, Sq, Sk;
  float scale;
  int causal;
};

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 row pitch of Q, dO, K, V tiles
  static constexpr int LDS = BQ + 4;  // fp32 row pitch of Sᵀ and dPᵀ
  static constexpr int LDP = BQ + 8;  // bf16 row pitch of Pᵀ and dSᵀ
  static constexpr int LDA = D + 4;   // fp32 row pitch of the dK and dV accumulators
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BK * LDQ;
  static constexpr size_t q_off = v_off + sizeof(bf16) * BK * LDQ;
  static constexpr size_t do_off = q_off + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t s_off = do_off + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t dp_off = s_off + sizeof(float) * BK * LDS;
  static constexpr size_t p_off = dp_off + sizeof(float) * BK * LDS;
  static constexpr size_t ds_off = p_off + sizeof(bf16) * BK * LDP;
  static constexpr size_t dk_off = ds_off + sizeof(bf16) * BK * LDP;
  static constexpr size_t dv_off = dk_off + sizeof(float) * BK * LDA;
  static constexpr size_t lse_off = dv_off + sizeof(float) * BK * LDA;
  static constexpr size_t dlt_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t bytes = dlt_off + sizeof(float) * BQ;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  float* St = reinterpret_cast<float*>(smem + L::s_off);
  float* dPt = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* Pt = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* dSt = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* dKa = reinterpret_cast<float*>(smem + L::dk_off);
  float* dVa = reinterpret_cast<float*>(smem + L::dv_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dlt_s = reinterpret_cast<float*>(smem + L::dlt_off);

  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kb * BK;
  const bf16* qg = p.q + b * p.q_st.b + h * p.q_st.h;
  const bf16* dog = p.dout + b * p.do_st.b + h * p.do_st.h;
  const bf16* kg = p.k + b * p.k_st.b + h * p.k_st.h;
  const bf16* vg = p.v + b * p.v_st.b + h * p.v_st.h;
  bf16* dkg = p.dk + b * p.dk_st.b + h * p.dk_st.h;
  bf16* dvg = p.dv + b * p.dv_st.b + h * p.dv_st.h;
  const float* lse_g = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* dlt_g = p.delta + ((long long)b * p.H + h) * p.Sq;

  load_tile<D, NTHREADS>(Ks, L::LDQ, kg, p.k_st.s, k0, BK, p.Sk);
  load_tile<D, NTHREADS>(Vs, L::LDQ, vg, p.v_st.s, k0, BK, p.Sk);
  for (int i = threadIdx.x; i < BK * L::LDA; i += NTHREADS) {
    dKa[i] = 0.f;
    dVa[i] = 0.f;
  }

  const int n_qb = (p.Sq + BQ - 1) / BQ;
  const int first_qb = p.causal ? k0 / BQ : 0;  // earlier q rows cannot see this K tile

  for (int qb = first_qb; qb < n_qb; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // previous tile's readers are done (and the init is visible)
    load_tile<D, NTHREADS>(Qs, L::LDQ, qg, p.q_st.s, q0, BQ, p.Sq);
    load_tile<D, NTHREADS>(dOs, L::LDQ, dog, p.do_st.s, q0, BQ, p.Sq);
    if (threadIdx.x < BQ) {
      const int qpos = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qpos < p.Sq ? lse_g[qpos] : 0.f;
      dlt_s[threadIdx.x] = qpos < p.Sq ? dlt_g[qpos] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for this warp's 16 K rows
    mma_abt<D, BQ>(St + warp * 16 * L::LDS, L::LDS, Ks + warp * 16 * L::LDQ, L::LDQ, Qs, L::LDQ);
    mma_abt<D, BQ>(dPt + warp * 16 * L::LDS, L::LDS, Vs + warp * 16 * L::LDQ, L::LDQ, dOs, L::LDQ);
    __syncwarp();

    // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − delta) · scale; each lane owns 2 of the 64 q columns
    for (int rr = 0; rr < 16; ++rr) {
      const int row = warp * 16 + rr;
      const int kpos = k0 + row;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = lane + half * 32;
        const int qpos = q0 + col;
        const bool ok = qpos < p.Sq && (!p.causal || kpos <= qpos);
        const float pr = ok ? expf(St[row * L::LDS + col] * p.scale - lse_s[col]) : 0.f;
        const float ds = pr * (dPt[row * L::LDS + col] - dlt_s[col]) * p.scale;
        Pt[row * L::LDP + col] = __float2bfloat16(pr);
        dSt[row * L::LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dV += Pᵀ dO and dK += dSᵀ Q for this warp's K rows
    mma_acc_ab<D, BQ>(dVa + warp * 16 * L::LDA, L::LDA, Pt + warp * 16 * L::LDP, L::LDP, dOs, L::LDQ);
    mma_acc_ab<D, BQ>(dKa + warp * 16 * L::LDA, L::LDA, dSt + warp * 16 * L::LDP, L::LDP, Qs, L::LDQ);
  }
  __syncthreads();

  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    const int kpos = k0 + row;
    if (kpos >= p.Sk) break;
    for (int d = lane; d < D; d += 32) {
      dkg[kpos * p.dk_st.s + d] = __float2bfloat16(dKa[row * L::LDA + d]);
      dvg[kpos * p.dv_st.s + d] = __float2bfloat16(dVa[row * L::LDA + d]);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.Sk + BK - 1) / BK, p.H, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 18 int64 element strides, (batch, seq, head) for q, k, v, dO, dK, dV
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int H, int Sq, int Sk, int D, const long long* st, float scale,
                                  int causal, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_st = {st[0], st[1], st[2]};
  p.k_st = {st[3], st[4], st[5]};
  p.v_st = {st[6], st[7], st[8]};
  p.do_st = {st[9], st[10], st[11]};
  p.dk_st = {st[12], st[13], st[14]};
  p.dv_st = {st[15], st[16], st[17]};
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

extern "C" const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
