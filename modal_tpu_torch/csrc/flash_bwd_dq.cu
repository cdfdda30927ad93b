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
// What bounds it on the H100: operations. Three S×S×D products per (b, h)
// over the causal triangle, 2·h·d·S(S+1)/2 FLOP each; at S 2048, D 128
// that is ~750 FLOP per byte moved, above the ~295 FLOP/byte ridge, so the
// bound is causal FLOPs / 989 TFLOP/s (bf16 tensor cores).
//
// Design (csrc/hopper.cuh; K1's loop with one more product): one block of
// two warpgroups per 128-row q tile, 64 q rows each. Thread 0 loads the
// block's Q and dO tiles once with TMA, then keeps a ring of NST 64-row K
// and V tiles in flight (128B swizzle; 64B at D 32), refilling the slot of
// tile i − 1 with tile i − 1 + NST once both warpgroups have released it
// (full/empty mbarriers). Each warpgroup runs S = Q·Kᵀ and dP = dO·Vᵀ on
// wgmma (m64n64k16, A and B K-major from shared memory, K1's descriptors)
// into fp32 registers; P = exp2(S·scale·log2e − lse·log2e) and dS =
// P∘(dP − delta)·scale are computed there (each thread's two q rows keep
// their lse and delta in registers for the whole loop), masking only the
// diagonal tile and a ragged last tile. dS is rounded to bf16 once and fed
// as the register A operand of dQ += dS·K (m64nDk16), whose B is the same
// K tile under an MN-major descriptor, as K1 feeds P into P·V: the m64nN
// accumulator layout is the next product's A fragment, so no data moves
// between threads. dQ stays in fp32 registers for the whole loop and is
// written once, as bf16, at the end; the block owns its dQ rows, so no
// atomics are needed. Blocks are numbered heaviest q tile first, so the
// causal tail is short tiles.
//
// Registers decide the layout: each thread holds S 32, dP 32, dQ D/2 and
// the packed dS 16. K3's lesson (PERF.md) holds here too: a
// 256-thread block with thread 0 issuing the loads leaves every thread 255
// registers, where a producer warpgroup under setmaxnreg made ptxas spill
// and serialize the wgmmas. ptxas gives 156 registers at D 128 (125 at
// 64, 108 at 32) with no spill and no serialization. dS is rounded to bf16
// once for dS·K: at llama3-8b that keeps the grads closer to fp32
// attention than the einsum path's (PERF.md), so K1's hi + lo split of P
// is not needed here.
//
// What holds it from its bound (2.4x at S 2048, D 128; PERF.md): a
// warpgroup waits on its own products in turn (S and dP, then dS·K), so
// the tensor cores idle while it computes P and dS; 193 KB of shared
// memory at D 128 leaves one block per SM, with no second block to fill
// those gaps.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;        // q rows per block: two warpgroups x 64
constexpr int BK = 64;         // K/V rows per streamed tile
constexpr int NST = 4;         // K/V ring stages
constexpr int NTHREADS = 256;  // two warpgroups, no producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int Q_BYTES = Swz<D>::template tile_bytes<BQ>();
  static constexpr int KV_BYTES = Swz<D>::template tile_bytes<BK>();
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + Q_BYTES;
  static constexpr int k_off = do_off + Q_BYTES;
  static constexpr int v_off = k_off + NST * KV_BYTES;
  static constexpr int bar_off = v_off + NST * KV_BYTES;
  static constexpr int bytes = bar_off + (1 + 2 * NST) * 8 + 1024;  // + alignment slack
};

struct Params {
  const float* lse;
  const float* delta;
  bf16* dq;
  long long dq_sb, dq_ss, dq_sh;
  int B, H, Sq, Sk, n_qb;
  float scale;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const Params p) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + NST;

  // heaviest q tiles first under the causal mask: block i takes tile
  // n_qb - 1 - i / (H·B)
  const int heads = p.H * p.B;
  const int tile = blockIdx.x / heads;
  const int qb = p.causal ? p.n_qb - 1 - tile : tile;
  const int h = (blockIdx.x % heads) % p.H, b = (blockIdx.x % heads) / p.H;
  const int q0 = qb * BQ;
  int n_kb = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);  // ceiling: include the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NTHREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // K/V tile `kb` into its ring slot (thread 0 only)
  auto load_kv_tile = [&](int kb) {
    const int s = kb % NST;
    mbar_arrive_tx(&full[s], 2 * L::KV_BYTES);
    tma_load_tile<D, BK>(Ks + s * (L::KV_BYTES / 2), &tk, &full[s], kb * BK, h, b);
    tma_load_tile<D, BK>(Vs + s * (L::KV_BYTES / 2), &tv, &full[s], kb * BK, h, b);
  };
  if (threadIdx.x == 0) {
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    mbar_arrive_tx(q_bar, 2 * L::Q_BYTES);
    tma_load_tile<D, BQ>(Qs, &tq, q_bar, q0, h, b);
    tma_load_tile<D, BQ>(dOs, &tdo, q_bar, q0, h, b);
    for (int kb = 0; kb < min(NST, n_kb); ++kb) load_kv_tile(kb);
  }

  const int cw = threadIdx.x / 128;  // warpgroup: q rows [qw0, qw0 + 64)
  const int t = threadIdx.x % 128;
  const int row = (t / 32) * 16 + (t % 32) / 4;  // this thread's q rows: row, row + 8
  const int col2 = 2 * (t % 4);                  // and columns 8i + col2 + {0, 1}
  const int qw0 = q0 + 64 * cw;
  const float sl2 = p.scale * LOG2E;

  // lse·log2(e) and delta of this thread's two q rows, for the whole loop
  float lse2[2], dlt[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qpos = qw0 + row + 8 * j;
    const long long at = ((long long)b * p.H + h) * p.Sq + qpos;
    lse2[j] = qpos < p.Sq ? __ldg(p.lse + at) * LOG2E : 0.f;
    dlt[j] = qpos < p.Sq ? __ldg(p.delta + at) : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % NST;
    const int k0 = kb * BK;
    // the slot of tile kb − 1 takes tile kb − 1 + NST once both
    // warpgroups are done with it
    if (threadIdx.x == 0 && kb >= 1 && kb - 1 + NST < n_kb) {
      mbar_wait(&empty[(kb - 1) % NST], ((kb - 1) / NST) & 1);
      load_kv_tile(kb - 1 + NST);
    }
    __syncwarp();
    mbar_wait(&full[s], (kb / NST) & 1);
    // a K tile past this warpgroup's last row is all masked: skip it
    if (!(p.causal && k0 > qw0 + 63)) {
      const uint32_t Qa = smem_addr(Qs), dOa = smem_addr(dOs);
      const uint32_t Kt = smem_addr(Ks) + s * L::KV_BYTES, Vt = smem_addr(Vs) + s * L::KV_BYTES;
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_kmajor<D, BQ>(Qa, 64 * cw, kk), desc_kmajor<D, BK>(Kt, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor<D, BQ>(dOa, 64 * cw, kk), desc_kmajor<D, BK>(Vt, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P in place of S; the diagonal tile and a ragged last tile are masked
      const bool masked = (p.causal && k0 + BK - 1 > qw0) || k0 + BK > p.Sk;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * i + 2 * j + c;
            float pv = exp2f(fmaf(sc[idx], sl2, -lse2[j]));
            if (masked) {
              const int kpos = k0 + 8 * i + col2 + c, qpos = qw0 + row + 8 * j;
              if (kpos >= p.Sk || (p.causal && kpos > qpos)) pv = 0.f;
            }
            sc[idx] = pv;
          }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P ∘ (dP − delta) · scale, rounded to bf16 once, as the register
      // A fragments of dQ += dS·K
      uint32_t ds[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = 8 * kk + 2 * r;  // row + 8·(r % 2), columns 16kk + 8·(r / 2) + col2 + {0, 1}
          const int j = r % 2;
          ds[kk][r] = pack_bf16(sc[idx] * (dp[idx] - dlt[j]) * p.scale,
                                sc[idx + 1] * (dp[idx + 1] - dlt[j]) * p.scale);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(dq, ds[kk], desc_mnmajor<D, BK>(Kt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    mbar_arrive(&empty[s]);
  }

  // dQ in bf16 straight from registers
  bf16* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qpos = qw0 + row + 8 * j;
    if (qpos < p.Sq) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dqg + qpos * p.dq_ss + 8 * i + col2) =
            pack_bf16(dq[4 * i + 2 * j], dq[4 * i + 2 * j + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& base,
           const long long* st, cudaStream_t stream) {
  constexpr int smem = Smem<D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int B = base.B, H = base.H;
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_bshd(&tq, q, B, base.Sq, H, D, st[0], st[1], st[2], BQ);
  if (!err) err = encode_bshd(&tk, k, B, base.Sk, H, D, st[3], st[4], st[5], BK);
  if (!err) err = encode_bshd(&tv, v, B, base.Sk, H, D, st[6], st[7], st[8], BK);
  if (!err) err = encode_bshd(&tdo, dout, B, base.Sq, H, D, st[9], st[10], st[11], BQ);
  if (err) return err;
  flash_bwd_dq_kernel<D><<<base.n_qb * H * B, NTHREADS, smem, stream>>>(tq, tk, tv, tdo, base);
  return cudaGetLastError();
}

}  // namespace

// strides: 15 int64 element strides, (batch, seq, head) for q, k, v, dO, dQ
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int H,
                                 int Sq, int Sk, int D, const long long* st, float scale,
                                 int causal, void* stream) {
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dq_sb = st[12];
  p.dq_ss = st[13];
  p.dq_sh = st[14];
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.n_qb = (Sq + BQ - 1) / BQ;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, dout, p, st, s);
    case 64: return launch<64>(q, k, v, dout, p, st, s);
    case 128: return launch<128>(q, k, v, dout, p, st, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dq_error_string(int err) { return error_string(err); }
