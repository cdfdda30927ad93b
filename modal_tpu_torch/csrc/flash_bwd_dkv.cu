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
// Design (csrc/hopper.cuh): one block of two warpgroups per 128-row K/V
// tile, 64 K rows each. Thread 0 loads the block's K and V tiles once with
// TMA, then keeps a ring of NST 64-row Q and dO tiles in flight (128B
// swizzle; 64B at D 32), refilling the slot of tile i − 1 with tile
// i − 1 + NST once both warpgroups have released it (full/empty mbarriers).
// Each warpgroup computes the TRANSPOSED scores Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// (wgmma, A = K or V from shared memory, B = Q or dO K-major), so it owns
// its K rows from the scores to the accumulators and no atomics are needed
// anywhere. Pᵀ and dSᵀ are computed in registers (each warpgroup stages
// the tile's lse and delta in shared memory, one value per thread, loaded a
// tile ahead; each thread reads those of the q columns it holds), rounded to bf16 once in place and
// fed as register A operands to dV += Pᵀ·dO and dK += dSᵀ·Q, whose B is the
// same swizzled dO or Q tile under an MN-major descriptor. dK and dV stay
// in fp32 registers for the whole loop (2 × D/2 per thread).
//
// Registers are what binds. With a producer warpgroup and setmaxnreg
// (40 / 232), ptxas spilled ~250 bytes per thread at D 128 and serialized
// the wgmmas ("insufficient register resources"), at 240 as at 232; the
// same consumer code in a 256-thread block, where every thread may hold
// 255 registers, needs ~230 and neither spills nor serializes. So K3 has
// no producer warpgroup: TMA needs one thread, not a warp's registers.
// Each 64-row Q/dO tile is consumed in two passes of 32 q columns
// (m64n32 scores, two k-steps of the dK/dV products each), so that Sᵀ and
// dPᵀ of a pass take 2 × 16 registers beside dK and dV. P and dS are
// rounded to bf16 once for their products: at llama3-8b that keeps the
// grads closer to fp32 attention than the einsum path's (PERF.md). Blocks
// are numbered from the first K tile, which sees every q tile under the
// causal mask: the heaviest start first.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BKV = 128;  // K/V rows per block: two consumer warpgroups x 64
constexpr int BQ = 64;    // q rows per streamed tile
constexpr int CQ = 32;    // q columns per compute pass over a tile
constexpr int NST = 3;    // Q/dO ring stages
constexpr int NTHREADS = 256;  // two warpgroups x 64 K rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int KV_BYTES = Swz<D>::template tile_bytes<BKV>();
  static constexpr int Q_BYTES = Swz<D>::template tile_bytes<BQ>();
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + KV_BYTES;
  static constexpr int q_off = v_off + KV_BYTES;
  static constexpr int do_off = q_off + NST * Q_BYTES;
  // per warpgroup, two buffers of the tile's lse·log2(e) and delta: [2][2][2 * BQ] fp32
  static constexpr int stat_off = do_off + NST * Q_BYTES;
  static constexpr int bar_off = stat_off + 2 * 2 * 2 * BQ * 4;
  static constexpr int bytes = bar_off + (1 + 2 * NST) * 8 + 1024;  // + alignment slack
};

struct Params {
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int B, H, Sq, Sk;
  float scale;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const Params p) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  float* stats = reinterpret_cast<float*>(smem + L::stat_off);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + NST;

  // the first K tiles see the most q tiles under the causal mask: they go first
  const int heads = p.H * p.B;
  const int kb = blockIdx.x / heads;
  const int h = (blockIdx.x % heads) % p.H, b = (blockIdx.x % heads) / p.H;
  const int k0 = kb * BKV;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int first_qt = p.causal ? k0 / BQ : 0;  // earlier q rows cannot see this K tile
  const int n_it = n_qt - first_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NTHREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Q/dO tile `j` of this block's loop into its ring slot (thread 0 only)
  auto load_q_tile = [&](int j) {
    const int s = j % NST;
    mbar_arrive_tx(&full[s], 2 * L::Q_BYTES);
    tma_load_tile<D, BQ>(Qs + s * (L::Q_BYTES / 2), &tq, &full[s], (first_qt + j) * BQ, h, b);
    tma_load_tile<D, BQ>(dOs + s * (L::Q_BYTES / 2), &tdo, &full[s], (first_qt + j) * BQ, h, b);
  };
  if (threadIdx.x == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tdo);
    mbar_arrive_tx(kv_bar, 2 * L::KV_BYTES);
    tma_load_tile<D, BKV>(Ks, &tk, kv_bar, k0, h, b);
    tma_load_tile<D, BKV>(Vs, &tv, kv_bar, k0, h, b);
    for (int j = 0; j < min(NST, n_it); ++j) load_q_tile(j);
  }

  const int cw = threadIdx.x / 128;  // warpgroup: K rows [kw0, kw0 + 64)
  const int t = threadIdx.x % 128;
  const int row = (t / 32) * 16 + (t % 32) / 4;  // this thread's K rows: row, row + 8
  const int col2 = 2 * (t % 4);                  // and q columns 8i + col2 + {0, 1}
  const int kw0 = k0 + 64 * cw;
  const float sl2 = p.scale * LOG2E;
  const float* lse_g = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* dlt_g = p.delta + ((long long)b * p.H + h) * p.Sq;
  // thread t of a warpgroup stages lse·log2(e) (t < 64) or delta (t >= 64)
  // of q row t % 64 of tile j, one tile ahead of its use
  auto stat_of = [&](int j) -> float {
    const int qpos = (first_qt + j) * BQ + t % BQ;
    if (qpos >= p.Sq) return 0.f;
    return t < BQ ? __ldg(lse_g + qpos) * LOG2E : __ldg(dlt_g + qpos);
  };
  float staged = stat_of(0);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % NST;
    const int q0 = (first_qt + it) * BQ;
    // the slot of tile it − 1 takes tile it − 1 + NST once both warpgroups
    // are done with it
    if (threadIdx.x == 0 && it >= 1 && it - 1 + NST < n_it) {
      mbar_wait(&empty[(it - 1) % NST], ((it - 1) / NST) & 1);
      load_q_tile(it - 1 + NST);
    }
    __syncwarp();
    // this tile's lse and delta into the warpgroup's buffer for it (the
    // buffers alternate, so a warp still reading the last tile's is safe)
    float* st = stats + (cw * 2 + (it & 1)) * 2 * BQ;
    st[t] = staged;
    named_barrier_sync(1 + cw, 128);
    if (it + 1 < n_it) staged = stat_of(it + 1);
    mbar_wait(&full[s], (it / NST) & 1);
    // a q tile wholly before this warpgroup's first K row sees none of it
    if (!(p.causal && q0 + BQ - 1 < kw0)) {
      const uint32_t Ka = smem_addr(Ks), Va = smem_addr(Vs);
      const uint32_t Qt = smem_addr(Qs) + s * L::Q_BYTES, dOt = smem_addr(dOs) + s * L::Q_BYTES;
      const bool masked = (p.causal && q0 < kw0 + 63) || q0 + BQ > p.Sq;
      // the tile's q columns in two passes of CQ: Sᵀ and dPᵀ of one pass
      // are 2 x CQ/2 registers beside dK and dV's 2 x D/2
#pragma unroll
      for (int part = 0; part < BQ / CQ; ++part) {
        const int c0 = part * CQ;
        float sc[CQ / 2], dp[CQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n32(sc, desc_kmajor<D, BKV>(Ka, 64 * cw, kk), desc_kmajor<D, BQ>(Qt, c0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n32(dp, desc_kmajor<D, BKV>(Va, 64 * cw, kk), desc_kmajor<D, BQ>(dOt, c0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        // Pᵀ in place of Sᵀ; the diagonal tile and a ragged last tile are masked
#pragma unroll
        for (int i = 0; i < CQ / 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int idx = 4 * i + 2 * j + c;
              float pv = exp2f(fmaf(sc[idx], sl2, -st[c0 + 8 * i + col2 + c]));
              if (masked) {
                const int qpos = q0 + c0 + 8 * i + col2 + c, kpos = kw0 + row + 8 * j;
                if (qpos >= p.Sq || (p.causal && kpos > qpos)) pv = 0.f;
              }
              sc[idx] = pv;
            }
        wgmma_wait<0>();
        fence_regs(dp);
        // dSᵀ = Pᵀ ∘ (dPᵀ − delta) · scale in place of dPᵀ
#pragma unroll
        for (int i = 0; i < CQ / 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int idx = 4 * i + 2 * j + c;
              dp[idx] = sc[idx] * (dp[idx] - st[BQ + c0 + 8 * i + col2 + c]) * p.scale;
            }
        // bf16 register A fragments: dV += Pᵀ·dO, dK += dSᵀ·Q over this
        // pass's CQ rows of dO and Q
        uint32_t pa[CQ / 16][4], da[CQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < CQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
            da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CQ / 16; ++kk)
          wgmma_rs<D>(dv, pa[kk], desc_mnmajor<D, BQ>(dOt, c0 / 16 + kk), 1);
#pragma unroll
        for (int kk = 0; kk < CQ / 16; ++kk)
          wgmma_rs<D>(dk, da[kk], desc_mnmajor<D, BQ>(Qt, c0 / 16 + kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
      }
    }
    mbar_arrive(&empty[s]);
  }

  bf16* dkg = p.dk + b * p.dk_sb + h * p.dk_sh;
  bf16* dvg = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kpos = kw0 + row + 8 * j;
    if (kpos < p.Sk) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dkg + kpos * p.dk_ss + 8 * i + col2) =
            pack_bf16(dk[4 * i + 2 * j], dk[4 * i + 2 * j + 1]);
        *reinterpret_cast<uint32_t*>(dvg + kpos * p.dv_ss + 8 * i + col2) =
            pack_bf16(dv[4 * i + 2 * j], dv[4 * i + 2 * j + 1]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& base,
           const long long* st, cudaStream_t stream) {
  constexpr int smem = Smem<D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int B = base.B, H = base.H;
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_bshd(&tq, q, B, base.Sq, H, D, st[0], st[1], st[2], BQ);
  if (!err) err = encode_bshd(&tk, k, B, base.Sk, H, D, st[3], st[4], st[5], BKV);
  if (!err) err = encode_bshd(&tv, v, B, base.Sk, H, D, st[6], st[7], st[8], BKV);
  if (!err) err = encode_bshd(&tdo, dout, B, base.Sq, H, D, st[9], st[10], st[11], BQ);
  if (err) return err;
  const int n_kb = (base.Sk + BKV - 1) / BKV;
  flash_bwd_dkv_kernel<D><<<n_kb * H * B, NTHREADS, smem, stream>>>(tq, tk, tv, tdo, base);
  return cudaGetLastError();
}

}  // namespace

// strides: 18 int64 element strides, (batch, seq, head) for q, k, v, dO, dK, dV
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int H, int Sq, int Sk, int D, const long long* st, float scale,
                                  int causal, void* stream) {
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dk_sb = st[12];
  p.dk_ss = st[13];
  p.dk_sh = st[14];
  p.dv_sb = st[15];
  p.dv_ss = st[16];
  p.dv_sh = st[17];
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
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

extern "C" const char* flash_bwd_dkv_error_string(int err) { return error_string(err); }
