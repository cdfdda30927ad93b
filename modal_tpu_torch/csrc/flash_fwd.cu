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
// tensor cores). P·V runs twice (hi and lo halves of P, below), so the
// tensor cores do 1.5x the bound's work.
//
// Design (FA3-shaped, csrc/hopper.cuh): one block of three warpgroups per
// 128-row q tile. Warpgroup 0 is the producer: it gives its registers back
// (setmaxnreg) and one thread streams the Q tile, then each 64-row K and V
// tile, with TMA (128B swizzle; 64B at D 32) into a ring of NST stages
// guarded by full/empty mbarriers. Warpgroups 1 and 2 are consumers, 64 q
// rows each: S = Q·Kᵀ runs on wgmma from shared memory into fp32 registers;
// the online softmax works on those registers, reducing each row over the 4
// lanes that hold it (shuffles 1 and 2), masking only the diagonal tile and
// a ragged last tile; P = exp(S − m) is converted to bf16 in place and fed
// to O += P·V as wgmma's register A operand (the m64nN accumulator layout is
// the next product's A fragment, so no data moves between threads); O stays
// in registers for the whole loop and is rescaled there. P enters P·V as
// two bf16 halves (hi + lo, two wgmmas on the same V descriptor), so the
// product keeps about 16 mantissa bits of the fp32 P instead of bf16's 8:
// at llama3-8b's depth a single bf16 rounding of P moves the logits more
// than the plain reference's own tolerance. l sums the fp32 P. Blocks are
// numbered heaviest q tile first, so the causal tail is short tiles.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;  // q rows per block: two consumer warpgroups x 64
constexpr int BK = 64;   // K/V rows per tile
constexpr int NST = 4;   // K/V ring stages
constexpr int NTHREADS = 384;
constexpr int CONSUMERS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int Q_BYTES = Swz<D>::template tile_bytes<BQ>();
  static constexpr int KV_BYTES = Swz<D>::template tile_bytes<BK>();
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + Q_BYTES;
  static constexpr int v_off = k_off + NST * KV_BYTES;
  static constexpr int bar_off = v_off + NST * KV_BYTES;
  static constexpr int bytes = bar_off + (1 + 2 * NST) * 8 + 1024;  // + alignment slack
};

struct Params {
  bf16* out;
  float* lse;
  int B, H, Sq, Sk, n_qb;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
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
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      mbar_arrive_tx(q_bar, L::Q_BYTES);
      tma_load_tile<D, BQ>(Qs, &tq, q_bar, q0, h, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % NST;
        if (kb >= NST) mbar_wait(&empty[s], ((kb / NST) - 1) & 1);
        mbar_arrive_tx(&full[s], 2 * L::KV_BYTES);
        tma_load_tile<D, BK>(Ks + s * (L::KV_BYTES / 2), &tk, &full[s], kb * BK, h, b);
        tma_load_tile<D, BK>(Vs + s * (L::KV_BYTES / 2), &tv, &full[s], kb * BK, h, b);
      }
    }
  } else {
    regs_alloc<232>();
    const int cw = wg - 1;          // consumer warpgroup: q rows [qw0, qw0 + 64)
    const int t = threadIdx.x % 128;
    const int row = (t / 32) * 16 + (t % 32) / 4;  // this thread's rows: row, row + 8
    const int col2 = 2 * (t % 4);                  // and columns 8i + col2 + {0, 1}
    const int qw0 = q0 + 64 * cw;
    const float sl2 = p.scale * LOG2E;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % NST;
      const int k0 = kb * BK;
      mbar_wait(&full[s], (kb / NST) & 1);
      // a K tile past this warpgroup's last row is all masked: skip it
      if (!(p.causal && k0 > qw0 + 63)) {
        const uint32_t Qa = smem_addr(Qs), Kt = smem_addr(Ks) + s * L::KV_BYTES,
                       Vt = smem_addr(Vs) + s * L::KV_BYTES;
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, desc_kmajor<D, BQ>(Qa, 64 * cw, kk), desc_kmajor<D, BK>(Kt, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // the diagonal tile and a ragged last tile are masked; the others not
        if ((p.causal && k0 + BK - 1 > qw0) || k0 + BK > p.Sk) {
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int kpos = k0 + 8 * i + col2 + c, qpos = qw0 + row + 8 * j;
                if (kpos >= p.Sk || (p.causal && kpos > qpos)) sc[4 * i + 2 * j + c] = -INFINITY;
              }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mx[j] = fmaxf(mx[j], fmaxf(sc[4 * i + 2 * j], sc[4 * i + 2 * j + 1]));
        float msc[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
          const float m_new = fmaxf(m[j], mx[j]);
          msc[j] = m_new == -INFINITY ? 0.f : m_new * sl2;  // a row masked so far stays at 0
          corr[j] = exp2f(m[j] * sl2 - msc[j]);
          m[j] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float pv = exp2f(fmaf(sc[4 * i + 2 * j + c], sl2, -msc[j]));
              sc[4 * i + 2 * j + c] = pv;
              rs[j] += pv;
            }
        // l stays a per-thread partial sum (its 16 columns); the 4 lanes
        // of a row add theirs at the end
#pragma unroll
        for (int j = 0; j < 2; ++j) l[j] = l[j] * corr[j] + rs[j];
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            o[4 * i + 2 * j] *= corr[j];
            o[4 * i + 2 * j + 1] *= corr[j];
          }

        // P = hi + lo, both bf16, as register A fragments of O += P·V
        uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = desc_mnmajor<D, BK>(Vt, kk);
          wgmma_rs<D>(o, hi[kk], dv, 1);
          wgmma_rs<D>(o, lo[kk], dv, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      mbar_arrive(&empty[s]);
    }

    // out = O / l in bf16 straight from registers; lse = m·scale + log l
    bf16* og = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float lt = l[j];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float l_safe = lt == 0.f ? 1.f : lt;
      const float inv = 1.f / l_safe;
      const int qpos = qw0 + row + 8 * j;
      if (qpos < p.Sq) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(og + qpos * p.o_ss + 8 * i + col2) =
              pack_bf16(o[4 * i + 2 * j] * inv, o[4 * i + 2 * j + 1] * inv);
        if (t % 4 == 0) p.lse[((long long)b * p.H + h) * p.Sq + qpos] = m[j] * p.scale + logf(l_safe);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int Sq,
           int Sk, const long long* st, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, q, B, Sq, H, D, st[0], st[1], st[2], BQ);
  if (!err) err = encode_bshd(&tk, k, B, Sk, H, D, st[3], st[4], st[5], BK);
  if (!err) err = encode_bshd(&tv, v, B, Sk, H, D, st[6], st[7], st[8], BK);
  if (err) return err;
  Params p;
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.n_qb = (Sq + BQ - 1) / BQ;
  p.o_sb = st[9];
  p.o_ss = st[10];
  p.o_sh = st[11];
  p.scale = scale;
  p.causal = causal;
  flash_fwd_kernel<D><<<p.n_qb * H * B, NTHREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 int64 element strides, (batch, seq, head) for q, k, v, out
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int H, int Sq, int Sk, int D, const long long* strides,
                              float scale, int causal, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, out, lse, B, H, Sq, Sk, strides, scale, causal, st);
    case 64: return launch<64>(q, k, v, out, lse, B, H, Sq, Sk, strides, scale, causal, st);
    case 128: return launch<128>(q, k, v, out, lse, B, H, Sq, Sk, strides, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_error_string(int err) { return error_string(err); }
