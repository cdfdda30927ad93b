// Paged decode attention for Hopper (sm_90a): one query token per slot,
// K/V read page by page through the slot's page table.
//
// Replaces: modal_tpu/ops/paged_attention.py:42 `_paged_decode_kernel`
// (Pallas, reached via `paged_decode_attention` at :93). Same contract:
// q [S, n_kv, n_rep, hd] bf16, k/v pages [P, page, n_kv, hd] bf16,
// page_table [S, pages_per_slot] int32, seq_lens [S] int32 where
// q_pos = seq_lens[s] is inclusive (kv_pos <= q_pos is attended), output in
// q's layout, fp32 softmax statistics, the `l == 0` guard of :89.
//
// What bounds it on the H100: the live KV bytes it reads. At llama3-8b
// (hd 128, n_rep 4) each K/V element read feeds 4 query heads, i.e. about
// 4 FLOP per byte, far below the ~295 FLOP/byte where the tensor cores
// would become the limit, so time = live KV bytes / 3.35 TB/s at best.
//
// Design. On the TPU the grid's page axis runs in order and carries m/l/acc
// in VMEM from step to step. Hopper blocks run in no order, so the carry
// lives inside one block: one block per (kv head, slot), 8 warps. The
// block's tokens 0..q_pos are cut into warp tiles of CH*RPL tokens; warp w
// takes tiles w, w+8, ... so 8 tiles' loads are in flight per block. Pages
// past q_pos are never touched (the Pallas `pl.when` skip). Each K/V row
// (hd bf16) is read by hd/8 lanes as 16-byte vectors, every lane issuing
// all CH of its row loads before any arithmetic. Each lane group keeps its
// own online-softmax state for the n_rep query rows (fp32); groups combine
// by shuffles, warps through shared memory at the end. The next step for
// speed (a later change) is splitting long sequences across blocks: at 8
// slots x 8 kv heads this grid has 64 blocks for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int CH = 8;  // rows each lane loads per tile
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int HD, int NREP>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,   // [S, n_kv, NREP, HD]
                    const __nv_bfloat16* __restrict__ kp,  // [P, page, n_kv, HD]
                    const __nv_bfloat16* __restrict__ vp,  // [P, page, n_kv, HD]
                    const int* __restrict__ page_table,    // [S, pps]
                    const int* __restrict__ seq_lens,      // [S]
                    __nv_bfloat16* __restrict__ out,       // [S, n_kv, NREP, HD]
                    int n_kv, int page, int pps, float scale) {
  constexpr int LPR = HD / 8;    // lanes per KV row, 16 bytes each
  constexpr int RPL = 32 / LPR;  // rows one warp-wide load covers
  constexpr int T = CH * RPL;    // tokens per warp tile

  __shared__ float sm_m[NWARPS][NREP];
  __shared__ float sm_l[NWARPS][NREP];
  __shared__ float sm_acc[NWARPS][NREP][HD];

  const int kvh = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;  // which row of a warp-wide load this lane reads
  const int seg = lane % LPR;  // which 8-element segment of the row

  const int q_pos = seq_lens[s];
  const int n_tok = min(q_pos + 1, pps * page);
  const int* pt = page_table + (size_t)s * pps;
  const size_t row_stride = (size_t)n_kv * HD;
  const size_t head_off = (size_t)kvh * HD + seg * 8;

  float qf[NREP][8];
  const __nv_bfloat16* qbase = q + ((size_t)s * n_kv + kvh) * NREP * HD + seg * 8;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    uint4 u = *reinterpret_cast<const uint4*>(qbase + (size_t)r * HD);
    bf16x8_to_float(u, qf[r]);
  }

  float m[NREP], l[NREP], acc[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }

  for (int tile = warp; tile * T < n_tok; tile += NWARPS) {
    uint4 kr[CH], vr[CH];
    bool valid[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int t = tile * T + i * RPL + grp;
      valid[i] = t < n_tok;
      if (valid[i]) {
        const size_t off = ((size_t)pt[t / page] * page + (t % page)) * row_stride + head_off;
        kr[i] = *reinterpret_cast<const uint4*>(kp + off);
        vr[i] = *reinterpret_cast<const uint4*>(vp + off);
      } else {
        kr[i] = make_uint4(0u, 0u, 0u, 0u);
        vr[i] = kr[i];
      }
    }
    float sc[CH][NREP];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      float kf[8];
      bf16x8_to_float(kr[i], kf);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(qf[r][j], kf[j], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
        sc[i][r] = valid[i] ? dot * scale : NEG;
      }
    }
    float corr[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < CH; ++i) mx = fmaxf(mx, sc[i][r]);
      corr[r] = expf(m[r] - mx);
      m[r] = mx;
      l[r] *= corr[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      float vf[8];
      bf16x8_to_float(vr[i], vf);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float p = valid[i] ? expf(sc[i][r] - m[r]) : 0.f;
        l[r] += p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(p, vf[j], acc[r][j]);
      }
    }
  }

  // combine the RPL lane groups of this warp (same seg, different rows)
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float mw = m[r];
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(FULL, mw, o));
    const float c = expf(m[r] - mw);
    float lw = l[r] * c;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) lw += __shfl_xor_sync(FULL, lw, o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = acc[r][j] * c;
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) a += __shfl_xor_sync(FULL, a, o);
      acc[r][j] = a;
    }
    m[r] = mw;
    l[r] = lw;
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sm_acc[warp][r][seg * 8 + j] = acc[r][j];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  __syncthreads();

  // combine the warps and write the output
  __nv_bfloat16* obase = out + ((size_t)s * n_kv + kvh) * NREP * HD;
  for (int idx = threadIdx.x; idx < NREP * HD; idx += NWARPS * 32) {
    const int r = idx / HD;
    const int d = idx % HD;
    float mt = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mt = fmaxf(mt, sm_m[w][r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(sm_m[w][r] - mt);
      lt += sm_l[w][r] * c;
      at += sm_acc[w][r][d] * c;
    }
    const float l_safe = (lt == 0.f) ? 1.f : lt;
    obase[idx] = __float2bfloat16(at / l_safe);
  }
}

template <int HD>
cudaError_t launch_hd(int n_rep, dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                      const __nv_bfloat16* k, const __nv_bfloat16* v, const int* pt,
                      const int* sl, __nv_bfloat16* out, int n_kv, int page, int pps,
                      float scale) {
  const dim3 block(NWARPS * 32);
  switch (n_rep) {
    case 1: paged_decode_kernel<HD, 1><<<grid, block, 0, st>>>(q, k, v, pt, sl, out, n_kv, page, pps, scale); break;
    case 2: paged_decode_kernel<HD, 2><<<grid, block, 0, st>>>(q, k, v, pt, sl, out, n_kv, page, pps, scale); break;
    case 4: paged_decode_kernel<HD, 4><<<grid, block, 0, st>>>(q, k, v, pt, sl, out, n_kv, page, pps, scale); break;
    case 8: paged_decode_kernel<HD, 8><<<grid, block, 0, st>>>(q, k, v, pt, sl, out, n_kv, page, pps, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_bf16(const void* q, const void* k_pages, const void* v_pages,
                                 const void* page_table, const void* seq_lens, void* out,
                                 int n_slots, int n_kv, int n_rep, int hd, int page, int pps,
                                 float scale, void* stream) {
  const dim3 grid(n_kv, n_slots);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* sl = static_cast<const int*>(seq_lens);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  switch (hd) {
    case 32: err = launch_hd<32>(n_rep, grid, st, qb, kb, vb, pt, sl, ob, n_kv, page, pps, scale); break;
    case 64: err = launch_hd<64>(n_rep, grid, st, qb, kb, vb, pt, sl, ob, n_kv, page, pps, scale); break;
    case 128: err = launch_hd<128>(n_rep, grid, st, qb, kb, vb, pt, sl, ob, n_kv, page, pps, scale); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
