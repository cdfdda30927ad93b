// Paged decode attention for Hopper (sm_90a): one query token per slot,
// K/V read page by page through the slot's page table, the sequence split
// across blocks.
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
// would become the limit, so time = live KV bytes / 3.35 TB/s at best, and
// CUDA cores, not tensor cores, do the arithmetic. To reach that rate the
// card needs enough loads in flight on every SM.
//
// Design. On the TPU the grid's page axis runs in order and carries m/l/acc
// in VMEM from step to step. Hopper blocks run in no order, so the grid is
// (kv head, slot, split): each block takes one chunk of `chunk` tokens of
// its slot, so a long slot spreads over many SMs instead of queueing its
// whole sequence through one block per kv head (64 blocks for 132 SMs at 8
// slots x 8 kv heads). The split count comes from the shapes
// (ceil(pages_per_slot·page / chunk)), never from seq_lens, so the host
// never reads the device. A block whose chunk starts past q_pos exits at
// once and touches no page (the Pallas `pl.when` skip). Inside a block the
// chunk is cut into warp tiles of CH*RPL tokens; warp w takes tiles w,
// w+8, ... Each K/V row (hd bf16) is read by hd/8 lanes as 16-byte
// vectors, every lane issuing all CH of its row loads before any
// arithmetic. Each lane group keeps its own online-softmax state for the
// n_rep query rows (fp32); groups combine by shuffles, warps through shared
// memory. A block's life is short (a 256-token chunk is four warp tiles per
// warp at hd 128), so its loads, its arithmetic and its merge run one after
// another; CH 4 keeps a thread under 128 registers, and two blocks per SM
// overlap one block's loads with the other's arithmetic (at the serving
// shapes 0.0398 against 0.0456 ms for CH 8 at one block per SM, and 0.0428
// for 128-token chunks, H100 80GB HBM3 at 700 W: PERF.md).
//
// Combine, in the same launch. A slot with one live chunk writes its output
// directly. Otherwise each block writes its chunk's (m, l, acc) in fp32 to
// the workspace, fences, and takes a ticket from the (slot, kv head)
// counter; the block that draws the last of the slot's
// ceil((q_pos + 1) / chunk) tickets merges the partials (the `l == 0` guard
// kept), writes q's layout and puts the counter back to 0 for the next
// launch. One launch per call, no second pass. The workspace and counters
// belong to one stream at a time (the wrapper enforces it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const __nv_bfloat16* q;   // [S, n_kv, NREP, HD]
  const __nv_bfloat16* kp;  // [P, page, n_kv, HD]
  const __nv_bfloat16* vp;  // [P, page, n_kv, HD]
  const int* page_table;    // [S, pps]
  const int* seq_lens;      // [S]
  __nv_bfloat16* out;       // [S, n_kv, NREP, HD]
  float* partials;          // [S, n_kv, n_split, NREP * (HD + 2)]: m, l, acc per chunk
  int* counters;            // [S, n_kv], 0 between launches
  int n_kv, page, pps, chunk, n_split;
  float scale;
};

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Two blocks per SM (at most 128 registers a thread) below n_rep 8: one
// block's loads then overlap the other's arithmetic and merge. At n_rep 8
// the query rows and accumulators alone take 128 registers, so one.
template <int HD, int NREP>
__global__ void __launch_bounds__(NWARPS * 32, NREP >= 8 ? 1 : 2) paged_decode_kernel(const Params p) {
  constexpr int CH = 4;          // rows each lane loads per tile
  constexpr int LPR = HD / 8;    // lanes per KV row, 16 bytes each
  constexpr int RPL = 32 / LPR;  // rows one warp-wide load covers
  constexpr int T = CH * RPL;    // tokens per warp tile
  constexpr int PART = NREP * (HD + 2);

  __shared__ float sm_m[NWARPS][NREP];
  __shared__ float sm_l[NWARPS][NREP];
  __shared__ float sm_acc[NWARPS][NREP][HD];
  __shared__ int sm_last;

  const int kvh = blockIdx.x;
  const int s = blockIdx.y;
  const int split = blockIdx.z;
  const int span = p.pps * p.page;
  const int n_tok = min(max(p.seq_lens[s] + 1, 0), span);
  // a slot with no token still has one live chunk, which writes the l == 0 output
  const int n_live = max(1, (n_tok + p.chunk - 1) / p.chunk);
  if (split >= n_live) return;  // past q_pos: no page of this chunk is touched
  const int t_begin = split * p.chunk;
  const int t_end = min(t_begin + p.chunk, n_tok);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;  // which row of a warp-wide load this lane reads
  const int seg = lane % LPR;  // which 8-element segment of the row
  const int* pt = p.page_table + (size_t)s * p.pps;
  const size_t row_stride = (size_t)p.n_kv * HD;
  const size_t head_off = (size_t)kvh * HD + seg * 8;

  float qf[NREP][8];
  const __nv_bfloat16* qbase = p.q + ((size_t)s * p.n_kv + kvh) * NREP * HD + seg * 8;
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

  for (int t0 = t_begin + warp * T; t0 < t_end; t0 += NWARPS * T) {
    uint4 kr[CH], vr[CH];
    bool valid[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int t = t0 + i * RPL + grp;
      valid[i] = t < t_end;
      if (valid[i]) {
        const size_t off = ((size_t)pt[t / p.page] * p.page + (t % p.page)) * row_stride + head_off;
        kr[i] = *reinterpret_cast<const uint4*>(p.kp + off);
        vr[i] = *reinterpret_cast<const uint4*>(p.vp + off);
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
        sc[i][r] = valid[i] ? dot * p.scale : NEG;
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
        const float e = valid[i] ? expf(sc[i][r] - m[r]) : 0.f;
        l[r] += e;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(e, vf[j], acc[r][j]);
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

  // combine the warps: the chunk's (m, l, acc), or the output if it is the
  // slot's only live chunk
  __nv_bfloat16* obase = p.out + ((size_t)s * p.n_kv + kvh) * NREP * HD;
  float* slot_parts = p.partials + ((size_t)s * p.n_kv + kvh) * p.n_split * PART;
  float* part = slot_parts + (size_t)split * PART;
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
    if (n_live == 1) {
      const float l_safe = (lt == 0.f) ? 1.f : lt;
      obase[idx] = __float2bfloat16(at / l_safe);
    } else {
      part[2 * NREP + idx] = at;
      if (d == 0) {
        part[r] = mt;
        part[NREP + r] = lt;
      }
    }
  }
  if (n_live == 1) return;

  // the partial is visible device-wide before this block's ticket is drawn
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (size_t)s * p.n_kv + kvh;
  if (threadIdx.x == 0) sm_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  // the last block of the slot merges its n_live partials (read from L2:
  // other SMs wrote them)
  for (int idx = threadIdx.x; idx < NREP * HD; idx += NWARPS * 32) {
    const int r = idx / HD;
    float mt = NEG;
    for (int i = 0; i < n_live; ++i) mt = fmaxf(mt, __ldcg(slot_parts + (size_t)i * PART + r));
    float lt = 0.f, at = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float* pi = slot_parts + (size_t)i * PART;
      const float c = expf(__ldcg(pi + r) - mt);
      lt += __ldcg(pi + NREP + r) * c;
      at += __ldcg(pi + 2 * NREP + idx) * c;
    }
    const float l_safe = (lt == 0.f) ? 1.f : lt;
    obase[idx] = __float2bfloat16(at / l_safe);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <int HD>
cudaError_t launch_hd(int n_rep, dim3 grid, cudaStream_t st, const Params& p) {
  const dim3 block(NWARPS * 32);
  switch (n_rep) {
    case 1: paged_decode_kernel<HD, 1><<<grid, block, 0, st>>>(p); break;
    case 2: paged_decode_kernel<HD, 2><<<grid, block, 0, st>>>(p); break;
    case 4: paged_decode_kernel<HD, 4><<<grid, block, 0, st>>>(p); break;
    case 8: paged_decode_kernel<HD, 8><<<grid, block, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// partials: n_slots·n_kv·n_split·n_rep·(hd + 2) fp32; counters: n_slots·n_kv
// int32, zero before the first launch (each launch leaves them at zero)
extern "C" int paged_decode_bf16(const void* q, const void* k_pages, const void* v_pages,
                                 const void* page_table, const void* seq_lens, void* out,
                                 void* partials, void* counters, int n_slots, int n_kv, int n_rep,
                                 int hd, int page, int pps, int chunk, int n_split, float scale,
                                 void* stream) {
  if (chunk <= 0 || n_split != (pps * page + chunk - 1) / chunk) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kp = static_cast<const __nv_bfloat16*>(k_pages);
  p.vp = static_cast<const __nv_bfloat16*>(v_pages);
  p.page_table = static_cast<const int*>(page_table);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.partials = static_cast<float*>(partials);
  p.counters = static_cast<int*>(counters);
  p.n_kv = n_kv;
  p.page = page;
  p.pps = pps;
  p.chunk = chunk;
  p.n_split = n_split;
  p.scale = scale;
  const dim3 grid(n_kv, n_slots, n_split);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 32: err = launch_hd<32>(n_rep, grid, st, p); break;
    case 64: err = launch_hd<64>(n_rep, grid, st, p); break;
    case 128: err = launch_hd<128>(n_rep, grid, st, p); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
