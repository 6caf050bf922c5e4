// Flash decode over a KV slot table with the fused per-slot attention mass
// (DynamicAdaptiveClimb's hit signal), for sm_90a, plain C interface for
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_pallas: _stats_kernel, pallas_call at :136, and
// _out_kernel, pallas_call at :161), whose oracle is
// models/layers.py::decode_attention, the function the reference's serve
// step calls on every decode step.
//
//   q [B, H, D], k [B, S, Hkv, D], v [B, S, Hkv, Dv], valid [B, S] (bool)
//   ->  o [B, H, Dv] (q's type), mass [B, S] f32 = mean over the H heads of
//       softmax_s(scale * q.k masked)
//
// Masked scores are -1e30, as in the reference: a row with no valid slot
// averages uniformly over all S slots.  The softcap is applied before the
// mask.
//
// Bound on an H100: bytes.  A call must read K and V of the valid slots
// once (every slot of a row with none), q and valid, and write o and mass.
// Each K or V element takes g = H / Hkv multiply-adds (g <= 8 in the
// configs): at most 8 flops a bf16 element, 4 a byte, where the CUDA cores
// give 20 flops a byte at 3.35 TB/s (67 TFLOP/s f32), so no tensor cores:
// the design is about bytes in flight, instructions per byte, and short
// dependency chains.
//
// Design: split S across blocks, then one fixed-order combine.  Two
// kernels, one launch each.
//
// decode_attn_split, one block of 4 warps per (chunk of slots, kv head,
//   group of up to 8 query heads, batch row); the kv heads are the grid's
//   fastest axis.  The wrapper picks the chunk length
//   (kernels/decode_attention.py::chunk_len: 256 slots, halved down to 32
//   while a call would have fewer than two blocks an SM; the kernel takes
//   any multiple of 8 up to 1,024).  A block:
//   1. reads its batch row's whole valid (S bytes, in 16-byte words, from
//      L2 after the first block of the row) to learn whether the row has a
//      valid slot, and keeps its chunk's bytes in shared memory;
//   2. cuts its chunk into warp tiles of 8 slots and lists, in order, the
//      tiles to load: in a row with a valid slot those that hold one (the
//      others' scores are written as -1e30), in a row with none all of
//      them.  Warp w takes tiles w, w + 4, ... of the list;
//   3. each warp runs on its own, with no block barrier until its last
//      tile: its K and V tiles come into its own ring of three stages by
//      16-byte cp.async (two tiles in flight while one is used: 8 KB a
//      warp, 128 KB an SM at D = Dv = 128 in bf16, four blocks an SM).
//      Invalid slots of a loaded tile in a row with a valid slot are not
//      fetched (cp.async's zero-fill stands in), so the bytes read are
//      those the bound counts.  A row whose bytes are not a multiple of 16,
//      or a K or V not 16-byte aligned, is copied element by element;
//   4. scores of a tile: lane (slot sr = lane / 4, quarter sq = lane % 4)
//      over every fourth 16-byte piece of the K row, for all the block's
//      heads, then two shuffles; q (scaled) sits in shared memory; the
//      masked raw score goes to scores [B, H, S] f32;
//   5. one online-softmax update per tile and head: warp max and warp sum
//      (fixed butterfly order; each slot's p sits in four lanes, and a
//      quarter of the sum of four equal sums is exact);
//   6. o += p V: lane (piece of the V row, row group) keeps an f32
//      accumulator of 8 columns for each head, rescaled once per tile, p
//      by shuffle;
//   7. after its last tile a warp folds its row groups' accumulators by a
//      butterfly, and the block merges the four warps' (m, l, acc) in warp
//      order into its split's (m_i, l_i, acc_i), written to part
//      [B, H, n_split, Dv + 2].  A chunk with no tile to load writes
//      m_i = -1e30, l_i = 0, acc_i = 0.
//
// decode_attn_combine, blocks of 256 threads of two kinds.  Each first
//   folds the splits' (m_i, l_i) of the heads it needs in split order into
//   m = max_i m_i and l = max(sum_i e^(m_i - m) l_i, 1e-30) (a thread a
//   head, from shared memory where the block stages the pairs if they
//   fit).  An o block takes 256 / Dv heads of a batch row, a thread per
//   (head, column): o = (sum_i e^(m_i - m) acc_i) / l in split order.  A
//   mass block takes 2048 / H slots (at most 256) of a batch row: its
//   threads form p = e^(s_h - m_h) / l_h for every (slot, head) pair into
//   shared memory, then a thread a slot sums mass = (sum_h p_h) / H in
//   head order 0..H-1.
//
// A slot table split over ranks (a KV cache whose heads do not divide the
// model axis; the slots [s0, s0 + S) of rows of S_row on each rank) runs in
// two parts, the cross-slot softmax that the reference's GSPMD program does
// implicitly, each one launch:
//
// decode_attn_part (decode_attention_partial): a rank's block.  Bound:
//   bytes, the block's share of the whole call's.  What held the split
//   kernel above back at these shapes (every slot-split configuration is
//   GQA, g = 4-8) was not flops but instructions: per 8-slot tile and head,
//   shared loads of q, shuffles for the score, max and sum and for p in
//   P V, some 900 warp instructions per 4 KB of K and V at g = 8, and 8 x 8
//   f32 accumulators a lane.  So the bf16 body puts the products on the
//   tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate; the g <= 8
//   query heads of a kv head on M, padded to 16, 16-slot tiles on N of
//   S = Q K^T and on K of O += P V, P reused from S's accumulators as the A
//   operand, V through ldmatrix.trans): about 110 warp instructions per
//   4 KB by count.  mma.sync, not wgmma: wgmma wants 64 rows of M, which
//   would be slots, and would leave P in the wrong operand for P V; the
//   tensor cores are far from binding here (some 48 flops a byte with
//   the padding and hi + lo, against the ~295 a byte at which their bf16
//   peak binds), so the smaller tile costs nothing and keeps one
//   online-softmax update per tile, on the accumulator fragments (a
//   head's max over its 4 lanes: 2 shuffles; its sum kept a lane and
//   summed once at the end).  Numerics the sharded law's checks hold:
//   scale multiplies the f32 product (not a bf16 q), P enters P V as bf16
//   hi + lo (hi = bf16(p), lo = bf16(p - hi), two products: within 2^-17
//   of p, where bf16(p) alone is 2^-9 and fails the partial's 2e-5
//   check), l sums the f32 p.  f32 inputs, and bf16 rows that are not
//   multiples of 16 elements, take the CUDA-core body (16-slot tiles,
//   lane = (slot, half of the K row); no tf32); part_body states the
//   rule, and which of the two g = 1 takes.  The splits of a (kv head,
//   batch row) are one thread-block cluster (at most 8 blocks;
//   decode_attention.py::partial_split picks them; a longer chunk is
//   taken in pieces of 1,024 slots), which folds its splits' partials on
//   chip through distributed shared memory, in split order, and writes
//   part [B, H, Dv + 2] once: no second launch and no round trip of the
//   splits' partials.  A block reads its chunk's valid; only a cluster
//   whose chunks hold no valid slot reads the whole row's, a share a
//   block.  Each warp streams its 16-slot tiles through a ring of two
//   (16-byte cp.async, one tile in flight while one is used).  On an
//   H100 the stream, not the arithmetic, is what is left: a call takes
//   little more than PyTorch's own read of the same K and V, and a deeper
//   ring, more blocks than one wave, bulk copies (the TMA unit) or L2
//   prefetch and eviction hints ran no faster (PERF.md).  l is not
//   clamped: a block with no valid slot in a row that has some gives
//   m = -1e30, l = 0, acc = 0, which weighs nothing; a row with none
//   anywhere weighs every slot alike, as above.
// decode_attn_merge (decode_attention_merge): the combine with a rank axis
//   in place of the split axis, in one memory round trip a block.  An o
//   block brings its heads' N partials into shared memory at once
//   (cp.async), then a thread a (head, column) folds its head's (m, l)
//   (l clamped at 1e-30) and o = sum_r e^(m_r - m) acc_r / l in rank
//   order.  A mass block (128 slots of a batch row, about one wave at
//   qwen1.5-110b's rank) issues every head's (m, l) from each rank and its
//   slots' scores at once (three cp.async groups: the pairs, then each
//   half of the heads), a thread a head folds (m, l) in rank order once
//   the pairs are in, and a thread a slot sums its mass over the heads in
//   head order, p = 2^((s - m) log2 e) * (1 / l), each half as it lands.
//   Its bytes are the partials and the block's scores, not the cache.
//
// Nothing is summed with atomics and every sum has a fixed order, so o and
// mass (whose argmax picks the slot DAC promotes) are the same bit for bit
// from run to run.  An invalid slot beside a valid one gets p = 0 exactly:
// its score is -1e30 and the row's max is a real score.  The scores make a
// round trip through device memory (8 * H * S bytes, about 1.6% of K and V
// at deepseek-7b's shape).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 128;          // threads of a split block
constexpr int NW = NT / 32;      // its warps
constexpr int WR = 8;            // slots of a warp tile
constexpr int STAGES = 3;        // warp tiles in each warp's cp.async ring
constexpr int MAX_CHUNK = 1024;  // slots per block at most
constexpr int GMAX = 8;          // query heads per block at most
constexpr int CT = 256;          // threads of a combine block
constexpr int STAGE_MAX = 3072;  // (m_i, l_i) pairs a combine block stages
constexpr int MASS_PAIRS = 2048; // (slot, head) pairs of a mass block
constexpr int MAXD = 256;        // D, Dv <= MAXD
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte piece of shared memory as floats (4 f32 or 8 bf16)
__device__ __forceinline__ void unpack(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// 16 bytes global -> shared; fetch = false reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fetch) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(fetch ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory of a split block: the warps' K/V rings (reused at
// the end for the warps' (m, l, acc) as the block merges them), then q
// scaled, [GB][D padded].
template <typename T, int GB>
__host__ __device__ inline size_t ring_bytes(int D, int Dv) {
  constexpr int E = 16 / sizeof(T);
  const size_t dkp = (D + E - 1) / E * E, dvp = (Dv + E - 1) / E * E;
  const size_t ring = (size_t)NW * STAGES * WR * (dkp + dvp) * sizeof(T);
  const size_t merge = (size_t)NW * GB * (dvp + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}
template <typename T, int GB>
inline size_t split_smem(int D, int Dv) {
  constexpr int E = 16 / sizeof(T);
  return ring_bytes<T, GB>(D, Dv) +
         sizeof(float) * GB * ((D + E - 1) / E * E);
}

template <typename T, int GB>
__global__ void __launch_bounds__(NT, 4)
decode_attn_split(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ valid,
                  float* __restrict__ scores, float* __restrict__ part,
                  int S, int S_row, int s0, int H, int Hkv, int D, int Dv,
                  int chunk, float scale, float softcap) {
  constexpr int E = 16 / sizeof(T);         // elements per 16-byte piece
  constexpr int PPL = sizeof(T) == 4 ? 2 : 1;   // V pieces a lane, at most
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint8_t vs[MAX_CHUNK];   // the chunk's valid
  __shared__ __align__(16) uint8_t fs[MAX_CHUNK];   // its slots to fetch
  __shared__ uint8_t need[MAX_CHUNK / WR];  // warp tiles to load
  __shared__ int list[MAX_CHUNK / WR];      // ... in order
  __shared__ int n_list;

  const int g = H / Hkv, n_hg = (g + GMAX - 1) / GMAX;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int hk = blockIdx.x / n_hg, hg = blockIdx.x % n_hg;
  const int b = blockIdx.z;
  const int h0 = hk * g + hg * GMAX;        // the block's first query head
  const int gb = min(GMAX, g - hg * GMAX);  // its heads, <= GB
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int nck = (D + E - 1) / E, ncv = (Dv + E - 1) / E;
  const int dkp = nck * E, dvp = ncv * E;
  const int wt = WR * (dkp + dvp);          // elements of a warp tile
  T* ring = reinterpret_cast<T*>(smem) + warp * STAGES * wt;
  float* qs = reinterpret_cast<float*>(smem + ring_bytes<T, GB>(D, Dv));

  const int s_lo = split * chunk;
  const int clen = min(chunk, S - s_lo);
  const int nwt = (clen + WR - 1) / WR;
  const long kv_k = (long)Hkv * D, kv_v = (long)Hkv * Dv;
  const T* kb = k + ((long)b * S + s_lo) * kv_k + (long)hk * D;
  const T* vb = v + ((long)b * S + s_lo) * kv_v + (long)hk * Dv;
  const uint8_t* vrow = valid + (long)b * S_row;
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   (Dv * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  // q scaled; the whole row's valid in 16-byte words (its ragged ends byte
  // by byte); the chunk's valid bytes (at s0 + s_lo of the row), all loads
  // of a thread in flight at once
#pragma unroll 8
  for (int i = threadIdx.x; i < GB * dkp; i += NT) {
    const int h = i / dkp, d = i - h * dkp;
    qs[i] = (h < gb && d < D)
                ? to_f(q[((long)b * H + h0 + h) * D + d]) * scale
                : 0.f;
  }
  int any = 0;
  {
    const int head = min(
        S_row, (int)((16 - (reinterpret_cast<uintptr_t>(vrow) & 15)) & 15));
    const int nvec = (S_row - head) / 16;
    const uint4* body = reinterpret_cast<const uint4*>(vrow + head);
#pragma unroll 4
    for (int i = threadIdx.x; i < nvec; i += NT) {
      const uint4 w = body[i];
      any |= (w.x | w.y | w.z | w.w) != 0;
    }
    if (threadIdx.x < head) any |= vrow[threadIdx.x];
    const int tail = head + 16 * nvec + threadIdx.x;
    if (tail < S_row) any |= vrow[tail];
  }
  {
    uint8_t x[MAX_CHUNK / NT];
#pragma unroll
    for (int u = 0; u < MAX_CHUNK / NT; ++u) {
      const int r = threadIdx.x + u * NT;
      x[u] = r < clen ? vrow[s0 + s_lo + r] : 0;
    }
#pragma unroll
    for (int u = 0; u < MAX_CHUNK / NT; ++u) {
      const int r = threadIdx.x + u * NT;
      if (r < clen) vs[r] = x[u];
    }
  }
  const bool row_any = __syncthreads_or(any) != 0;

  // which slots to fetch (all in a row with no valid slot, else the valid
  // ones), which warp tiles hold one, and the list of those, in order
  for (int r = threadIdx.x; r < nwt * WR; r += NT)
    fs[r] = r < clen && (vs[r] || !row_any);
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int t0 = 0; t0 < nwt; t0 += 32) {
      const int t = t0 + lane;
      bool want = false;
      if (t < nwt) {
        const uint2 f = *reinterpret_cast<const uint2*>(fs + t * WR);
        want = (f.x | f.y) != 0;
        need[t] = want;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, want);
      if (want) list[base + __popc(bal & ((1u << lane) - 1))] = t;
      base += __popc(bal);
    }
    if (lane == 0) n_list = base;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gb * clen; i += NT) {
    const int h = i / clen, r = i - h * clen;
    if (!need[r / WR])
      scores[((long)b * H + h0 + h) * S + s_lo + r] = NEG_INF;
  }
  const int nl = n_list;
  const int my_n = nl > warp ? (nl - warp + NW - 1) / NW : 0;

  // a warp tile's rows of n 16-byte pieces (dp elements apart in shared
  // memory): piece i = lane + 32 j is (row i / n, piece i % n), stepped
  // without a division
  auto copy_rows = [&](T* dst, const T* src, long stride, int n, int dp,
                       int r0) {
    int r = lane / n, c = lane % n;
    const int dr = 32 / n, dc = 32 % n;
    while (r < WR) {
      const int s = r0 + r;
      cp_async16(dst + r * dp + c * E,
                 src + (long)min(s, clen - 1) * stride + c * E, fs[s]);
      r += dr;
      c += dc;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
  };
  auto load = [&](int j, int st) {       // this warp's j-th tile
    const int r0 = list[warp + NW * j] * WR;
    T* ks = ring + st * wt;
    T* vsm = ks + WR * dkp;
    if (vec) {
      copy_rows(ks, kb, kv_k, nck, dkp, r0);
      copy_rows(vsm, vb, kv_v, ncv, dvp, r0);
    } else {
      for (int i = lane; i < WR * dkp; i += 32) {
        const int r = i / dkp, d = i - r * dkp;
        ks[i] = fs[r0 + r] && d < D ? kb[(long)(r0 + r) * kv_k + d]
                                    : from_f<T>(0.f);
      }
      for (int i = lane; i < WR * dvp; i += 32) {
        const int r = i / dvp, d = i - r * dvp;
        vsm[i] = fs[r0 + r] && d < Dv ? vb[(long)(r0 + r) * kv_v + d]
                                      : from_f<T>(0.f);
      }
    }
  };

  // scores: lane (row sr, quarter sq) over pieces sq, sq + 4, ...
  const int sr = lane >> 2, sq = lane & 3;
  // o += p V: lane (piece pc, row group rg) over rows rg, rg + ngrp, ...
  int ncp = 4;
  while (ncp < ncv && ncp < 32) ncp <<= 1;
  const int pc = lane % ncp, rg = lane / ncp, ngrp = 32 / ncp;

  float m_run[GB], l_run[GB], acc[GB][PPL * E];
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    m_run[h] = NEG_INF;
    l_run[h] = 0.f;
#pragma unroll
    for (int e = 0; e < PPL * E; ++e) acc[h][e] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < my_n) load(st, st);
    cp_async_commit();
  }
  for (int j = 0; j < my_n; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();      // tile j is in; every lane is done with tile j - 1
    if (j + STAGES - 1 < my_n)
      load(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const T* ks = ring + (j % STAGES) * wt;
    const T* vsm = ks + WR * dkp;
    const int r0 = list[warp + NW * j] * WR;

    float dot[GB];
#pragma unroll
    for (int h = 0; h < GB; ++h) dot[h] = 0.f;
    for (int c = sq; c < nck; c += 4) {
      float x[E];
      unpack(ks + sr * dkp + c * E, x);
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        float qv[E];
#pragma unroll
        for (int e = 0; e < E; e += 4)
          unpack(qs + h * dkp + c * E + e, qv + e);
#pragma unroll
        for (int e = 0; e < E; ++e) dot[h] = fmaf(qv[e], x[e], dot[h]);
      }
    }
    const int s = r0 + sr;             // the lane's slot in the chunk
    const bool in = s < clen, ok = in && vs[s];
    float p[GB];
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      float x = dot[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x = in ? (ok ? x : NEG_INF) : -INFINITY;
      if (h < gb && sq == 0 && in)
        scores[((long)b * H + h0 + h) * S + s_lo + s] = x;
      // one online-softmax update for the tile's 8 slots (each 4 lanes)
      const float m_new = fmaxf(m_run[h], warp_max(x));
      const float a = expf(m_run[h] - m_new);
      p[h] = expf(x - m_new);
      l_run[h] = l_run[h] * a + warp_sum(p[h]) * 0.25f;
      m_run[h] = m_new;
#pragma unroll
      for (int e = 0; e < PPL * E; ++e) acc[h][e] *= a;
    }
    for (int rr = rg; rr < WR; rr += ngrp) {
      float pr[GB];
#pragma unroll
      for (int h = 0; h < GB; ++h)
        pr[h] = __shfl_sync(0xffffffffu, p[h], rr * 4);
#pragma unroll
      for (int u = 0; u < PPL; ++u) {
        const int c = pc + 32 * u;
        if (c < ncv) {
          float x[E];
          unpack(vsm + rr * dvp + c * E, x);
#pragma unroll
          for (int h = 0; h < GB; ++h)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[h][u * E + e] = fmaf(pr[h], x[e], acc[h][u * E + e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // the row groups' accumulators, by a butterfly (the same bits in every
  // lane of a piece)
  for (int off = ncp; off < 32; off <<= 1)
#pragma unroll
    for (int h = 0; h < GB; ++h)
#pragma unroll
      for (int e = 0; e < PPL * E; ++e)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
  __syncthreads();     // every warp is done with its ring

  // the warps' (m, l, acc), merged in warp order into the block's split
  float* mg = reinterpret_cast<float*>(smem);    // [NW][GB][dvp + 2]
  const int mw = dvp + 2;
  float* mine = mg + warp * GB * mw;
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    if (rg == 0)
#pragma unroll
      for (int u = 0; u < PPL; ++u) {
        const int c = pc + 32 * u;
        if (c < ncv)
#pragma unroll
          for (int e = 0; e < E; ++e)
            mine[h * mw + c * E + e] = acc[h][u * E + e];
      }
    if (lane == 0) {
      mine[h * mw + dvp] = m_run[h];
      mine[h * mw + dvp + 1] = l_run[h];
    }
  }
  __syncthreads();
  // part's columns: acc in 0..Dv-1, then m, then l
  const long P = Dv + 2;
  for (int i = threadIdx.x; i < gb * (Dv + 2); i += NT) {
    const int h = i / (Dv + 2), d = i - h * (Dv + 2);
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, mg[(w * GB + h) * mw + dvp]);
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* mw_h = mg + (w * GB + h) * mw;
      const float wgt = expf(mw_h[dvp] - m);
      x += wgt * (d < Dv ? mw_h[d] : mw_h[dvp + 1]);
    }
    part[(((long)b * H + h0 + h) * n_split + split) * P + d] =
        d == Dv ? m : x;
  }
}

// (m, l) of one head's splits, m_i at ml[i * stride] and l_i next to it:
// m = max_i m_i, l = max(sum_i e^(m_i - m) l_i, 1e-30), in split order
__device__ __forceinline__ float2 fold(const float* ml, long stride, int n) {
  float m = NEG_INF;
#pragma unroll 8
  for (int i = 0; i < n; ++i) m = fmaxf(m, ml[i * stride]);
  float l = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i)
    l += expf(ml[i * stride] - m) * ml[i * stride + 1];
  return make_float2(m, fmaxf(l, 1e-30f));
}

// (m, l) of nh consecutive heads (pb: the first one's splits) into mh, lh:
// the block first stages the splits' (m_i, l_i) in st when they fit, then
// a thread a head folds them
__device__ void fold_heads(const float* pb, long P, int Dv, int n_split,
                           int nh, float* st, float* mh, float* lh) {
  const bool staged = nh * n_split <= STAGE_MAX;
  if (staged) {
#pragma unroll 4
    for (int i = threadIdx.x; i < nh * n_split; i += CT) {
      st[2 * i] = pb[i * P + Dv];
      st[2 * i + 1] = pb[i * P + Dv + 1];
    }
    __syncthreads();
  }
  for (int h = threadIdx.x; h < nh; h += CT) {
    const float2 ml = staged ? fold(st + 2 * h * n_split, 2, n_split)
                             : fold(pb + h * n_split * P + Dv, P, n_split);
    mh[h] = ml.x;
    lh[h] = ml.y;
  }
  __syncthreads();
}

// heads of one o block, slots of one mass block
__host__ __device__ inline int o_heads(int Dv) {
  return CT / Dv > 1 ? CT / Dv : 1;
}
__host__ __device__ inline int mass_slots(int H) {
  const int n = MASS_PAIRS / H;
  return n < 1 ? 1 : (n > CT ? CT : n);
}
inline size_t combine_smem(int H, int Dv) {
  const int hb = o_heads(Dv), ms = mass_slots(H);
  const size_t o_blk = 2 * hb, m_blk = 2 * H + (size_t)ms * (H + 1);
  return sizeof(float) * (2 * STAGE_MAX + (o_blk > m_blk ? o_blk : m_blk));
}

// blocks [0, n_o): o for o_heads(Dv) heads of a batch row, a thread per
// (head, column); then a block per mass_slots(H) slots of a batch row
template <typename T>
__global__ void __launch_bounds__(CT)
decode_attn_combine(const float* __restrict__ part,
                    const float* __restrict__ scores, T* __restrict__ o,
                    float* __restrict__ mass, int B, int S, int H, int Dv,
                    int n_split) {
  extern __shared__ float sm[];
  float* st = sm;                      // staged (m_i, l_i), [2 * STAGE_MAX]
  float* mh = sm + 2 * STAGE_MAX;      // then m, l per head
  const long P = Dv + 2;
  const int hb = o_heads(Dv), per_b = (H + hb - 1) / hb;
  if ((int)blockIdx.x < B * per_b) {
    const int b = blockIdx.x / per_b, h0 = (blockIdx.x % per_b) * hb;
    const int nh = min(hb, H - h0);
    float* lh = mh + hb;
    const float* pb = part + ((long)b * H + h0) * n_split * P;
    fold_heads(pb, P, Dv, n_split, nh, st, mh, lh);
    for (int i = threadIdx.x; i < nh * Dv; i += CT) {
      const int h = i / Dv, d = i - h * Dv;
      const float* ph = pb + (long)h * n_split * P;
      float x = 0.f;
#pragma unroll 8
      for (int j = 0; j < n_split; ++j)
        x = fmaf(expf(ph[j * P + Dv] - mh[h]), ph[j * P + d], x);
      o[((long)b * H + h0 + h) * Dv + d] = from_f<T>(x / lh[h]);
    }
    return;
  }
  const int ms = mass_slots(H), nmb = (S + ms - 1) / ms;
  const int blk = blockIdx.x - B * per_b, b = blk / nmb;
  const int s0 = (blk - b * nmb) * ms, ns = min(ms, S - s0);
  float* lh = mh + H;
  float* p = lh + H;                   // [ms][H + 1]: p per slot and head
  fold_heads(part + (long)b * H * n_split * P, P, Dv, n_split, H, st, mh, lh);
  const float* sb = scores + (long)b * H * S + s0;
#pragma unroll 4
  for (int i = threadIdx.x; i < ns * H; i += CT) {
    const int h = i / ns, r = i - h * ns;
    p[r * (H + 1) + h] = expf(sb[(long)h * S + r] - mh[h]) / lh[h];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < ns; r += CT) {
    float x = 0.f;
    for (int h = 0; h < H; ++h) x += p[r * (H + 1) + h];
    mass[(long)b * S + s0 + r] = x / (float)H;
  }
}

// ---------------------------------------------------------------------------
// B3 over a rank's block of a slot table (decode_attention_partial): one
// launch, the splits of a (batch row, kv head) in one thread-block cluster.
// ---------------------------------------------------------------------------

constexpr int PT = 128;          // threads of a partial block, at most
constexpr int PR = 16;           // slots of a partial warp tile
constexpr int PSTAGES = 2;       // warp tiles in each warp's cp.async ring
constexpr int PIECE = 1024;      // slots a partial block stages at a time
constexpr int MAX_CLUSTER = 8;   // splits of a cluster (the portable size)
constexpr int PH = 8;            // query heads of a partial block
constexpr int MAX_DYN = 220 * 1024;  // dynamic shared bytes a block, at most

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// whether this block's threads find a nonzero byte among n at p (16-byte
// words, the ragged ends byte by byte)
__device__ __forceinline__ int any_in(const uint8_t* p, int n) {
  if (n <= 0) return 0;
  int any = 0;
  const int head =
      min(n, (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  const int nvec = (n - head) / 16;
  const uint4* body = reinterpret_cast<const uint4*>(p + head);
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 w = body[i];
    any |= (w.x | w.y | w.z | w.w) != 0;
  }
  if ((int)threadIdx.x < head) any |= p[threadIdx.x];
  const int tail = head + 16 * nvec + threadIdx.x;
  if (tail < n) any |= p[tail];
  return any;
}

// four 8x8 b16 matrices from shared memory (lane i gives row i % 8 of
// matrix i / 8), as they are or transposed
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// c += a b on the tensor cores: a 16x16 (row), b 16x8 (col) bf16, c f32
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two columns of p as bf16 words hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// a partial block's row widths: 16-byte pieces of a K and a V row, K's
// row padded to whole pieces, and the rows' strides in a ring tile (one
// piece more, so that ldmatrix's eight rows fall in distinct banks)
struct Dims {
  int D, Dv, nck, ncv, dkp, kst, vst;
};
// a tile body's view of its piece: the piece's valid bytes, the block's
// first head's scores at the piece's first slot (heads S apart), the
// piece's slots and the block's heads, and whether two slots' scores go
// in one 8-byte store
struct Tile {
  const uint8_t* vs;
  float* sc;
  long S;
  int plen, gb;
  float scale, softcap;
  bool pairs;    // sc 8-byte aligned at even slots (S even)
};

// the scaled, capped and masked score of slot r of the piece: -1e30 where
// not valid (softcap first), -inf past the piece's end
__device__ __forceinline__ float mask_score(float x, int r, const Tile& t) {
  x *= t.scale;
  if (t.softcap > 0.f) x = tanhf(x / t.softcap) * t.softcap;
  return r < t.plen ? (t.vs[r] ? x : NEG_INF) : -INFINITY;
}

// The tensor-core body (bf16; D and Dv multiples of 16, at most C): the
// block's up to 8 heads on rows 0-7 of M of mma.m16n8k16 (rows 8-15 zero),
// a tile's 16 slots on N of S = Q K^T (K's rows by ldmatrix) and on K of
// O += P V (V's rows by ldmatrix.trans), P taken from S's accumulators as
// the A operand.  Lane (g = lane / 4, t = lane % 4) holds head g's scores
// of slots 2t, 2t + 1, 8 + 2t, 9 + 2t and its O columns 8n + 2t, 8n + 2t + 1.
template <int C>
struct MmaBody {
  static constexpr bool MMA = true;
  static constexpr int KD = C / 16, NV = C / 8;
  uint32_t qa[KD][2];  // A fragments of q, rows 0-7 (k 2t.. and 8 + 2t..)
  float o[NV][4];
  float m, l;          // head g's running max, this lane's share of its sum

  __device__ void init(const __nv_bfloat16* q, int D, int gb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = ks * 16 + 8 * i + 2 * t;
        qa[ks][i] = g < gb && col < D ? qw[(g * D + col) / 2] : 0u;
      }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    m = NEG_INF;
    l = 0.f;
  }

  __device__ void tile(const __nv_bfloat16* ks, const __nv_bfloat16* vsm,
                       const Dims& dm, int r0, const Tile& tc) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int mi = lane >> 3, mr = lane & 7;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      if (kk * 16 < dm.D) {
        uint32_t b[4];
        ldsm4(b, ks + ((mi >> 1) * 8 + mr) * dm.kst + kk * 16 + (mi & 1) * 8);
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma16816(s[0], a, b[0], b[1]);
        mma16816(s[1], a, b[2], b[3]);
      }
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)     // slot 8 (i / 2) + 2t + i % 2
      x[i] = mask_score(s[i >> 1][i & 1], r0 + 8 * (i >> 1) + 2 * t + (i & 1),
                        tc);
    if (g < tc.gb)                  // the raw scores, a pair a store
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + 8 * j + 2 * t;
        float* dst = tc.sc + g * tc.S + r;
        if (r + 1 < tc.plen && tc.pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(x[2 * j], x[2 * j + 1]);
        } else {
          if (r < tc.plen) dst[0] = x[2 * j];
          if (r + 1 < tc.plen) dst[1] = x[2 * j + 1];
        }
      }
    // one online-softmax update for the tile's 16 slots: the row's max
    // over its four lanes, this lane's share of the sum
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float a = expf(m - m_new);
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = expf(x[i] - m_new);
    l = l * a + ((p[0] + p[1]) + (p[2] + p[3]));
    m = m_new;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      o[n][0] *= a;
      o[n][1] *= a;
    }
    // P as bf16 hi + lo, two products: P V within 2^-17 of f32's
    uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
    split_bf16(p[0], p[1], hi[0], lo[0]);
    split_bf16(p[2], p[3], hi[2], lo[2]);
#pragma unroll
    for (int c = 0; c < NV / 2; ++c)
      if (c * 16 < dm.Dv) {
        uint32_t b[4];
        ldsm4t(b, vsm + ((mi & 1) * 8 + mr) * dm.vst + c * 16 + (mi >> 1) * 8);
        mma16816(o[2 * c], hi, b[0], b[1]);
        mma16816(o[2 * c], lo, b[0], b[1]);
        mma16816(o[2 * c + 1], hi, b[2], b[3]);
        mma16816(o[2 * c + 1], lo, b[2], b[3]);
      }
  }

  // the warp's (acc, m, l) of its heads into mine [PH][Dv + 2]
  __device__ void store(float* mine, const Dims& dm, int gb) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int P = dm.Dv + 2;
    float lt = l + __shfl_xor_sync(0xffffffffu, l, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (g >= gb) return;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      if (n * 8 < dm.Dv) {
        mine[g * P + n * 8 + 2 * t] = o[n][0];
        mine[g * P + n * 8 + 2 * t + 1] = o[n][1];
      }
    if (t == 0) {
      mine[g * P + dm.Dv] = m;
      mine[g * P + dm.Dv + 1] = lt;
    }
  }
};

// The CUDA-core body (f32, and bf16 rows the tensor cores do not take):
// lane (slot sr = lane / 2, half sq = lane % 2) forms the block's heads'
// scores over every other 16-byte piece of the K row (q from shared
// memory), one online-softmax update a tile and head, then o += p V with
// lane (piece pc, row group rg) keeping E columns a piece and head.
template <typename T, int GB>
struct CoreBody {
  static constexpr bool MMA = false;
  static constexpr int E = 16 / sizeof(T), PPL = sizeof(T) == 4 ? 2 : 1;
  float m[GB], l[GB], acc[GB][PPL * E];
  const float* qs;     // q [PH][dkp] f32

  __device__ void init(const float* q_smem) {
    qs = q_smem;
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < PPL * E; ++e) acc[h][e] = 0.f;
    }
  }

  __device__ static int pieces_pow2(int ncv) {
    int ncp = 4;
    while (ncp < ncv && ncp < 32) ncp <<= 1;
    return ncp;
  }

  __device__ void tile(const T* ks, const T* vsm, const Dims& dm, int r0,
                       const Tile& tc) {
    const int lane = threadIdx.x & 31, sr = lane >> 1, sq = lane & 1;
    const int ncp = pieces_pow2(dm.ncv);
    const int pc = lane % ncp, rg = lane / ncp, ngrp = 32 / ncp;
    float dot[GB];
#pragma unroll
    for (int h = 0; h < GB; ++h) dot[h] = 0.f;
    for (int c = sq; c < dm.nck; c += 2) {
      float x[E];
      unpack(ks + sr * dm.kst + c * E, x);
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        float qv[E];
#pragma unroll
        for (int e = 0; e < E; e += 4)
          unpack(qs + h * dm.dkp + c * E + e, qv + e);
#pragma unroll
        for (int e = 0; e < E; ++e) dot[h] = fmaf(qv[e], x[e], dot[h]);
      }
    }
    const int r = r0 + sr;
    float p[GB];
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      float x = dot[h] + __shfl_xor_sync(0xffffffffu, dot[h], 1);
      x = mask_score(x, r, tc);
      if (h < tc.gb && sq == 0 && r < tc.plen) tc.sc[h * tc.S + r] = x;
      const float m_new = fmaxf(m[h], warp_max(x));
      const float a = expf(m[h] - m_new);
      p[h] = expf(x - m_new);
      l[h] = l[h] * a + (sq == 0 ? p[h] : 0.f);
      m[h] = m_new;
#pragma unroll
      for (int e = 0; e < PPL * E; ++e) acc[h][e] *= a;
    }
    for (int rr = rg; rr < PR; rr += ngrp) {
      float pr[GB];
#pragma unroll
      for (int h = 0; h < GB; ++h)
        pr[h] = __shfl_sync(0xffffffffu, p[h], rr * 2);
#pragma unroll
      for (int u = 0; u < PPL; ++u) {
        const int c = pc + 32 * u;
        if (c < dm.ncv) {
          float x[E];
          unpack(vsm + rr * dm.vst + c * E, x);
#pragma unroll
          for (int h = 0; h < GB; ++h)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[h][u * E + e] = fmaf(pr[h], x[e], acc[h][u * E + e]);
        }
      }
    }
  }

  __device__ void store(float* mine, const Dims& dm, int gb) {
    const int lane = threadIdx.x & 31, ncp = pieces_pow2(dm.ncv);
    const int pc = lane % ncp, rg = lane / ncp, P = dm.Dv + 2;
    for (int off = ncp; off < 32; off <<= 1)
#pragma unroll
      for (int h = 0; h < GB; ++h)
#pragma unroll
        for (int e = 0; e < PPL * E; ++e)
          acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      const float lt = warp_sum(l[h]);
      if (h >= gb) continue;
      if (rg == 0)
#pragma unroll
        for (int u = 0; u < PPL; ++u) {
          const int c = pc + 32 * u;
          if (c < dm.ncv)
#pragma unroll
            for (int e = 0; e < E; ++e)
              if (c * E + e < dm.Dv) mine[h * P + c * E + e] = acc[h][u * E + e];
        }
      if (lane == 0) {
        mine[h * P + dm.Dv] = m[h];
        mine[h * P + dm.Dv + 1] = lt;
      }
    }
  }
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline Dims part_dims(int D, int Dv, int E) {
  Dims dm;
  dm.D = D;
  dm.Dv = Dv;
  dm.nck = (D + E - 1) / E;
  dm.ncv = (Dv + E - 1) / E;
  dm.dkp = dm.nck * E;
  dm.kst = dm.dkp + E;
  dm.vst = dm.ncv * E + E;
  return dm;
}
// Dynamic shared memory of a partial block of nw warps: the warps' K/V
// rings, reused at the end for the warps' (acc, m, l) [nw][PH][Dv + 2] and
// then the block's partial [PH][Dv + 2]; after them, for the CUDA-core
// body, q [PH][dkp] f32.
__host__ __device__ inline size_t part_merge_bytes(int nw, int Dv) {
  return align16((size_t)nw * PH * (Dv + 2) * sizeof(float));
}
__host__ __device__ inline size_t part_q_offset(int nw, int D, int Dv,
                                                size_t elem) {
  const Dims dm = part_dims(D, Dv, (int)(16 / elem));
  const size_t ring = (size_t)nw * PSTAGES * PR * (dm.kst + dm.vst) * elem;
  const size_t epi = part_merge_bytes(nw, Dv) +
                     align16(sizeof(float) * PH * (Dv + 2));
  return align16(ring > epi ? ring : epi);
}
inline size_t part_smem(int nw, int D, int Dv, size_t elem, bool core) {
  const Dims dm = part_dims(D, Dv, (int)(16 / elem));
  return part_q_offset(nw, D, Dv, elem) +
         (core ? sizeof(float) * PH * dm.dkp : 0);
}

// One block per (split, group of up to PH query heads of a kv head, batch
// row); the splits of a (kv head, group, row) are one cluster (grid x =
// the cluster's size), each taking `chunk` slots of the block [s0, s0 + S)
// of rows of S_row slots, in pieces of PIECE.  A block:
//   1. learns whether its chunk holds a valid slot; if not, whether the
//      cluster's chunks do (their flags, through distributed shared
//      memory); if not, whether the whole row does (a share of it read by
//      each block of the cluster);
//   2. for each piece: its valid bytes and slots to fetch (the valid ones,
//      all in a row with none) into shared memory, the list of its 16-slot
//      tiles that hold one to fetch (the others' scores -1e30), tile w,
//      w + nw, ... of the list to warp w, each warp streaming its tiles
//      through its own ring of 16-byte cp.async (zero-fill for the slots
//      not fetched) into its body;
//   3. merges its warps' (acc, m, l) in warp order into its split's,
//      in shared memory; after a cluster barrier, the cluster's threads fold
//      the splits' partials in split order (each thread some columns, read
//      through distributed shared memory) and write part [B, H, Dv + 2]
//      once; a last barrier keeps every block's partial until it is read.
template <typename T, class Body>
__global__ void __launch_bounds__(PT)
decode_attn_part(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ valid,
                 float* __restrict__ scores, float* __restrict__ out, int S,
                 int S_row, int s0, int H, int Hkv, int D, int Dv, int chunk,
                 float scale, float softcap) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint8_t vs[PIECE];   // the piece's valid
  __shared__ __align__(16) uint8_t fs[PIECE];   // its slots to fetch
  __shared__ uint8_t need[PIECE / PR];          // its tiles to load
  __shared__ int list[PIECE / PR];              // ... in order
  __shared__ int n_list, flag[2];

  cg::cluster_group cl = cg::this_cluster();
  const int split = blockIdx.x, n_split = gridDim.x;
  const int g = H / Hkv, n_hg = (g + PH - 1) / PH;
  const int hk = blockIdx.y / n_hg, hg = blockIdx.y % n_hg, b = blockIdx.z;
  const int h0 = hk * g + hg * PH, gb = min(PH, g - hg * PH);
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = Dv + 2;
  const Dims dm = part_dims(D, Dv, E);
  const int wt = PR * (dm.kst + dm.vst);
  T* ring = reinterpret_cast<T*>(smem) + warp * PSTAGES * wt;
  float* mg = reinterpret_cast<float*>(smem);   // [nw][PH][P], at the end
  float* blk = reinterpret_cast<float*>(smem + part_merge_bytes(nw, Dv));
  float* qs = reinterpret_cast<float*>(
      smem + part_q_offset(nw, D, Dv, sizeof(T)));   // [PH][dkp]

  const int s_lo = split * chunk, clen = max(0, min(chunk, S - s_lo));
  const long kv_k = (long)Hkv * D, kv_v = (long)Hkv * Dv;
  const T* kb = k + ((long)b * S + s_lo) * kv_k + (long)hk * D;
  const T* vb = v + ((long)b * S + s_lo) * kv_v + (long)hk * Dv;
  const uint8_t* vrow = valid + (long)b * S_row;
  const uint8_t* vblk = vrow + s0 + s_lo;
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   (Dv * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  Body body;
  if constexpr (Body::MMA) {
    body.init(q + ((long)b * H + h0) * D, D, gb);
  } else {
    for (int i = threadIdx.x; i < PH * dm.dkp; i += blockDim.x) {
      const int h = i / dm.dkp, d = i - h * dm.dkp;
      qs[i] = h < gb && d < D ? to_f(q[((long)b * H + h0 + h) * D + d]) : 0.f;
    }
    body.init(qs);
  }

  // 1. whether the row has a valid slot: the chunk (its first piece's
  //    bytes kept), else the cluster's chunks, else the whole row, read
  //    once by the cluster
  int any0 = 0;
  {
    const int plen = min(PIECE, clen);
    for (int r = threadIdx.x; r < (plen + PR - 1) / PR * PR; r += blockDim.x) {
      const uint8_t x = r < plen ? vblk[r] : 0;
      vs[r] = x;
      any0 |= x;
    }
    any0 |= any_in(vblk + PIECE, clen - PIECE);
  }
  const bool chunk_any = __syncthreads_or(any0) != 0;
  if (threadIdx.x == 0) flag[0] = chunk_any;
  cluster_arrive();
  bool row_any = chunk_any, waited = false;
  if (!chunk_any) {
    cluster_wait();
    waited = true;
    int any = 0;
    for (int r = 0; r < n_split; ++r) any |= *cl.map_shared_rank(flag, r);
    if (!any) {     // the same in every block of the cluster
      const int per = (S_row + n_split - 1) / n_split;
      const int lo = min(S_row, split * per);
      const int mine = __syncthreads_or(any_in(vrow + lo, min(per, S_row - lo)));
      if (threadIdx.x == 0) flag[1] = mine;
      cluster_arrive();
      cluster_wait();
      for (int r = 0; r < n_split; ++r)
        any |= *cl.map_shared_rank(flag + 1, r);
    }
    row_any = any != 0;
  }

  // 2. the pieces
  const Tile base{vs, scores + ((long)b * H + h0) * S + s_lo, S, 0, gb,
                  scale, softcap,
                  S % 2 == 0 && (reinterpret_cast<uintptr_t>(scores) & 7) == 0};
  for (int p_lo = 0; p_lo < clen; p_lo += PIECE) {
    const int plen = min(PIECE, clen - p_lo), nt = (plen + PR - 1) / PR;
    for (int r = threadIdx.x; r < nt * PR; r += blockDim.x) {
      const uint8_t x = p_lo == 0 ? vs[r] : r < plen ? vblk[p_lo + r] : 0;
      vs[r] = x;
      fs[r] = r < plen && (x || !row_any);
    }
    __syncthreads();
    if (warp == 0) {
      int nl = 0;
      for (int t0 = 0; t0 < nt; t0 += 32) {
        const int t = t0 + lane;
        bool want = false;
        if (t < nt) {
          const uint4 f = *reinterpret_cast<const uint4*>(fs + t * PR);
          want = (f.x | f.y | f.z | f.w) != 0;
          need[t] = want;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, want);
        if (want) list[nl + __popc(bal & ((1u << lane) - 1))] = t;
        nl += __popc(bal);
      }
      if (lane == 0) n_list = nl;
    }
    __syncthreads();
    Tile tc = base;
    tc.sc += p_lo;
    tc.plen = plen;
    for (int i = threadIdx.x; i < gb * plen; i += blockDim.x) {
      const int h = i / plen, r = i - h * plen;
      if (!need[r / PR]) tc.sc[h * (long)S + r] = NEG_INF;
    }
    const int nl = n_list;
    const int my_n = nl > warp ? (nl - warp + nw - 1) / nw : 0;
    const T* kp = kb + (long)p_lo * kv_k;
    const T* vp = vb + (long)p_lo * kv_v;
    // a tile's rows of n 16-byte pieces (stride dp elements in shared
    // memory): piece i = lane + 32 j is (row i / n, piece i % n)
    auto copy_rows = [&](T* dst, const T* src, long stride, int n, int dp,
                         int r0) {
      int r = lane / n, c = lane % n;
      const int dr = 32 / n, dc = 32 % n;
      while (r < PR) {
        const int s = r0 + r;
        cp_async16(dst + r * dp + c * E,
                   src + (long)min(s, plen - 1) * stride + c * E, fs[s]);
        r += dr;
        c += dc;
        if (c >= n) {
          c -= n;
          ++r;
        }
      }
    };
    auto load = [&](int j, int st) {       // this warp's j-th tile
      const int r0 = list[warp + nw * j] * PR;
      T* ks = ring + st * wt;
      T* vsm = ks + PR * dm.kst;
      if (vec) {
        copy_rows(ks, kp, kv_k, dm.nck, dm.kst, r0);
        copy_rows(vsm, vp, kv_v, dm.ncv, dm.vst, r0);
      } else {
        for (int i = lane; i < PR * dm.dkp; i += 32) {
          const int r = i / dm.dkp, d = i - r * dm.dkp;
          ks[r * dm.kst + d] = fs[r0 + r] && d < D
                                   ? kp[(long)(r0 + r) * kv_k + d]
                                   : from_f<T>(0.f);
        }
        for (int i = lane; i < PR * dm.ncv * E; i += 32) {
          const int r = i / (dm.ncv * E), d = i - r * (dm.ncv * E);
          vsm[r * dm.vst + d] = fs[r0 + r] && d < Dv
                                    ? vp[(long)(r0 + r) * kv_v + d]
                                    : from_f<T>(0.f);
        }
      }
    };
#pragma unroll
    for (int st = 0; st < PSTAGES - 1; ++st) {
      if (st < my_n) load(st, st);
      cp_async_commit();
    }
    for (int j = 0; j < my_n; ++j) {
      cp_async_wait<PSTAGES - 2>();
      __syncwarp();    // tile j is in; every lane is done with tile j - 1
      if (j + PSTAGES - 1 < my_n)
        load(j + PSTAGES - 1, (j + PSTAGES - 1) % PSTAGES);
      cp_async_commit();
      const T* ks = ring + (j % PSTAGES) * wt;
      body.tile(ks, ks + PR * dm.kst, dm, list[warp + nw * j] * PR, tc);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring and the piece's arrays are free
  }

  // 3. the warps' partials merged in warp order into the block's, then the
  //    cluster's blocks folded in split order
  body.store(mg + warp * PH * P, dm, gb);
  __syncthreads();
  for (int i = threadIdx.x; i < gb * P; i += blockDim.x) {
    const int h = i / P, d = i - h * P, c = d < Dv ? d : Dv + 1;
    float m = NEG_INF;
    for (int w = 0; w < nw; ++w) m = fmaxf(m, mg[(w * PH + h) * P + Dv]);
    float x = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* mw = mg + (w * PH + h) * P;
      x += expf(mw[Dv] - m) * mw[c];
    }
    blk[h * P + d] = d == Dv ? m : x;
  }
  if (!waited) cluster_wait();
  cluster_arrive();
  cluster_wait();      // every split's partial is in its block
  for (int i = split * blockDim.x + threadIdx.x; i < gb * P;
       i += n_split * blockDim.x) {
    const int h = i / P, d = i - h * P, c = d < Dv ? d : Dv + 1;
    float mr[MAX_CLUSTER], xr[MAX_CLUSTER];   // every split's, loads at once
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < n_split) {
        const float* br = cl.map_shared_rank(blk, r) + h * P;
        mr[r] = br[Dv];
        xr[r] = br[c];
      }
    float m = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < n_split) m = fmaxf(m, mr[r]);
    float x = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < n_split) x = fmaf(expf(mr[r] - m), xr[r], x);
    out[((long)b * H + h0 + h) * P + d] = d == Dv ? m : x;
  }
  cluster_arrive();
  cluster_wait();      // no block leaves while its partial is read
}

// ---------------------------------------------------------------------------
// The merge over ranks (decode_attention_merge): one launch, one memory
// round trip a block.
// ---------------------------------------------------------------------------

constexpr int MT = 128;          // threads of a merge block
constexpr int MS = MT;           // slots of a mass block: one a thread
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
}

// heads of an o block; its shared bytes; a mass block's
__host__ __device__ inline int merge_o_heads(int Dv) {
  return MT / Dv > 1 ? MT / Dv : 1;
}
inline size_t merge_o_smem(int N, int Dv) {
  return sizeof(float) * N * merge_o_heads(Dv) * (Dv + 2);
}
__host__ __device__ inline int merge_st(int N, int H) {  // 16-byte aligned
  return (2 * N * H + 3) / 4 * 4;
}
inline size_t merge_mass_smem(int N, int H) {
  return sizeof(float) * (merge_st(N, H) + (size_t)H * MS + 2 * H);
}

// Blocks [0, B * ceil(Hn / hb)): o of hb = merge_o_heads(Dv) of the Hn
// heads of parts [N, B, Hn, Dv + 2] for a batch row: the block's N x hb
// partials come into shared memory by cp.async at once, then a thread per
// (head, column) folds its head's (m, l) over the ranks and its column,
// o = (sum_r e^(m_r - m) acc_r) / max(sum_r e^(m_r - m) l_r, 1e-30) in
// rank order.  Then, with scores, a block per MS slots of a batch row of
// one block's raw scores [B, H, S]: every head's (m, l) from each rank (ml
// [N, B, H, 2]) and the block's scores [H][MS] come in at once (cp.async,
// 16-byte words where the rows allow), a thread a head folds its (m, l)
// in rank order, then a thread a slot sums mass = (sum_h e^(s_h - m_h) /
// l_h) / H in head order.
template <typename T>
__global__ void __launch_bounds__(MT)
decode_attn_merge(const float* __restrict__ parts,
                  const float* __restrict__ ml,
                  const float* __restrict__ scores, T* __restrict__ o,
                  float* __restrict__ mass, int N, int B, int Hn, int H,
                  int S, int Dv) {
  extern __shared__ __align__(16) float sm[];
  const int P = Dv + 2;
  const int hb = merge_o_heads(Dv), per_b = (Hn + hb - 1) / hb;
  if ((int)blockIdx.x < B * per_b) {
    const int b = blockIdx.x / per_b, h0 = (blockIdx.x % per_b) * hb;
    const int nh = min(hb, Hn - h0), w = nh * P;   // floats of a rank
    for (int i = threadIdx.x; i < N * w; i += MT) {
      const int r = i / w, j = i - r * w;
      cp_async_ca(sm + i, parts + ((long)(r * B + b) * Hn + h0) * P + j, 4);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < nh * Dv; i += MT) {
      const int h = i / Dv, d = i - h * Dv;
      const float* ph = sm + h * P;
      float m = NEG_INF;
      for (int r = 0; r < N; ++r) m = fmaxf(m, ph[r * w + Dv]);
      float l = 0.f, x = 0.f;
      for (int r = 0; r < N; ++r) {
        const float e = expf(ph[r * w + Dv] - m);
        l += e * ph[r * w + Dv + 1];
        x = fmaf(e, ph[r * w + d], x);
      }
      o[((long)b * Hn + h0 + h) * Dv + d] = from_f<T>(x / fmaxf(l, 1e-30f));
    }
    return;
  }
  const int nmb = (S + MS - 1) / MS;
  const int blk = blockIdx.x - B * per_b, b = blk / nmb;
  const int s_lo = (blk - b * nmb) * MS, ns = min(MS, S - s_lo);
  float* mlp = sm;                    // [N][H] (m, l)
  float* st = sm + merge_st(N, H);    // [H][MS] the block's scores
  float* mh = st + H * MS;            // m, l per head
  float* lh = mh + H;
  for (int i = threadIdx.x; i < N * H; i += MT) {
    const int r = i / H, h = i - r * H;
    cp_async_ca(mlp + 2 * i, ml + ((long)(r * B + b) * H + h) * 2, 8);
  }
  cp_async_commit();
  // the scores of heads [h0, h1), 16-byte words where the rows allow
  const float* sb = scores + (long)b * H * S + s_lo;
  const bool quad = S % 4 == 0 && (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  auto load = [&](int h0, int h1) {
    if (quad) {
      const int nq = ns / 4;          // s_lo and ns are multiples of 4
      for (int i = threadIdx.x; i < (h1 - h0) * nq; i += MT) {
        const int h = h0 + i / nq, c = i % nq;
        cp_async16(st + h * MS + 4 * c, sb + (long)h * S + 4 * c, true);
      }
    } else {
      for (int i = threadIdx.x; i < (h1 - h0) * ns; i += MT) {
        const int h = h0 + i / ns, r = i % ns;
        cp_async_ca(st + h * MS + r, sb + (long)h * S + r, 4);
      }
    }
    cp_async_commit();
  };
  const int hh = (H + 1) / 2;         // two halves, summed as they come
  load(0, hh);
  load(hh, H);
  cp_async_wait<2>();
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += MT) {
    float m = NEG_INF;
    for (int r = 0; r < N; ++r) m = fmaxf(m, mlp[2 * (r * H + h)]);
    float l = 0.f;
    for (int r = 0; r < N; ++r)
      l += expf(mlp[2 * (r * H + h)] - m) * mlp[2 * (r * H + h) + 1];
    mh[h] = m;                       // p = 2^((s - m) log2 e) / l
    lh[h] = 1.f / fmaxf(l, 1e-30f);
  }
  cp_async_wait<1>();
  __syncthreads();
  const int r = threadIdx.x;          // a thread a slot
  float x = 0.f;
  if (r < ns)
#pragma unroll 8
    for (int h = 0; h < hh; ++h)
      x += exp2f((st[h * MS + r] - mh[h]) * LOG2E) * lh[h];
  cp_async_wait<0>();
  __syncthreads();
  if (r < ns) {
#pragma unroll 8
    for (int h = hh; h < H; ++h)
      x += exp2f((st[h * MS + r] - mh[h]) * LOG2E) * lh[h];
    mass[(long)b * S + s_lo + r] = x / (float)H;
  }
}

__global__ void noop_kernel() {}

// the split kernel's grid: (kv heads x groups of up to GMAX query heads,
// splits, batch rows); the combine's blocks: o blocks, then mass blocks
inline dim3 split_grid(int B, int S, int H, int Hkv, int chunk) {
  const int n_hg = (H / Hkv + GMAX - 1) / GMAX;
  return dim3(Hkv * n_hg, (S + chunk - 1) / chunk, B);
}
inline int combine_blocks(int B, int S, int H, int Dv) {
  return B * ((H + o_heads(Dv) - 1) / o_heads(Dv)) +
         B * ((S + mass_slots(H) - 1) / mass_slots(H));
}

template <typename T, int GB>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* valid, void* scores, void* part,
                         dim3 grid, int S, int S_row, int s0, int H, int Hkv,
                         int D, int Dv, int chunk, float scale,
                         float softcap, cudaStream_t stream) {
  const size_t smem = split_smem<T, GB>(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_split<T, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_split<T, GB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(scores), static_cast<float*>(part), S, S_row, s0,
      H, Hkv, D, Dv, chunk, scale, softcap);
  return cudaGetLastError();
}

// the split kernel over slots [s0, s0 + S) of rows of S_row slots (k, v,
// scores and part hold the S slots; valid the whole rows)
template <typename T>
cudaError_t run_split(const void* q, const void* k, const void* v,
                      const void* valid, void* scores, void* part, int B,
                      int S, int S_row, int s0, int H, int Hkv, int D,
                      int Dv, int chunk, float scale, float softcap,
                      cudaStream_t stream) {
  const int g = H / Hkv;
  const dim3 grid = split_grid(B, S, H, Hkv, chunk);
  const int gb = g < GMAX ? g : GMAX;
  if (gb == 1)
    return launch_split<T, 1>(q, k, v, valid, scores, part, grid, S, S_row,
                              s0, H, Hkv, D, Dv, chunk, scale, softcap,
                              stream);
  if (gb == 2)
    return launch_split<T, 2>(q, k, v, valid, scores, part, grid, S, S_row,
                              s0, H, Hkv, D, Dv, chunk, scale, softcap,
                              stream);
  if (gb <= 4)
    return launch_split<T, 4>(q, k, v, valid, scores, part, grid, S, S_row,
                              s0, H, Hkv, D, Dv, chunk, scale, softcap,
                              stream);
  return launch_split<T, 8>(q, k, v, valid, scores, part, grid, S, S_row, s0,
                            H, Hkv, D, Dv, chunk, scale, softcap, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o, void* mass, void* scores,
                   void* part, int B, int S, int H, int Hkv, int D, int Dv,
                   int chunk, float scale, float softcap,
                   cudaStream_t stream) {
  cudaError_t err = run_split<T>(q, k, v, valid, scores, part, B, S, S, 0,
                                 H, Hkv, D, Dv, chunk, scale, softcap,
                                 stream);
  if (err != cudaSuccess) return err;
  const int n_split = (S + chunk - 1) / chunk;
  const int blocks = combine_blocks(B, S, H, Dv);
  const size_t smem = combine_smem(H, Dv);
  err = cudaFuncSetAttribute(decode_attn_combine<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_combine<T><<<blocks, CT, smem, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scores),
      static_cast<T*>(o), static_cast<float*>(mass), B, S, H, Dv, n_split);
  return cudaGetLastError();
}

// which body a partial call runs: 1 the tensor cores, 2 the CUDA cores.
// The rule (`ask` 0): the tensor cores wherever they take the call (bf16,
// D and Dv multiples of 16, q, k and v aligned for their loads), g = 1
// too, where they ran some 7% faster than the CUDA cores at
// musicgen-medium's D 64 on an H100 (decode_sweep.py --slot --sweep);
// `ask` 1 or 2 insists (-1 where 1 cannot run).
inline int part_body(int dtype, int D, int Dv, int ask, bool aligned) {
  const bool mma = dtype == 1 && D % 16 == 0 && Dv % 16 == 0 && aligned;
  if (ask == 2) return 2;
  return mma ? 1 : ask == 1 ? -1 : 2;
}
// warps of a partial block: 4, halved while the shared memory would not fit
inline int part_warps(int D, int Dv, size_t elem, bool core) {
  int nw = PT / 32;
  while (nw > 1 && part_smem(nw, D, Dv, elem, core) > MAX_DYN) nw /= 2;
  return nw;
}
inline dim3 part_grid(int B, int H, int Hkv, int n_split) {
  return dim3(n_split, Hkv * ((H / Hkv + PH - 1) / PH), B);
}

template <typename T, class Body>
cudaError_t launch_part(const void* q, const void* k, const void* v,
                        const void* valid, void* out, void* scores, int B,
                        int S, int S_row, int s0, int H, int Hkv, int D,
                        int Dv, int n_split, int chunk, float scale,
                        float softcap, cudaStream_t stream) {
  const bool core = !Body::MMA;
  const int nw = part_warps(D, Dv, sizeof(T), core);
  const size_t smem = part_smem(nw, D, Dv, sizeof(T), core);
  if (smem > MAX_DYN) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_part<T, Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = part_grid(B, H, Hkv, n_split);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, decode_attn_part<T, Body>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<float*>(scores),
      static_cast<float*>(out), S, S_row, s0, H, Hkv, D, Dv, chunk, scale,
      softcap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_part(const void* q, const void* k, const void* v,
                     const void* valid, void* out, void* scores, int B,
                     int S, int S_row, int s0, int H, int Hkv, int D, int Dv,
                     int n_split, int chunk, int body, float scale,
                     float softcap, cudaStream_t stream) {
#define PART_ARGS q, k, v, valid, out, scores, B, S, S_row, s0, H, Hkv, D, \
                  Dv, n_split, chunk, scale, softcap, stream
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (body == 1) {
      const int c = D > Dv ? D : Dv;
      if (c <= 64) return launch_part<T, MmaBody<64>>(PART_ARGS);
      if (c <= 128) return launch_part<T, MmaBody<128>>(PART_ARGS);
      return launch_part<T, MmaBody<256>>(PART_ARGS);
    }
  }
  if (H / Hkv == 1) return launch_part<T, CoreBody<T, 1>>(PART_ARGS);
  return launch_part<T, CoreBody<T, PH>>(PART_ARGS);
#undef PART_ARGS
}

// the merge's blocks (o blocks, then mass blocks where asked) and shared
// bytes
inline int merge_blocks(int B, int Hn, int S, int Dv, bool with_mass) {
  return B * ((Hn + merge_o_heads(Dv) - 1) / merge_o_heads(Dv)) +
         (with_mass ? B * ((S + MS - 1) / MS) : 0);
}
inline size_t merge_smem(int N, int H, int Dv, bool with_mass) {
  const size_t a = merge_o_smem(N, Dv);
  const size_t b = with_mass ? merge_mass_smem(N, H) : 0;
  return a > b ? a : b;
}

template <typename T>
cudaError_t launch_merge(const void* parts, const void* ml,
                         const void* scores, void* o, void* mass, int N,
                         int B, int Hn, int H, int S, int Dv,
                         cudaStream_t stream) {
  const size_t smem = merge_smem(N, H, Dv, scores != nullptr);
  if (smem > MAX_DYN) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_merge<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_merge<T><<<merge_blocks(B, Hn, S, Dv, scores != nullptr), MT,
                         smem, stream>>>(
      static_cast<const float*>(parts), static_cast<const float*>(ml),
      static_cast<const float*>(scores), static_cast<T*>(o),
      static_cast<float*>(mass), N, B, Hn, H, S, Dv);
  return cudaGetLastError();
}

inline bool bad_args(int B, int S, int H, int Hkv, int D, int Dv,
                     int chunk) {
  return B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 ||
         D > MAXD || Dv <= 0 || Dv > MAXD || chunk <= 0 || chunk % WR ||
         chunk > MAX_CHUNK;
}
inline bool bad_part_args(int B, int S, int H, int Hkv, int D, int Dv,
                          int n_split, int chunk) {
  return B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 ||
         D > MAXD || Dv <= 0 || Dv > MAXD || n_split < 1 ||
         n_split > MAX_CLUSTER || chunk <= 0 || chunk % PR ||
         (long)n_split * chunk < S || (long)(n_split - 1) * chunk >= S;
}
inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// blocks[0]: the split kernel's blocks of a call, blocks[1]: the combine's.
// Returns cudaErrorInvalidValue where decode_attention_fwd would.
extern "C" int decode_attention_grid(int B, int S, int H, int Hkv, int D,
                                     int Dv, int chunk, int* blocks) {
  if (bad_args(B, S, H, Hkv, D, Dv, chunk)) return cudaErrorInvalidValue;
  const dim3 g = split_grid(B, S, H, Hkv, chunk);
  blocks[0] = g.x * g.y * g.z;
  blocks[1] = combine_blocks(B, S, H, Dv);
  return cudaSuccess;
}

// dtype: 0 = float32, 1 = bfloat16.  D, Dv <= 256; H % Hkv == 0; chunk a
// multiple of 8, at most 1,024.  scores: f32 scratch [B, H, S]; part: f32
// scratch [B, H, ceil(S / chunk), Dv + 2].  Returns cudaGetLastError()
// after the launches.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* valid,
                                    void* o, void* mass, void* scores,
                                    void* part, int dtype, int B, int S,
                                    int H, int Hkv, int D, int Dv, int chunk,
                                    float scale, float softcap,
                                    void* stream) {
  if (bad_args(B, S, H, Hkv, D, Dv, chunk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, valid, o, mass, scores, part, B, S, H, Hkv,
                         D, Dv, chunk, scale, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, o, mass, scores, part, B, S,
                                 H, Hkv, D, Dv, chunk, scale, softcap, s);
  return cudaErrorInvalidValue;
}

// A partial call's plan, as decode_attention_partial would launch it with
// aligned q, k, v: out[0] its blocks, out[1] the body (1 tensor cores, 2
// CUDA cores), out[2] threads a block, out[3] dynamic shared bytes a
// block.  Returns cudaErrorInvalidValue where the call would.
extern "C" int decode_attention_partial_plan(int dtype, int B, int S, int H,
                                             int Hkv, int D, int Dv,
                                             int n_split, int chunk,
                                             int body, int* out) {
  if (bad_part_args(B, S, H, Hkv, D, Dv, n_split, chunk) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int taken = part_body(dtype, D, Dv, body, true);
  if (taken < 0) return cudaErrorInvalidValue;
  const dim3 g = part_grid(B, H, Hkv, n_split);
  const size_t elem = dtype == 0 ? 4 : 2;
  const int nw = part_warps(D, Dv, elem, taken == 2);
  out[0] = g.x * g.y * g.z;
  out[1] = taken;
  out[2] = 32 * nw;
  out[3] = (int)part_smem(nw, D, Dv, elem, taken == 2);
  return cudaSuccess;
}

// B3 over a block of a slot table: slots [s0, s0 + S) of rows of S_row
// slots.  k, v [B, S, Hkv, D|Dv] hold the block, valid [B, S_row] the whole
// rows (a row with no valid slot anywhere averages over all its slots, a
// block with none in a row that has some weighs nothing).  out: f32
// [B, H, Dv + 2], each head's (acc, m, l) over the block; scores: f32
// [B, H, S], the block's raw masked scores.  n_split blocks a (kv head,
// batch row) in one cluster (at most 8), each `chunk` slots (a multiple of
// 16 that n_split chunks need all of to cover S); body as part_body.  One
// launch.
extern "C" int decode_attention_partial(const void* q, const void* k,
                                        const void* v, const void* valid,
                                        void* out, void* scores, int dtype,
                                        int B, int S, int S_row, int s0,
                                        int H, int Hkv, int D, int Dv,
                                        int n_split, int chunk, int body,
                                        float scale, float softcap,
                                        void* stream) {
  if (bad_part_args(B, S, H, Hkv, D, Dv, n_split, chunk) || s0 < 0 ||
      s0 + S > S_row)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int taken = part_body(
      dtype, D, Dv, body, aligned(q, 4) && aligned(k, 16) && aligned(v, 16));
  if (taken < 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run_part<float>(q, k, v, valid, out, scores, B, S, S_row, s0, H,
                           Hkv, D, Dv, n_split, chunk, taken, scale, softcap,
                           s);
  if (dtype == 1)
    return run_part<__nv_bfloat16>(q, k, v, valid, out, scores, B, S, S_row,
                                   s0, H, Hkv, D, Dv, n_split, chunk, taken,
                                   scale, softcap, s);
  return cudaErrorInvalidValue;
}

// A merge call's plan: out[0] its blocks, out[1] dynamic shared bytes a
// block (with_mass: scores given).
extern "C" int decode_attention_merge_plan(int N, int B, int Hn, int H,
                                           int S, int Dv, int with_mass,
                                           int* out) {
  if (N <= 0 || B <= 0 || Hn <= 0 || H <= 0 || S <= 0 || Dv <= 0 ||
      Dv > MAXD || merge_smem(N, H, Dv, with_mass) > MAX_DYN)
    return cudaErrorInvalidValue;
  out[0] = merge_blocks(B, Hn, S, Dv, with_mass);
  out[1] = (int)merge_smem(N, H, Dv, with_mass);
  return cudaSuccess;
}

// The merge of N blocks' partials: parts f32 [N, B, Hn, Dv + 2] (Hn heads'
// (acc, m, l) from each block, in block order) -> o [B, Hn, Dv] (dtype: 0
// float32, 1 bfloat16); with scores (f32 [B, H, S], one block's raw scores)
// and ml (f32 [N, B, H, 2], every head's (m, l) from each block) also that
// block's mass [B, S] f32; scores NULL: o alone.  One launch.
extern "C" int decode_attention_merge(const void* parts, const void* ml,
                                      const void* scores, void* o,
                                      void* mass, int dtype, int N, int B,
                                      int Hn, int H, int S, int Dv,
                                      void* stream) {
  if (N <= 0 || B <= 0 || Hn <= 0 || H <= 0 || S <= 0 || Dv <= 0 ||
      Dv > MAXD || (scores && !(ml && mass)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_merge<float>(parts, ml, scores, o, mass, N, B, Hn, H, S,
                               Dv, s);
  if (dtype == 1)
    return launch_merge<__nv_bfloat16>(parts, ml, scores, o, mass, N, B, Hn,
                                       H, S, Dv, s);
  return cudaErrorInvalidValue;
}

// One launch of an empty kernel: the floor under a launch's time.
extern "C" int decode_attention_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
