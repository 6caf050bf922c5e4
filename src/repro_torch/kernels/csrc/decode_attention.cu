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
// Nothing is summed with atomics and every sum has a fixed order, so o and
// mass (whose argmax picks the slot DAC promotes) are the same bit for bit
// from run to run.  An invalid slot beside a valid one gets p = 0 exactly:
// its score is -1e30 and the row's max is a real score.  The scores make a
// round trip through device memory (8 * H * S bytes, about 1.6% of K and V
// at deepseek-7b's shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
                  int S, int H, int Hkv, int D, int Dv, int chunk,
                  float scale, float softcap) {
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
  const uint8_t* vrow = valid + (long)b * S;
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   (Dv * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  // q scaled; the row's valid in 16-byte words (its ragged ends byte by
  // byte); the chunk's valid bytes, all loads of a thread in flight at once
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
        S, (int)((16 - (reinterpret_cast<uintptr_t>(vrow) & 15)) & 15));
    const int nvec = (S - head) / 16;
    const uint4* body = reinterpret_cast<const uint4*>(vrow + head);
#pragma unroll 4
    for (int i = threadIdx.x; i < nvec; i += NT) {
      const uint4 w = body[i];
      any |= (w.x | w.y | w.z | w.w) != 0;
    }
    if (threadIdx.x < head) any |= vrow[threadIdx.x];
    const int tail = head + 16 * nvec + threadIdx.x;
    if (tail < S) any |= vrow[tail];
  }
  {
    uint8_t x[MAX_CHUNK / NT];
#pragma unroll
    for (int u = 0; u < MAX_CHUNK / NT; ++u) {
      const int r = threadIdx.x + u * NT;
      x[u] = r < clen ? vrow[s_lo + r] : 0;
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
                         dim3 grid, int S, int H, int Hkv, int D, int Dv,
                         int chunk, float scale, float softcap,
                         cudaStream_t stream) {
  const size_t smem = split_smem<T, GB>(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_split<T, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_split<T, GB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(scores), static_cast<float*>(part), S, H, Hkv, D,
      Dv, chunk, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o, void* mass, void* scores,
                   void* part, int B, int S, int H, int Hkv, int D, int Dv,
                   int chunk, float scale, float softcap,
                   cudaStream_t stream) {
  const int g = H / Hkv;
  const dim3 grid = split_grid(B, S, H, Hkv, chunk);
  const int gb = g < GMAX ? g : GMAX;
  cudaError_t err;
  if (gb == 1)
    err = launch_split<T, 1>(q, k, v, valid, scores, part, grid, S, H, Hkv,
                             D, Dv, chunk, scale, softcap, stream);
  else if (gb == 2)
    err = launch_split<T, 2>(q, k, v, valid, scores, part, grid, S, H, Hkv,
                             D, Dv, chunk, scale, softcap, stream);
  else if (gb <= 4)
    err = launch_split<T, 4>(q, k, v, valid, scores, part, grid, S, H, Hkv,
                             D, Dv, chunk, scale, softcap, stream);
  else
    err = launch_split<T, 8>(q, k, v, valid, scores, part, grid, S, H, Hkv,
                             D, Dv, chunk, scale, softcap, stream);
  if (err != cudaSuccess) return err;
  const int blocks = combine_blocks(B, S, H, Dv);
  const size_t smem = combine_smem(H, Dv);
  err = cudaFuncSetAttribute(decode_attn_combine<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_combine<T><<<blocks, CT, smem, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scores),
      static_cast<T*>(o), static_cast<float*>(mass), B, S, H, Dv, grid.y);
  return cudaGetLastError();
}

inline bool bad_args(int B, int S, int H, int Hkv, int D, int Dv,
                     int chunk) {
  return B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 ||
         D > MAXD || Dv <= 0 || Dv > MAXD || chunk <= 0 || chunk % WR ||
         chunk > MAX_CHUNK;
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
