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
// Bound on an H100: bytes.  A call must read K and V once (the slots that
// are valid; all of them when none is), a few KB of q, and write o and
// mass: at 3.35 TB/s that is the whole cost, the flops are ~1 per byte.
//
// Design: two kernels, one launch each.
//   decode_attn_kernel, one block of 256 threads per (kv head, batch):
//     pass A: each warp takes one slot at a time (four in flight), reads
//       its K row once for all g = H/Hkv query heads, writes the masked
//       score to a scratch [B, H, S] f32 and keeps a running max and sum
//       per head; the eight warps' (m, l) combine in a fixed order;
//     pass B: each warp takes one slot at a time again, forms
//       p = exp(s - m) / l from the scratch, adds p * v to its own f32
//       accumulator in shared memory, and writes the slot's mass over its
//       g heads to a per-(b, kv head) partial [B, Hkv, S];
//     the warps' accumulators sum in a fixed order into o.
//   decode_mass_kernel sums the partials over kv heads in the order
//   0..Hkv-1.  Nothing is summed with atomics, so mass (whose argmax picks
//   the slot DAC promotes) is the same bit for bit from run to run.
// K is read once (the reference reads it twice); the scores make a small
// round trip instead (4 * H * S bytes against 2 * Hkv * S * D for K).
// Invalid slots are not read when a valid one exists: their p is exactly 0.
// A row with no valid slot averages uniformly, as the reference's -1e30
// masking does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;     // warps per block
constexpr int U = 4;            // slots in flight per warp
constexpr int MAXC = 8;         // D, Dv <= 32 * MAXC = 256
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ valid,
                   T* __restrict__ o, float* __restrict__ scores,
                   float* __restrict__ mass_part, int S, int H, int Hkv,
                   int D, int Dv, float scale, float softcap) {
  extern __shared__ float smem[];
  const int g = H / Hkv;
  float* qs = smem;                    // [g][D], scaled
  float* acc = qs + g * D;             // [NW][g][Dv]
  float* wm = acc + NW * g * Dv;       // [NW][g] running max per warp
  float* wl = wm + NW * g;             // [NW][g] running sum per warp
  float* fm = wl + NW * g;             // [g] final max
  float* fl = fm + g;                  // [g] final sum, >= 1e-30
  __shared__ int any_valid;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = hk * g;               // first query head of this kv head
  const long kv_k = (long)Hkv * D, kv_v = (long)Hkv * Dv;
  const T* kb = k + (long)b * S * kv_k + (long)hk * D;
  const T* vb = v + (long)b * S * kv_v + (long)hk * Dv;
  const uint8_t* vb_ok = valid + (long)b * S;
  float* sc_b = scores + ((long)b * H + h0) * S;

  for (int i = threadIdx.x; i < g * D; i += NT)
    qs[i] = to_f(q[((long)b * H + h0) * D + i]) * scale;
  for (int i = threadIdx.x; i < NW * g * Dv; i += NT) acc[i] = 0.f;
  for (int i = threadIdx.x; i < NW * g; i += NT) {
    wm[i] = NEG_INF;
    wl[i] = 0.f;
  }
  if (threadIdx.x == 0) any_valid = 0;
  __syncthreads();

  // pass A: scores, per-warp running (m, l)
  bool saw_valid = false;
  for (int s0 = warp * U; s0 < S; s0 += NW * U) {
    float kr[U][MAXC];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      ok[u] = s < S && vb_ok[s] != 0;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = lane + 32 * c;
        kr[u][c] = (ok[u] && d < D) ? to_f(kb[s * kv_k + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s >= S) break;
      saw_valid |= ok[u];
      for (int h = 0; h < g; ++h) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) part = fmaf(qs[h * D + d], kr[u][c], part);
        }
        float x = warp_sum(part);
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = ok[u] ? x : NEG_INF;
        const float m_old = wm[warp * g + h];
        const float m_new = fmaxf(m_old, x);
        const float l_new =
            wl[warp * g + h] * expf(m_old - m_new) + expf(x - m_new);
        __syncwarp();
        if (lane == 0) {
          sc_b[(long)h * S + s] = x;
          wm[warp * g + h] = m_new;
          wl[warp * g + h] = l_new;
        }
        __syncwarp();
      }
    }
  }
  if (saw_valid) any_valid = 1;        // benign race: every writer writes 1
  __syncthreads();
  for (int h = threadIdx.x; h < g; h += NT) {
    float m = NEG_INF;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, wm[w * g + h]);
    float l = 0.f;
    for (int w = 0; w < NW; ++w) l += wl[w * g + h] * expf(wm[w * g + h] - m);
    fm[h] = m;
    fl[h] = fmaxf(l, 1e-30f);
  }
  __syncthreads();

  // pass B: p = exp(s - m) / l, o += p v, mass partial over this kv head
  const bool skip_invalid = any_valid != 0;
  float* mp = mass_part + ((long)b * Hkv + hk) * S;
  float* acc_w = acc + warp * g * Dv;
  for (int s0 = warp * U; s0 < S; s0 += NW * U) {
    float vr[U][MAXC];
    bool need[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      need[u] = s < S && (!skip_invalid || vb_ok[s] != 0);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = lane + 32 * c;
        vr[u][c] = (need[u] && d < Dv) ? to_f(vb[s * kv_v + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s >= S) break;
      if (!need[u]) {                  // invalid beside a valid slot: p = 0
        if (lane == 0) mp[s] = 0.f;
        continue;
      }
      float msum = 0.f;
      for (int h = 0; h < g; ++h) {
        const float p = expf(sc_b[(long)h * S + s] - fm[h]) / fl[h];
        msum += p;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int d = lane + 32 * c;
          if (d < Dv) acc_w[h * Dv + d] = fmaf(p, vr[u][c], acc_w[h * Dv + d]);
        }
      }
      if (lane == 0) mp[s] = msum / (float)H;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * Dv; i += NT) {
    float x = 0.f;
    for (int w = 0; w < NW; ++w) x += acc[w * g * Dv + i];
    o[((long)b * H + h0) * Dv + i] = from_f<T>(x);
  }
}

__global__ void decode_mass_kernel(const float* __restrict__ mass_part,
                                   float* __restrict__ mass, int B, int S,
                                   int Hkv) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)B * S) return;
  const long b = i / S, s = i - b * S;
  float x = 0.f;
  for (int hk = 0; hk < Hkv; ++hk) x += mass_part[(b * Hkv + hk) * S + s];
  mass[i] = x;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o, void* mass, void* scores,
                   void* mass_part, int B, int S, int H, int Hkv, int D,
                   int Dv, float scale, float softcap, cudaStream_t stream) {
  const int g = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)g * D + (size_t)NW * g * Dv +
                                       2 * (size_t)NW * g + 2 * (size_t)g);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_kernel<T><<<dim3(Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(o), static_cast<float*>(scores),
      static_cast<float*>(mass_part), S, H, Hkv, D, Dv, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = (long)B * S;
  decode_mass_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      static_cast<const float*>(mass_part), static_cast<float*>(mass), B, S,
      Hkv);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D, Dv <= 256; H % Hkv == 0.
// scores: f32 scratch [B, H, S]; mass_part: f32 scratch [B, Hkv, S].
// Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* valid,
                                    void* o, void* mass, void* scores,
                                    void* mass_part, int dtype, int B, int S,
                                    int H, int Hkv, int D, int Dv,
                                    float scale, float softcap,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 ||
      D > 32 * MAXC || Dv <= 0 || Dv > 32 * MAXC)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, valid, o, mass, scores, mass_part, B, S, H,
                         Hkv, D, Dv, scale, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, o, mass, scores, mass_part,
                                 B, S, H, Hkv, D, Dv, scale, softcap, s);
  return cudaErrorInvalidValue;
}
