// Causal flash attention forward (GQA, sliding window, tanh softcap) for
// sm_90a, plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, pallas_call at :107), which the reference
// documents as the TPU drop-in for models/layers.py::chunked_attention.
//
//   q [B, Sq, H, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, Dv]  ->  o [B, Sq, H, Dv]
//
// bf16 or f32 inputs; scores, the online-softmax state and the output
// accumulator are f32; the output is cast to q's type.  kv head = h / (H/Hkv).
//
// Bound on an H100: operations.  At prefill sizes the work is
// 2 * D + 2 * Dv flops for every (q, k) pair the mask keeps, which the
// tensor cores could do at 989 TFLOP/s (bf16); the bytes (q, k, v, o once)
// take a fraction of that.  This first kernel runs on the CUDA cores in
// f32: it is simple and exact to f32 rounding, and sits well above the
// tensor-core bound (PERF.md).  Tensor cores (wgmma), TMA and warp
// specialisation are later work.
//
// Design: one block of 256 threads per (64-row q tile, head, batch).  The
// q tile (pre-scaled) stays in shared memory; the block walks the 64-key
// tiles that the causal and window masks leave (tiles wholly above the
// diagonal or wholly left of the window are never loaded), staging K
// (transposed) and V in shared memory.  Thread (tr, tc) owns q rows
// 4*tr..4*tr+3 of the 64x64 score tile at columns tc + 16*c, and the same
// rows of the output at columns tc + 16*j, so each row's max and sum are
// shuffles within a half-warp and the running m, l stay in registers.
// Any Sq, Sk (primes included): rows and keys past the end are masked, not
// padded by the caller.  Masked scores are -1e30, not -inf, as in the
// reference, so a row that is masked in a whole tile never makes a NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads per block
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

// NCV = output columns per thread = ceil(Dv / 16)
template <typename T, int NCV>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int Hkv, int D, int Dv, float scale, int causal,
                 int window, float softcap) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [D][BQ + 1], scaled q, transposed
  float* Ks = Qs + D * (BQ + 1);       // [D][BK + 1], transposed
  float* Vs = Ks + D * (BK + 1);       // [BK][Dv]
  float* Ps = Vs + BK * Dv;            // [BQ][BK + 1], probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;             // row group: rows 4*tr .. 4*tr+3
  const int tc = tid & 15;             // column lane

  const long q_row = (long)H * D;      // stride between tokens
  const long k_row = (long)Hkv * D;
  const long v_row = (long)Hkv * Dv;
  const T* qb = q + (long)b * Sq * q_row + (long)h * D;
  const T* kb = k + (long)b * Sk * k_row + (long)hk * D;
  const T* vb = v + (long)b * Sk * v_row + (long)hk * Dv;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    const int s = q0 + r;
    Qs[d * (BQ + 1) + r] = s < Sq ? to_f(qb[s * q_row + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NCV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NCV; ++j) acc[r][j] = 0.f;
  }

  // key tiles the masks leave: [kt_begin, kt_end)
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;    // least key position row q0 keeps
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // the last tile's readers are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx - r * D;
      const int s = k0 + r;
      Ks[d * (BK + 1) + r] = s < Sk ? to_f(kb[s * k_row + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * Dv; idx += NT) {
      const int r = idx / Dv, d = idx - r * Dv;
      const int s = k0 + r;
      Vs[r * Dv + d] = s < Sk ? to_f(vb[s * v_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[d * (BQ + 1) + tr * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = Ks[d * (BK + 1) + tc + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(a[r], bb[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + tr * 4 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tc + 16 * c;
        float s = sc[r][c];
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        sc[r][c] = ok ? s : NEG_INF;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[r][c] - m_new);
        Ps[(tr * 4 + r) * (BK + 1) + tc + 16 * c] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NCV; ++j) acc[r][j] *= corr;
    }
    __syncwarp();                      // a row's P is written by its half-warp

    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(tr * 4 + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NCV; ++c) {
        const int dv = tc + 16 * c;
        const float vv = dv < Dv ? Vs[j * Dv + dv] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

  const long o_row = (long)H * Dv;
  T* ob = o + (long)b * Sq * o_row + (long)h * Dv;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = q0 + tr * 4 + r;
    if (s >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
      const int dv = tc + 16 * c;
      if (dv < Dv) ob[s * o_row + dv] = from_f<T>(acc[r][c] / den);
    }
  }
}

template <typename T, int NCV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int D, int Dv,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)D * (BQ + 1) + (size_t)D * (BK + 1) +
                       (size_t)BK * Dv + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NCV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, NCV><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, D, Dv,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int Hkv, int D, int Dv,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t s) {
#define FLASH_CASE(N)                                                       \
  if (Dv <= 16 * N)                                                         \
    return launch<T, N>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale, causal, \
                        window, softcap, s);
  FLASH_CASE(1)
  FLASH_CASE(2)
  FLASH_CASE(4)
  FLASH_CASE(8)
  FLASH_CASE(16)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D, Dv <= 256; H % Hkv == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int H, int Hkv, int D,
                                   int Dv, float scale, int causal,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv ||
      D <= 0 || D > 256 || Dv <= 0 || Dv > 256)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                           causal, window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv,
                                   scale, causal, window, softcap, s);
  return cudaErrorInvalidValue;
}
