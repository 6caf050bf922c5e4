// Causal flash attention forward (GQA, sliding window, tanh softcap) for
// sm_90a, plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, pallas_call at :107), which the reference
// documents as the TPU drop-in for models/layers.py::chunked_attention.
//
//   q [B, Sq, H, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, Dv]  ->  o [B, Sq, H, Dv]
//
// kv head = h / (H/Hkv); any Sq, Sk (primes included) and any D, Dv <= 256.
// Scores, the online-softmax state and the output accumulator are f32; the
// output is cast to q's type.  Masked scores are -1e30, not -inf, as in the
// reference, so a row that is masked in a whole tile never makes a NaN; the
// softcap is applied before the masks; the epilogue divides by
// max(l, 1e-30).  Key tiles wholly above the diagonal or wholly left of the
// window are never loaded, and the masks are evaluated only on the tiles
// they cut.
//
// Bound on an H100: operations.  At prefill sizes the work is 2 * D + 2 * Dv
// flops for every (q, k) pair the masks keep, which the tensor cores do at
// 989 TFLOP/s in bf16; q, k, v and o, each moved once, take about half that
// time at 3.35 TB/s (PERF.md).
//
// bf16: flash_fwd_wg, on the tensor cores through wgmma (warpgroup matrix
//   multiply), in the shape of FlashAttention-2 with Hopper's instruction.
//   * A block of two warpgroups owns 128 q rows of one (batch, head); each
//     warpgroup owns 64.  Key tiles are 64 wide.  D and Dv are rounded up
//     to 64, 128 or 256 in shared memory, the extra columns zero (so D = 72
//     or Dv = 40 need no caller padding).
//   * Q, and K and V tiles, arrive by 16-byte cp.async into the 128-byte
//     swizzled layout wgmma reads (64-column blocks of 128-byte rows, the
//     16-byte chunks of row r XOR-ed with r % 8), then a proxy fence.  K and
//     V are double-buffered: tile j + 1 is in flight while tile j is
//     multiplied.
//   * S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major descriptors); O += P V is wgmma m64nDvk16 with P in
//     registers and V through a transposing (MN-major) descriptor.  The S
//     accumulator layout is the A-register layout, so P is rounded to bf16
//     in registers and never touches shared memory.  Row max and sum are
//     quad shuffles, exponentials ex2.approx on log2-scaled scores; O stays
//     in registers.
//   * D, Dv <= 128: at most 128 registers a thread, so two blocks (four
//     warpgroups) share an SM and one's softmax overlaps another's
//     products.  Causal blocks are launched heaviest first (the
//     q tile index runs backwards), and the q tiles of one head are
//     adjacent in the grid, so the blocks in flight share K and V in L2.
//   A row that is not 16-byte aligned (D or Dv not a multiple of 8) is
//   copied element by element instead of by cp.async.
//
// f32: flash_fwd_f32, on the CUDA cores (no TF32 anywhere, so f32 results
//   stay within f32 rounding of the plain version).  One block of 256
//   threads per 64 q rows; thread (tr, tc) owns rows 4*tr..4*tr+3 of the
//   64x64 score tile at columns tc + 16*c, K is staged transposed in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;        // q rows per block
constexpr int F_BK = 64;        // keys per tile
constexpr int F_NT = 256;       // threads per block

// NCV = output columns per thread = ceil(Dv / 16)
template <int NCV>
__global__ void __launch_bounds__(F_NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Sk, int H, int Hkv, int D, int Dv, float scale, int causal,
              int window, float softcap) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [D][BQ + 1], scaled q, transposed
  float* Ks = Qs + D * (F_BQ + 1);     // [D][BK + 1], transposed
  float* Vs = Ks + D * (F_BK + 1);     // [BK][Dv]
  float* Ps = Vs + F_BK * Dv;          // [BQ][BK + 1], probabilities

  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;             // row group: rows 4*tr .. 4*tr+3
  const int tc = tid & 15;             // column lane

  const long q_row = (long)H * D;      // stride between tokens
  const long k_row = (long)Hkv * D;
  const long v_row = (long)Hkv * Dv;
  const float* qb = q + (long)b * Sq * q_row + (long)h * D;
  const float* kb = k + (long)b * Sk * k_row + (long)hk * D;
  const float* vb = v + (long)b * Sk * v_row + (long)hk * Dv;

  for (int idx = tid; idx < F_BQ * D; idx += F_NT) {
    const int r = idx / D, d = idx - r * D;
    const int s = q0 + r;
    Qs[d * (F_BQ + 1) + r] = s < Sq ? qb[s * q_row + d] * scale : 0.f;
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
  int kt_end = (Sk + F_BK - 1) / F_BK;
  if (causal) kt_end = min(kt_end, (q0 + F_BQ - 1) / F_BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;    // least key position row q0 keeps
    kt_begin = lo > 0 ? lo / F_BK : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * F_BK;
    __syncthreads();                   // the last tile's readers are done
    for (int idx = tid; idx < F_BK * D; idx += F_NT) {
      const int r = idx / D, d = idx - r * D;
      const int s = k0 + r;
      Ks[d * (F_BK + 1) + r] = s < Sk ? kb[s * k_row + d] : 0.f;
    }
    for (int idx = tid; idx < F_BK * Dv; idx += F_NT) {
      const int r = idx / Dv, d = idx - r * Dv;
      const int s = k0 + r;
      Vs[r * Dv + d] = s < Sk ? vb[s * v_row + d] : 0.f;
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
      for (int r = 0; r < 4; ++r) a[r] = Qs[d * (F_BQ + 1) + tr * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = Ks[d * (F_BK + 1) + tc + 16 * c];
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
        Ps[(tr * 4 + r) * (F_BK + 1) + tc + 16 * c] = p;
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

    for (int j = 0; j < F_BK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(tr * 4 + r) * (F_BK + 1) + j];
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
  float* ob = o + (long)b * Sq * o_row + (long)h * Dv;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = q0 + tr * 4 + r;
    if (s >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
      const int dv = tc + 16 * c;
      if (dv < Dv) ob[s * o_row + dv] = acc[r][c] / den;
    }
  }
}

template <int NCV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int Hkv, int D, int Dv,
                       float scale, int causal, int window, float softcap,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)D * (F_BQ + 1) + (size_t)D * (F_BK + 1) +
                       (size_t)F_BK * Dv + (size_t)F_BQ * (F_BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<NCV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  flash_fwd_f32<NCV><<<grid, F_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, Hkv,
      D, Dv, scale, causal, window, softcap);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, int B, int Sq, int Sk, int H, int Hkv,
                         int D, int Dv, float scale, int causal, int window,
                         float softcap, cudaStream_t s) {
#define FLASH_CASE(N)                                                     \
  if (Dv <= 16 * N)                                                       \
    return launch_f32<N>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,     \
                         causal, window, softcap, s);
  FLASH_CASE(1)
  FLASH_CASE(2)
  FLASH_CASE(4)
  FLASH_CASE(8)
  FLASH_CASE(16)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: shared helpers (cp.async, bf16 packing, 2^x)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special function unit (flush to zero; 2^-1.4e30 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16: warpgroup matrix multiply (wgmma), 128-byte swizzled shared tiles
// ---------------------------------------------------------------------------

// d[32] += A (64x16, shared, K-major) * B (16x64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[32] += A (64x16, registers) * B (16x64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (64x16, registers) * B (16x128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A (64x16, registers) * B (16x256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async
// proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// accumulators written by wgmma are read only after its wait
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (encoded >> 4), swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

// Copy ROWS rows of `dim` values into a tile kept as DP / 64 column blocks
// of ROWS x 128 bytes (1024-byte aligned), the 16-byte chunks of row r
// XOR-swizzled by r % 8: the layout wgmma reads with the 128-byte swizzle.
// Rows >= rows_valid and columns >= dim become zero.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile_sw(bf16* s, const bf16* g, long ld,
                                             int rows_valid, int dim,
                                             bool vec, int tid) {
  constexpr int CH = DP / 8;
  static_assert((ROWS * CH) % NT == 0, "tile chunks divide among threads");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / CH, cc = idx % CH, c = cc * 8;
    bf16* dst =
        s + (cc >> 3) * (ROWS * 64) + r * 64 + (((cc & 7) ^ (r & 7)) << 3);
    if (vec && r < rows_valid && c + 8 <= dim) {
      cp_async16(dst, g + r * ld + c);
    } else {
      uint4 z = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid && c < dim) {
        bf16* e = reinterpret_cast<bf16*>(&z);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < dim) e[j] = g[r * ld + c + j];
      }
      *reinterpret_cast<uint4*>(dst) = z;
    }
  }
}

template <int DVP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DVP == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DVP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// Two warpgroups, each owning 64 q rows; 64-key tiles.  S = Q K^T is a
// wgmma with both operands in shared memory, O += P V one with P in
// registers (the S accumulator layout is the A-register layout).
template <int DP, int DVP>
__global__ void __launch_bounds__(256, (DP <= 128 && DVP <= 128) ? 2 : 1)
flash_fwd_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
             int H, int Hkv, int D, int Dv, float scale, int causal,
             int window, float softcap, int vec_q, int vec_k, int vec_v,
             int vec_o) {
  constexpr int NT = 256, BQ = 128, BK = 64;
  constexpr int NSR = BK / 2;                   // S accumulators a thread
  constexpr int NOR = DVP / 2;                  // O accumulators a thread
  constexpr float MASKED = NEG_INF * LOG2E;     // a masked score, log2 units
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  bf16* Ks = Qs + BQ * DP;                       // 2 x [BK x DP]
  bf16* Vs = Ks + 2 * BK * DP;                   // 2 x [BK x DVP]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;

  const long q_ld = (long)H * D, k_ld = (long)Hkv * D, v_ld = (long)Hkv * Dv;
  const bf16* kb = k + (long)b * Sk * k_ld + (long)hk * D;
  const bf16* vb = v + (long)b * Sk * v_ld + (long)hk * Dv;

  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  load_tile_sw<BQ, DP, NT>(Qs, q + ((long)b * Sq + q0) * q_ld + (long)h * D,
                           q_ld, Sq - q0, D, vec_q, tid);
  if (kt_begin < kt_end) {
    const int k1 = kt_begin * BK;
    load_tile_sw<BK, DP, NT>(Ks, kb + k1 * k_ld, k_ld, Sk - k1, D, vec_k, tid);
    load_tile_sw<BK, DVP, NT>(Vs, vb + k1 * v_ld, v_ld, Sk - k1, Dv, vec_v,
                              tid);
  }
  cp_async_commit();

  float oacc[NOR];
#pragma unroll
  for (int i = 0; i < NOR; ++i) oacc[i] = 0.f;
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  const int row0 = q0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;
  const float c2 = scale * LOG2E;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      const int k1 = (kt + 1) * BK;
      load_tile_sw<BK, DP, NT>(Ks + (buf ^ 1) * BK * DP, kb + k1 * k_ld, k_ld,
                               Sk - k1, D, vec_k, tid);
      load_tile_sw<BK, DVP, NT>(Vs + (buf ^ 1) * BK * DVP, vb + k1 * v_ld,
                                v_ld, Sk - k1, Dv, vec_v, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const bf16* Kt = Ks + buf * BK * DP;
    const bf16* Vt = Vs + buf * BK * DVP;
    const int k0 = kt * BK;

    // S = Q K^T: 64 x 64 per warpgroup, 16 columns of D a step
    float s[NSR];
#pragma unroll
    for (int i = 0; i < NSR; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks * 16 < D) {
        const bf16* qa =
            Qs + (ks >> 2) * (BQ * 64) + wg * 64 * 64 + (ks & 3) * 16;
        const bf16* kk = Kt + (ks >> 2) * (BK * 64) + (ks & 3) * 16;
        wgmma_ss_n64(s, sw128_desc(qa, 16, 1024), sw128_desc(kk, 16, 1024));
      }
    }
    wg_commit();
    wg_wait_all();
    pin<NSR>(s);

    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        x = softcap > 0.f ? tanhf(x * scale / softcap) * (softcap * LOG2E)
                          : x * c2;
        if (masked) {
          const int kp = k0 + j * 8 + 2 * tg + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          bool ok = kp < Sk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) x = MASKED;
        }
        s[4 * j + e] = x;
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = ex2(m[r] - mx);
      m[r] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = ex2(s[4 * j + e] - mx);
          s[4 * j + e] = p;
          ps += p;
        }
      l[r] = l[r] * corr[r] + ps;
    }
#pragma unroll
    for (int n = 0; n < NOR / 4; ++n) {
      oacc[4 * n + 0] *= corr[0];
      oacc[4 * n + 1] *= corr[0];
      oacc[4 * n + 2] *= corr[1];
      oacc[4 * n + 3] *= corr[1];
    }

    // O += P V, 16 keys a step
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      a[ks][0] = pack_bf16(s[8 * ks + 0], s[8 * ks + 1]);
      a[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
      a[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
      a[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
    }
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_pv<DVP>(oacc, a[ks],
                    sw128_desc(Vt + ks * 16 * 64, BK * 128, 1024));
    wg_commit();
    wg_wait_all();
    pin<NOR>(oacc);
    __syncthreads();
  }
  cp_async_wait<0>();

  const long o_ld = (long)H * Dv;
  bf16* ob = o + (long)b * Sq * o_ld + (long)h * Dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qp = row0 + 8 * r;
    if (qp >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NOR / 4; ++n) {
      const int col = n * 8 + 2 * tg;
      const float x0 = oacc[4 * n + 2 * r] * inv;
      const float x1 = oacc[4 * n + 2 * r + 1] * inv;
      bf16* dst = ob + qp * o_ld + col;
      if (vec_o && col + 1 < Dv) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < Dv) dst[0] = __float2bfloat16(x0);
        if (col + 1 < Dv) dst[1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP, int DVP>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int Hkv, int D, int Dv,
                      float scale, int causal, int window, float softcap,
                      cudaStream_t stream) {
  constexpr int BQ = 128, BK = 64;
  const size_t smem = sizeof(bf16) * ((size_t)BQ * DP + 2 * (size_t)BK * DP +
                                      2 * (size_t)BK * DVP) + 1024;
  auto kern = flash_fwd_wg<DP, DVP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto aligned = [](const void* p, uintptr_t n) {
    return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
  };
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, 256, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, Hkv, D,
      Dv, scale, causal, window, softcap, D % 8 == 0 && aligned(q, 16),
      D % 8 == 0 && aligned(k, 16), Dv % 8 == 0 && aligned(v, 16),
      Dv % 2 == 0 && aligned(o, 4));
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_wg_dv(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Sk, int H, int Hkv,
                           int D, int Dv, float scale, int causal, int window,
                           float softcap, cudaStream_t s) {
  if (Dv <= 64)
    return launch_wg<DP, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                             causal, window, softcap, s);
  if (Dv <= 128)
    return launch_wg<DP, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                              causal, window, softcap, s);
  return launch_wg<DP, 256>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                            causal, window, softcap, s);
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int H, int Hkv,
                          int D, int Dv, float scale, int causal, int window,
                          float softcap, cudaStream_t s) {
  if (D <= 64)
    return dispatch_wg_dv<64>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                              causal, window, softcap, s);
  if (D <= 128)
    return dispatch_wg_dv<128>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                               causal, window, softcap, s);
  return dispatch_wg_dv<256>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                             causal, window, softcap, s);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// D, Dv <= 256; H % Hkv == 0.  Returns cudaGetLastError() after the launch.
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
    return dispatch_f32(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale, causal,
                        window, softcap, s);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale,
                         causal, window, softcap, s);
  return cudaErrorInvalidValue;
}
