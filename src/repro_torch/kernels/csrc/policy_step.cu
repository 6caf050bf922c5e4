// Fused rank-policy step for Hopper (sm_90a): find + plan + shift + wipe.
//
// Replaces the TPU kernel `src/repro/kernels/policy_step.py`
// (`_batched_call`, `pl.pallas_call` at :247, body `_tiled_kernel`).  What it
// computes, per lane, over an int32 rank row of width W (a multiple of 128,
// EMPTY = -1 padding):
//
//   1. find       first rank m holding the key (m = W when absent; i = 0 then)
//   2. plan       the policy's control law (hit, i, scalars) ->
//                 (src, t, wipe_from, new scalars), a switch on a plan id:
//                 CLIMB, ADAPTIVECLIMB, DAC and DAC with an arbiter cap
//   3. evict      evicted = row[src] before the update
//   4. shift      ranks (t, src] move right by one
//   5. key        row[t] = key
//   6. wipe       ranks >= wipe_from become EMPTY
//
// The TPU kernel's float32 iota-min and 16-bit split sums worked around
// Mosaic's lack of integer vector reductions; here the find is an integer
// compare with a shared-memory atomicMin.  The TPU's sequential
// (B, 2, n_tiles) grid with an SMEM carry becomes one thread block per lane
// that loops over its row.
//
// Two entry points share the device step:
//   policy_step_batched  one step on B lanes (rank_step on CUDA tensors)
//   policy_replay        T steps over a [B, T] request block, the time loop
//                        inside the kernel (the engine's replacement for
//                        lax.scan); the row lives in shared memory for the
//                        whole replay when W * 4 bytes fit, else in device
//                        memory.  Per-lane metrics are summed by one thread
//                        in the reference's order (simulator.py::_acc_step),
//                        so the float32 totals match it bit for bit.
//
// Bound on an H100: the work is integer compares and moves, with no
// floating-point arithmetic to speak of.  A step scans m + 1 ranks on a hit
// (W on a miss: 4 * W bytes), moves src - t ranks (8 * (src - t) bytes) and
// ends in a handful of block barriers; one block per lane, so B lanes share
// 132 SMs and B < 132 leaves SMs idle.  Each step is a chain of dependent
// phases (find -> plan -> shift), so at the main path's widths a step is
// bound by barrier and memory latency, not by bandwidth.  The design keeps
// the row on chip (shared memory) when it fits, exits the find at the first
// chunk holding the key, and moves SHIFT_V values per thread per barrier
// pair.
#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY_KEY (-1)
#define MAX_SC 5
#define SHIFT_V 4
#define SMEM_ROW_LIMIT (200 * 1024)

#define PLAN_CLIMB 0
#define PLAN_ADAPTIVECLIMB 1
#define PLAN_DAC 2
#define PLAN_DAC_BUDGETED 3

struct StepShared {
    int min_idx;        // find result (W = not found)
    int src, t, wipe;   // plan outputs
    int hit, evicted;
    int sc[MAX_SC];     // control scalars, carried across steps
};

// floor(x / 2) for any sign, as jnp's `k // 2`
__device__ __forceinline__ int floor_half(int x) { return x >> 1; }

// The policies' control laws.  Reads and updates sc in place; one thread.
__device__ void plan_eval(int pid, bool hit, int i, int* sc, float eps,
                          int k_min, int& src, int& t, int& wipe) {
    switch (pid) {
    case PLAN_CLIMB: {                       // baselines.py:171-177
        const int n = sc[0];
        src = hit ? i : n - 1;
        t = hit ? max(i - 1, 0) : n - 1;
        wipe = n;
        break;
    }
    case PLAN_ADAPTIVECLIMB: {               // adaptiveclimb.py:53-63
        const int jump = sc[0], n = sc[1];
        const int jump_h = max(jump - 1, 1);
        const int t_h = max(i - jump_h, 0);
        const int jump_m = min(jump + 1, n);
        const int t_m = n - jump_m;
        src = hit ? i : n - 1;
        t = hit ? t_h : t_m;
        wipe = n;
        sc[0] = hit ? jump_h : jump_m;
        break;
    }
    default: {                               // dynamicadaptiveclimb.py:135-169
        int jump = sc[0], jump2 = sc[1];
        const int k = sc[2], kmax = sc[3];
        const int half = floor_half(k);
        // hit_update (control.py:48-65)
        const int jump_h = jump > -half ? jump - 1 : jump;
        const int jump2_h = (i < half) ? (jump2 > -half ? jump2 - 1 : jump2)
                                       : (jump2 < 0 ? jump2 + 1 : jump2);
        const int actual_h = max(1, min(jump_h, i));
        const int t_h = i > 0 ? i - actual_h : 0;
        // miss_update (control.py:68-79)
        const int jump_m = min(jump + 1, 2 * k);
        const int jump2_m = jump2 < 0 ? jump2 + 1 : jump2;
        const int actual_m = max(1, min(k - 1, jump_m));
        const int t_m = k - actual_m;
        src = hit ? i : k - 1;
        t = hit ? t_h : t_m;
        jump = hit ? jump_h : jump_m;
        jump2 = hit ? jump2_h : jump2_m;
        // resize_update (control.py:82-117); eps arrives as float32 and the
        // product is rounded once, as jnp computes it
        if (jump == 0) jump2 = 0;
        const int thresh = -(int)ceilf(eps * (float)half);
        int k_grow;
        bool grow;
        if (pid == PLAN_DAC) {
            k_grow = 2 * k;
            grow = (jump >= 2 * k) && (2 * k <= kmax);
        } else {
            k_grow = min(2 * k, min(sc[4], kmax));
            grow = (jump >= 2 * k) && (k_grow > k);
        }
        const bool shrink = !grow && (jump <= -half) && (jump2 <= thresh) &&
                            (half >= k_min);
        const int k_new = grow ? k_grow : (shrink ? half : k);
        jump = shrink ? 0 : min(max(jump, -floor_half(k_new)), 2 * k_new);
        if (grow || shrink) jump2 = 0;
        wipe = shrink ? k_new : kmax;
        sc[0] = jump;
        sc[1] = jump2;
        sc[2] = k_new;
        break;
    }
    }
}

// One step of one lane.  Every thread of the block calls it; `row` may point
// to shared or device memory and must be 16-byte aligned.  On return (after
// the final barrier) `s` holds the step's results and the new scalars.
__device__ void step_row(int* row, int W, int key, int pid, float eps,
                         int k_min, StepShared& s) {
    const int tid = threadIdx.x, nt = blockDim.x;

    // 1. find: strided int4 compares, chunk by chunk, stopping at the first
    //    chunk that holds the key; the whole row is scanned on a miss
    if (tid == 0) s.min_idx = W;
    __syncthreads();
    for (int base = 0; base < W; base += nt * 4) {
        const int idx = base + tid * 4;
        int local = W;
        if (idx < W) {
            const int4 v = *reinterpret_cast<const int4*>(row + idx);
            if (v.x == key) local = idx;
            else if (v.y == key) local = idx + 1;
            else if (v.z == key) local = idx + 2;
            else if (v.w == key) local = idx + 3;
        }
        if (local < W) atomicMin(&s.min_idx, local);
        if (__syncthreads_or(local < W)) break;
    }

    // 2-3. plan and evict, on one thread
    if (tid == 0) {
        const int m = s.min_idx;
        const bool hit = m < W;
        int src, t, wipe;
        plan_eval(pid, hit, hit ? m : 0, s.sc, eps, k_min, src, t, wipe);
        s.src = src;
        s.t = t;
        s.wipe = wipe;
        s.hit = hit;
        s.evicted = row[src];
    }
    __syncthreads();
    const int src = s.src, t = s.t, wipe = max(s.wipe, 0);

    // 4. shift (t, src] right by one, high ranks first: each chunk reads,
    //    then writes, so no chunk reads what another has written
    for (int hi = src; hi > t; hi -= nt * SHIFT_V) {
        int v[SHIFT_V];
#pragma unroll
        for (int j = 0; j < SHIFT_V; ++j) {
            const int r = hi - tid - j * nt;
            if (r > t) v[j] = row[r - 1];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SHIFT_V; ++j) {
            const int r = hi - tid - j * nt;
            if (r > t) row[r] = v[j];
        }
        __syncthreads();
    }

    // 5. key at t (a wipe over t wins, as in the reference)
    if (tid == 0 && t < wipe) row[t] = key;
    // 6. wipe
    for (int r = wipe + tid; r < W; r += nt) row[r] = EMPTY_KEY;
    __syncthreads();
}

// at most 1024 threads a block (threads_for), so at most 64 registers each
__global__ void __launch_bounds__(1024) policy_step_kernel(int* __restrict__ rows,
                                   const int* __restrict__ keys,
                                   int* __restrict__ sc, int* hit_out,
                                   int* ev_out, int W, int n_sc, int pid,
                                   float eps, int k_min) {
    __shared__ StepShared s;
    const int b = blockIdx.x, tid = threadIdx.x;
    if (tid < n_sc) s.sc[tid] = sc[b * n_sc + tid];
    step_row(rows + (size_t)b * W, W, keys[b], pid, eps, k_min, s);
    if (tid < n_sc) sc[b * n_sc + tid] = s.sc[tid];
    if (tid == 0) {
        hit_out[b] = s.hit;
        ev_out[b] = s.evicted;
    }
}

__global__ void __launch_bounds__(1024) policy_replay_kernel(
        int* __restrict__ rows, int* __restrict__ sc,
        const int* __restrict__ keys, const int* __restrict__ sizes,
        const float* __restrict__ costs, int W, int T, int n_sc, int pid,
        float eps, int k_min, int resident, unsigned char* info_hit,
        int* info_ev, int* obs, long long* counts, float* sums,
        long long* work) {
    extern __shared__ int4 smem_row[];
    __shared__ StepShared s;
    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    int* grow = rows + (size_t)b * W;
    int* row = grow;
    if (resident) {
        row = reinterpret_cast<int*>(smem_row);
        for (int r = tid; r < W; r += nt) row[r] = grow[r];
    }
    if (tid < n_sc) s.sc[tid] = sc[b * n_sc + tid];
    const size_t off = (size_t)b * T;

    // per-lane totals, one thread, in the order of simulator.py::_acc_step
    long long hits = 0, scanned = 0, moved = 0, wiped = 0;
    float bytes_total = 0.f, bytes_missed = 0.f, cost_total = 0.f,
          penalty = 0.f;
    for (int step = 0; step < T; ++step) {
        step_row(row, W, keys[off + step], pid, eps, k_min, s);
        if (tid == 0) {
            const int hit = s.hit;
            const int size = sizes[off + step];
            const float cost = costs[off + step];
            hits += hit;
            bytes_total += (float)size;
            bytes_missed += hit ? 0.f : (float)size;
            cost_total += cost;
            penalty += hit ? 0.f : cost;
            scanned += hit ? s.min_idx + 1 : W;
            moved += s.src - s.t;
            wiped += W - min(max(s.wipe, 0), W);
            if (info_hit) {
                info_hit[off + step] = (unsigned char)hit;
                info_ev[off + step] = hit ? EMPTY_KEY : s.evicted;
            }
            if (obs) {
                for (int q = 0; q < n_sc; ++q)
                    obs[(off + step) * n_sc + q] = s.sc[q];
            }
        }
    }
    if (resident) {
        for (int r = tid; r < W; r += nt) grow[r] = row[r];
    }
    if (tid < n_sc) sc[b * n_sc + tid] = s.sc[tid];
    if (tid == 0) {
        counts[b * 2 + 0] = T;
        counts[b * 2 + 1] = hits;
        sums[b * 4 + 0] = bytes_total;
        sums[b * 4 + 1] = bytes_missed;
        sums[b * 4 + 2] = cost_total;
        sums[b * 4 + 3] = penalty;
        work[b * 3 + 0] = scanned;
        work[b * 3 + 1] = moved;
        work[b * 3 + 2] = wiped;
    }
}

static int threads_for(int W) {
    int n = (W / 4 + 31) / 32 * 32;
    return n < 128 ? 128 : (n > 1024 ? 1024 : n);
}

static bool bad_args(int W, int n_sc, int pid) {
    return W <= 0 || W % 128 != 0 || n_sc < 0 || n_sc > MAX_SC ||
           pid < PLAN_CLIMB || pid > PLAN_DAC_BUDGETED;
}

// One step on B lanes.  rows [B, W] and sc [B, n_sc] are updated in place;
// hit_out/ev_out are int32 [B].  Returns cudaGetLastError().
extern "C" int policy_step_batched(void* rows, const void* keys, void* sc,
                                   void* hit_out, void* ev_out, int B, int W,
                                   int n_sc, int pid, float eps, int k_min,
                                   void* stream) {
    if (bad_args(W, n_sc, pid) || B < 0) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    policy_step_kernel<<<B, threads_for(W), 0, (cudaStream_t)stream>>>(
        (int*)rows, (const int*)keys, (int*)sc, (int*)hit_out, (int*)ev_out,
        W, n_sc, pid, eps, k_min);
    return (int)cudaGetLastError();
}

// T steps on B lanes over keys/sizes/costs [B, T].  rows and sc are
// updated in place.  info_hit (uint8) / info_ev (int32) [B, T] are written
// when non-null, obs [B, T, n_sc] (the scalars after each step) when
// non-null; counts [B, 2] int64 (requests, hits), sums [B, 4] float32
// (bytes_total, bytes_missed, cost_total, penalty) and work [B, 3] int64
// (ranks scanned, moved, wiped) always.  Returns cudaGetLastError().
extern "C" int policy_replay(void* rows, void* sc, const void* keys,
                             const void* sizes, const void* costs, int B,
                             int W, int T, int n_sc, int pid, float eps,
                             int k_min, void* info_hit, void* info_ev,
                             void* obs, void* counts, void* sums, void* work,
                             void* stream) {
    if (bad_args(W, n_sc, pid) || B < 0 || T < 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const size_t row_bytes = (size_t)W * sizeof(int);
    const int resident = row_bytes <= SMEM_ROW_LIMIT;
    const size_t smem = resident ? row_bytes : 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            policy_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    policy_replay_kernel<<<B, threads_for(W), smem, (cudaStream_t)stream>>>(
        (int*)rows, (int*)sc, (const int*)keys, (const int*)sizes,
        (const float*)costs, W, T, n_sc, pid, eps, k_min, resident,
        (unsigned char*)info_hit, (int*)info_ev, (int*)obs,
        (long long*)counts, (float*)sums, (long long*)work);
    return (int)cudaGetLastError();
}
