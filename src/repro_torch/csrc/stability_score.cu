// Candidate stability scoring (paper Eq. 3-7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stability_score/kernel.py
// (_score_kernel, stability_scores_kernel). For each candidate n:
//
//   S_n = sum_{m,i} mask * min(exp(min((w + L_n) / tau - 1, ln C)), C)
//         - sum_{i < B_n} (the same terms at row q_n)
//
// computed as total minus removed, in that order, like the reference. tau is
// an [M, Q] per-task deadline matrix, or (a null pointer) one scalar SLO: the
// reference fills a matrix with the scalar, which divides bitwise the same.
//
// Design. Two layouts, picked on the host from the shape, neither with
// atomics, so a result repeats bitwise from run to run:
//
// * Few tasks (M*Q <= 4096; the scheduler's M = 3 rounds). One warp per
//   candidate, eight candidates to a block. The warp's lanes stride over the
//   M*Q tasks, loading 8 tasks each before computing any (a loop that loads
//   one task at a time waits on L2 once per task, which at M = 3 is most of
//   the kernel's time), and fold with a fixed xor-shuffle butterfly: no
//   shared memory and no barrier.
// * Many tasks (M = 256 and up). A block of 32 warps holds K candidates and
//   its 1024 threads stride over the tasks, 4 tasks loaded at a time: each
//   thread loads a task's (w, mask, tau) once and evaluates it for the K
//   candidates, whose latencies and running sums sit in registers. Every
//   block reads the [M, Q] matrices from L2 once, so the L2 traffic falls K
//   times against one block per candidate. K = 8 where that still leaves at
//   least 128 blocks (about one per SM of the 132); smaller K keeps more
//   blocks in flight for fewer candidates. 32 warps an SM hide the latency
//   of the IEEE division, whose slow-path branch keeps the compiler from
//   interleaving one division with the next (16-warp blocks were slower at
//   M = 256, N = 1024). The warps fold by shuffle, then warp 0 adds the 32
//   warp sums in a fixed order after one barrier.
//
// In both, the removed term is summed over the first B_n positions of row
// q_n only (B_n is at most the batch ladder's top), not tested on every
// element; ln C is taken once on the host. A task whose mask is 0 adds
// +0 (the term is finite: it is at most C), so it is skipped.
//
// Bound on this card. Per (candidate, task) an add, an IEEE division, a
// subtract, a min, an expf, a min, a multiply and an add: the bound counts
// these as 8 float32 operations at 67 TFLOP/s, 8*N*M*Q in all, against w,
// mask and tau (3*M*Q*4 bytes) read once plus 16 bytes a candidate. That is
// optimistic: built without --use_fast_math, the division (a reciprocal on
// the special function unit and Newton steps) and the precise expf (range
// reduction around ex2) take some 25 instructions and two special-function
// operations, and the special function units issue at an eighth of the
// float32 rate. The products and adds are rounded as the reference's
// (__fmul_rn, __fadd_rn).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpTasks = 4096;   // at or below: one warp per candidate
constexpr int kWarpBlockWarps = 8;
constexpr int kWarpChunk = 8;      // tasks a lane loads before it computes
constexpr int kTileWarps = 32;     // many tasks: 1024 threads share K candidates
constexpr int kTileChunk = 4;
constexpr int kMaxK = 8;
constexpr int kMinTileBlocks = 128;

struct Args {
  const float* w;
  const float* mask;
  const float* tau;  // null: tau_scalar for every task
  float tau_scalar;
  const float* lat;
  const int32_t* batch;
  const int32_t* queue;  // null: the greedy layout, candidate n serves queue n
  int n, m, q;
  float clip, log_clip;
  float* out;
};

__device__ __forceinline__ float term(float w, float lat, float tau, float mk,
                                      float log_clip, float clip) {
  const float x = __fsub_rn(__fdiv_rn(__fadd_rn(w, lat), tau), 1.0f);
  return __fmul_rn(fminf(expf(fminf(x, log_clip)), clip), mk);
}

// The terms of tasks [start, M*Q) in steps of `stride`, for candidates whose
// latencies are lat[0..K), added to total[0..K) in task order. C tasks are
// loaded before any is computed, so their loads are in flight together.
template <int K, int C>
__device__ __forceinline__ void sum_tasks(const Args& a, const float* lat,
                                          float* total, int start,
                                          int stride) {
  const int size = a.m * a.q;
  for (int base = start; base < size; base += C * stride) {
    float wv[C], mv[C], tv[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = base + j * stride;
      const bool in = i < size;
      mv[j] = in ? a.mask[i] : 0.0f;
      wv[j] = in ? a.w[i] : 0.0f;
      tv[j] = a.tau == nullptr ? a.tau_scalar : (in ? a.tau[i] : 1.0f);
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (mv[j] == 0.0f) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        total[k] = __fadd_rn(total[k], term(wv[j], lat[k], tv[j], mv[j],
                                            a.log_clip, a.clip));
      }
    }
  }
}

// The removed term of candidate c, this lane's share (positions lane,
// lane + 32, ... below B_c of row q_c).
__device__ __forceinline__ float removed_share(const Args& a, int c, float lat,
                                               int lane) {
  const int row = a.queue != nullptr ? a.queue[c] : c;
  const int b = min(a.batch[c], a.q);
  float removed = 0.0f;
  if (row < 0 || row >= a.m) return removed;
  for (int pos = lane; pos < b; pos += 32) {
    const int i = row * a.q + pos;
    const float mk = a.mask[i];
    if (mk == 0.0f) continue;
    const float t = a.tau != nullptr ? a.tau[i] : a.tau_scalar;
    removed = __fadd_rn(removed, term(a.w[i], lat, t, mk, a.log_clip, a.clip));
  }
  return removed;
}

// A fixed xor butterfly: every lane ends with the same bits (each level adds
// the same two values, in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(32 * kWarpBlockWarps)
    score_warp_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpBlockWarps + (threadIdx.x >> 5);
  if (c >= a.n) return;  // whole warps leave together
  const float lat = a.lat[c];
  float total = 0.0f;
  sum_tasks<1, kWarpChunk>(a, &lat, &total, lane, 32);
  const float removed = removed_share(a, c, lat, lane);
  total = warp_sum(total);
  const float gone = warp_sum(removed);
  if (lane == 0) a.out[c] = total - gone;
}

template <int K>
__global__ void __launch_bounds__(32 * kTileWarps) score_tile_kernel(Args a) {
  __shared__ float s_total[kTileWarps][K];
  __shared__ float s_removed[K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * K;
  float lat[K], total[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lat[k] = a.lat[min(first + k, a.n - 1)];  // a ragged tail scores a copy
    total[k] = 0.0f;
  }
  sum_tasks<K, kTileChunk>(a, lat, total, threadIdx.x, 32 * kTileWarps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    total[k] = warp_sum(total[k]);
    if (lane == 0) s_total[warp][k] = total[k];
  }
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float r = first + k < a.n
                          ? warp_sum(removed_share(a, first + k, lat[k], lane))
                          : 0.0f;
      if (lane == 0) s_removed[k] = r;
    }
  }
  __syncthreads();
  if (warp == 0 && lane < K && first + lane < a.n) {
    float sum = s_total[0][lane];
    for (int w = 1; w < kTileWarps; ++w) sum = __fadd_rn(sum, s_total[w][lane]);
    a.out[first + lane] = sum - s_removed[lane];
  }
}

// The kernel entries, in the order of ENTRIES in ops.py.
enum Entry { kWarpEntry = 0, kTile8, kTile4, kTile2, kTile1 };

// One launch of a plan: the kernel entry (an index into ENTRIES in
// kernels/stability_score/ops.py), grid, block, dynamic shared memory bytes,
// whether the launch path raises the 48 KB cap on it, and the blocks of a
// cluster along x. The launch path takes its geometry from the plan, and
// stability_score_plan writes each launch as kPlanFields ints for the launch audit
// (repro_torch/analysis/launch_audit.py), which holds it against
// launch_plan in ops.py.
struct Launch {
  int entry;
  dim3 grid, block;
  int smem, optin, cluster;
};
constexpr int kPlanFields = 10;

int write_plan(const Launch* l, int n, int* out) {
  for (int i = 0; i < n; ++i) {
    const int row[kPlanFields] = {
        l[i].entry, static_cast<int>(l[i].grid.x),
        static_cast<int>(l[i].grid.y), static_cast<int>(l[i].grid.z),
        static_cast<int>(l[i].block.x), static_cast<int>(l[i].block.y),
        static_cast<int>(l[i].block.z), l[i].smem, l[i].optin, l[i].cluster};
    for (int j = 0; j < kPlanFields; ++j) out[i * kPlanFields + j] = row[j];
  }
  return n;
}

// One launch: a warp per candidate over few tasks, else K candidates per
// block of kTileWarps warps, K halved until there are kMinTileBlocks
// blocks (or K is 1). No launch for no candidates or no tasks.
int make_plan(int n, int m, int q, Launch* out) {
  if (n <= 0 || m * q <= 0) return 0;
  if (m * q <= kWarpTasks) {
    const int blocks = (n + kWarpBlockWarps - 1) / kWarpBlockWarps;
    const int warps = blocks == 1 ? n : kWarpBlockWarps;
    out[0] = {kWarpEntry, dim3(blocks), dim3(32 * warps), 0, 0, 1};
    return 1;
  }
  int k = kMaxK;
  while (k > 1 && (n + k - 1) / k < kMinTileBlocks) k >>= 1;
  const int entry = k == 8 ? kTile8 : k == 4 ? kTile4 : k == 2 ? kTile2
                                                              : kTile1;
  out[0] = {entry, dim3((n + k - 1) / k), dim3(32 * kTileWarps), 0, 0, 1};
  return 1;
}

}  // namespace

// tau == nullptr selects tau_scalar for every task; cand_queue == nullptr
// the greedy layout (then n == m). Launches on `stream` and returns
// cudaGetLastError() (0 = launched). The caller checks shapes and types.
extern "C" int stability_score_launch(
    const float* w, const float* mask, const float* tau, float tau_scalar,
    const float* cand_latency, const int32_t* cand_batch,
    const int32_t* cand_queue, int n, int m, int q, float clip, float* out,
    void* stream) {
  Launch l[1];
  if (make_plan(n, m, q, l) == 1) {
    const Args a{w, mask, tau, tau_scalar, cand_latency, cand_batch,
                 cand_queue, n, m, q, clip, logf(clip), out};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (l[0].entry) {
      case kWarpEntry: score_warp_kernel<<<l[0].grid, l[0].block, 0, s>>>(a); break;
      case kTile8: score_tile_kernel<8><<<l[0].grid, l[0].block, 0, s>>>(a); break;
      case kTile4: score_tile_kernel<4><<<l[0].grid, l[0].block, 0, s>>>(a); break;
      case kTile2: score_tile_kernel<2><<<l[0].grid, l[0].block, 0, s>>>(a); break;
      default: score_tile_kernel<1><<<l[0].grid, l[0].block, 0, s>>>(a); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan of stability_score_launch at these sizes: writes each launch's
// kPlanFields ints to `plan` and returns the number of launches.
extern "C" int stability_score_plan(int n, int m, int q, int* plan) {
  Launch l[1];
  return write_plan(l, make_plan(n, m, q, l), plan);
}
