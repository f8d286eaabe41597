// Candidate stability scoring (paper Eq. 3-7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stability_score/kernel.py
// (_score_kernel, stability_scores_kernel). For each candidate n:
//
//   S_n = sum_{m,i} mask * min(exp(min((w + L_n) / tau - 1, ln C)), C)
//         - sum_{i < B_n} (the same terms at row q_n)
//
// computed as total minus removed, in that order, like the reference.
//
// Design. One thread block per candidate; its threads stride over the M*Q
// tasks, so neighbouring threads read neighbouring words of w, mask and tau.
// Each thread keeps two running sums (total, removed) in registers; the
// block then folds them with a fixed-order tree in shared memory. There are
// no atomics, so a result is the same from run to run. The Pallas kernel's
// padding of N to its block size is not needed: the grid is exactly N.
//
// Bound on this card. Per candidate every task costs a float32 add, an IEEE
// division, a subtract, a min, an expf, a min, a multiply and an add: about
// 8 float32 operations, so 8*N*M*Q in all, against w, mask and tau
// (3*M*Q*4 bytes) read once plus 16 bytes a candidate. Every block rereads
// the [M, Q] matrices, which stay in the 50 MB L2 at the scheduler's sizes,
// so the operations bound it: exp and the division go through the special
// function units, which is why the kernel keeps each element to one expf and
// one division. Built without --use_fast_math: expf and the division stay
// precise, and the products are rounded like the reference's (__fmul_rn).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stability_score_kernel(
    const float* __restrict__ w, const float* __restrict__ mask,
    const float* __restrict__ tau, const float* __restrict__ cand_latency,
    const int32_t* __restrict__ cand_batch,
    const int32_t* __restrict__ cand_queue, int size, int q, float clip,
    float* __restrict__ out) {
  __shared__ float s_total[kThreads];
  __shared__ float s_removed[kThreads];

  const int n = blockIdx.x;
  const float lat = cand_latency[n];
  const int batch = cand_batch[n];
  // cand_queue == nullptr: the greedy layout, candidate n serves queue n.
  const int queue = cand_queue != nullptr ? cand_queue[n] : n;
  const float log_clip = logf(clip);

  // (row, pos) of idx advance by a fixed step: one integer division per
  // thread, not one per element.
  const int row_step = kThreads / q;
  const int pos_step = kThreads - row_step * q;
  int row = threadIdx.x / q;
  int pos = threadIdx.x - row * q;
  float total = 0.0f;
  float removed = 0.0f;
  for (int idx = threadIdx.x; idx < size; idx += kThreads) {
    const float x = __fsub_rn(__fdiv_rn(__fadd_rn(w[idx], lat), tau[idx]), 1.0f);
    const float u = __fmul_rn(fminf(expf(fminf(x, log_clip)), clip), mask[idx]);
    total = __fadd_rn(total, u);
    if (row == queue && pos < batch) removed = __fadd_rn(removed, u);
    row += row_step;
    pos += pos_step;
    if (pos >= q) {
      pos -= q;
      ++row;
    }
  }
  s_total[threadIdx.x] = total;
  s_removed[threadIdx.x] = removed;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_total[threadIdx.x] += s_total[threadIdx.x + stride];
      s_removed[threadIdx.x] += s_removed[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[n] = s_total[0] - s_removed[0];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller checks shapes and types; cand_queue may be null (greedy layout,
// then n == m).
extern "C" int stability_score_launch(
    const float* w, const float* mask, const float* tau,
    const float* cand_latency, const int32_t* cand_batch,
    const int32_t* cand_queue, int n, int m, int q, float clip, float* out,
    void* stream) {
  if (n > 0 && m * q > 0) {
    stability_score_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        w, mask, tau, cand_latency, cand_batch, cand_queue, m * q, q, clip, out);
  }
  return static_cast<int>(cudaGetLastError());
}
