// RMSNorm over the last dimension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, rmsnorm_kernel):
//
//   out[t, :] = x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * g
//
// accumulated in float32 and written in x's type (float32 or bfloat16).
//
// Design. One thread block per row for the models' residual norms (D = 576
// to 4096; 128 or 256 threads). The TPU kernel keeps a [bt, D] row tile
// resident in VMEM; here a row is at most a few KB, so each block reads its
// row twice (the second read hits L1/L2): once for the sum of squares, once
// to scale and write. Each thread sums a fixed, strided set of elements in
// registers; the warps fold with a shuffle tree and the block with a
// fixed-order pass over the warp sums. Short rows (D <= 512: Qwen3's
// per-head q/k norm has D = 128 and T = B * 128 * 32 rows) take one warp
// per row instead, eight rows to a block, so that a block is not mostly
// idle threads. No atomics, so a row's result is the same from run to run.
// Any D works.
//
// Bound on this card: bytes. Each element costs three float32 operations
// against 4 (bf16) to 8 (f32) bytes moved, far below the card's
// operations-per-byte line, so the least time is (read T*D + write T*D) over
// the HBM rate. At the served shapes (T = B*128 rows) a launch moves at most
// a few MB, so the launch itself is a large share of the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS) rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out,
    int d, float eps) {
  constexpr int kWarps = THREADS / 32;
  __shared__ float s_warp[kWarps];
  __shared__ float s_scale;

  const T* row = x + static_cast<int64_t>(blockIdx.x) * d;
  T* orow = out + static_cast<int64_t>(blockIdx.x) * d;

  float sq = 0.0f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float v = to_f32(row[i]);
    sq = fmaf(v, v, sq);
  }
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) s_warp[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    // mean then rsqrt, as the reference: IEEE division and sqrt.
    s_scale = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float scale = s_scale;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    orow[i] = from_f32<T>(to_f32(row[i]) * scale * to_f32(g[i]));
  }
}

// One warp per row, kRowsPerBlock rows to a block.
constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock) rmsnorm_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out,
    int t, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= t) return;  // whole warps leave together
  const T* xr = x + static_cast<int64_t>(row) * d;
  T* orow = out + static_cast<int64_t>(row) * d;
  float sq = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    sq = fmaf(v, v, sq);
  }
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float scale = 1.0f / sqrtf(sq / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * scale * to_f32(g[i]));
  }
}

template <typename T>
int launch(const void* x, const void* g, void* out, int t, int d, float eps,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  if (d <= 512) {
    const int blocks = (t + kRowsPerBlock - 1) / kRowsPerBlock;
    rmsnorm_rows_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        xp, gp, op, t, d, eps);
  } else if (d <= 1024) {
    rmsnorm_kernel<T, 128><<<t, 128, 0, stream>>>(xp, gp, op, d, eps);
  } else {
    rmsnorm_kernel<T, 256><<<t, 256, 0, stream>>>(xp, gp, op, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [t, d] and g [d], contiguous, all of one type: dtype 0 = float32,
// 1 = bfloat16. Launches on `stream` and returns cudaGetLastError()
// (0 = launched). The caller checks shapes and types.
extern "C" int rmsnorm_launch(const void* x, const void* g, void* out, int t,
                              int d, float eps, int dtype, void* stream) {
  if (t <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, g, out, t, d, eps, s);
  return launch<__nv_bfloat16>(x, g, out, t, d, eps, s);
}
