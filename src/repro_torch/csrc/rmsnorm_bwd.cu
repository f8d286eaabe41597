// RMSNorm backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel (nothing
// under src/repro/kernels/ defines a custom_vjp), and its train_loss takes
// the gradient of the jnp rms_norm (src/repro/models/common.py) through
// XLA's autodiff. The port's forward is the CUDA kernel of csrc/rmsnorm.cu,
// whose output carries no autograd graph, so training needs this gradient
// as a kernel of its own. With x^ = x * r and r = rsqrt(mean(x^2) + eps),
// all in float32:
//
//   dx[t, :]  = r * (dy * g - x^ * mean(dy * g * x^))      (x's type)
//   dgain[:]  = sum over rows t of dy * x^                 (float32)
//
// Two launches a call. (1) rmsnorm_bwd_rows: block b owns a run of
// consecutive rows; for each row its threads fold sum(x^2) and
// sum(dy * g * x) over the row (warp shuffles, then the warps' sums added in
// one fixed order), write dx, and add dy * x^ into the block's own
// float32 accumulator of the gain's gradient in shared memory, column j
// always by the same thread. The block writes that accumulator out as its
// row of a [blocks, D] partial. (2) rmsnorm_bwd_reduce: one thread a column
// adds the partial's rows in block order. No float atomics anywhere, so
// the same inputs give the same gradient bitwise. The pair (a model's q and
// k norms, one D) shares both launches: the first blocks take the first
// tensor's rows and the rest the second's, as csrc/rmsnorm.cu does.
//
// Bound on this card: bytes. Each element costs about ten float32
// operations against reading x and dy and writing dx (6 bytes an element in
// bfloat16, 12 in float32), far below the card's operations-per-byte line,
// so the least time is those bytes over the HBM rate. This first version
// reads x, dy and g twice (once for the two sums, once for dx), loads one
// element at a time, and gives a 128-wide row a whole block with two
// barriers: it is right and simple, and the speed is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlocksPerTensor = 512;

template <typename T>
struct Rows {
  const T* x;
  const T* g;
  const T* dy;
  T* dx;
  float* partial;  // [blocks, d]
  int rows;
  int rows_per_block;
  int blocks;
};

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
  return __float2bfloat16(v);
}

// (sum of a, sum of b) over the block, the same in every thread; the warp
// folds are xor butterflies and the warps' sums are added in warp order.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous row's readers are done with scratch
  if ((threadIdx.x & 31) == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    total.x += scratch[w].x;
    total.y += scratch[w].y;
  }
  return total;
}

template <typename T>
__global__ void rmsnorm_bwd_rows(Rows<T> a, Rows<T> b, int d, float eps) {
  extern __shared__ float dg[];  // [d]: this block's share of dgain
  __shared__ float2 scratch[32];
  int block = blockIdx.x;
  const Rows<T>& p = block < a.blocks ? a : b;
  if (block >= a.blocks) block -= a.blocks;
  for (int j = threadIdx.x; j < d; j += blockDim.x) dg[j] = 0.f;
  const int r0 = block * p.rows_per_block;
  const int r1 = min(r0 + p.rows_per_block, p.rows);
  for (int r = r0; r < r1; ++r) {
    const T* x = p.x + static_cast<size_t>(r) * d;
    const T* dy = p.dy + static_cast<size_t>(r) * d;
    float sq = 0.f, dot = 0.f;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float xv = to_f32(x[j]);
      sq += xv * xv;
      dot += to_f32(dy[j]) * to_f32(p.g[j]) * xv;
    }
    const float2 s = block_sum2(sq, dot, scratch);
    // mean then rsqrt, as the forward: IEEE division and sqrt
    const float rr = 1.0f / sqrtf(s.x / static_cast<float>(d) + eps);
    const float c = rr * s.y / static_cast<float>(d);  // mean(dy g x^)
    T* dx = p.dx + static_cast<size_t>(r) * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float xh = to_f32(x[j]) * rr;
      const float dv = to_f32(dy[j]);
      dx[j] = from_f32<T>(rr * (dv * to_f32(p.g[j]) - xh * c));
      dg[j] += dv * xh;
    }
  }
  float* out = p.partial + static_cast<size_t>(block) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) out[j] = dg[j];
}

// dgain[j] = sum over the tensor's blocks, in block order; blockIdx.y picks
// the tensor.
__global__ void rmsnorm_bwd_reduce(const float* partial, float* dg_a,
                                   int blocks_a, float* dg_b, int blocks_b,
                                   int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const float* src = partial;
  float* dst = dg_a;
  int n = blocks_a;
  if (blockIdx.y == 1) {
    src = partial + static_cast<size_t>(blocks_a) * d;
    dst = dg_b;
    n = blocks_b;
  }
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += src[static_cast<size_t>(i) * d + j];
  dst[j] = s;
}

template <typename T>
Rows<T> plan(const void* x, const void* g, const void* dy, void* dx,
             float* partial, int rows) {
  Rows<T> p;
  p.x = static_cast<const T*>(x);
  p.g = static_cast<const T*>(g);
  p.dy = static_cast<const T*>(dy);
  p.dx = static_cast<T*>(dx);
  p.partial = partial;
  p.rows = rows;
  const int blocks = rows < kMaxBlocksPerTensor ? rows : kMaxBlocksPerTensor;
  p.rows_per_block = blocks > 0 ? (rows + blocks - 1) / blocks : 1;
  p.blocks = rows > 0 ? (rows + p.rows_per_block - 1) / p.rows_per_block : 0;
  return p;
}

template <typename T>
int launch(const void* x_a, const void* g_a, const void* dy_a, void* dx_a,
           void* dg_a, int t_a, const void* x_b, const void* g_b,
           const void* dy_b, void* dx_b, void* dg_b, int t_b, void* partial,
           int d, float eps, cudaStream_t stream) {
  float* part = static_cast<float*>(partial);
  Rows<T> a = plan<T>(x_a, g_a, dy_a, dx_a, part, t_a);
  Rows<T> b = plan<T>(x_b, g_b, dy_b, dx_b,
                      part + static_cast<size_t>(a.blocks) * d, t_b);
  const int blocks = a.blocks + b.blocks;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  int threads = ((d + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rmsnorm_bwd_rows<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rmsnorm_bwd_rows<T><<<blocks, threads, smem, stream>>>(a, b, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((d + 255) / 256, b.blocks > 0 ? 2 : 1);
  rmsnorm_bwd_reduce<<<grid, 256, 0, stream>>>(
      part, static_cast<float*>(dg_a), a.blocks, static_cast<float*>(dg_b),
      b.blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows of the [blocks, D] float32 partial that a tensor of t rows
// needs; the wrapper allocates the sum over the call's tensors.
extern "C" int rmsnorm_bwd_partial_rows(int t) {
  if (t <= 0) return 0;
  const int blocks = t < kMaxBlocksPerTensor ? t : kMaxBlocksPerTensor;
  const int per = (t + blocks - 1) / blocks;
  return (t + per - 1) / per;
}

// Two tensors of one D: (x_a, g_a, dy_a) -> (dx_a, dg_a) over t_a rows and
// (x_b, ...) over t_b rows (t_b = 0: one tensor). x, dy, dx [t, d]
// contiguous of the dtype (0 float32, 1 bfloat16), g [d] of the dtype, dg
// [d] float32, partial float32 [partial rows of a + of b, d].
extern "C" int rmsnorm_pair_bwd_launch(
    const void* x_a, const void* g_a, const void* dy_a, void* dx_a,
    void* dg_a, int t_a, const void* x_b, const void* g_b, const void* dy_b,
    void* dx_b, void* dg_b, int t_b, void* partial, int d, float eps,
    int dtype, void* stream) {
  if (d <= 0 || t_a < 0 || t_b < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x_a, g_a, dy_a, dx_a, dg_a, t_a, x_b, g_b, dy_b,
                         dx_b, dg_b, t_b, partial, d, eps, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x_a, g_a, dy_a, dx_a, dg_a, t_a, x_b, g_b,
                                 dy_b, dx_b, dg_b, t_b, partial, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rmsnorm_bwd_launch(const void* x, const void* g,
                                  const void* dy, void* dx, void* dg, int t,
                                  void* partial, int d, float eps, int dtype,
                                  void* stream) {
  return rmsnorm_pair_bwd_launch(x, g, dy, dx, dg, t, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, 0, partial, d,
                                 eps, dtype, stream);
}
