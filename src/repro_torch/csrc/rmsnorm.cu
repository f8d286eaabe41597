// RMSNorm over the last dimension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, rmsnorm_kernel):
//
//   out[t, :] = x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * g
//
// accumulated in float32 and written in x's type (float32 or bfloat16). One
// launch normalises one tensor, or two with the same D and their own gains
// (a model's per-head q and k norms): the first blocks take the first
// tensor's rows and the rest the second's.
//
// Bound on this card: bytes. Each element costs three float32 operations
// against 4 (bf16) to 8 (f32) bytes moved, far below the card's
// operations-per-byte line, so the least time is (read T*D + write T*D) over
// the HBM rate. At a decode step's rows (T = B) a launch moves a few KB, so
// its time is the launch and one dependent chain: load, fold, scale, store.
//
// Design. The TPU kernel keeps a [bt, D] row tile resident in VMEM. Here a
// row is held in registers: each thread loads its share of the row 16 bytes
// at a time (8 bf16 or 4 float32), sums the squares, and after the fold
// scales the same registers and stores 16 bytes at a time, so x is read from
// memory once. The gain is loaded before the fold, so its latency hides
// behind it. Two layouts, by the row's count of 16-byte vectors (nvec):
//
// * nvec <= 128 (bf16 D <= 1024, float32 D <= 512): a sub-warp of
//   min(32, nvec) lanes (rounded up to a power of two) per row, several rows
//   a warp, 256 threads a block: Qwen3's 32768 q rows of D = 128 (16 lanes a
//   row) fill the card with 2048 blocks. The sub-warp folds with an xor
//   butterfly; no shared memory, no barrier.
// * Longer rows: one block a row, 32 * ceil(nvec / 128) threads, so each
//   thread holds up to 4 vectors (128 threads at D = 4096 bf16). Warps fold
//   by shuffle; after one barrier every thread adds the warp sums in the same
//   order, so no thread waits on another for the scale.
//
// The vector path needs D * size a multiple of 16 bytes and every base
// address 16-byte aligned (then every row is). Where either fails (D = 100,
// an offset view), or a row exceeds 4096 vectors, the C entry takes the
// scalar kernels below before the launch: one warp per row for D <= 512,
// else one block per row, each element loaded alone and x read twice. The
// choice is made from the shape and the addresses, never after a failure.
// Every fold is in a fixed order, with IEEE sqrtf and division, so a result
// repeats bitwise from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One tensor's rows: x, out [rows, d] and g [d], contiguous.
template <typename T>
struct Rows {
  const T* x;
  const T* g;
  T* out;
  int rows;
};

// The tensors of one launch: blocks [0, blocks_a) take a's rows, the rest
// b's (b.rows == 0 for a single tensor).
template <typename T>
struct Pair {
  Rows<T> a, b;
  int blocks_a;
};

// This block's tensor, and `block` made relative to it.
template <typename T>
__device__ __forceinline__ Rows<T> pick(const Pair<T>& p, int& block) {
  if (block < p.blocks_a) return p.a;
  block -= p.blocks_a;
  return p.b;
}

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

// 16 bytes as float32 values, and back.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  // a bf16 is the high half of its float32; element 2i is the low half of
  // word i
  __device__ __forceinline__ static void load(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]))) |
             (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])))
              << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The squares of this thread's vectors idx = first + j * step (j < V,
// idx < nvec), loaded into xv and gv; returns their float32 sum.
template <typename T, int V>
__device__ __forceinline__ float load_row(const Rows<T>& r, int row, bool live,
                                          int nvec, int first, int step,
                                          uint4* xv, uint4* gv) {
  constexpr int E = Vec<T>::kElems;
  const uint4* xr =
      reinterpret_cast<const uint4*>(r.x + static_cast<int64_t>(row) * nvec * E);
  const uint4* g = reinterpret_cast<const uint4*>(r.g);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int idx = first + j * step;
    if (live && idx < nvec) {
      xv[j] = xr[idx];
      gv[j] = g[idx];
      float f[E];
      Vec<T>::load(xv[j], f);
#pragma unroll
      for (int e = 0; e < E; ++e) sq = fmaf(f[e], f[e], sq);
    }
  }
  return sq;
}

template <typename T, int V>
__device__ __forceinline__ void store_row(const Rows<T>& r, int row, bool live,
                                          int nvec, int first, int step,
                                          const uint4* xv, const uint4* gv,
                                          float scale) {
  constexpr int E = Vec<T>::kElems;
  uint4* orow =
      reinterpret_cast<uint4*>(r.out + static_cast<int64_t>(row) * nvec * E);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int idx = first + j * step;
    if (live && idx < nvec) {
      float f[E], g[E];
      Vec<T>::load(xv[j], f);
      Vec<T>::load(gv[j], g);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = f[e] * scale * g[e];
      orow[idx] = Vec<T>::store(f);
    }
  }
}

// mean then rsqrt, as the reference: IEEE division and sqrt.
__device__ __forceinline__ float rms_scale(float sq, int d, float eps) {
  return 1.0f / sqrtf(sq / static_cast<float>(d) + eps);
}

constexpr int kVecThreads = 256;

// LANES lanes a row (a power of two up to 32), each holding up to V vectors.
template <typename T, int LANES, int V>
__global__ void __launch_bounds__(kVecThreads) rmsnorm_vec_rows_kernel(
    Pair<T> p, int d, float eps) {
  constexpr int kRowsPerBlock = kVecThreads / LANES;
  int block = blockIdx.x;
  const Rows<T> r = pick(p, block);
  const int row = block * kRowsPerBlock + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const bool live = row < r.rows;  // a dead row's lanes still shuffle
  const int nvec = d / Vec<T>::kElems;
  uint4 xv[V], gv[V];
  float sq = load_row<T, V>(r, row, live, nvec, lane, LANES, xv, gv);
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  store_row<T, V>(r, row, live, nvec, lane, LANES, xv, gv,
                  rms_scale(sq, d, eps));
}

// One block a row, each thread holding up to kBlockVecs vectors.
constexpr int kBlockVecs = 4;

template <typename T>
__global__ void __launch_bounds__(1024) rmsnorm_vec_block_kernel(
    Pair<T> p, int d, float eps) {
  __shared__ float s_warp[32];
  int row = blockIdx.x;
  const Rows<T> r = pick(p, row);
  const int nvec = d / Vec<T>::kElems;
  uint4 xv[kBlockVecs], gv[kBlockVecs];
  float sq = load_row<T, kBlockVecs>(r, row, true, nvec, threadIdx.x,
                                     blockDim.x, xv, gv);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x / 32] = sq;
  __syncthreads();
  float total = s_warp[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) total += s_warp[w];
  store_row<T, kBlockVecs>(r, row, true, nvec, threadIdx.x, blockDim.x, xv,
                           gv, rms_scale(total, d, eps));
}

// The scalar kernels, for rows the vector path cannot take.

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS) rmsnorm_kernel(
    Pair<T> p, int d, float eps) {
  constexpr int kWarps = THREADS / 32;
  __shared__ float s_warp[kWarps];
  __shared__ float s_scale;

  int block = blockIdx.x;
  const Rows<T> r = pick(p, block);
  const T* row = r.x + static_cast<int64_t>(block) * d;
  T* orow = r.out + static_cast<int64_t>(block) * d;

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
    s_scale = rms_scale(total, d, eps);
  }
  __syncthreads();
  const float scale = s_scale;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    orow[i] = from_f32<T>(to_f32(row[i]) * scale * to_f32(r.g[i]));
  }
}

// One warp per row, kRowsPerBlock rows to a block.
constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock) rmsnorm_rows_kernel(
    Pair<T> p, int d, float eps) {
  int block = blockIdx.x;
  const Rows<T> r = pick(p, block);
  const int row = block * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= r.rows) return;  // whole warps leave together
  const T* xr = r.x + static_cast<int64_t>(row) * d;
  T* orow = r.out + static_cast<int64_t>(row) * d;
  float sq = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    sq = fmaf(v, v, sq);
  }
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float scale = rms_scale(sq, d, eps);
  for (int i = lane; i < d; i += 32) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * scale * to_f32(r.g[i]));
  }
}

template <typename T>
bool aligned16(const Rows<T>& r) {
  return r.rows == 0 ||
         ((reinterpret_cast<uintptr_t>(r.x) | reinterpret_cast<uintptr_t>(r.g) |
           reinterpret_cast<uintptr_t>(r.out)) % 16) == 0;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Launch `kernel` over both tensors, `per_block` rows to a block.
template <typename T, typename K>
void launch_pair(K kernel, Pair<T> p, int per_block, int threads, int d,
                 float eps, cudaStream_t stream) {
  p.blocks_a = cdiv(p.a.rows, per_block);
  const int blocks = p.blocks_a + cdiv(p.b.rows, per_block);
  kernel<<<blocks, threads, 0, stream>>>(p, d, eps);
}

template <typename T, int LANES>
void launch_rows(Pair<T> p, int nvec, int d, float eps, cudaStream_t s) {
  const int per_block = kVecThreads / LANES;
  switch (cdiv(nvec, LANES)) {
    case 1: launch_pair(rmsnorm_vec_rows_kernel<T, LANES, 1>, p, per_block,
                        kVecThreads, d, eps, s); break;
    case 2: launch_pair(rmsnorm_vec_rows_kernel<T, LANES, 2>, p, per_block,
                        kVecThreads, d, eps, s); break;
    case 3: launch_pair(rmsnorm_vec_rows_kernel<T, LANES, 3>, p, per_block,
                        kVecThreads, d, eps, s); break;
    default: launch_pair(rmsnorm_vec_rows_kernel<T, LANES, 4>, p, per_block,
                         kVecThreads, d, eps, s); break;
  }
}

template <typename T>
int launch(Pair<T> p, int d, float eps, cudaStream_t s) {
  constexpr int E = Vec<T>::kElems;
  const int nvec = d / E;
  const bool vec = d % E == 0 && nvec <= 32 * kBlockVecs * 32 &&
                   aligned16(p.a) && aligned16(p.b);
  if (vec && nvec <= 32 * kBlockVecs) {
    if (nvec <= 4) launch_rows<T, 4>(p, nvec, d, eps, s);
    else if (nvec <= 8) launch_rows<T, 8>(p, nvec, d, eps, s);
    else if (nvec <= 16) launch_rows<T, 16>(p, nvec, d, eps, s);
    else launch_rows<T, 32>(p, nvec, d, eps, s);
  } else if (vec) {
    launch_pair(rmsnorm_vec_block_kernel<T>, p, 1,
                32 * cdiv(nvec, 32 * kBlockVecs), d, eps, s);
  } else if (d <= 512) {
    launch_pair(rmsnorm_rows_kernel<T>, p, kRowsPerBlock, 32 * kRowsPerBlock,
                d, eps, s);
  } else if (d <= 1024) {
    launch_pair(rmsnorm_kernel<T, 128>, p, 1, 128, d, eps, s);
  } else {
    launch_pair(rmsnorm_kernel<T, 256>, p, 1, 256, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* xa, const void* ga, void* outa, int ta,
                 const void* xb, const void* gb, void* outb, int tb, int d,
                 float eps, cudaStream_t s) {
  Pair<T> p{{static_cast<const T*>(xa), static_cast<const T*>(ga),
             static_cast<T*>(outa), ta},
            {static_cast<const T*>(xb), static_cast<const T*>(gb),
             static_cast<T*>(outb), tb},
            0};
  return launch<T>(p, d, eps, s);
}

}  // namespace

// x_a, out_a [t_a, d] with gain g_a [d], and x_b, out_b [t_b, d] with g_b
// [d], contiguous, all of one type: dtype 0 = float32, 1 = bfloat16. Both
// in one launch on `stream`; returns cudaGetLastError() (0 = launched). The
// caller checks shapes and types.
extern "C" int rmsnorm_pair_launch(const void* x_a, const void* g_a,
                                   void* out_a, int t_a, const void* x_b,
                                   const void* g_b, void* out_b, int t_b,
                                   int d, float eps, int dtype, void* stream) {
  if (t_a < 0 || t_b < 0 || t_a + t_b == 0 || d <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(x_a, g_a, out_a, t_a, x_b, g_b, out_b, t_b, d,
                               eps, s);
  }
  return launch_typed<__nv_bfloat16>(x_a, g_a, out_a, t_a, x_b, g_b, out_b,
                                     t_b, d, eps, s);
}

// One tensor: x, out [t, d] and g [d].
extern "C" int rmsnorm_launch(const void* x, const void* g, void* out, int t,
                              int d, float eps, int dtype, void* stream) {
  return rmsnorm_pair_launch(x, g, out, t, nullptr, nullptr, nullptr, 0, d,
                             eps, dtype, stream);
}
