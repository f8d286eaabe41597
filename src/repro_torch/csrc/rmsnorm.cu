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

// One launch of a plan: the kernel entry (an index into ENTRIES in
// kernels/rmsnorm/ops.py), grid, block, dynamic shared memory bytes,
// whether the launch path raises the 48 KB cap on it, and the blocks of a
// cluster along x. The launch path takes its geometry from the plan, and
// rmsnorm_plan writes each launch as kPlanFields ints for the launch audit
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

// Entries, for float (0-19) then __nv_bfloat16 (20-39):
// rmsnorm_vec_rows_kernel<T, LANES, V> for LANES 4, 8, 16, 32 and V 1-4
// (4 * LANES slot + V - 1), rmsnorm_vec_block_kernel<T> (16),
// rmsnorm_rows_kernel<T> (17), rmsnorm_kernel<T, 128> (18) and <T, 256>
// (19).
enum Entry { kVecBlock = 16, kRows = 17, kBlock128 = 18, kBlock256 = 19,
             kEntries = 20 };

// Rows a block of entry `e` (of one type) takes.
int rows_per_block(int e) {
  if (e < kVecBlock) return kVecThreads / (4 << (e / 4));
  return e == kRows ? kRowsPerBlock : 1;
}

// One launch over both tensors, a's blocks first: 16-byte vectors where
// D allows and every address is aligned, LANES lanes a row (a block per
// row past 128 vectors), else a warp a row up to D = 512 and a block a
// row above. No launch for no rows.
int make_plan(int t_a, int t_b, int d, int dtype, int aligned, Launch* out) {
  if (t_a < 0 || t_b < 0 || t_a + t_b == 0 || d <= 0) return 0;
  const int type = dtype == 0 ? 0 : 1;
  const int elems = type == 0 ? Vec<float>::kElems
                              : Vec<__nv_bfloat16>::kElems;
  const int nvec = d / elems;
  const bool vec = d % elems == 0 && nvec <= 32 * kBlockVecs * 32 && aligned;
  int e, threads;
  if (vec && nvec <= 32 * kBlockVecs) {
    const int slot = nvec <= 4 ? 0 : nvec <= 8 ? 1 : nvec <= 16 ? 2 : 3;
    const int v = cdiv(nvec, 4 << slot);
    e = 4 * slot + (v < 4 ? v : 4) - 1;
    threads = kVecThreads;
  } else if (vec) {
    e = kVecBlock;
    threads = 32 * cdiv(nvec, 32 * kBlockVecs);
  } else if (d <= 512) {
    e = kRows;
    threads = 32 * kRowsPerBlock;
  } else {
    e = d <= 1024 ? kBlock128 : kBlock256;
    threads = d <= 1024 ? 128 : 256;
  }
  const int per = rows_per_block(e);
  out[0] = {kEntries * type + e, dim3(cdiv(t_a, per) + cdiv(t_b, per)),
            dim3(threads), 0, 0, 1};
  return 1;
}

template <typename T, int LANES>
void launch_rows(const Launch& l, const Pair<T>& p, int v, int d, float eps,
                 cudaStream_t s) {
  switch (v) {
    case 1: rmsnorm_vec_rows_kernel<T, LANES, 1><<<l.grid, l.block, 0, s>>>(p, d, eps); break;
    case 2: rmsnorm_vec_rows_kernel<T, LANES, 2><<<l.grid, l.block, 0, s>>>(p, d, eps); break;
    case 3: rmsnorm_vec_rows_kernel<T, LANES, 3><<<l.grid, l.block, 0, s>>>(p, d, eps); break;
    default: rmsnorm_vec_rows_kernel<T, LANES, 4><<<l.grid, l.block, 0, s>>>(p, d, eps); break;
  }
}

template <typename T>
int launch(Pair<T> p, int d, float eps, int dtype, cudaStream_t s) {
  Launch l[1];
  if (make_plan(p.a.rows, p.b.rows, d, dtype, aligned16(p.a) && aligned16(p.b),
                l) != 1) {
    return static_cast<int>(cudaGetLastError());
  }
  const int e = l[0].entry % kEntries;
  p.blocks_a = cdiv(p.a.rows, rows_per_block(e));
  if (e < kVecBlock) {
    switch (e / 4) {
      case 0: launch_rows<T, 4>(l[0], p, e % 4 + 1, d, eps, s); break;
      case 1: launch_rows<T, 8>(l[0], p, e % 4 + 1, d, eps, s); break;
      case 2: launch_rows<T, 16>(l[0], p, e % 4 + 1, d, eps, s); break;
      default: launch_rows<T, 32>(l[0], p, e % 4 + 1, d, eps, s); break;
    }
  } else if (e == kVecBlock) {
    rmsnorm_vec_block_kernel<T><<<l[0].grid, l[0].block, 0, s>>>(p, d, eps);
  } else if (e == kRows) {
    rmsnorm_rows_kernel<T><<<l[0].grid, l[0].block, 0, s>>>(p, d, eps);
  } else if (e == kBlock128) {
    rmsnorm_kernel<T, 128><<<l[0].grid, l[0].block, 0, s>>>(p, d, eps);
  } else {
    rmsnorm_kernel<T, 256><<<l[0].grid, l[0].block, 0, s>>>(p, d, eps);
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
  return launch<T>(p, d, eps, sizeof(T) == 4 ? 0 : 1, s);
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

// The plan of rmsnorm_pair_launch at these sizes (`aligned`: every
// address 16-byte aligned; see make_plan): writes each launch's
// kPlanFields ints to `plan` and returns their number.
extern "C" int rmsnorm_plan(int t_a, int t_b, int d, int dtype, int aligned,
                            int* plan) {
  Launch l[1];
  return write_plan(l, make_plan(t_a, t_b, d, dtype, aligned, l), plan);
}

// One tensor: x, out [t, d] and g [d].
extern "C" int rmsnorm_launch(const void* x, const void* g, void* out, int t,
                              int d, float eps, int dtype, void* stream) {
  return rmsnorm_pair_launch(x, g, out, t, nullptr, nullptr, nullptr, 0, d,
                             eps, dtype, stream);
}
