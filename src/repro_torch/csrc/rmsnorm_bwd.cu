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
// Two launches a call. (1) The rows: block b owns rows_per_block
// consecutive rows of one tensor; it folds each row's sum(x^2) and
// sum(dy * g * x) together, writes dx, and adds dy * x^ into its share of
// the gain's gradient, then writes that share as its row of a [blocks, D]
// float32 partial. (2) The reduction: the partial's rows added column by
// column in a fixed order. No float atomics anywhere, so the same inputs
// give the same gradient bitwise. The pair (a model's q and k norms, one
// D) shares both launches: the first blocks take the first tensor's rows
// and the rest the second's, as csrc/rmsnorm.cu does.
//
// Design (csrc/rmsnorm.cu's, with dy beside x). A row is held in registers:
// each thread loads its share of x and dy 16 bytes at a time (8 bf16 or 4
// float32), and the gain once before the first row; it folds both sums
// together, then writes dx from the same registers, so x and dy are read
// from memory once. The next row's loads are issued before this row is
// folded, so a block streams its rows without a bubble at each fold. A
// thread owns the same columns in every row it takes, so it adds dy * x^
// into registers across its rows, in row order. The
// layout follows the row's count of 16-byte vectors, nvec:
//
// * rows (nvec <= 64): a sub-warp of 4, 8, 16 or 32 lanes a row (up to 2
//   vectors a lane), 256 / lanes rows in flight a block of 256 threads,
//   each sub-warp taking every (256 / lanes)-th row of the block's run. The
//   sub-warp folds with an xor butterfly: no shared memory, no barrier.
// * block (64 < nvec <= 1024): 32 * ceil(nvec / 64) threads a row (at most
//   256), each holding up to 2 vectors (4 past nvec = 512), and 256 / that
//   many rows in flight a block (at least one). Warps fold by shuffle,
//   then the row's warps through shared memory, double-buffered by row so
//   that a row costs one barrier.
// * scalar (a base address not 16-byte aligned, D * size not a multiple
//   of 16 bytes, or nvec > 1024; D <= 32768): a warp a row (8 rows in
//   flight) for D <= 1024, else 256 threads a row; elements load one at a
//   time, x and dy are read twice (the second time from L1/L2), and the
//   gain's share is kept in shared memory [rows in flight][D].
//
// Two vectors a thread, not the forward's four: with the next row's x and
// dy in flight too, 3 vectors a lane take 154 registers, one 256-thread
// block an SM; SmolLM's 2048 x 576 rows took 8.28 us that way (a sub-warp
// a row) against 6.94 us at two warps a row (chip_smoke.py's
// train_kernels, NVIDIA H100 80GB HBM3, 700 W).
//
// Where a block has several rows in flight, their shares of the gain's
// gradient are added in shared memory in a fixed order (row slot 0, 1,
// ...) before the block writes its partial row. The launch plan (layout,
// blocks and rows per block of each tensor) is computed in Python
// (repro_torch/kernels/rmsnorm/ops.py::bwd_plan, with the threads a row
// from bwd_row_threads) as a fixed function of (rows, D, dtype,
// alignment), never of the device, so a result repeats bitwise on any
// card. The thresholds live there alone: this entry takes the layout, the
// threads a row and the rows per block, derives the block counts, and
// refuses only a plan the kernels cannot run. The plan aims at 4 blocks
// an SM of an H100 (528) and gives each block at least 8 rows, so the
// partial stays at most an eighth of the rows (and mostly in L2).
//
// Bound on this card: bytes. Each element costs about twelve float32
// operations against reading x and dy and writing dx (6 bytes an element in
// bfloat16, 12 in float32), far below the card's operations-per-byte line,
// so the least time is those bytes over the HBM rate. What still separates
// it from the bound: the second launch's fixed cost (a thread-block
// cluster or a last-block fold could take the partial's sum into launch
// 1); at the small rows (SmolLM's 2048 x 576, 7 MB) the launches
// themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One launch of a plan: the kernel entry (an index into ENTRIES in
// kernels/rmsnorm_bwd/ops.py), grid, block, dynamic shared memory bytes,
// whether the launch path raises the 48 KB cap on it, and the blocks of a
// cluster along x. The launch path takes its geometry from the plan, and
// rmsnorm_bwd_plan writes each launch as kPlanFields ints for the launch audit
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

// One tensor's rows and its share of the partial.
template <typename T>
struct Rows {
  const T* x;
  const T* g;
  const T* dy;
  T* dx;
  float* partial;  // [blocks, d]
  int rows;
  int per;         // rows per block
  int blocks;
};

template <typename T>
struct Pair {
  Rows<T> a, b;
};

// This block's tensor, and `block` made relative to it (a copy: a
// reference into the kernel's parameters would put them on the stack).
template <typename T>
__device__ __forceinline__ Rows<T> pick(const Pair<T>& p, int& block) {
  if (block < p.a.blocks) return p.a;
  block -= p.a.blocks;
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

// (sum of a, sum of b) over a row's `lanes` threads, the same in each of
// them. Up to 32 lanes: an xor butterfly inside the warp. More: each warp's
// butterfly, then the row's warps' sums added in warp order through `red`
// (one slot a warp, written and read between the same two barriers: the
// caller alternates two `red` buffers from row to row). Every thread of the
// block calls it the same number of times.
__device__ __forceinline__ float2 fold2(float a, float b, int lanes, int slot,
                                        float2* red) {
  const int width = lanes < 32 ? lanes : 32;
  for (int off = width / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (lanes <= 32) return make_float2(a, b);
  const int warps = lanes / 32;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
  for (int w = 0; w < warps; ++w) {
    total.x += red[slot * warps + w].x;
    total.y += red[slot * warps + w].y;
  }
  return total;
}

// mean then rsqrt, as the forward: IEEE division and sqrt.
__device__ __forceinline__ float rms_scale(float sq, int d, float eps) {
  return 1.0f / sqrtf(sq / static_cast<float>(d) + eps);
}

// The block's partial row: its row slots' shares `fold` [slots][d] added in
// slot order (after a barrier); with one slot the caller stores directly.
__device__ __forceinline__ void write_partial(const float* fold, int slots,
                                              int d, float* out) {
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float s = fold[j];
    for (int sl = 1; sl < slots; ++sl) s += fold[sl * d + j];
    out[j] = s;
  }
}

// This thread's vectors idx = lane + j * lanes (j < V, idx < nvec) of x and
// dy in row `row`, where row < r1.
template <typename T, int V>
__device__ __forceinline__ void load_row(const Rows<T>& r, int row, int r1,
                                         int nvec, int lane, int lanes,
                                         uint4* xv, uint4* dyv) {
  const int64_t off = static_cast<int64_t>(row) * nvec;
  const uint4* xr = reinterpret_cast<const uint4*>(r.x) + off;
  const uint4* dyr = reinterpret_cast<const uint4*>(r.dy) + off;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int idx = lane + j * lanes;
    if (row < r1 && idx < nvec) {
      xv[j] = xr[idx];
      dyv[j] = dyr[idx];
    }
  }
}

// The rows and block layouts: `lanes` threads a row, each holding up to V
// vectors of x, dy and g in registers (and the next row's x and dy).
template <typename T, int V>
__global__ void __launch_bounds__(256, 1) rmsnorm_bwd_vec_kernel(
    Pair<T> p, int d, int lanes, float eps) {
  extern __shared__ __align__(16) float fold[];  // [slots][d], slots > 1
  __shared__ float2 red[2][32];
  constexpr int E = Vec<T>::kElems;
  int block = blockIdx.x;
  const Rows<T> r = pick(p, block);
  const int slots = blockDim.x / lanes;
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int nvec = d / E;
  const int r0 = block * r.per;
  const int r1 = min(r0 + r.per, r.rows);
  const int iters = (r.per + slots - 1) / slots;  // the same in every thread

  uint4 gv[V];
  float dg[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int idx = lane + j * lanes;
    if (idx < nvec) gv[j] = reinterpret_cast<const uint4*>(r.g)[idx];
#pragma unroll
    for (int e = 0; e < E; ++e) dg[j][e] = 0.f;
  }

  // x and dy of the slot's first row; each turn issues the next row's
  // loads before it folds this one, so a row's loads are in flight while
  // the previous row is folded and written
  uint4 xv[V], dyv[V];
  load_row<T, V>(r, r0 + slot, r1, nvec, lane, lanes, xv, dyv);
  for (int it = 0; it < iters; ++it) {
    const int row = r0 + it * slots + slot;
    const bool live = row < r1;  // a dead row's lanes still fold
    float sq = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int idx = lane + j * lanes;
      if (live && idx < nvec) {
        float xf[E], df[E], gf[E];
        Vec<T>::load(xv[j], xf);
        Vec<T>::load(dyv[j], df);
        Vec<T>::load(gv[j], gf);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sq = fmaf(xf[e], xf[e], sq);
          dot = fmaf(df[e] * gf[e], xf[e], dot);
        }
      }
    }
    uint4 xn[V], dyn[V];
    load_row<T, V>(r, row + slots, r1, nvec, lane, lanes, xn, dyn);
    const float2 s = fold2(sq, dot, lanes, slot, red[it & 1]);
    const float rr = rms_scale(s.x, d, eps);
    const float c = rr * s.y / static_cast<float>(d);  // mean(dy g x^)
    uint4* dxr =
        reinterpret_cast<uint4*>(r.dx) + static_cast<int64_t>(row) * nvec;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int idx = lane + j * lanes;
      if (live && idx < nvec) {
        float xf[E], df[E], gf[E];
        Vec<T>::load(xv[j], xf);
        Vec<T>::load(dyv[j], df);
        Vec<T>::load(gv[j], gf);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = xf[e] * rr;
          dg[j][e] += df[e] * xh;
          xf[e] = rr * (df[e] * gf[e] - xh * c);
        }
        dxr[idx] = Vec<T>::store(xf);
      }
      xv[j] = xn[j];
      dyv[j] = dyn[j];
    }
  }

  float* out = r.partial + static_cast<int64_t>(block) * d;
  float* dst = slots == 1 ? out : fold + slot * d;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int idx = lane + j * lanes;
    if (idx < nvec) {
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        *reinterpret_cast<float4*>(dst + idx * E + e) =
            make_float4(dg[j][e], dg[j][e + 1], dg[j][e + 2], dg[j][e + 3]);
      }
    }
  }
  if (slots > 1) write_partial(fold, slots, d, out);
}

// The scalar layout: `lanes` threads a row, one element at a time.
template <typename T>
__global__ void __launch_bounds__(256) rmsnorm_bwd_scalar_kernel(
    Pair<T> p, int d, int lanes, float eps) {
  extern __shared__ float acc[];  // [slots][d]: each slot's share of dgain
  __shared__ float2 red[2][32];
  int block = blockIdx.x;
  const Rows<T> r = pick(p, block);
  const int slots = blockDim.x / lanes;
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int r0 = block * r.per;
  const int r1 = min(r0 + r.per, r.rows);
  const int iters = (r.per + slots - 1) / slots;
  float* mine = acc + slot * d;
  for (int j = lane; j < d; j += lanes) mine[j] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int row = r0 + it * slots + slot;
    const bool live = row < r1;
    const int64_t off = static_cast<int64_t>(row) * d;
    float sq = 0.f, dot = 0.f;
    if (live) {
      for (int j = lane; j < d; j += lanes) {
        const float xv = to_f32(r.x[off + j]);
        sq = fmaf(xv, xv, sq);
        dot = fmaf(to_f32(r.dy[off + j]) * to_f32(r.g[j]), xv, dot);
      }
    }
    const float2 s = fold2(sq, dot, lanes, slot, red[it & 1]);
    const float rr = rms_scale(s.x, d, eps);
    const float c = rr * s.y / static_cast<float>(d);
    if (live) {
      for (int j = lane; j < d; j += lanes) {
        const float xh = to_f32(r.x[off + j]) * rr;
        const float dv = to_f32(r.dy[off + j]);
        r.dx[off + j] = from_f32<T>(rr * (dv * to_f32(r.g[j]) - xh * c));
        mine[j] += dv * xh;
      }
    }
  }
  write_partial(acc, slots, d, r.partial + static_cast<int64_t>(block) * d);
}

// dgain[j] = the sum of the tensor's partial rows at column j; blockIdx.y
// picks the tensor. 32 row lanes (threadIdx.y) each add rows y, y + 32,
// ... in block order; the 32 sums are then added in lane order.
constexpr int kRedCols = 32, kRedLanes = 32;

__global__ void __launch_bounds__(kRedCols * kRedLanes) rmsnorm_bwd_reduce(
    const float* partial, float* dg_a, int blocks_a, float* dg_b,
    int blocks_b, int d) {
  __shared__ float sums[kRedLanes][kRedCols];
  const int j = blockIdx.x * kRedCols + threadIdx.x;
  const float* src = partial;
  float* dst = dg_a;
  int n = blocks_a;
  if (blockIdx.y == 1) {
    src = partial + static_cast<int64_t>(blocks_a) * d;
    dst = dg_b;
    n = blocks_b;
  }
  float s = 0.f;
  if (j < d) {
#pragma unroll 8
    for (int i = threadIdx.y; i < n; i += kRedLanes) {
      s += src[static_cast<int64_t>(i) * d + j];
    }
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < d) {
    float total = sums[0][threadIdx.x];
    for (int y = 1; y < kRedLanes; ++y) total += sums[y][threadIdx.x];
    dst[j] = total;
  }
}

// The layouts, as bwd_plan in ops.py numbers them (rows and block differ
// only in their lanes a row, which the plan gives).
enum Layout { kRowsLayout = 0, kBlockLayout = 1, kScalarLayout = 2 };
constexpr int kRowThreads = 256;
constexpr int kMaxVec = 4;  // vectors a lane: rmsnorm_bwd_vec_kernel's V

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
bool aligned16(const Rows<T>& r) {
  return r.rows == 0 ||
         ((reinterpret_cast<uintptr_t>(r.x) | reinterpret_cast<uintptr_t>(r.g) |
           reinterpret_cast<uintptr_t>(r.dy) |
           reinterpret_cast<uintptr_t>(r.dx)) % 16) == 0;
}

// fold2 takes a power of two up to a warp, or whole warps up to a block.
bool lanes_fold(int lanes) {
  if (lanes <= 0 || lanes > kRowThreads) return false;
  return lanes <= 32 ? (32 % lanes) == 0 : lanes % 32 == 0;
}

// Entries: rmsnorm_bwd_vec_kernel<float, V> for V 1-4 (0-3),
// rmsnorm_bwd_scalar_kernel<float> (4), the same for __nv_bfloat16 (5-9),
// rmsnorm_bwd_reduce (10).
constexpr int kTypeEntries = 5, kReduceEntry = 10;

// Up to two launches: the rows (a's blocks, then b's; none where both are
// empty) by the caller's layout, threads a row and rows a block, with the
// [slots][d] float fold in dynamic shared memory (opted in past 48 KB),
// then the gains' reduction, a block of kRedCols columns by kRedLanes
// lanes per (column tile, gain). -1 where the launch refuses the plan: a
// vector layout at a misaligned address or a D it cannot hold, threads a
// row fold2 cannot take, or no rows a block.
int make_plan(int t_a, int t_b, int d, int dtype, int layout, int lanes,
              int per_a, int per_b, int aligned, int two, Launch* out) {
  const int type = dtype == 0 ? 0 : 1;
  const int elems = type == 0 ? Vec<float>::kElems
                              : Vec<__nv_bfloat16>::kElems;
  const int nvec = d / elems;
  const bool vec = layout != kScalarLayout;
  if (d <= 0 || t_a < 0 || t_b < 0 || (dtype != 0 && dtype != 1) ||
      layout < kRowsLayout || layout > kScalarLayout || !lanes_fold(lanes) ||
      (t_a > 0 && per_a < 1) || (t_b > 0 && per_b < 1) ||
      (vec && (d % elems != 0 || !aligned || cdiv(nvec, lanes) > kMaxVec))) {
    return -1;
  }
  const int blocks = (t_a > 0 ? cdiv(t_a, per_a) : 0) +
                     (t_b > 0 ? cdiv(t_b, per_b) : 0);
  const int slots = lanes >= kRowThreads ? 1 : kRowThreads / lanes;
  const int smem = slots > 1 || layout == kScalarLayout
                       ? slots * d * static_cast<int>(sizeof(float))
                       : 0;
  int n = 0;
  if (blocks > 0) {
    const int e = vec ? cdiv(nvec, lanes) - 1 : kTypeEntries - 1;
    out[n++] = {kTypeEntries * type + e, dim3(blocks), dim3(lanes * slots),
                smem, smem > 48 * 1024 ? 1 : 0, 1};
  }
  out[n++] = {kReduceEntry, dim3(cdiv(d, kRedCols), two ? 2 : 1),
              dim3(kRedCols, kRedLanes), 0, 0, 1};
  return n;
}

template <typename T, typename K>
cudaError_t launch_rows(K kernel, const Pair<T>& p, const Launch& l, int d,
                        int lanes, float eps, cudaStream_t stream) {
  if (l.optin) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<l.grid, l.block, l.smem, stream>>>(p, d, lanes, eps);
  return cudaGetLastError();
}

template <typename T>
int launch(Pair<T> p, int d, float eps, int layout, int lanes, float* dg_a,
           float* dg_b, float* partial, cudaStream_t stream) {
  Launch l[2];
  const int n = make_plan(p.a.rows, p.b.rows, d, sizeof(T) == 4 ? 0 : 1,
                          layout, lanes, p.a.per, p.b.per,
                          aligned16(p.a) && aligned16(p.b), dg_b != nullptr,
                          l);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  p.a.blocks = p.a.rows > 0 ? cdiv(p.a.rows, p.a.per) : 0;
  p.b.blocks = p.b.rows > 0 ? cdiv(p.b.rows, p.b.per) : 0;
  p.a.partial = partial;
  p.b.partial = partial + static_cast<int64_t>(p.a.blocks) * d;
  if (n == 2) {
    const int e = l[0].entry % kTypeEntries;
    cudaError_t err;
    switch (e) {
      case 0: err = launch_rows(rmsnorm_bwd_vec_kernel<T, 1>, p, l[0], d, lanes, eps, stream); break;
      case 1: err = launch_rows(rmsnorm_bwd_vec_kernel<T, 2>, p, l[0], d, lanes, eps, stream); break;
      case 2: err = launch_rows(rmsnorm_bwd_vec_kernel<T, 3>, p, l[0], d, lanes, eps, stream); break;
      case 3: err = launch_rows(rmsnorm_bwd_vec_kernel<T, 4>, p, l[0], d, lanes, eps, stream); break;
      default: err = launch_rows(rmsnorm_bwd_scalar_kernel<T>, p, l[0], d, lanes, eps, stream); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Launch& r = l[n - 1];
  rmsnorm_bwd_reduce<<<r.grid, r.block, 0, stream>>>(
      partial, dg_a, p.a.blocks, dg_b, p.b.blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Rows<T> rows(const void* x, const void* g, const void* dy, void* dx, int t,
             int per) {
  Rows<T> r;
  r.x = static_cast<const T*>(x);
  r.g = static_cast<const T*>(g);
  r.dy = static_cast<const T*>(dy);
  r.dx = static_cast<T*>(dx);
  r.partial = nullptr;
  r.rows = t;
  r.per = per;
  r.blocks = 0;  // ceil(rows / per), set by launch
  return r;
}

}  // namespace

// Two tensors of one D: (x_a, g_a, dy_a) -> (dx_a, dg_a) over t_a rows and
// (x_b, ...) over t_b rows (t_b = 0 and null pointers: one tensor). x, dy,
// dx [t, d] contiguous of the dtype (0 float32, 1 bfloat16), g [d] of the
// dtype, dg [d] float32, partial float32 [ceil(t_a / per_a) +
// ceil(t_b / per_b), d]. The plan, as ops.py::bwd_plan and bwd_row_threads
// give it: the layout (0 rows, 1 block, 2 scalar), the threads a row, and
// each tensor's rows per block. It is checked, not recomputed: refused
// (cudaErrorInvalidValue) where a vector layout meets a misaligned address
// or a D it cannot hold, or the threads a row are not a power of two up to
// 32 or whole warps up to 256. Two launches on `stream` (one, the
// reduction, when both tensors are empty).
extern "C" int rmsnorm_pair_bwd_launch(
    const void* x_a, const void* g_a, const void* dy_a, void* dx_a,
    void* dg_a, int t_a, const void* x_b, const void* g_b, const void* dy_b,
    void* dx_b, void* dg_b, int t_b, void* partial, int d, float eps,
    int dtype, int layout, int lanes, int per_a, int per_b, void* stream) {
  if (d <= 0 || t_a < 0 || t_b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* dga = static_cast<float*>(dg_a);
  float* dgb = static_cast<float*>(dg_b);
  if (dtype == 0) {
    Pair<float> p{rows<float>(x_a, g_a, dy_a, dx_a, t_a, per_a),
                  rows<float>(x_b, g_b, dy_b, dx_b, t_b, per_b)};
    return launch<float>(p, d, eps, layout, lanes, dga, dgb, part, s);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    Pair<bf> p{rows<bf>(x_a, g_a, dy_a, dx_a, t_a, per_a),
               rows<bf>(x_b, g_b, dy_b, dx_b, t_b, per_b)};
    return launch<bf>(p, d, eps, layout, lanes, dga, dgb, part, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan of rmsnorm_pair_bwd_launch at these arguments (`aligned`: every
// address 16-byte aligned; `two`: a second gain; see make_plan): writes
// each launch's kPlanFields ints to `plan` and returns their number (-1
// where the launch refuses them).
extern "C" int rmsnorm_bwd_plan(int t_a, int t_b, int d, int dtype,
                                int layout, int lanes, int per_a, int per_b,
                                int aligned, int two, int* plan) {
  Launch l[2];
  const int n = make_plan(t_a, t_b, d, dtype, layout, lanes, per_a, per_b,
                          aligned, two, l);
  return n < 0 ? n : write_plan(l, n, plan);
}
