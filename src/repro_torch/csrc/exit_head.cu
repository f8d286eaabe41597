// Fused early-exit head for Hopper (sm_90a): RMSNorm, unembedding and the
// top-1 statistics, without writing the [T, V] logits to device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/exit_head/kernel.py
// (_exit_head_kernel, exit_head_kernel). For each row t:
//
//   z[t, :] = (h[t, :] * rsqrt(mean(h[t, :]^2) + eps) * g) @ W      (float32)
//   idx[t] = argmax z[t, :] (first on ties), mx[t] = max z[t, :],
//   lse[t] = logsumexp z[t, :]
//
// Design. The TPU kernel runs one program per row tile and walks V in
// sequence, carrying running (max, argmax, sum of exp) in scratch. Served
// here with T = B <= 8 rows, that would put one block on the card and stream
// all of W (up to 1.2 GB) through one SM. So V is split across blocks
// instead: pass 1 gives each block one tile of 256 (bfloat16) or 128
// (float32) columns for up to 8 rows; the block normalises its rows itself
// (one warp per row sums h^2), stages the normed rows in shared memory in
// chunks of 256 features, and its 8 warps each take a slice of the features
// of a chunk, every lane reading 16 bytes of one W row per step (a warp
// reads 512 contiguous bytes). The warps' partial logits are summed in a
// fixed order in shared memory, and one warp per row reduces the tile to
// (max, first argmax, sum of exp(z - max)), written to a scratch buffer
// that the wrapper allocates. Pass 2 runs one block per row and folds the
// tiles' partials with a fixed tree in which ties go to the smaller vocab
// index, so the argmax stays first-on-ties and every result is the same
// from run to run. Any V works: columns past V are masked, and W rows
// whose length is not a multiple of 16 bytes are read element by element.
//
// Bound on this card: bytes. W ([D, V], 0.05 to 1.2 GB at the served
// models) is read once; everything else is a few KB. The float32 work is
// 2 * T * D * V operations, below the bytes' time for T <= 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // features staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC consecutive elements of p as float32; one 16-byte load when aligned.
template <typename T, int VEC, bool ALIGNED>
__device__ __forceinline__ void load_cols(const T* p, int n_valid,
                                          float (&out)[VEC]) {
  if (ALIGNED && n_valid >= VEC) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int c = 0; c < VEC; ++c) out[c] = to_f32(e[c]);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) out[c] = c < n_valid ? to_f32(p[c]) : 0.0f;
  }
}

// (max, index): the larger value wins; on a tie, the smaller index.
__device__ __forceinline__ bool beats(float m2, int a2, float m1, int a1) {
  return m2 > m1 || (m2 == m1 && a2 < a1);
}

template <typename T, int ROWS, bool ALIGNED>
__global__ void __launch_bounds__(kThreads) exit_head_tiles(
    const T* __restrict__ h, const T* __restrict__ g, const T* __restrict__ w,
    int t_len, int d, int v_len, float eps, float* __restrict__ part_m,
    int32_t* __restrict__ part_a, float* __restrict__ part_l) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int BV = 32 * VEC;
  __shared__ float s_rs[ROWS];
  __shared__ float s_hn[kChunk][ROWS];
  __shared__ float s_red[kWarps][BV];
  __shared__ float s_z[ROWS][BV];

  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int v0 = tile * BV;
  const int t0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // 1. each row's rsqrt(mean(h^2) + eps), one warp per row
  for (int r = warp; r < ROWS; r += kWarps) {
    float sq = 0.0f;
    if (t0 + r < t_len) {
      const T* hr = h + static_cast<int64_t>(t0 + r) * d;
      for (int i = lane; i < d; i += 32) {
        const float x = to_f32(hr[i]);
        sq = fmaf(x, x, sq);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) s_rs[r] = 1.0f / sqrtf(sq / static_cast<float>(d) + eps);
  }

  // 2. partial logits of this warp's feature slices, for VEC columns a lane
  const int col = v0 + lane * VEC;
  const int n_valid = v_len - col;
  float acc[ROWS][VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[r][c] = 0.0f;
  }
  for (int d0 = 0; d0 < d; d0 += kChunk) {
    __syncthreads();  // s_rs is written; the previous chunk is consumed
    {
      const int dd = threadIdx.x;  // kThreads == kChunk
      const int di = d0 + dd;
      const float gi = di < d ? to_f32(g[di]) : 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool ok = di < d && t0 + r < t_len;
        s_hn[dd][r] = ok
            ? to_f32(h[static_cast<int64_t>(t0 + r) * d + di]) * s_rs[r] * gi
            : 0.0f;
      }
    }
    __syncthreads();
    if (n_valid > 0) {
      const int dd_end = min(kChunk / kWarps, d - d0 - warp * (kChunk / kWarps));
#pragma unroll 4
      for (int i = 0; i < dd_end; ++i) {
        const int dd = warp * (kChunk / kWarps) + i;
        float wv[VEC];
        load_cols<T, VEC, ALIGNED>(
            w + static_cast<int64_t>(d0 + dd) * v_len + col, n_valid, wv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float x = s_hn[dd][r];
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[r][c] = fmaf(x, wv[c], acc[r][c]);
        }
      }
    }
  }

  // 3. sum the warps' partials in a fixed order (unrolled: acc stays in
  // registers)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) s_red[warp][lane * VEC + c] = acc[r][c];
    __syncthreads();
    for (int j = threadIdx.x; j < BV; j += kThreads) {
      float z = 0.0f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) z += s_red[ww][j];
      s_z[r][j] = z;
    }
    __syncthreads();
  }

  // 4. this tile's (max, first argmax, sum of exp) per row, one warp a row
  for (int r = warp; r < ROWS; r += kWarps) {
    if (t0 + r >= t_len) continue;
    float m = -INFINITY;
    int a = 0x7fffffff;
    for (int j = lane; j < BV; j += 32) {
      if (v0 + j < v_len && beats(s_z[r][j], v0 + j, m, a)) {
        m = s_z[r][j];
        a = v0 + j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const int a2 = __shfl_xor_sync(0xffffffffu, a, off);
      if (beats(m2, a2, m, a)) {
        m = m2;
        a = a2;
      }
    }
    float l = 0.0f;
    for (int j = lane; j < BV; j += 32) {
      if (v0 + j < v_len) l += expf(s_z[r][j] - m);
    }
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    if (lane == 0) {
      const int64_t o = static_cast<int64_t>(t0 + r) * n_tiles + tile;
      part_m[o] = m;
      part_a[o] = a;
      part_l[o] = l;
    }
  }
}

struct Stat {
  float m;
  int a;
  float l;
};

// Fold two tiles' statistics; an empty side (m = -inf) leaves the other.
__device__ __forceinline__ Stat fold(Stat x, Stat y) {
  if (y.m == -INFINITY) return x;
  if (x.m == -INFINITY) return y;
  const float m = fmaxf(x.m, y.m);
  Stat out;
  out.m = m;
  out.a = beats(y.m, y.a, x.m, x.a) ? y.a : x.a;
  out.l = x.l * expf(x.m - m) + y.l * expf(y.m - m);
  return out;
}

__global__ void __launch_bounds__(kThreads) exit_head_fold(
    const float* __restrict__ part_m, const int32_t* __restrict__ part_a,
    const float* __restrict__ part_l, int n_tiles, int32_t* __restrict__ idx,
    float* __restrict__ mx, float* __restrict__ lse) {
  __shared__ Stat s[kThreads];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n_tiles;
  // each thread folds a contiguous run of tiles, in order
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n_tiles);
  Stat acc{-INFINITY, 0x7fffffff, 0.0f};
  for (int i = lo; i < hi; ++i) {
    acc = fold(acc, Stat{part_m[row + i], part_a[row + i], part_l[row + i]});
  }
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s[threadIdx.x] = fold(s[threadIdx.x], s[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    idx[blockIdx.x] = s[0].a;
    mx[blockIdx.x] = s[0].m;
    lse[blockIdx.x] = s[0].m + logf(fmaxf(s[0].l, 1e-30f));
  }
}

template <typename T, int ROWS, bool ALIGNED>
void launch_tiles(const void* h, const void* g, const void* w, int t_len,
                  int d, int v_len, float eps, float* pm, int32_t* pa,
                  float* pl, cudaStream_t stream) {
  constexpr int BV = 32 * (16 / sizeof(T));
  dim3 grid((v_len + BV - 1) / BV, (t_len + ROWS - 1) / ROWS);
  exit_head_tiles<T, ROWS, ALIGNED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(g),
      static_cast<const T*>(w), t_len, d, v_len, eps, pm, pa, pl);
}

template <typename T, bool ALIGNED>
void by_rows(const void* h, const void* g, const void* w, int t_len, int d,
             int v_len, float eps, float* pm, int32_t* pa, float* pl,
             cudaStream_t stream) {
  if (t_len == 1) {
    launch_tiles<T, 1, ALIGNED>(h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream);
  } else if (t_len == 2) {
    launch_tiles<T, 2, ALIGNED>(h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream);
  } else if (t_len <= 4) {
    launch_tiles<T, 4, ALIGNED>(h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream);
  } else {
    launch_tiles<T, 8, ALIGNED>(h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream);
  }
}

}  // namespace

// Columns per pass-1 tile for dtype 0 (float32) or 1 (bfloat16); the
// wrapper sizes the scratch buffers [t_len, ceil(v_len / tile)] from it.
extern "C" int exit_head_tile_cols(int dtype) { return dtype == 0 ? 128 : 256; }

// h [t_len, d], g [d], w [d, v_len] contiguous, one type (dtype 0 =
// float32, 1 = bfloat16); `aligned` says that w's rows start on 16-byte
// boundaries. part_* are float32/int32 scratch of t_len * n_tiles; idx, mx,
// lse [t_len]. Launches both passes on `stream` and returns a CUDA error
// code (0 = launched).
extern "C" int exit_head_launch(const void* h, const void* g, const void* w,
                                int t_len, int d, int v_len, float eps,
                                int dtype, int aligned, float* part_m,
                                int32_t* part_a, float* part_l, int32_t* idx,
                                float* mx, float* lse, void* stream) {
  if (t_len <= 0 || v_len <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (aligned) by_rows<float, true>(h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
    else by_rows<float, false>(h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
  } else {
    if (aligned) by_rows<__nv_bfloat16, true>(h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
    else by_rows<__nv_bfloat16, false>(h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (v_len + exit_head_tile_cols(dtype) - 1) /
                      exit_head_tile_cols(dtype);
  exit_head_fold<<<t_len, kThreads, 0, s>>>(part_m, part_a, part_l, n_tiles,
                                            idx, mx, lse);
  return static_cast<int>(cudaGetLastError());
}
