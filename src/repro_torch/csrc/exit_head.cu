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
// all of W (up to 1.2 GB) through one SM. So V is split into tiles across
// blocks: pass 1 reduces each tile to (max, first argmax, sum of
// exp(z - max)) per row, written to a scratch buffer that the wrapper
// allocates, and pass 2 (exit_head_fold) runs one block per row and folds
// the tiles' partials with a fixed tree in which ties go to the smaller
// vocab index, so the argmax stays first-on-ties and every result is the
// same from run to run. Two launches: a fold inside pass 1 would need a
// grid-wide barrier or a counter that must be reset between calls, and the
// fold costs a few microseconds against pass 1's 0.03-0.45 ms. Pass 1 has
// two kernels, dispatched explicitly by exit_head_tensor_cores (neither is
// a fallback for the other):
//
//   * bfloat16 with 16-byte W rows and D <= 5120 (every served model: V =
//     49152, 200064, 151936 are multiples of 8) runs on the tensor cores
//     (tc::exit_head_tc). A persistent grid (as many 8-warp blocks as are
//     resident, each given the same number of 128-column tiles, so there is
//     no tail wave) streams W once through a 4-stage ring of [64 features x
//     128 columns] tiles in shared memory, filled by 16-byte cp.async
//     copies (columns past V and features past D zero-filled) into an
//     XOR-swizzled layout; the ring
//     runs on across a block's tiles, so the next tile's loads overlap this
//     tile's statistics. A warp owns 16 columns: ldmatrix.trans reads W as
//     the A operand of mma.sync m16n8k16 (16 columns x 16 features) and the
//     normed rows are the B operand (N = 8 rows; rows past T read a zero
//     line). The block normalises its rows once in float32 while the first
//     tiles load. Precision: the reference multiplies float32 normed rows
//     by float32(W). One bf16 rounding of the rows would err by 2^-9 of
//     each term, which puts Qwen3-8B's logits at the edge of the 2e-3
//     tolerance; so each normed row is split into hi = bf16(x) and lo =
//     bf16(x - hi), and two mmas (hi, then lo) go into one float32
//     accumulator. W is exact in bf16, so the product errs by about 2^-17
//     of each term (tests/test_torch_lm_kernels.py emulates the split at
//     Qwen3-8B's width), at a negligible tensor-core cost. The tile's
//     statistics fold from the accumulators in registers (shuffles over the
//     8 lanes that share a row, then the 8 warps in order). T > 8 runs
//     ceil(T / 8) row groups.
//   * float32, W rows that are not 16-byte aligned and D > 5120 run on the
//     CUDA cores (exit_head_tiles): one block per tile of 256 (bfloat16) or
//     128 (float32) columns for up to 8 rows; the block normalises its rows
//     itself (one warp per row sums h^2), stages the normed rows in shared
//     memory in chunks of 256 features, and its 8 warps each take a slice
//     of the features of a chunk, every lane reading 16 bytes of one W row
//     per step (or element by element where the rows are not aligned). The
//     warps' partial logits are summed in a fixed order in shared memory,
//     and one warp per row reduces the tile. Any V works: columns past V
//     are masked.
//
// Bound on this card: bytes. W ([D, V], 0.05 to 1.2 GB at the served
// models) is read once; everything else is a few KB. The product is
// 2 * T * D * V operations (twice that on the tensor cores, with hi and
// lo), below the bytes' time for T <= 8 on either unit; but at T = 8 the
// CUDA-core kernel's float32 issue competed with W's 0.37 ms of bytes, and
// the tensor cores take it off the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // features staged per step

// One launch of a plan: the kernel entry (an index into ENTRIES in
// kernels/exit_head/ops.py), grid, block, dynamic shared memory bytes,
// whether the launch path raises the 48 KB cap on it, and the blocks of a
// cluster along x. The launch path takes its geometry from the plan, and
// exit_head_plan writes each launch as kPlanFields ints for the launch audit
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

int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// ---------------------------------------------------------------------------
// bfloat16 with 16-byte W rows: the product on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBN = 128;      // vocab columns of a tile
constexpr int kBK = 64;       // features of a ring stage
constexpr int kStages = 4;    // ring stages (16 KB each)
// 8 warps of 16 columns each: at T = 8 the block's 197 KB (Qwen3-8B) leave
// one block an SM, and on an H100 8 warps hid more of each other's latency
// than 4 warps of 32 columns (and than a 6-stage ring).
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = kBN / kWarps / 16;  // 16-column m-tiles of a warp
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
// The normed rows stay in shared memory as bf16 hi and lo parts, 32 bytes a
// feature at 8 rows: up to this D the ring and the rows fit.
constexpr int kMaxD = 5120;

__host__ __device__ constexpr int padded(int d) {
  return (d + kBK - 1) / kBK * kBK;
}

// The ring, the hi and lo rows [rows][padded(d) + 8], a zero line, the
// rows' rsqrt and the warps' tile statistics.
__host__ __device__ constexpr int smem_bytes(int rows, int d) {
  return kStages * kBK * kBN * 2 + 2 * rows * (padded(d) + 8) * 2 + 16 +
         8 * 4 + 3 * kWarps * 8 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, float32 accumulators.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (blocks, row groups of ROWS); block x walks the vocab tiles x,
// x + gridDim.x, ... and writes each tile's statistics of its rows to
// part_*[t, tile], as exit_head_tiles does.
template <int ROWS>
__global__ void __launch_bounds__(kThreads) exit_head_tc(
    const bf16* __restrict__ h, const bf16* __restrict__ g,
    const bf16* __restrict__ w, int t_len, int d, int v_len, float eps,
    int n_tiles, float* __restrict__ part_m, int32_t* __restrict__ part_a,
    float* __restrict__ part_l) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int dp = padded(d);
  const int hs = dp + 8;  // row stride: 8 rows hit 8 bank groups
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);  // [kStages][kBK][kBN]
  bf16* hi = ring + kStages * kBK * kBN;          // [ROWS][hs]
  bf16* lo = hi + ROWS * hs;                      // [ROWS][hs]
  bf16* zero = lo + ROWS * hs;                    // 8 zeros
  float* s_rs = reinterpret_cast<float*>(zero + 8);
  float* s_sm = s_rs + 8;                         // [kWarps][8]
  int32_t* s_sa = reinterpret_cast<int32_t*>(s_sm + kWarps * 8);
  float* s_sl = reinterpret_cast<float*>(s_sa + kWarps * 8);

  const int t0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kc_n = dp / kBK;  // stages a tile
  const int bx = static_cast<int>(blockIdx.x);
  const int gx = static_cast<int>(gridDim.x);
  const int my_tiles = (n_tiles - 1 - bx) / gx + 1;
  const int iters = my_tiles * kc_n;

  // W[k0 .. k0 + kBK, v0 .. v0 + kBN) of iteration `it` into its stage, one
  // commit group (empty past the end). A row of the tile is 16 chunks of
  // 16 bytes; chunk c of row r sits at c ^ (r & 7), so the 8 rows that an
  // ldmatrix phase reads at one chunk land in 8 bank groups. Rows past D
  // and columns past V are zero-filled, never read.
  auto issue = [&](int it) {
    if (it < iters) {
      const int tile = bx + (it / kc_n) * gx;
      const int k0 = (it % kc_n) * kBK;
      const int v0 = tile * kBN;
      bf16* st = ring + (it % kStages) * kBK * kBN;
#pragma unroll
      for (int i = tid; i < kBK * kBN / 8; i += kThreads) {
        const int r = i / (kBN / 8);
        const int c = i % (kBN / 8);
        const bool ok = k0 + r < d && v0 + c * 8 < v_len;
        const bf16* src =
            ok ? w + static_cast<int64_t>(k0 + r) * v_len + v0 + c * 8 : w;
        cp_async16(st + r * kBN + ((c ^ (r & 7)) << 3), src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // The block's rows, normalised once in float32 while W is in flight:
  // x = h * rsqrt(mean(h^2) + eps) * g, kept as hi = bf16(x) and
  // lo = bf16(x - hi).
  for (int r = warp; r < ROWS; r += kWarps) {
    float sq = 0.0f;
    if (t0 + r < t_len) {
      const bf16* hr = h + static_cast<int64_t>(t0 + r) * d;
      for (int i = lane; i < d; i += 32) {
        const float x = __bfloat162float(hr[i]);
        sq = fmaf(x, x, sq);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) s_rs[r] = 1.0f / sqrtf(sq / static_cast<float>(d) + eps);
  }
  if (tid < 8) zero[tid] = __float2bfloat16_rn(0.0f);
  __syncthreads();
  for (int i = tid; i < ROWS * dp; i += kThreads) {
    const int r = i / dp;
    const int dd = i - r * dp;
    float x = 0.0f;
    if (dd < d && t0 + r < t_len) {
      x = __bfloat162float(h[static_cast<int64_t>(t0 + r) * d + dd]) *
          s_rs[r] * __bfloat162float(g[dd]);
    }
    const bf16 xh = __float2bfloat16_rn(x);
    hi[r * hs + dd] = xh;
    lo[r * hs + dd] = __float2bfloat16_rn(x - __bfloat162float(xh));
  }

  // The B operand (the rows) of a k-step: lane l addresses row l & 7 of
  // matrix l >> 3 = hi k 0-7, hi k 8-15, lo k 0-7, lo k 8-15; rows past
  // ROWS read the zero line.
  const int bj = lane >> 3;
  const int bn = lane & 7;
  const bf16* b_row =
      bn < ROWS ? (bj < 2 ? hi : lo) + bn * hs + (bj & 1) * 8 : zero;
  const int b_step = bn < ROWS ? 16 : 0;
  // The A operand (16 vocab columns x 16 features, read transposed from the
  // [k][n] tile): lane l addresses feature row (l & 7) + 8 (l >> 4) at
  // 16-byte chunk (l >> 3) & 1 of the m-tile.
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_chunk = warp * 2 * kMT + ((lane >> 3) & 1);

  float c[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0.0f;
  }

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is consumed
    issue(it + kStages - 1);
    const bf16* st = ring + (it % kStages) * kBK * kBN;
    const int kc = it % kc_n;
    const bf16* bp = b_row + (b_step ? kc * kBK : 0);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bf[4];
      ldsm_x4(bf, bp + ks * b_step);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int kr = ks * 16 + a_row;
        const int ch = a_chunk + mt * 2;
        uint32_t af[4];
        ldsm_x4_trans(af, st + kr * kBN + ((ch ^ (kr & 7)) << 3));
        // W is exact in bf16, so hi and lo into one float32 accumulator
        // give the float32 product to about 2^-16 of each term
        mma(c[mt], af, bf[0], bf[1]);
        mma(c[mt], af, bf[2], bf[3]);
      }
    }
    if (kc != kc_n - 1) continue;

    // The tile's (max, first argmax, sum of exp) of each row. Lane l holds
    // rows n = 2 (l & 3) + j at vocab columns (l >> 2) + 8 i of the warp's
    // 16 kMT columns, in increasing order.
    const int tile = bx + (it / kc_n) * gx;
    const int vw = tile * kBN + warp * 16 * kMT + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float z[2 * kMT];
      int vi[2 * kMT];
#pragma unroll
      for (int i = 0; i < 2 * kMT; ++i) {
        z[i] = c[i >> 1][(i & 1) * 2 + j];
        vi[i] = vw + i * 8;
      }
      float m = -INFINITY;
      int a = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < 2 * kMT; ++i) {
        if (vi[i] < v_len && beats(z[i], vi[i], m, a)) {
          m = z[i];
          a = vi[i];
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const int a2 = __shfl_xor_sync(0xffffffffu, a, off);
        if (beats(m2, a2, m, a)) {
          m = m2;
          a = a2;
        }
      }
      float l = 0.0f;
      if (m != -INFINITY) {
#pragma unroll
        for (int i = 0; i < 2 * kMT; ++i) {
          if (vi[i] < v_len) l += expf(z[i] - m);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, off);
      }
      if (lane < 4) {
        const int n = 2 * lane + j;
        s_sm[warp * 8 + n] = m;
        s_sa[warp * 8 + n] = a;
        s_sl[warp * 8 + n] = l;
      }
    }
    __syncthreads();
    if (tid < ROWS && t0 + tid < t_len) {
      Stat acc{s_sm[tid], s_sa[tid], s_sl[tid]};
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) {
        acc = fold(acc, Stat{s_sm[ww * 8 + tid], s_sa[ww * 8 + tid],
                             s_sl[ww * 8 + tid]});
      }
      const int64_t o = static_cast<int64_t>(t0 + tid) * n_tiles + tile;
      part_m[o] = acc.m;
      part_a[o] = acc.a;
      part_l[o] = acc.l;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0.0f;
    }
  }
  cp_async_wait<0>();  // only empty groups can be left
}

// The SMs and the blocks of exit_head_tc<ROWS> resident on one at width
// d: the persistent grid's size, which the plan takes as arguments.
template <int ROWS>
int occupancy(int d, int* sms, int* per) {
  static bool configured = false;
  static int n_sm = 0;
  static int cached_d = -1;
  static int per_sm = 0;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        exit_head_tc<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (d != cached_d) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, exit_head_tc<ROWS>, kThreads, smem_bytes(ROWS, d));
    if (err != cudaSuccess) return static_cast<int>(err);
    cached_d = d;
  }
  *sms = n_sm;
  *per = per_sm;
  return 0;
}

int occupancy_by_rows(int t_len, int d, int* sms, int* per) {
  if (t_len == 1) return occupancy<1>(d, sms, per);
  if (t_len == 2) return occupancy<2>(d, sms, per);
  if (t_len <= 4) return occupancy<4>(d, sms, per);
  return occupancy<8>(d, sms, per);
}

template <int ROWS>
void launch(const Launch& l, const void* h, const void* g, const void* w,
            int t_len, int d, int v_len, float eps, float* pm, int32_t* pa,
            float* pl, cudaStream_t stream) {
  exit_head_tc<ROWS><<<l.grid, l.block, l.smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(g),
      static_cast<const bf16*>(w), t_len, d, v_len, eps,
      (v_len + kBN - 1) / kBN, pm, pa, pl);
}

}  // namespace tc

template <typename T, int ROWS, bool ALIGNED>
void launch_tiles(const Launch& l, const void* h, const void* g,
                  const void* w, int t_len, int d, int v_len, float eps,
                  float* pm, int32_t* pa, float* pl, cudaStream_t stream) {
  exit_head_tiles<T, ROWS, ALIGNED><<<l.grid, l.block, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(g),
      static_cast<const T*>(w), t_len, d, v_len, eps, pm, pa, pl);
}

template <typename T, bool ALIGNED>
void tiles_by_rows(const Launch& l, int slot, const void* h, const void* g,
                   const void* w, int t_len, int d, int v_len, float eps,
                   float* pm, int32_t* pa, float* pl, cudaStream_t stream) {
  switch (slot) {
    case 0: launch_tiles<T, 1, ALIGNED>(l, h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream); break;
    case 1: launch_tiles<T, 2, ALIGNED>(l, h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream); break;
    case 2: launch_tiles<T, 4, ALIGNED>(l, h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream); break;
    default: launch_tiles<T, 8, ALIGNED>(l, h, g, w, t_len, d, v_len, eps, pm, pa, pl, stream); break;
  }
}

// The row-block size's slot (ROWS = 1, 2, 4, 8).
int rows_slot(int t_len) {
  return t_len == 1 ? 0 : t_len == 2 ? 1 : t_len <= 4 ? 2 : 3;
}

}  // namespace

// Which kernel takes the product, dispatched explicitly (neither is a
// fallback for the other): 1 = the tensor cores, for bfloat16 with 16-byte
// W rows (`aligned`) and d <= 5120 (the normed rows fit in shared memory),
// which holds at every served model; 0 = the CUDA cores, for float32 (whose
// products stay in full float32) and for W rows that cp.async cannot copy.
extern "C" int exit_head_tensor_cores(int dtype, int aligned, int d) {
  return dtype == 1 && aligned && d <= tc::kMaxD ? 1 : 0;
}

// The persistent grid's card-dependent arguments on the current card, as
// exit_head_launch reads them for t_len rows at width d on the tensor
// cores: the SMs (*sms) and the pass-1 blocks resident on one (*per).
// Returns the CUDA error.
extern "C" int exit_head_occupancy(int t_len, int d, int* sms, int* per) {
  return tc::occupancy_by_rows(t_len, d, sms, per);
}

// Columns per pass-1 tile of the kernel that exit_head_tensor_cores picks;
// the wrapper sizes the scratch buffers [t_len, ceil(v_len / tile)] from it.
extern "C" int exit_head_tile_cols(int dtype, int aligned, int d) {
  if (exit_head_tensor_cores(dtype, aligned, d)) return tc::kBN;
  return dtype == 0 ? 128 : 256;
}

// Entries: tc::exit_head_tc<1, 2, 4, 8> (0-3); exit_head_tiles<float,
// ROWS, ALIGNED> (4-11) and <__nv_bfloat16, ROWS, ALIGNED> (12-19), ROWS
// 1, 2, 4, 8 each unaligned then aligned; exit_head_fold (20). Two
// launches: pass 1, then the fold (a block a row). Pass 1 on the tensor
// cores is a persistent grid: as many blocks as n_sm SMs hold at per_sm
// each, every block given the same number of 128-column tiles, by ROWS
// rows; on the CUDA cores a block per (column tile, ROWS rows). No launch
// for no rows or columns, -1 where the launch refuses the arguments.
int make_plan(int t_len, int d, int v_len, int dtype, int aligned, int n_sm,
              int per_sm, Launch* out) {
  if (t_len <= 0 || v_len <= 0) return 0;
  const int slot = rows_slot(t_len);
  const int rows = 1 << slot;
  if (exit_head_tensor_cores(dtype, aligned, d)) {
    if (v_len % 8 || n_sm < 1) return -1;
    const int n_tiles = cdiv(v_len, tc::kBN);
    const int resident = (per_sm > 1 ? per_sm : 1) * n_sm;
    int blocks = n_tiles < resident ? n_tiles : resident;
    const int per_block = cdiv(n_tiles, blocks);
    blocks = cdiv(n_tiles, per_block);
    out[0] = {slot, dim3(blocks, cdiv(t_len, rows)), dim3(tc::kThreads),
              tc::smem_bytes(rows, d), 1, 1};
  } else {
    const int type = dtype == 0 ? 0 : 1;
    out[0] = {4 + 8 * type + 2 * slot + (aligned ? 1 : 0),
              dim3(cdiv(v_len, exit_head_tile_cols(dtype, aligned, d)),
                   cdiv(t_len, rows)),
              dim3(kThreads), 0, 0, 1};
  }
  out[1] = {20, dim3(t_len), dim3(kThreads), 0, 0, 1};
  return 2;
}

// h [t_len, d], g [d], w [d, v_len] contiguous, one type (dtype 0 =
// float32, 1 = bfloat16); `aligned` says that w's rows start on 16-byte
// boundaries. part_* are float32/int32 scratch of t_len * n_tiles; idx, mx,
// lse [t_len]. Launches pass 1 (on the tensor cores or the CUDA cores, see
// exit_head_tensor_cores) and the fold on `stream` by make_plan and returns
// a CUDA error code (0 = launched).
extern "C" int exit_head_launch(const void* h, const void* g, const void* w,
                                int t_len, int d, int v_len, float eps,
                                int dtype, int aligned, float* part_m,
                                int32_t* part_a, float* part_l, int32_t* idx,
                                float* mx, float* lse, void* stream) {
  if (t_len <= 0 || v_len <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tensor_cores = exit_head_tensor_cores(dtype, aligned, d);
  int n_sm = 1, per_sm = 1;
  if (tensor_cores) {
    if (reinterpret_cast<uintptr_t>(w) % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int err = tc::occupancy_by_rows(t_len, d, &n_sm, &per_sm);
    if (err != 0) return err;
  }
  Launch l[2];
  if (make_plan(t_len, d, v_len, dtype, aligned, n_sm, per_sm, l) != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slot = rows_slot(t_len);
  if (tensor_cores) {
    switch (slot) {
      case 0: tc::launch<1>(l[0], h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s); break;
      case 1: tc::launch<2>(l[0], h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s); break;
      case 2: tc::launch<4>(l[0], h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s); break;
      default: tc::launch<8>(l[0], h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s); break;
    }
  } else if (dtype == 0) {
    if (aligned) tiles_by_rows<float, true>(l[0], slot, h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
    else tiles_by_rows<float, false>(l[0], slot, h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
  } else {
    if (aligned) tiles_by_rows<__nv_bfloat16, true>(l[0], slot, h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
    else tiles_by_rows<__nv_bfloat16, false>(l[0], slot, h, g, w, t_len, d, v_len, eps, part_m, part_a, part_l, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = exit_head_tile_cols(dtype, aligned, d);
  exit_head_fold<<<l[1].grid, l[1].block, 0, s>>>(
      part_m, part_a, part_l, (v_len + cols - 1) / cols, idx, mx, lse);
  return static_cast<int>(cudaGetLastError());
}

// The plan of exit_head_launch at these arguments on a card of n_sm SMs
// that holds per_sm pass-1 blocks on each (see make_plan): writes each
// launch's kPlanFields ints to `plan` and returns their number (-1 where
// the launch refuses them).
extern "C" int exit_head_plan(int t_len, int d, int v_len, int dtype,
                              int aligned, int n_sm, int per_sm, int* plan) {
  Launch l[2];
  const int n = make_plan(t_len, d, v_len, dtype, aligned, n_sm, per_sm, l);
  return n < 0 ? n : write_plan(l, n, plan);
}
