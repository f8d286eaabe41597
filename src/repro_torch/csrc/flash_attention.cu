// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel, flash_attention_kernel):
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, g(h), j] / sqrt(D)) v[b, g(h), j]
//
// with g(h) = h / (H / K) (grouped-query attention), j <= i when causal, the
// softmax kept online in float32 (running max m, denominator l and output
// accumulator), and the output in q's type. Two kernels, picked by dtype in
// flash_attention_launch, with no route from one to the other:
//
//   * bfloat16 runs on the tensor cores (tc::flash_attention_kernel);
//   * float32 runs on the CUDA cores (f32::flash_attention_kernel), so
//     that the float32 model path keeps full float32 products (TF32 would
//     not hold its 2e-3 tolerance).
//
// Both: the TPU kernel carries (m, l, acc) in VMEM scratch across a
// sequential grid axis over the kv blocks. Blocks on the card run in no
// order, so here one thread block owns one 64-row q tile of one (batch,
// head) and walks the kv tiles itself, with m, l and acc in registers. kv
// tiles entirely above the causal diagonal are never loaded. Any S works:
// rows and columns past S are masked, where the Pallas kernel asserts
// S % block == 0. The tensors are addressed through their strides (the head
// dimension must be contiguous), so the model's [B, S, H, D] activations go
// in as [B, H, S, D] views with no transpose copies, and the output can be
// written in the model's layout.
//
// bfloat16, tensor cores (FlashAttention-2's layout). 4 warps; warp w owns
// q rows 16w..16w+15 of the tile. The kv tiles (64 positions) pass through
// a double-buffered ring in shared memory, filled with 16-byte cp.async
// copies (rows past S zero-filled through the src-size operand): tile t+1
// loads while tile t is computed. Rows of D bf16 sit in 16-byte chunks whose
// index is XOR-swizzled with the row, so that the 8 row addresses of every
// ldmatrix (and ldmatrix.trans for V) fall in 8 different bank groups. The
// warp loads its Q fragments once with ldmatrix and keeps them in registers.
// S = Q.K^T and O += P.V are mma.sync.m16n8k16 (bf16 inputs, float32
// accumulators). The softmax runs on the S accumulators in registers: a row
// lives in the 4 lanes of a quad, so its max folds with two shuffles (its
// sum is folded once, at the end). P is rounded to bf16 in registers (as the
// plain version casts the probabilities to the input type) and, since the
// C layout of two m16n8 tiles is the A layout of one m16n8k16, goes straight
// into the P.V product without touching shared memory. Only the diagonal
// tile and a ragged last tile are masked. The q tiles are issued longest
// causal walk first (blockIdx.z reversed, z the slowest grid axis), so the
// short tiles fill the tail. The output is staged through the warp's own Q
// rows in shared memory and written as 16-byte rows. cp.async needs 16-byte
// aligned rows: the wrapper raises unless the base pointers are 16-byte
// aligned and every batch, head and position stride is a multiple of 8
// elements (the launcher refuses such a launch too).
//
// float32, CUDA cores (the port's first attention kernel, unchanged). 256
// threads as a 16 x 16 grid (ty, tx) over 32-position kv tiles. For the
// scores a thread owns rows ty + 16 i (i < 4) and columns tx + 16 j
// (j < 2) of the 64 x 32 tile; for the output, rows ty + 16 i and head
// dims tx + 16 k. Row maxima and sums fold over the 16 lanes that share
// ty with a shuffle tree. Tiles sit in shared memory as float32 (the score
// tile padded by one word per row so that the column reads hit 16
// different banks).
//
// Bound on this card. Causal attention costs 4 * B * H * S^2 * D / 2
// operations against (q, k, v, out) read or written once. In bfloat16 at
// the served S = 128 the bytes bound it (0.9-6.3 us at 3.35 TB/s); at
// S = 2048 the operations do (35 us at 989 TFLOP/s). The float32 kernel is
// bound by the float32 units (67 TFLOP/s).
//
// Budget of the tensor-core kernel (ptxas -v, sm_90a, CUDA 12.8): 252
// registers at D = 128 (165, 127, 85 at D = 64, 32, 16), no spills; shared
// memory (64 + 4 * 64) * D * 2 bytes, 80 KB at D = 128 (40 KB at D = 64).
// Registers and shared memory each allow 2 blocks, 8 warps, an SM at
// D = 128, so a warp's products wait on its own softmax with little else
// to hide it: at S = 2048 the kernel reaches about a quarter of the tensor
// cores' rate. Warps that own 32 rows (FlashAttention-2's 128-row tile, so
// each K/V fragment feeds twice the products) spill at D = 128 and ran
// slower on this card; wgmma issued asynchronously, with the softmax of one
// warpgroup overlapping the products of another (FlashAttention-3), is the
// route to the rest of the rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Element strides (batch, head, position) of q, k, v and out; the head
// dimension has stride 1.
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

// One launch of a plan: the kernel entry (an index into ENTRIES in
// kernels/flash_attention/ops.py), grid, block, dynamic shared memory bytes,
// whether the launch path raises the 48 KB cap on it, and the blocks of a
// cluster along x. The launch path takes its geometry from the plan, and
// flash_attention_plan writes each launch as kPlanFields ints for the launch audit
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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;           // q rows of a block, 16 per warp
constexpr int kBK = 64;           // kv positions of a tile
constexpr int kThreads = 128;
static_assert(kBQ == kBK, "load_tile fills q and kv tiles alike");

template <int D>
constexpr int smem_bytes() {
  return (kBQ + 4 * kBK) * D * static_cast<int>(sizeof(bf16));
}

// Element offset of 16-byte chunk c of row r in a [rows][D] tile. The chunk
// index is XORed with the index of the row's 128-byte line (mod 8, or mod
// the chunks of a row where a row is shorter than a line), so the 8 rows
// that one ldmatrix phase reads at one chunk land in 8 different 16-byte
// bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;
  constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  return r * D + ((c ^ ((r / kRowsPerLine) & kMask)) << 3);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows r0..r0+kBK-1 of a [S, D] matrix (position stride `stride`) into a
// swizzled tile; rows at or past s_len are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g,
                                          int64_t stride, int r0, int s_len,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = r0 + r < s_len;
    const bf16* src = ok ? g + (r0 + r) * stride + c * 8 : g;
    cp_async16(tile + swz<D>(r, c), src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, Strides st,
    int s_len, int group, float scale_log2, int causal) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kBQ][D], later the output
  bf16* ks = qs + kBQ * D;                     // [2][kBK][D]
  bf16* vs = ks + 2 * kBK * D;                 // [2][kBK][D]
  constexpr int kDK = D / 16;                  // k-steps of Q.K^T
  constexpr int kDN = D / 8;                   // n-tiles of the output
  constexpr int kNT = kBK / 8;                 // n-tiles of the scores

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest causal walk first
  const int q0 = qt * kBQ;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vb = v + b * st.v[0] + kvh * st.v[1];

  const int kv_end = causal ? min(s_len, q0 + kBQ) : s_len;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  load_tile<D>(qs, qb, st.q[2], q0, s_len, tid);
  load_tile<D>(ks, kb, st.k[2], 0, s_len, tid);
  load_tile<D>(vs, vb, st.v[2], 0, s_len, tid);
  cp_async_commit();

  uint32_t qf[kDK][4];
  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // rows g and g + 8 of the warp's 16 (g = lane / 4): running max (in
  // log2 units) and this lane's share of the running sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + lane / 4;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile<D>(ks + (buf ^ 1) * kBK * D, kb, st.k[2], (kt + 1) * kBK,
                   s_len, tid);
      load_tile<D>(vs + (buf ^ 1) * kBK * D, vb, st.v[2], (kt + 1) * kBK,
                   s_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        ldsm_x4(qf[kk], qs + swz<D>(warp * 16 + (lane & 15),
                                    2 * kk + (lane >> 4)));
      }
    }
    const bf16* kt_s = ks + buf * kBK * D;
    const bf16* vt_s = vs + buf * kBK * D;

    // S = Q . K^T: 16 rows x 64 positions a warp
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t kf[4];
        ldsm_x4(kf, kt_s + swz<D>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
        mma(s[2 * n2], qf[kk], kf[0], kf[1]);
        mma(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const int k0 = kt * kBK;
    if ((causal && k0 + kBK - 1 > q0) || k0 + kBK > s_len) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= s_len || (causal && col > row)) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax on the accumulators; P packed as the A operand
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      // every row sees position k0 of every tile it walks, so m_new is
      // finite; the guard keeps a fully masked row at p = 0, not NaN
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float p0 = exp2f(fmaf(s[n][2 * i], scale_log2, -m_use));
        const float p1 = exp2f(fmaf(s[n][2 * i + 1], scale_log2, -m_use));
        sum += p0 + p1;
        // A fragment of k-step n / 2: a[i] rows g (i = 0) or g + 8
        // (i = 1) at columns 0..7, a[2 + i] at columns 8..15
        pa[n / 2][(n & 1) * 2 + i] = pack_bf16(p0, p1);
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // O += P . V
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
      for (int n2 = 0; n2 < kDN / 2; ++n2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt_s + swz<D>(j * 16 + (lane & 15),
                                        2 * n2 + (lane >> 4)));
        mma(o[2 * n2], pa[j], vf[0], vf[1]);
        mma(o[2 * n2 + 1], pa[j], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile kt + 2
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[i] = 1.0f / sum;
  }
  // stage the warp's 16 rows in its own (already read) Q rows
  const int g = lane / 4;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      *reinterpret_cast<__nv_bfloat162*>(qs + swz<D>(r, n) + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] * inv[i],
                                o[n][2 * i + 1] * inv[i]);
    }
  }
  __syncwarp();
  bf16* ob = out + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int it = 0; it < 16 * kDN / 32; ++it) {
    const int idx = lane + it * 32;
    const int r = warp * 16 + idx / kDN;
    const int c = idx % kDN;
    const int pos = q0 + r;
    if (pos < s_len) {
      *reinterpret_cast<uint4*>(ob + pos * st.o[2] + c * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<D>(r, c));
    }
  }
}

template <int D>
int launch(const Launch& l, const void* q, const void* k, const void* v,
           void* out, const Strides& st, int s_len, int group, float scale,
           int causal, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  flash_attention_kernel<D><<<l.grid, l.block, l.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), st, s_len, group,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

// cp.async moves 16-byte rows: every base pointer 16-byte aligned and every
// stride a multiple of 8 elements.
bool aligned(const void* q, const void* k, const void* v, const void* out,
             const Strides& st) {
  const void* ptrs[] = {q, k, v, out};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  for (int i = 0; i < 3; ++i) {
    if (st.q[i] % 8 || st.k[i] % 8 || st.v[i] % 8 || st.o[i] % 8) {
      return false;
    }
  }
  return true;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, Strides st,
    int s_len, int group, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                         // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);           // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);           // [kBK][D]
  float* ps = vs + kBK * D;                 // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  constexpr int kDK = D / 16;               // output dims per thread

  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + kvh * st.k[1];
  const float* vb = v + b * st.v[0] + kvh * st.v[1];

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int dd = idx % D;
    const int pos = q0 + r;
    qs[r * (D + 1) + dd] = pos < s_len ? qb[pos * st.q[2] + dd] : 0.0f;
  }

  float m[4], l[4], acc[4][kDK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) acc[i][kk] = 0.0f;
  }

  const int kv_end = causal ? min(s_len, q0 + kBQ) : s_len;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D;
      const int dd = idx % D;
      const int pos = k0 + r;
      const bool ok = pos < s_len;
      ks[r * (D + 1) + dd] = ok ? kb[pos * st.k[2] + dd] : 0.0f;
      vs[r * D + dd] = ok ? vb[pos * st.v[2] + dd] : 0.0f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool keep[2];
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        keep[j] = kpos < s_len && !(causal && kpos > qpos);
        s[i][j] *= scale;
        if (keep[j]) row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      }
      const float m_new = fmaxf(m[i], row_max);
      // m_new is finite: every row sees kv position 0 in the first tile
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      }
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) acc[i][kk] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[kDK];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) vv[kk] = vs[j * D + tx + 16 * kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk) {
          acc[i][kk] = fmaf(pv[i], vv[kk], acc[i][kk]);
        }
      }
    }
  }

  float* ob = out + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s_len) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      ob[qpos * st.o[2] + tx + 16 * kk] = acc[i][kk] * inv;
    }
  }
}

template <int D>
int launch(const Launch& l, const void* q, const void* k, const void* v,
           void* out, const Strides& st, int s_len, int group, float scale,
           int causal, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  flash_attention_kernel<D><<<l.grid, l.block, l.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st, s_len,
      group, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

template <int D>
int launch(const Launch& l, const void* q, const void* k, const void* v,
           void* out, const Strides& st, int s_len, int group, float scale,
           int causal, cudaStream_t stream) {
  if (l.entry >= 4) {
    return f32::launch<D>(l, q, k, v, out, st, s_len, group, scale, causal,
                          stream);
  }
  return tc::launch<D>(l, q, k, v, out, st, s_len, group, scale, causal,
                       stream);
}

template <int D>
int smem_of(int dtype) {
  return dtype == 1 ? tc::smem_bytes<D>()
                    : f32::smem_floats<D>() * static_cast<int>(sizeof(float));
}

// Entries: tc::flash_attention_kernel<16, 32, 64, 128> (0-3), then
// f32:: at the same head dims (4-7). One launch: a block per (head, row,
// 64 query positions) with the whole kernel's shared memory opted in; -1
// where the launch refuses the shape.
int make_plan(int b, int h, int kh, int s_len, int d, int dtype,
              Launch* out) {
  if (b <= 0 || h <= 0 || s_len <= 0) return 0;
  const int slot = d == 16 ? 0 : d == 32 ? 1 : d == 64 ? 2 : d == 128 ? 3
                                                                       : -1;
  if (slot < 0 || kh <= 0 || h % kh || (dtype != 0 && dtype != 1)) return -1;
  const int smem = d == 16 ? smem_of<16>(dtype) : d == 32 ? smem_of<32>(dtype)
                   : d == 64 ? smem_of<64>(dtype) : smem_of<128>(dtype);
  if (dtype == 1) {
    out[0] = {slot, dim3(h, b, (s_len + tc::kBQ - 1) / tc::kBQ),
              dim3(tc::kThreads), smem, 1, 1};
  } else {
    out[0] = {4 + slot, dim3((s_len + f32::kBQ - 1) / f32::kBQ, h, b),
              dim3(f32::kThreads), smem, 1, 1};
  }
  return 1;
}

}  // namespace

// q, out [b, h, s, d]; k, v [b, kh, s, d], addressed through `strides`
// (12 element strides: batch, head, position of q, k, v, out; the head
// dimension is contiguous). d is 16, 32, 64 or 128; h % kh == 0; dtype 0 =
// float32 (CUDA cores), 1 = bfloat16 (tensor cores; base pointers 16-byte
// aligned, strides multiples of 8) for all four. Launches on `stream` and
// returns a CUDA error code (0 = launched; cudaErrorInvalidValue for a head
// dim, dtype or bf16 alignment the kernels do not take).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const int64_t* strides, int b, int h, int kh, int s_len, int d,
    float scale, int causal, int dtype, void* stream) {
  Launch l[1];
  const int n = make_plan(b, h, kh, s_len, d, dtype, l);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  // A dimension of size 1 never uses its stride: 0 keeps it out of the
  // alignment check.
  const int q_dims[3] = {b, h, s_len};
  const int kv_dims[3] = {b, kh, s_len};
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = q_dims[i] > 1 ? strides[i] : 0;
    st.k[i] = kv_dims[i] > 1 ? strides[3 + i] : 0;
    st.v[i] = kv_dims[i] > 1 ? strides[6 + i] : 0;
    st.o[i] = q_dims[i] > 1 ? strides[9 + i] : 0;
  }
  if (dtype == 1 && !tc::aligned(q, k, v, out, st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = h / kh;
  switch (d) {
    case 16: return launch<16>(l[0], q, k, v, out, st, s_len, group, scale, causal, s);
    case 32: return launch<32>(l[0], q, k, v, out, st, s_len, group, scale, causal, s);
    case 64: return launch<64>(l[0], q, k, v, out, st, s_len, group, scale, causal, s);
    default: return launch<128>(l[0], q, k, v, out, st, s_len, group, scale, causal, s);
  }
}

// The plan of flash_attention_launch at these sizes (see make_plan):
// writes each launch's kPlanFields ints to `plan` and returns their number
// (-1 where the launch refuses the shape).
extern "C" int flash_attention_plan(int b, int h, int kh, int s_len, int d,
                                    int dtype, int* plan) {
  Launch l[1];
  const int n = make_plan(b, h, kh, s_len, d, dtype, l);
  return n < 0 ? n : write_plan(l, n, plan);
}
