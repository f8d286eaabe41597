// Single-token KV-cache (decode) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, decode_attention_kernel):
//
//   out[b, h] = sum_{j < len_b} softmax_j(q[b, h] . k[b, g(h), j] / sqrt(D)) v[b, g(h), j]
//
// with g(h) = h / (H / K) (grouped-query attention), len_b = lengths[b]
// clamped to [0, S], the softmax in float32 and the output in q's type
// (float32 or bfloat16). A row with length 0 gives 0, as the Pallas kernel
// does; the plain version follows the reference's oracle there (the mean of
// v), and the model always passes lengths >= 1.
//
// Bound on this card: bytes. Each valid K/V element is read once and costs
// about 4 operations per query head (a product-add for the score and one for
// the value sum), far below the card's operations-per-byte line; the least
// time is (the valid K/V prefix + q + out) over the HBM rate: 0.04-1 us at
// the served S = 160, 21-24 us at B = 8, S = 4096 with half-full rows. At
// the served shapes the launch and one memory round trip, not the bytes,
// are most of the time.
//
// Design: one launch per call. The TPU kernel runs a grid (B, H, S / bs)
// whose last axis walks the cache in sequence, carrying (m, l, acc) in
// VMEM. Here a block takes one (row b, kv head, chunk of positions) and the
// query heads that share the kv head, so each K/V element is read once. The
// wrapper's plan (kernels/decode_attention/ops.py::split) gives the whole
// prefix to one block up to 256 positions (the served S = 160) and splits a
// longer cache into up to kMaxCluster chunks, about one block an SM. Two
// kernels, picked by dtype in decode_attention_launch (neither is a
// fallback for the other):
//
//   * bfloat16 runs on the tensor cores (tc::decode_attention_kernel), up
//     to 8 query heads a block (the mma's N; the served G is 3 or 4).
//     Each of the 8 warps owns the 16-position slices w, w + 8, ... of the
//     block's chunk and runs on its own: it fills its own ring of 2-8
//     slices (128 KB a block at D = 128) with 16-byte cp.async copies (K
//     and V of a slice as separate commit groups, so the scores start when
//     K has landed; at S = 160 every load of the block is issued before the
//     first score), and only __syncwarp orders it. Rows at or past the
//     length are zero-filled, never read. Scores S^T = K q^T are one
//     mma.sync m16n8k16 per 16 dims, with K read by ldmatrix as the A
//     operand (16 positions) and q in registers as the B operand (8 heads,
//     zero past G). The softmax is online over the warp's slices, in
//     registers (a head's 16 scores fold over 8 lanes with 3 shuffles). P is
//     rounded to bf16 (as the plain version casts the probabilities) and
//     goes through 384 bytes of the warp's shared memory to become the B
//     operand of O^T += V^T P^T, with V read by ldmatrix.trans as the A
//     operand (16 dims x 16 positions). At the end the 8 warps' (m, l, O)
//     fold in warp order. Eight warps, not four: a block's slices are
//     latency-bound chains, and at S = 160 (10 slices) eight warps take
//     them in at most two rounds instead of three.
//   * float32 runs on the CUDA cores (f32::decode_attention_kernel), up to
//     4 query heads a block, so that the float32 model path keeps full float32
//     products. The block walks its chunk in tiles of 32 positions through
//     a ring of 3-8 tiles in shared memory (cp.async, K and V as separate
//     groups); a cache row is read as 16-byte vectors by D / 4 neighbouring
//     lanes with q in registers and the dot products folded by a shuffle
//     tree; warp g keeps the online softmax of query head g, a lane per
//     position; the P.V sums stay in registers and fold over lanes and
//     warps at the end.
//
// Both: the fold of the chunks stays in the launch. The chunks of one (b,
// kv head, head group) are one thread-block cluster (gridDim.x = chunks =
// cluster size <= 8) that shares (m, l, acc) through distributed shared
// memory. After a cluster barrier each block folds a share of the outputs
// over the chunks in chunk order and writes acc / l; a second barrier keeps
// every block's shared memory alive until the fold has read it. With one
// chunk the block writes its output directly: no scratch, no second pass,
// no atomics. Every sum is taken in a fixed order (shuffle trees, warps in
// order, chunks in order), so a result repeats bitwise run to run. Any S:
// the ragged last slice is masked (the Pallas kernel asserts
// S % block_s == 0). The launch allocates nothing and never synchronises
// with the host, so it can be captured in a CUDA graph.
//
// Layout. q is addressed through its (batch, head) strides and k, v through
// their (batch, kv head, position) strides; the head dimension is
// contiguous and every row 16-byte aligned (the launcher refuses anything
// else). So the model's [B, 1, H, D] activations and a layer of its
// [B, Smax, K, D] cache go in as [B, H, D] and [B, K, Smax, D] views, with
// no copies.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // chunks of one (b, kv head, head group)
constexpr float kLog2e = 1.4426950408889634f;

// Element strides: q (batch, head); k and v (batch, kv head, position).
struct Strides {
  int64_t q[2], k[3], v[3];
};

// One launch of a plan: the kernel entry (an index into ENTRIES in
// kernels/decode_attention/ops.py), grid, block, dynamic shared memory bytes,
// whether the launch path raises the 48 KB cap on it, and the blocks of a
// cluster along x. The launch path takes its geometry from the plan, and
// decode_attention_plan writes each launch as kPlanFields ints for the launch audit
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
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

__device__ __forceinline__ int valid_length(const int* lengths, int b,
                                            int s_len) {
  return max(0, min(lengths[b], s_len));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The end of a block: s_acc [H][D] holds its chunk's unnormalised P.V sums
// of the gb query heads, s_m and s_l [H] their max (log2 units) and sum of
// 2^(s - m); a chunk with no valid position has m = -inf, l = 0. Writes
// out[b, h0 + g] (ob) directly with one chunk, else folds the cluster's
// chunks in chunk order; s_cm and s_cl [kMaxCluster][H] are scratch.
template <typename T, int D, int H>
__device__ __forceinline__ void finish(const float* s_acc, const float* s_m,
                                       const float* s_l, float* s_cm,
                                       float* s_cl, int gb, T* ob) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int n_chunks = gridDim.x;
  if (n_chunks == 1) {
    __syncthreads();
    for (int idx = tid; idx < gb * D; idx += threads) {
      const float l = s_l[idx / D];
      // no valid position (length 0): 0, as the Pallas kernel's acc / l
      ob[idx] = from_f32<T>(l > 0.0f ? s_acc[idx] / l : 0.0f);
    }
    return;
  }
  // Every block gathers each chunk's (m, l), then folds its share of the
  // outputs over the chunks in order.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = tid; i < n_chunks * gb; i += threads) {
    const int r = i / gb;
    const int g = i % gb;
    s_cm[r * H + g] = *cluster.map_shared_rank(s_m + g, r);
    s_cl[r * H + g] = *cluster.map_shared_rank(s_l + g, r);
  }
  __syncthreads();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int idx = rank * threads + tid; idx < gb * D;
       idx += n_chunks * threads) {
    const int g = idx / D;
    float mx = -INFINITY;
    for (int r = 0; r < n_chunks; ++r) mx = fmaxf(mx, s_cm[r * H + g]);
    float l = 0.0f;
    float o = 0.0f;
    if (mx != -INFINITY) {
      for (int r = 0; r < n_chunks; ++r) {
        const float mr = s_cm[r * H + g];
        if (mr == -INFINITY) continue;  // a chunk past the length
        const float w = exp2f(mr - mx);
        l = fmaf(s_cl[r * H + g], w, l);
        o = fmaf(*cluster.map_shared_rank(s_acc + idx, r), w, o);
      }
    }
    ob[idx] = from_f32<T>(mx != -INFINITY ? o / l : 0.0f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kH = 8;       // query heads of a block: the mma's N
constexpr int kSlice = 16;  // positions of a warp's slice: the mma's M
constexpr int kPStride = 24;  // P scratch row (8 heads x 16 positions):
                              // 48 bytes, so 8 rows hit 8 bank groups

template <int D>
struct Shape {
  static constexpr int kSliceElems = kSlice * D;
  static constexpr int kFit =
      104 * 1024 / (kTcWarps * 2 * kSliceElems * 2);
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  static constexpr int kRingElems = kTcWarps * kStages * 2 * kSliceElems;
  // the rings, P [warps][kH][kPStride] bf16, then float: acc [kH][D],
  // m and l [kH], the chunks' m and l [kMaxCluster][kH]
  static constexpr int kSmem = (kRingElems + kTcWarps * kH * kPStride) * 2 +
                               (kH * D + 2 * kH + 2 * kMaxCluster * kH) * 4;
  // the warps' (m, l, O) fold reuses the rings
  static_assert(kTcWarps * kH * (D + 2) * 4 <= kRingElems * 2, "ring");
};

// Element offset of 16-byte chunk c of row r in a [rows][D] slice, XOR-
// swizzled with the row's 128-byte line so that the 8 rows an ldmatrix
// phase reads at one chunk land in 8 bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;
  constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  return r * D + ((c ^ ((r / kRowsPerLine) & kMask)) << 3);
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

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, float32 accumulators.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// `rows` cache rows from position p of one kv head's [S, D] matrix
// (position stride `stride`) into a swizzled [kSlice][D] slice, the rest
// zero-filled, then one commit group; with rows = 0 nothing is copied and
// the group is empty.
template <int D>
__device__ __forceinline__ void load_slice(bf16* slice, const bf16* g,
                                           int64_t stride, int p, int rows,
                                           int lane) {
  if (rows > 0) {
#pragma unroll
    for (int i = lane; i < kSlice * D / 8; i += 32) {
      const int r = i / (D / 8);
      const int c = i % (D / 8);
      const bool ok = r < rows;
      const bf16* src = ok ? g + static_cast<int64_t>(p + r) * stride + c * 8
                           : g;
      cp_async16(slice + swz<D>(r, c), src, ok);
    }
  }
  cp_async_commit();
}

// Grid (chunks, kv heads * head groups of kH, B); the chunks of one (b, kv
// head, head group) form one cluster.
template <int D>
__global__ void __launch_bounds__(kTcThreads) decode_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ lengths,
    bf16* __restrict__ out, Strides st, int s_len, int h, int group,
    int chunk, float scale_log2) {
  using Sh = Shape<D>;
  constexpr int kStages = Sh::kStages;
  constexpr int kDK = D / 16;  // k-steps of the scores, m-tiles of O^T
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rings = reinterpret_cast<bf16*>(smem);
  bf16* p_all = rings + Sh::kRingElems;  // [warps][kH][kPStride]
  float* s_acc = reinterpret_cast<float*>(p_all + kTcWarps * kH * kPStride);
  float* s_m = s_acc + kH * D;
  float* s_l = s_m + kH;
  float* s_cm = s_l + kH;
  float* s_cl = s_cm + kMaxCluster * kH;

  const int b = blockIdx.z;
  const int len = valid_length(lengths, b, s_len);
  const int n_hgroups = (group + kH - 1) / kH;
  const int kvh = blockIdx.y / n_hgroups;
  const int g0 = (blockIdx.y % n_hgroups) * kH;
  const int gb = min(kH, group - g0);  // query heads of this block
  const int h0 = kvh * group + g0;
  const int p0 = blockIdx.x * chunk;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane >> 2;  // the mma fragments' row group
  const int q4 = lane & 3;   // and column pair

  // q as the B operand (dims x heads) of each k-step: lane holds head gq,
  // dims 2 q4 + {0, 1} and 2 q4 + {8, 9}; heads past gb are 0.
  uint32_t qf[kDK][2];
  {
    const bool ok = gq < gb;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + b * st.q[0] + (h0 + (ok ? gq : 0)) * st.q[1]);
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      qf[kk][0] = ok ? qr[kk * 8 + q4] : 0u;
      qf[kk][1] = ok ? qr[kk * 8 + 4 + q4] : 0u;
    }
  }

  const int n = max(0, min(chunk, len - p0));
  const int n_slices = (n + kSlice - 1) / kSlice;
  const int mine =
      n_slices > warp ? (n_slices - 1 - warp) / kTcWarps + 1 : 0;

  const bf16* kb = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vb = v + b * st.v[0] + kvh * st.v[1];
  bf16* ring = rings + warp * kStages * 2 * Sh::kSliceElems;
  bf16* pw = p_all + warp * kH * kPStride;
  // K and V of the warp's j-th slice (positions 16 (warp + W j) ..) into
  // stage j % kStages.
  auto issue = [&](int j) {
    const int pos = (warp + kTcWarps * j) * kSlice;
    const int rows = j < mine ? min(kSlice, n - pos) : 0;
    bf16* stage = ring + (j % kStages) * 2 * Sh::kSliceElems;
    load_slice<D>(stage, kb, st.k[2], p0 + pos, rows, lane);
    load_slice<D>(stage + Sh::kSliceElems, vb, st.v[2], p0 + pos, rows,
                  lane);
  };
#pragma unroll
  for (int j = 0; j < kStages; ++j) issue(j);

  // Heads 2 q4 + i (i = 0, 1): running max (log2 units) and this lane's
  // share of the running sum; O^T [dims, heads] accumulators, lane holding
  // dims 16 t + gq (+ 8) of heads 2 q4 + {0, 1}.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float o[kDK][4];
#pragma unroll
  for (int t = 0; t < kDK; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.0f;

  for (int j = 0; j < mine; ++j) {
    bf16* ks = ring + (j % kStages) * 2 * Sh::kSliceElems;
    bf16* vs = ks + Sh::kSliceElems;
    const int rows = min(kSlice, n - (warp + kTcWarps * j) * kSlice);

    cp_async_wait<2 * kStages - 1>();  // K of slice j has landed
    __syncwarp();
    // S^T = K q^T: positions gq (+ 8) of heads 2 q4 + {0, 1}, in two
    // accumulators to halve the chain of dependent mmas
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ks + swz<D>(lane & 15, 2 * kk + (lane >> 4)));
      mma(s[kk & 1], a, qf[kk][0], qf[kk][1]);
    }
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[e] = gq + (e >> 1) * 8 < rows ? (s[0][e] + s[1][e]) * scale_log2
                                       : -INFINITY;
    }
    __syncwarp();  // the previous slice's P is read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(sc[i], sc[2 + i]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);  // finite: position 0 is valid
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      const float e0 = exp2f(sc[i] - m_new);
      const float e1 = exp2f(sc[2 + i] - m_new);
      l[i] = fmaf(l[i], alpha, e0 + e1);
#pragma unroll
      for (int t = 0; t < kDK; ++t) {
        o[t][i] *= alpha;
        o[t][2 + i] *= alpha;
      }
      bf16* prow = pw + (2 * q4 + i) * kPStride;
      prow[gq] = __float2bfloat16_rn(e0);
      prow[gq + 8] = __float2bfloat16_rn(e1);
    }
    __syncwarp();
    // P^T as the B operand (positions x heads): head gq, positions
    // 2 q4 + {0, 1} and 2 q4 + {8, 9}
    uint32_t pb[2];
    ldsm_x2(pb, pw + (lane & 7) * kPStride + ((lane >> 3) & 1) * 8);

    cp_async_wait<2 * kStages - 2>();  // V of slice j has landed
    __syncwarp();
    // O^T += V^T P^T
#pragma unroll
    for (int t = 0; t < kDK; ++t) {
      uint32_t a[4];
      ldsm_x4_trans(a, vs + swz<D>((lane & 7) + ((lane >> 4) << 3),
                                   2 * t + ((lane >> 3) & 1)));
      mma(o[t], a, pb[0], pb[1]);
    }
    __syncwarp();  // the stage is consumed
    issue(j + kStages);
  }
  cp_async_wait<0>();  // only empty groups can be left

  // The warps' (m, l, O) in the rings, then folded in warp order.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    }
  }
  __syncthreads();  // every warp is done with its ring
  float* w_o = reinterpret_cast<float*>(rings);  // [warps][kH][D]
  float* w_m = w_o + kTcWarps * kH * D;          // [warps][kH]
  float* w_l = w_m + kTcWarps * kH;
#pragma unroll
  for (int t = 0; t < kDK; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = 2 * q4 + (e & 1);
      w_o[(warp * kH + head) * D + t * 16 + gq + (e >> 1) * 8] = o[t][e];
    }
  }
  if (gq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w_m[warp * kH + 2 * q4 + i] = m[i];
      w_l[warp * kH + 2 * q4 + i] = l[i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < gb * D; idx += kTcThreads) {
    const int g = idx / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) mx = fmaxf(mx, w_m[w * kH + g]);
    float ls = 0.0f;
    float acc = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) {
        const float mw = w_m[w * kH + g];
        if (mw == -INFINITY) continue;  // a warp with no slice
        const float f = exp2f(mw - mx);
        ls = fmaf(w_l[w * kH + g], f, ls);
        acc = fmaf(w_o[(w * kH + g) * D + idx % D], f, acc);
      }
    }
    s_acc[idx] = acc;
    if (idx % D == 0) {
      s_m[g] = mx;
      s_l[g] = ls;
    }
  }
  finish<bf16, D, kH>(s_acc, s_m, s_l, s_cm, s_cl, gb,
                      out + (static_cast<int64_t>(b) * h + h0) * D);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kH = 4;       // query heads of a block (one warp each in the
                            // softmax)
constexpr int kTile = 32;   // positions of a ring stage (a lane each)
constexpr int kVec = 4;     // floats of a 16-byte vector

template <int D>
struct Shape {
  static constexpr int kTpr = D / kVec;       // lanes (16-byte segments) a row
  static constexpr int kRpw = 32 / kTpr;      // rows a warp reads at once
  static constexpr int kRpb = kRpw * kWarps;  // rows the block reads at once
  static constexpr int kStageElems = 2 * kTile * D;  // K tile, then V tile
  static constexpr int kFit = 96 * 1024 / (kStageElems * 4);
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kRingElems = kStages * kStageElems;
  // the ring, then acc [kH][D], p [kH][kTile], m, l, alpha [kH], the
  // chunks' m and l [kMaxCluster][kH]
  static constexpr int kSmem =
      (kRingElems + kH * D + kH * kTile + 3 * kH + 2 * kMaxCluster * kH) * 4;
  static_assert(kTpr >= 1 && kTpr <= 32, "D too small or too large");
  static_assert(kStages >= 3, "the ring needs three stages");
  // the end-of-walk fold over warps reuses the ring
  static_assert(kWarps * kH * D <= kRingElems, "ring");
};

__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

// `rows` cache rows from position p into a dense [kTile][D] tile, then one
// commit group (empty when rows = 0).
template <int D>
__device__ __forceinline__ void load_rows(float* tile, const float* g,
                                          int64_t stride, int p, int rows,
                                          int tid) {
  constexpr int kTpr = Shape<D>::kTpr;
  for (int i = tid; i < rows * kTpr; i += kThreads) {
    const int r = i / kTpr;
    const int c = i % kTpr;
    cp_async16(tile + r * D + c * kVec,
               g + static_cast<int64_t>(p + r) * stride + c * kVec);
  }
  cp_async_commit();
}

// Grid (chunks, kv heads * head groups of kH, B); the chunks of one (b, kv
// head, head group) form one cluster.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ out, Strides st, int s_len, int h, int group,
    int chunk, float scale_log2) {
  using Sh = Shape<D>;
  constexpr int kTpr = Sh::kTpr;
  constexpr int kRpw = Sh::kRpw;
  constexpr int kRpb = Sh::kRpb;
  constexpr int kStages = Sh::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* s_acc = ring + Sh::kRingElems;  // [kH][D]
  float* s_p = s_acc + kH * D;           // [kH][kTile]
  float* s_m = s_p + kH * kTile;         // [kH]
  float* s_l = s_m + kH;                 // [kH]
  float* s_alpha = s_l + kH;             // [kH]
  float* s_cm = s_alpha + kH;            // [kMaxCluster][kH]
  float* s_cl = s_cm + kMaxCluster * kH;

  const int n_hgroups = (group + kH - 1) / kH;
  const int kvh = blockIdx.y / n_hgroups;
  const int g0 = (blockIdx.y % n_hgroups) * kH;
  const int gb = min(kH, group - g0);  // query heads of this block
  const int h0 = kvh * group + g0;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * chunk;
  const int n = max(0, min(chunk, valid_length(lengths, b, s_len) - p0));
  const int n_tiles = (n + kTile - 1) / kTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int seg = lane % kTpr;  // which 16 bytes of the row
  const int sub = lane / kTpr;  // which row of the warp's step

  const float* kb = k + b * st.k[0] + kvh * st.k[1];
  const float* vb = v + b * st.v[0] + kvh * st.v[1];
  // The ring's first kStages tiles, K and V of each as separate groups.
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    const int rows = max(0, min(kTile, n - t * kTile));
    float* stage = ring + t * Sh::kStageElems;
    load_rows<D>(stage, kb, st.k[2], p0 + t * kTile, rows, tid);
    load_rows<D>(stage + kTile * D, vb, st.v[2], p0 + t * kTile, rows, tid);
  }

  float qr[kH][kVec];
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    if (g < gb && n > 0) {
      load16(q + b * st.q[0] + (h0 + g) * st.q[1] + seg * kVec, qr[g]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] *= scale_log2;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] = 0.0f;
    }
  }

  float acc[kH][kVec];
#pragma unroll
  for (int g = 0; g < kH; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.0f;
  }
  float m_run = -INFINITY;  // query head `warp`'s running max (log2 units)
  float l_run = 0.0f;       // and sum

  for (int t = 0; t < n_tiles; ++t) {
    float* stage = ring + (t % kStages) * Sh::kStageElems;
    const float* ks = stage;
    const float* vs = stage + kTile * D;
    const int rows = min(kTile, n - t * kTile);

    cp_async_wait<2 * kStages - 1>();  // K of tile t has landed
    __syncthreads();
    for (int base = warp * kRpw; base < rows; base += kRpb) {
      const int r = base + sub;
      float kf[kVec];
      if (r < rows) {
        load16(ks + r * D + seg * kVec, kf);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = 0.0f;
      }
      float dot[kH];
#pragma unroll
      for (int g = 0; g < kH; ++g) {
        dot[g] = 0.0f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot[g] = fmaf(qr[g][i], kf[i], dot[g]);
      }
#pragma unroll
      for (int off = kTpr / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < kH; ++g) {
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        }
      }
      if (seg == 0 && r < rows) {
#pragma unroll
        for (int g = 0; g < kH; ++g) {
          if (g < gb) s_p[g * kTile + r] = dot[g];
        }
      }
    }
    __syncthreads();

    // Online softmax: warp g takes query head g, a lane per position.
    if (warp < gb) {
      const float s = lane < rows ? s_p[warp * kTile + lane] : -INFINITY;
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      const float m_new = fmaxf(m_run, mt);  // finite: rows >= 1
      const float alpha = exp2f(m_run - m_new);
      const float p = lane < rows ? exp2f(s - m_new) : 0.0f;
      s_p[warp * kTile + lane] = p;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      }
      l_run = fmaf(l_run, alpha, ps);
      m_run = m_new;
      if (lane == 0) s_alpha[warp] = alpha;
    }
    cp_async_wait<2 * kStages - 2>();  // V of tile t has landed
    __syncthreads();

    // Unnormalised P.V over the tile.
#pragma unroll
    for (int g = 0; g < kH; ++g) {
      const float a = g < gb ? s_alpha[g] : 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] *= a;
    }
    for (int base = warp * kRpw; base < rows; base += kRpb) {
      const int r = base + sub;
      if (r < rows) {
        float vf[kVec];
        load16(vs + r * D + seg * kVec, vf);
#pragma unroll
        for (int g = 0; g < kH; ++g) {
          const float p = g < gb ? s_p[g * kTile + r] : 0.0f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
    __syncthreads();  // the stage and the probabilities are consumed
    const int nt = t + kStages;
    const int nrows = max(0, min(kTile, n - nt * kTile));
    load_rows<D>(stage, kb, st.k[2], p0 + nt * kTile, nrows, tid);
    load_rows<D>(stage + kTile * D, vb, st.v[2], p0 + nt * kTile, nrows,
                 tid);
  }
  cp_async_wait<0>();  // only empty groups can be left

  // Fold the warp's rows (lanes with the same segment), then the warps in
  // order, into s_acc; the ring holds the warps' sums.
#pragma unroll
  for (int off = kTpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kH; ++g) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
      }
    }
  }
  float* red = ring;  // [kWarps][kH][D]
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kH; ++g) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        red[(warp * kH + g) * D + seg * kVec + i] = acc[g][i];
      }
    }
  }
  if (warp < gb && lane == 0) {
    s_m[warp] = m_run;  // -inf and 0 for a chunk with no valid position
    s_l[warp] = l_run;
  }
  __syncthreads();
  for (int idx = tid; idx < gb * D; idx += kThreads) {
    const int g = idx / D;
    const int dd = idx % D;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * kH + g) * D + dd];
    s_acc[idx] = sum;
  }
  finish<float, D, kH>(s_acc, s_m, s_l, s_cm, s_cl, gb,
                       out + (static_cast<int64_t>(b) * h + h0) * D);
}

}  // namespace f32

// One launch of `kernel` by the plan `l`: grid (n_chunks, kv heads * head
// groups, b), clusters of n_chunks blocks along x.
template <typename T, typename Kernel>
int launch(Kernel kernel, const Launch& l, const void* q, const void* k,
           const void* v, const int* lengths, void* out, const Strides& st,
           int h, int kh, int s_len, int chunk, float scale,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = l.block;
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), st, s_len, h,
      h / kh, chunk, scale * kLog2e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Launch& l, const void* q, const void* k, const void* v,
             const int* lengths, void* out, const Strides& st, int h, int kh,
             int s_len, int chunk, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tc::decode_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tc::Shape<D>::kSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          f32::decode_attention_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, f32::Shape<D>::kSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (l.entry < 4) {
    return launch<__nv_bfloat16>(tc::decode_attention_kernel<D>, l, q, k, v,
                                 lengths, out, st, h, kh, s_len, chunk,
                                 scale, stream);
  }
  return launch<float>(f32::decode_attention_kernel<D>, l, q, k, v, lengths,
                       out, st, h, kh, s_len, chunk, scale, stream);
}

template <int D>
Launch plan_d(int b, int h, int kh, int n_chunks, int dtype, int slot) {
  const int group = h / kh;
  if (dtype == 1) {
    const int n_hgroups = (group + tc::kH - 1) / tc::kH;
    return {slot, dim3(n_chunks, kh * n_hgroups, b), dim3(tc::kTcThreads),
            tc::Shape<D>::kSmem, 1, n_chunks};
  }
  const int n_hgroups = (group + f32::kH - 1) / f32::kH;
  return {4 + slot, dim3(n_chunks, kh * n_hgroups, b), dim3(kThreads),
          f32::Shape<D>::kSmem, 1, n_chunks};
}

// Entries: tc::decode_attention_kernel<16, 32, 64, 128> (0-3), then f32::
// at the same head dims (4-7). One launch: a block per (chunk, kv head x
// head group, row), the n_chunks chunks of a (row, kv head, head group)
// one cluster, the kernel's whole shared memory opted in; no launch for no
// rows or heads, -1 where the launch refuses the arguments.
int make_plan(int b, int h, int kh, int s_len, int d, int chunk,
              int n_chunks, int dtype, Launch* out) {
  if (b <= 0 || h <= 0) return 0;
  const int slot = d == 16 ? 0 : d == 32 ? 1 : d == 64 ? 2 : d == 128 ? 3
                                                                       : -1;
  if (kh <= 0 || h % kh != 0 || chunk <= 0 || chunk % 32 != 0 ||
      n_chunks < 1 || n_chunks > kMaxCluster ||
      static_cast<int64_t>(chunk) * n_chunks < s_len || slot < 0 ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  switch (d) {
    case 16: out[0] = plan_d<16>(b, h, kh, n_chunks, dtype, slot); break;
    case 32: out[0] = plan_d<32>(b, h, kh, n_chunks, dtype, slot); break;
    case 64: out[0] = plan_d<64>(b, h, kh, n_chunks, dtype, slot); break;
    default: out[0] = plan_d<128>(b, h, kh, n_chunks, dtype, slot); break;
  }
  return 1;
}

// cp.async moves 16-byte rows: every base pointer 16-byte aligned and every
// batch, head and position stride a whole number of 16 bytes.
bool aligned(const void* q, const void* k, const void* v, const void* out,
             const Strides& st, int elem) {
  const void* ptrs[] = {q, k, v, out};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  const int per = 16 / elem;
  const int64_t strides[] = {st.q[0], st.q[1], st.k[0], st.k[1], st.k[2],
                             st.v[0], st.v[1], st.v[2]};
  for (int64_t s : strides) {
    if (s % per) return false;
  }
  return true;
}

}  // namespace

// q [b, h, d] and k, v [b, kh, s_len, d], addressed through `strides` (8
// element strides: batch and head of q; batch, kv head and position of k,
// then of v; the head dimension is contiguous and every row 16-byte
// aligned); lengths [b] int32 on the device; out [b, h, d] contiguous. d is
// 16, 32, 64 or 128; h % kh == 0; chunk is a multiple of 32 and n_chunks in
// [1, 8] with n_chunks * chunk >= s_len (one cluster of n_chunks blocks per
// (b, kv head, head group)). dtype 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the tensor-core kernel) for q, k, v and out. Launches one
// kernel on `stream` and returns a CUDA error code (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, const int64_t* strides, int b, int h, int kh, int s_len, int d,
    int chunk, int n_chunks, float scale, int dtype, void* stream) {
  Launch l[1];
  const int n = make_plan(b, h, kh, s_len, d, chunk, n_chunks, dtype, l);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  st.q[0] = strides[0];
  st.q[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    st.k[i] = strides[2 + i];
    st.v[i] = strides[5 + i];
  }
  if (!aligned(q, k, v, out, st, dtype == 0 ? 4 : 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  switch (d) {
    case 16: return launch_d<16>(l[0], q, k, v, len, out, st, h, kh, s_len, chunk, scale, s);
    case 32: return launch_d<32>(l[0], q, k, v, len, out, st, h, kh, s_len, chunk, scale, s);
    case 64: return launch_d<64>(l[0], q, k, v, len, out, st, h, kh, s_len, chunk, scale, s);
    default: return launch_d<128>(l[0], q, k, v, len, out, st, h, kh, s_len, chunk, scale, s);
  }
}

// The plan of decode_attention_launch at these arguments (see make_plan):
// writes each launch's kPlanFields ints to `plan` and returns their number
// (-1 where the launch refuses them).
extern "C" int decode_attention_plan(int b, int h, int kh, int s_len, int d,
                                     int chunk, int n_chunks, int dtype,
                                     int* plan) {
  Launch l[1];
  const int n = make_plan(b, h, kh, s_len, d, chunk, n_chunks, dtype, l);
  return n < 0 ? n : write_plan(l, n, plan);
}
