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
// Design. The TPU kernel runs a grid (B, H, S / bs) whose last axis walks
// the cache in sequence, carrying (m, l, acc) in VMEM. On the card that
// would leave most SMs idle (B * K blocks: 8 for Qwen3-8B at B = 1), and
// would read each K/V row once per query head. Here the work is split
// (flash-decoding):
//
//   * pass 1: one block takes one (row b, kv head, chunk of positions) and
//     up to kMaxG query heads that share the kv head (all G of them in the
//     served models: G = 3 or 4), so each K/V element is read once. It
//     computes the chunk's scores into shared memory, their float32 softmax
//     statistics (max m, sum l), and the unnormalised P.V sum acc[D]; a
//     chunk at or past the row's length returns before any load. The
//     wrapper sizes the chunks (32..512 positions) so that B * K * chunks
//     fills the card;
//   * pass 2: one block per (b, h) folds the chunks' (m, l, acc) in chunk
//     order and writes acc / l.
//
// Every sum is taken in a fixed order (shuffle trees, then warps in order,
// then chunks in order) and there are no atomics, so a result repeats run
// to run. Any S: the ragged last chunk is masked (the Pallas kernel asserts
// S % block_s == 0).
//
// Threads. 128 (4 warps). A cache row of D elements is read as 16-byte
// vectors by TPR = D * sizeof(T) / 16 neighbouring lanes, so a warp reads
// 32 / TPR whole rows at once, each as one contiguous run of bytes. The
// q segment a lane needs stays in registers, pre-scaled by 1/sqrt(D).
//
// Layout. q is addressed through its (batch, head) strides and k, v through
// their (batch, kv head, position) strides; the head dimension is
// contiguous. So the model's [B, 1, H, D] activations and a layer of its
// [B, Smax, K, D] cache go in as [B, H, D] and [B, K, Smax, D] views, with
// no copies.
//
// Bound on this card: bytes. Each valid K/V element is read once and costs
// about 4 operations per query head (a product-add for the score and one for
// the value sum), far below the card's operations-per-byte line; the least
// time is (the valid K/V prefix + q + out) over the HBM rate. This simple
// kernel keeps one 16-byte load in flight per thread; deeper pipelining
// (cp.async or TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 4;        // query heads one block serves (one per warp
                                // in the softmax statistics)
constexpr int kMaxChunk = 512;  // cache positions one block walks

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes at p (16-byte aligned) as floats.
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Element strides: q (batch, head); k and v (batch, kv head, position).
struct Strides {
  int64_t q[2], k[3], v[3];
};

__device__ __forceinline__ int valid_length(const int* lengths, int b,
                                            int s_len) {
  return max(0, min(lengths[b], s_len));
}

// Pass 1. Grid (chunks, kv heads * head groups, B). Writes, for each query
// head h of the block, part_acc[b, h, c, :] (unnormalised) and
// part_ml[b, h, c, :] = (m, l).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float* __restrict__ part_ml, Strides st, int s_len, int h, int group,
    int chunk, int n_chunks, float scale) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kTpr = D / kVec;          // lanes per cache row
  constexpr int kRpw = 32 / kTpr;         // rows a warp reads at once
  constexpr int kRpb = kRpw * kWarps;     // rows the block reads at once
  static_assert(kTpr >= 1 && kTpr <= 32, "D too small or too large");

  __shared__ float sc[kMaxG][kMaxChunk];  // scores, then probabilities
  __shared__ float red[kWarps][kMaxG][D]; // per-warp P.V sums
  __shared__ float s_m[kMaxG], s_l[kMaxG];

  const int c = blockIdx.x;
  const int n_hgroups = (group + kMaxG - 1) / kMaxG;
  const int kvh = blockIdx.y / n_hgroups;
  const int g0 = (blockIdx.y % n_hgroups) * kMaxG;
  const int gb = min(kMaxG, group - g0);  // query heads of this block
  const int h0 = kvh * group + g0;
  const int b = blockIdx.z;

  const int p0 = c * chunk;
  const int n = min(chunk, valid_length(lengths, b, s_len) - p0);
  if (n <= 0) return;  // past the valid prefix: no loads, no partial

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seg = lane % kTpr;  // which 16 bytes of the row
  const int sub = lane / kTpr;  // which row of the warp's step

  float qr[kMaxG][kVec];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < gb) {
      load16(q + b * st.q[0] + (h0 + g) * st.q[1] + seg * kVec, qr[g]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] = 0.0f;
    }
  }

  // Scores of the chunk's valid rows.
  const T* kb = k + b * st.k[0] + kvh * st.k[1] + seg * kVec;
  for (int base = warp * kRpw; base < n; base += kRpb) {
    const int r = base + sub;
    float kf[kVec];
    if (r < n) {
      load16(kb + static_cast<int64_t>(p0 + r) * st.k[2], kf);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) kf[i] = 0.0f;
    }
    float dot[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      dot[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot[g] = fmaf(qr[g][i], kf[i], dot[g]);
    }
#pragma unroll
    for (int off = kTpr / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      }
    }
    if (seg == 0 && r < n) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < gb) sc[g][r] = dot[g];
      }
    }
  }
  __syncthreads();

  // Softmax statistics: warp w takes query head w.
  if (warp < gb) {
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, sc[warp][r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float l = 0.0f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(sc[warp][r] - m);
      sc[warp][r] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();

  // Unnormalised P.V over the chunk.
  float acc[kMaxG][kVec];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.0f;
  }
  const T* vb = v + b * st.v[0] + kvh * st.v[1] + seg * kVec;
  for (int base = warp * kRpw; base < n; base += kRpb) {
    const int r = base + sub;
    if (r < n) {
      float vf[kVec];
      load16(vb + static_cast<int64_t>(p0 + r) * st.v[2], vf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        const float p = g < gb ? sc[g][r] : 0.0f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
  }
  // Fold the warp's rows (lanes with the same segment), then the warps.
#pragma unroll
  for (int off = kTpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
      }
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) red[warp][g][seg * kVec + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gb * D; idx += kThreads) {
    const int g = idx / D;
    const int dd = idx % D;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][g][dd];
    const int64_t row = (static_cast<int64_t>(b) * h + h0 + g) * n_chunks + c;
    part_acc[row * D + dd] = sum;
    if (dd == 0) {
      part_ml[row * 2] = s_m[g];
      part_ml[row * 2 + 1] = s_l[g];
    }
  }
}

// Pass 2. Grid (H, B), D threads: out[b, h] = sum_c acc_c e^(m_c - M) /
// sum_c l_c e^(m_c - M) over the chunks that hold valid positions.
template <typename T>
__global__ void decode_attention_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, T* __restrict__ out, int h, int d,
    int s_len, int chunk, int n_chunks) {
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int used = (valid_length(lengths, b, s_len) + chunk - 1) / chunk;
  const int64_t row = (static_cast<int64_t>(b) * h + hh) * n_chunks;
  const float* ml = part_ml + row * 2;
  const float* acc = part_acc + row * d;
  float m = -INFINITY;
  for (int c = 0; c < used; ++c) m = fmaxf(m, ml[2 * c]);
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float l = 0.0f;
    float o = 0.0f;
    for (int c = 0; c < used; ++c) {
      const float w = expf(ml[2 * c] - m);
      l = fmaf(ml[2 * c + 1], w, l);
      o = fmaf(acc[c * d + dd], w, o);
    }
    // no valid position (length 0): 0, as the Pallas kernel's acc / l
    out[(static_cast<int64_t>(b) * h + hh) * d + dd] =
        from_f32<T>(used > 0 ? o / fmaxf(l, 1e-30f) : 0.0f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_acc, float* part_ml, const Strides& st,
           int b, int h, int kh, int s_len, int chunk, int n_chunks,
           float scale, cudaStream_t stream) {
  const int group = h / kh;
  const int n_hgroups = (group + kMaxG - 1) / kMaxG;
  dim3 grid1(n_chunks, kh * n_hgroups, b);
  decode_attention_partial_kernel<T, D><<<grid1, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, st, s_len, h,
      group, chunk, n_chunks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2(h, b);
  decode_attention_combine_kernel<T><<<grid2, D, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), h, D, s_len, chunk,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* part_acc, float* part_ml, const Strides& st,
             int b, int h, int kh, int s_len, int d, int chunk, int n_chunks,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, part_acc, part_ml, st, b, h, kh, s_len, chunk, n_chunks, scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, out, part_acc, part_ml, st, b, h, kh, s_len, chunk, n_chunks, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, part_acc, part_ml, st, b, h, kh, s_len, chunk, n_chunks, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, part_acc, part_ml, st, b, h, kh, s_len, chunk, n_chunks, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [b, h, d] and k, v [b, kh, s_len, d], addressed through `strides` (8
// element strides: batch and head of q; batch, kv head and position of k,
// then of v; the head dimension is contiguous and every row 16-byte
// aligned); lengths [b] int32 on the device; out [b, h, d] contiguous;
// part_acc [b, h, n_chunks, d] and part_ml [b, h, n_chunks, 2] float32
// scratch. d is 16, 32, 64 or 128; h % kh == 0; chunk is a multiple of 32,
// at most 512, and n_chunks * chunk >= s_len. dtype 0 = float32, 1 =
// bfloat16 for q, k, v and out. Launches both passes on `stream` and returns
// a CUDA error code (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_acc, void* part_ml, const int64_t* strides, int b,
    int h, int kh, int s_len, int d, int chunk, int n_chunks, float scale,
    int dtype, void* stream) {
  if (b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  if (kh <= 0 || h % kh != 0 || chunk <= 0 || chunk > kMaxChunk ||
      static_cast<int64_t>(chunk) * n_chunks < s_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  st.q[0] = strides[0];
  st.q[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    st.k[i] = strides[2 + i];
    st.v[i] = strides[5 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, len, out, pa, pm, st, b, h, kh, s_len, d, chunk, n_chunks, scale, s);
  }
  return dispatch<__nv_bfloat16>(q, k, v, len, out, pa, pm, st, b, h, kh, s_len, d, chunk, n_chunks, scale, s);
}
