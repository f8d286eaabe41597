// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel, flash_attention_kernel):
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, g(h), j] / sqrt(D)) v[b, g(h), j]
//
// with g(h) = h / (H / K) (grouped-query attention), j <= i when causal, the
// softmax kept online in float32 (running max m, denominator l and output
// accumulator), and the output in q's type (float32 or bfloat16).
//
// Design. The TPU kernel carries (m, l, acc) in VMEM scratch across a
// sequential grid axis over the kv blocks. Blocks on the card run in no
// order, so here one thread block owns one 64-row q tile of one (batch,
// head) and walks the kv tiles (32 rows each) itself, with m, l and acc in
// registers. kv tiles entirely above the causal diagonal are never loaded.
// Any S works: rows and columns past S are masked, where the Pallas kernel
// asserts S % block == 0. The tensors are addressed through their strides
// (the head dimension must be contiguous), so the model's [B, S, H, D]
// activations go in as [B, H, S, D] views with no transpose copies, and
// the output can be written in the model's layout.
//
// Threads. 256 threads as a 16 x 16 grid (ty, tx). For the scores a thread
// owns rows ty + 16 i (i < 4) and columns tx + 16 j (j < 2) of the 64 x 32
// tile; for the output, rows ty + 16 i and head dims tx + 16 k. Row maxima
// and sums fold over the 16 lanes that share ty with a shuffle tree. Tiles
// sit in shared memory as float32 (the score tile padded by one word per row
// so that the column reads hit 16 different banks).
//
// Bound on this card. Causal attention costs 4 * B * H * S^2 * D / 2
// operations against (q, k, v, out) read or written once. At the served
// S = 128 and D = 64..128 the operations bound it for every model, and this
// simple kernel runs them on the float32 units (67 TFLOP/s), not on the
// tensor cores: wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

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

// Element strides (batch, head, position) of q, k, v and out; the head
// dimension has stride 1.
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides st, int s_len, int group, float scale,
    int causal) {
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

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int dd = idx % D;
    const int pos = q0 + r;
    qs[r * (D + 1) + dd] = pos < s_len ? to_f32(qb[pos * st.q[2] + dd]) : 0.0f;
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
      ks[r * (D + 1) + dd] = ok ? to_f32(kb[pos * st.k[2] + dd]) : 0.0f;
      vs[r * D + dd] = ok ? to_f32(vb[pos * st.v[2] + dd]) : 0.0f;
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

  T* ob = out + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s_len) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      ob[qpos * st.o[2] + tx + 16 * kk] = from_f32<T>(acc[i][kk] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const Strides& st, int b, int h, int s_len, int group,
           float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((s_len + kBQ - 1) / kBQ, h, b);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st, s_len, group,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const Strides& st, int b, int h, int s_len, int group, int d,
             float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, st, b, h, s_len, group, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, st, b, h, s_len, group, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, st, b, h, s_len, group, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, st, b, h, s_len, group, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out [b, h, s, d]; k, v [b, kh, s, d], addressed through `strides`
// (12 element strides: batch, head, position of q, k, v, out; the head
// dimension is contiguous). d is 16, 32, 64 or 128; h % kh == 0; dtype 0 =
// float32, 1 = bfloat16 for all four. Launches on `stream` and returns a
// CUDA error code (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const int64_t* strides, int b, int h, int kh, int s_len, int d,
    float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || s_len <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = h / kh;
  if (dtype == 0) {
    return dispatch<float>(q, k, v, out, st, b, h, s_len, group, d, scale, causal, s);
  }
  return dispatch<__nv_bfloat16>(q, k, v, out, st, b, h, s_len, group, d, scale, causal, s);
}
