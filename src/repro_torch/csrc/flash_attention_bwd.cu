// Causal GQA flash attention, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward kernel (nothing
// under src/repro/kernels/ defines a custom_vjp); its train_loss takes the
// gradient of the jnp attention (_sdpa, src/repro/models/attention.py)
// through XLA's autodiff. The port's forward is csrc/flash_attention.cu,
// whose output carries no autograd graph, so training needs this gradient
// as a kernel of its own. For q [B, H, S, D], k and v [B, K, S, D] (head h
// reads kv head h / (H / K)), the forward's output o and its gradient do,
// with s = scale * q.k^T (masked where causal), all in float32:
//
//   lse_i   = logsumexp_j s_ij          (recomputed here from q and k, so the
//                                         forward kernel stays as it is)
//   P       = exp(s - lse),  delta_i = sum_d do_id * o_id
//   dv      = P^T . do     (P rounded to the input type first, as the
//                           reference's _sdpa rounds it before P.V)
//   dP      = do . v^T,   dS = P * (dP - delta)
//   dq      = scale * dS . k,   dk = scale * dS^T . q
//
// Two launches a call. (1) dq_kernel: one block a 64-row query tile of one
// (batch, head). It folds delta from o and do, walks the key tiles once for
// each row's running max and sum (lse, written to a float32 scratch
// [B, H, S] with delta), then again for dP, dS and dq. (2) dkv_kernel: one
// block a 64-position key tile of one (batch, kv head); K and V stay in
// shared memory while it walks, for each of the G = H / K query heads of
// the group in turn, every query tile that sees the key tile, and adds that
// tile's P^T.do and dS^T.q into dv and dk in registers. The group's sum is
// taken inside the block, in head order, and each tile's products in
// position order, so there are no float atomics and the same inputs give
// the same gradient bitwise. Key tiles entirely above the causal diagonal
// are skipped; rows and columns past S are masked, so any S works.
//
// Layout: 256 threads as a 16 x 16 grid (ty, tx). For a 64 x 64 score tile
// a thread owns rows ty + 16 r and columns tx + 16 c (r, c < 4); for an
// accumulator [64, D] rows ty + 16 r and head dims tx + 16 e (e < D / 16).
// A row's max and sum fold over the 16 lanes that share ty with a shuffle
// tree. Tiles sit in shared memory as float32, padded by one word a row, so
// that the 16 column reads of a warp hit 16 different banks. Inputs are read
// through their batch, head and position strides (the head dimension must
// be contiguous), so the model's strided [B, H, S, D] views of [B, S, H, D]
// activations go in with no copies; dq, dk and dv are written contiguous.
// bfloat16 inputs are widened to float32 as they load, and the products
// accumulate in float32 on the CUDA cores.
//
// Bound on this card. The gradient costs about 2.5 times the forward's
// operations (5 products of 2 * S^2 * D / 2 a head when causal, against the
// forward's 2), against q, k, v, o, do read once and dq, dk, dv written
// once: at the trained S = 256 and at S = 2048 the operations bound it. This
// first version runs on the CUDA cores (no mma), loads one element at a
// time and recomputes the scores in both launches: right, deterministic and
// simple; the tensor cores and a fused single pass are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and key positions per tile
constexpr int kThreads = 256;  // 16 x 16

struct Strides {
  int64_t q[3], k[3], v[3], o[3], dout[3];  // batch, head, position
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  float* lse;    // [B, H, S]
  float* delta;  // [B, H, S]
  Strides st;
  int h, kh, s;
  float scale;
  int causal;
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
// The value as the input type holds it (P's rounding before the dv product).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Sum (or max) over the 16 lanes that share ty.
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a [64][D + 1]
// float32 tile; rows past S become 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int64_t row_stride, int row0,
                                          int s) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < s ? to_f32(base[static_cast<int64_t>(row) * row_stride + c])
                : 0.f;
  }
}

// s[r][c] = scale * A[ty + 16 r] . B[tx + 16 c], masked to -inf past S and
// above the diagonal (causal), with query rows offset q0 and keys k0.
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* a,
                                       const float* b, int q0, int k0,
                                       int s_len, float scale, int causal) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] += av[r] * bv[c];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kj = k0 + tx + 16 * c;
      const bool masked = qi >= s_len || kj >= s_len || (causal && kj > qi);
      s[r][c] = masked ? -INFINITY : s[r][c] * scale;
    }
  }
}

// The key tiles a query tile at q0 sees.
__device__ __forceinline__ int key_tiles(int q0, int s_len, int causal) {
  const int all = (s_len + kTile - 1) / kTile;
  if (!causal) return all;
  const int last = (q0 + kTile - 1) / kTile + 1;
  return last < all ? last : all;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Args<T> p) {
  extern __shared__ float sh[];
  float* qs = sh;                         // [64][D + 1]
  float* dos = qs + kTile * (D + 1);      // [64][D + 1]
  float* ks = dos + kTile * (D + 1);      // [64][D + 1]
  float* vs = ks + kTile * (D + 1);       // [64][D + 1]
  float* dss = vs + kTile * (D + 1);      // [64][65]
  float* lse_s = dss + kTile * (kTile + 1);  // [64]
  float* delta_s = lse_s + kTile;            // [64]

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bh = blockIdx.y;
  const int b = bh / p.h, h = bh % p.h, g = h / (p.h / p.kh);
  const int q0 = blockIdx.x * kTile;
  const Strides& st = p.st;
  const T* qb = p.q + b * st.q[0] + h * st.q[1];
  const T* ob = p.o + b * st.o[0] + h * st.o[1];
  const T* dob = p.dout + b * st.dout[0] + h * st.dout[1];
  const T* kb = p.k + b * st.k[0] + g * st.k[1];
  const T* vb = p.v + b * st.v[0] + g * st.v[1];
  load_tile<T, D>(qs, qb, st.q[2], q0, p.s);
  load_tile<T, D>(dos, dob, st.dout[2], q0, p.s);

  // delta_i = sum_d do_id * o_id
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    float part = 0.f;
    if (row < p.s) {
      for (int e = tx; e < D; e += 16) {
        part += to_f32(dob[row * st.dout[2] + e]) *
                to_f32(ob[row * st.o[2] + e]);
      }
    }
    part = row_sum(part);
    if (tx == 0) delta_s[ty + 16 * r] = part;
  }

  // pass 1: each row's running max and sum -> lse
  const int n_kt = key_tiles(q0, p.s, p.causal);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { m[r] = -INFINITY; l[r] = 0.f; }
  float s[4][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(ks, kb, st.k[2], kt * kTile, p.s);
    __syncthreads();
    scores<D>(s, qs, ks, q0, kt * kTile, p.s, p.scale, p.causal);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tile_max = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
      tile_max = row_max(tile_max);
      const float m_new = fmaxf(m[r], tile_max);
      if (m_new == -INFINITY) continue;  // nothing seen yet in this row
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += expf(s[r][c] - m_new);
      l[r] = (m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - m_new)) + sum;
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float lsum = row_sum(l[r]);
    const int i = ty + 16 * r;
    const int row = q0 + i;
    if (tx == 0) {
      const float lse = m[r] == -INFINITY ? 0.f : m[r] + logf(lsum);
      lse_s[i] = lse;
      if (row < p.s) {
        const int64_t at = static_cast<int64_t>(bh) * p.s + row;
        p.lse[at] = lse;
        p.delta[at] = delta_s[i];
      }
    }
  }

  // pass 2: dP, dS and dq = scale * dS . K
  constexpr int E = D / 16;
  float acc[4][E];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(ks, kb, st.k[2], kt * kTile, p.s);
    load_tile<T, D>(vs, vb, st.v[2], kt * kTile, p.s);
    __syncthreads();
    scores<D>(s, qs, ks, q0, kt * kTile, p.s, p.scale, p.causal);
    float dp[4][4];
    scores<D>(dp, dos, vs, 0, 0, 1 << 30, 1.0f, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float lse = lse_s[i], delta = delta_s[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = s[r][c] == -INFINITY ? 0.f : expf(s[r][c] - lse);
        dss[i * (kTile + 1) + tx + 16 * c] = pr * (dp[r][c] - delta);
      }
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dss[(ty + 16 * r) * (kTile + 1) + j];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float kv = ks[j * (D + 1) + tx + 16 * e];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][e] += dsv[r] * kv;
      }
    }
  }
  T* dqb = p.dq + static_cast<int64_t>(bh) * p.s * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= p.s) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dqb[static_cast<int64_t>(row) * D + tx + 16 * e] =
          from_f32<T>(acc[r][e] * p.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(Args<T> p) {
  extern __shared__ float sh[];
  float* ks = sh;                         // [64][D + 1]
  float* vs = ks + kTile * (D + 1);       // [64][D + 1]
  float* qs = vs + kTile * (D + 1);       // [64][D + 1]
  float* dos = qs + kTile * (D + 1);      // [64][D + 1]
  float* ps = dos + kTile * (D + 1);      // [64][65], P rounded
  float* dss = ps + kTile * (kTile + 1);  // [64][65]
  float* lse_s = dss + kTile * (kTile + 1);  // [64]
  float* delta_s = lse_s + kTile;            // [64]

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bg = blockIdx.y;
  const int b = bg / p.kh, g = bg % p.kh;
  const int group = p.h / p.kh;
  const int k0 = blockIdx.x * kTile;
  const Strides& st = p.st;
  load_tile<T, D>(ks, p.k + b * st.k[0] + g * st.k[1], st.k[2], k0, p.s);
  load_tile<T, D>(vs, p.v + b * st.v[0] + g * st.v[1], st.v[2], k0, p.s);

  constexpr int E = D / 16;
  float dk[4][E], dv[4][E];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) { dk[r][e] = 0.f; dv[r][e] = 0.f; }
  const int n_qt = (p.s + kTile - 1) / kTile;
  const int first_qt = p.causal ? k0 / kTile : 0;
  float s[4][4], dp[4][4];
  for (int hg = 0; hg < group; ++hg) {
    const int h = g * group + hg;
    const int bh = b * p.h + h;
    const T* qb = p.q + b * st.q[0] + h * st.q[1];
    const T* dob = p.dout + b * st.dout[0] + h * st.dout[1];
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<T, D>(qs, qb, st.q[2], q0, p.s);
      load_tile<T, D>(dos, dob, st.dout[2], q0, p.s);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const int64_t at = static_cast<int64_t>(bh) * p.s + row;
        lse_s[threadIdx.x] = row < p.s ? p.lse[at] : 0.f;
        delta_s[threadIdx.x] = row < p.s ? p.delta[at] : 0.f;
      }
      __syncthreads();
      scores<D>(s, qs, ks, q0, k0, p.s, p.scale, p.causal);
      scores<D>(dp, dos, vs, 0, 0, 1 << 30, 1.0f, 0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float lse = lse_s[i], delta = delta_s[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pr = s[r][c] == -INFINITY ? 0.f : expf(s[r][c] - lse);
          ps[i * (kTile + 1) + tx + 16 * c] = round_to<T>(pr);
          dss[i * (kTile + 1) + tx + 16 * c] = pr * (dp[r][c] - delta);
        }
      }
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = ps[i * (kTile + 1) + ty + 16 * r];
          dsv[r] = dss[i * (kTile + 1) + ty + 16 * r];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dov = dos[i * (D + 1) + tx + 16 * e];
          const float qv = qs[i * (D + 1) + tx + 16 * e];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv[r][e] += pv[r] * dov;
            dk[r][e] += dsv[r] * qv;
          }
        }
      }
    }
  }
  const int64_t base = static_cast<int64_t>(bg) * p.s * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row >= p.s) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t at = base + static_cast<int64_t>(row) * D + tx + 16 * e;
      p.dk[at] = from_f32<T>(dk[r][e] * p.scale);
      p.dv[at] = from_f32<T>(dv[r][e]);
    }
  }
}

template <typename T, int D>
int launch_typed(const Args<T>& args, int b, cudaStream_t stream) {
  const int tiles = (args.s + kTile - 1) / kTile;
  const size_t dq_smem =
      (4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile) * sizeof(float);
  const size_t dkv_smem =
      (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkv_smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D><<<dim3(tiles, b * args.h), kThreads, dq_smem, stream>>>(
      args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<T, D><<<dim3(tiles, b * args.kh), kThreads, dkv_smem,
                      stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv, void* lse,
                 void* delta, const Strides& st, int b, int h, int kh,
                 int s_len, int d, float scale, int causal,
                 cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<const T*>(o);
  a.dout = static_cast<const T*>(dout);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.st = st;
  a.h = h;
  a.kh = kh;
  a.s = s_len;
  a.scale = scale;
  a.causal = causal;
  switch (d) {
    case 16: return launch_typed<T, 16>(a, b, stream);
    case 32: return launch_typed<T, 32>(a, b, stream);
    case 64: return launch_typed<T, 64>(a, b, stream);
    case 128: return launch_typed<T, 128>(a, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, do [B, H, S, D] and k, v [B, K, S, D] of the dtype (0 float32,
// 1 bfloat16), read through `strides`: 15 int64 element strides, (batch,
// head, position) of q, k, v, o and do in that order (the head dimension
// contiguous). dq [B, H, S, D] and dk, dv [B, K, S, D] contiguous of the
// dtype; lse and delta float32 scratch [B, H, S]. Two launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    const int64_t* strides, int b, int h, int kh, int s_len, int d,
    float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh || s_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.dout[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dtype<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, st,
                               b, h, kh, s_len, d, scale, causal, s);
  }
  if (dtype == 1) {
    return launch_dtype<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse,
                                       delta, st, b, h, kh, s_len, d, scale,
                                       causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
