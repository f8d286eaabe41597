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
// Two launches a call, bfloat16 and float32 alike. (1) dq: one block a
// 64-row query tile of one (batch, head). It folds delta from o and do,
// then walks the key tiles for each row's logsumexp (written, with delta,
// to a float32 scratch [B, H, S rounded up to 64]) and for dP, dS and dq:
// in bfloat16 in one walk (below), in float32 in two. (2) dkv: one block a
// 64-position key tile of one (batch, kv head); it walks, for each of the
// G = H / K query heads of the group in turn, every query tile that sees
// the key tile, and adds that tile's P^T.do and dS^T.q into dv and dk.
// The group's sum is taken inside the block in a fixed order (below), and
// each tile's products in position order, so there are no float atomics
// and the same inputs give the same gradient bitwise. Tiles entirely above
// the causal diagonal are never loaded; rows and columns past S are
// masked, so any S works. Inputs are read
// through their batch, head and position strides (the head dimension
// contiguous), so the model's [B, H, S, D] views of [B, S, H, D]
// activations go in with no copies; dq, dk and dv are written contiguous.
//
// bfloat16, tensor cores (FlashAttention-2's deterministic backward, with
// the forward's building blocks, copied from csrc/flash_attention.cu so
// that the forward's source stays as it is). dq has 4 warps, warp w owning
// query rows 16w..16w+15 of the tile; dkv has two warpgroups of 4, warp w
// of each owning key rows 16w..16w+15, and warpgroup g takes steps g,
// g + 2, ... of the walk (a step: one query tile of one head), so a key
// tile's walk runs on 8 warps; at the end warpgroup 1's dk and dv are
// added to warpgroup 0's through shared memory, in that order. Tiles pass
// through double-buffered rings in shared memory filled by 16-byte
// cp.async copies (rows past S zero-filled through the src-size operand):
// the next tile loads while this one is computed. Rows of D bf16 sit in
// 16-byte chunks whose index is XOR-swizzled with the row, so the 8 row
// addresses of every ldmatrix and ldmatrix.trans fall in 8 different bank
// groups. Every product is mma.sync.m16n8k16 (bf16 inputs, float32
// accumulators); the A operand of the warp's own rows (Q, dO in dq; K, V in
// dkv) is read with ldmatrix at each k-step, the B operand with ldmatrix
// (S = Q.K^T, dP = dO.V^T) or ldmatrix.trans (dQ += dS.K, dV += P^T.dO,
// dK += dS^T.Q). P and dS are made on the accumulators in registers and,
// since the C layout of two m16n8 tiles is the A layout of one m16n8k16,
// go into the next product rounded to bf16 without touching shared memory
// (dS is scaled before it is rounded, as the reference's transpose of
// `scores * scale` casts the scaled gradient to bf16). dq's one walk keeps
// each row's running max m and sum l of 2^(s log2 e - m), as the forward
// does, and rounds dS' = 2^(s log2 e - m) * (dP - delta) * scale, which is
// dS times the row's l * 2^(m_final - m): its accumulators are rescaled
// when m grows and divided by l at the end, where lse = m + log2 l is
// written. So dq's rounded operand has dS's relative precision but not
// its bits; dkv rounds dS itself, as the reference does. dkv takes a query
// tile in chunks of 16 at D = 128 (64 below; dq always 64), so that a
// chunk's S^T, P^T and dP^T and the two D-wide outputs dk and dv fit the
// register file. Only the diagonal tile and a ragged last tile are masked;
// a warp skips a chunk that lies wholly above the diagonal for its 16
// rows. dq's tiles are issued longest causal walk first (blockIdx.z
// reversed), dkv's in order (the first key tiles see the most query
// tiles). Outputs are staged through the warp's own rows of Q (dq) or of K
// and V (dk, dv) in shared memory and written as 16-byte rows.
// Recomputing lse costs no product (the rescaling above, and the forward
// kernel stays untouched); the two launches run 7 products (dq: S, dP, dQ;
// dkv: S, dP, dV, dK) against the gradient's 5, as each makes S and dP for
// itself. Walking dq's key tiles twice instead (lse first, then S again)
// took 8% longer at Qwen3-8B's B = 8, S = 256 (chip_smoke.py's
// train_kernels, NVIDIA H100 80GB HBM3, 700 W). cp.async needs
// 16-byte aligned rows: the wrapper raises unless every base pointer is
// 16-byte aligned and every batch, head and position stride is a multiple
// of 8 elements (the launcher refuses such a launch too).
//
// float32, CUDA cores (the first version's kernels, kept: TF32 would not
// hold float32's 2e-3 tolerance). Their source is the first version's as
// it was, templated on the input type and instantiated at float32 only,
// with the scratch read as [B, H, S]. 256 threads as a 16 x 16 grid
// (ty, tx); for a 64 x 64 score tile a thread owns rows ty + 16 r and
// columns tx + 16 c; for an accumulator [64, D] rows ty + 16 r and head
// dims tx + 16 e. Tiles sit in shared memory as float32, padded by one
// word a row.
//
// Bound on this card. The gradient costs 5 products of 2 * S^2 * D / 2 a
// head when causal (the scores again, dP, dV, dQ, dK) against q, k, v, o,
// do read once and dq, dk, dv written once. In bfloat16 at the trained
// S = 256 the bytes bound it (0.025 ms at Qwen3-8B's B = 8, 3.35 TB/s); at
// S = 2048 the operations do (0.087 ms at 989 TFLOP/s). This kernel runs 7
// products on mma.sync, with the exponentials and the masks between them
// on the same warps, and reads each A operand again at every chunk, so
// shared memory's bandwidth and the exponentials hold it well under the
// tensor cores' rate (PERF.md). What still separates it from the bound:
// wgmma issued asynchronously from shared memory, fed by TMA with a
// warp-specialised producer and the exponentials of one warpgroup
// overlapping the products of another (FlashAttention-3); and dkv's causal
// imbalance (key tile 0 walks every query tile, the last one walks one),
// which a split of the longest walks across blocks would even out at the
// price of a third, fixed-order launch.
//
// Budget (ptxas -v, sm_90a, CUDA 12.8, on the card), registers at D = 16,
// 32, 64, 128, no spills: tc::dq 96, 134, 166, 254; tc::dkv 128, 166, 223,
// 246 (the float32 kernels: f32::dq 80, 111, 80, 123, with 8 bytes
// spilled at D = 64 as in the first version; f32::dkv 64, 80, 128, 128).
// Shared memory 6 * 64 * D * 2 + 256 bytes for dq (96 KB at D = 128) and
// 10 * 64 * D * 2 + 2048 for dkv (162 KB): two dq blocks (8 warps) or one
// dkv block (8 warps) an SM at D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  int64_t q[3], k[3], v[3], o[3], dout[3];  // batch, head, position
};

// One launch of a plan: the kernel entry (an index into ENTRIES in
// kernels/flash_attention_bwd/ops.py), grid, block, dynamic shared memory bytes,
// whether the launch path raises the 48 KB cap on it, and the blocks of a
// cluster along x. The launch path takes its geometry from the plan, and
// flash_attention_bwd_plan writes each launch as kPlanFields ints for the launch audit
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

// The tiles of S positions, and the scratch's row length (lse and delta
// [B, H, s_pad]).
constexpr int kTile = 64;

__host__ __device__ __forceinline__ int n_tiles(int s_len) {
  return (s_len + kTile - 1) / kTile;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;    // [B, H, s_pad], log2 units: log2 sum_j 2^(s_ij log2 e)
  float* delta;  // [B, H, s_pad]
  Strides st;
  int h, kh, s, s_pad;
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // scale * log2(e)
  int causal;
};

// Columns of a tile taken at once by the inner loops: the whole tile,
// but dkv holds two D-wide accumulators (dk, dv), so it takes 16 at
// D = 128, where wider chunks spill.
template <int D, bool kDkv>
__host__ __device__ constexpr int chunk() {
  return kDkv && D >= 128 ? 16 : kTile;
}

constexpr int kDkvThreads = 2 * kThreads;  // dkv: two warpgroups

// dq: Q, dO and the K and V rings, then delta; dkv: K, V and each
// warpgroup's Q and dO rings, then each warpgroup's lse and delta rings.
template <int D>
constexpr int smem_bytes(bool dkv) {
  return (dkv ? 10 : 6) * kTile * D * static_cast<int>(sizeof(bf16)) +
         (dkv ? 8 : 1) * kTile * static_cast<int>(sizeof(float));
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

// Rows r0..r0+kTile-1 of a [S, D] matrix (position stride `stride`) into a
// swizzled tile; rows at or past s_len are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g,
                                          int64_t stride, int r0, int s_len,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = r0 + r < s_len;
    const bf16* src = ok ? g + (r0 + r) * stride + c * 8 : g;
    cp_async16(tile + swz<D>(r, c), src, ok);
  }
}

// acc[N / 8][4] = A[16 rows of the warp, from `a` at row a0] .
// B[N rows of `b` from row b0]^T over the D columns: the A operand by
// ldmatrix, the B operand by ldmatrix (non-transposed: B's rows are the
// product's columns).
template <int D, int N>
__device__ __forceinline__ void product_abt(float (&acc)[N / 8][4],
                                            const bf16* a, int a0,
                                            const bf16* b, int b0, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + swz<D>(a0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int n2 = 0; n2 < N / 16; ++n2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + swz<D>(b0 + n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                             2 * kk + ((lane >> 3) & 1)));
      mma(acc[2 * n2], af, bf[0], bf[1]);
      mma(acc[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// out[D / 8][4] += A[16 x N] (bf16 fragments in registers, N / 16 k-steps) .
// B[N rows of `b` from row b0, D columns], B through ldmatrix.trans.
template <int D, int N>
__device__ __forceinline__ void product_ab(float (&out)[D / 8][4],
                                           const uint32_t (&a)[N / 16][4],
                                           const bf16* b, int b0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + swz<D>(b0 + j * 16 + (lane & 15),
                                   2 * n2 + (lane >> 4)));
      mma(out[2 * n2], a[j], bf[0], bf[1]);
      mma(out[2 * n2 + 1], a[j], bf[2], bf[3]);
    }
  }
}

// The warp's 16 rows of `acc` (C layout) as bf16, staged in its own
// rows r0.. of the swizzled tile `stage`, then written as 16-byte rows to
// rows pos0.. of a contiguous [S, D] slice `dst` (rows past s_len left).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* stage, int r0,
                                           bf16* dst, int pos0, int s_len,
                                           int lane) {
  const int g = lane / 4;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(stage + swz<D>(r0 + g + 8 * i, n) +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * (D / 8) / 32; ++it) {
    const int idx = lane + it * 32;
    const int r = idx / (D / 8);
    const int c = idx % (D / 8);
    const int pos = pos0 + r;
    if (pos < s_len) {
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(pos) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(r0 + r, c));
    }
  }
}

// (1) dq, with each row's lse and delta into the scratch.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kTile][D], later dq
  bf16* dos = qs + kTile * D;                  // [kTile][D]
  bf16* ks = dos + kTile * D;                  // [2][kTile][D]
  bf16* vs = ks + 2 * kTile * D;               // [2][kTile][D]
  float* delta_s = reinterpret_cast<float*>(vs + 2 * kTile * D);  // [kTile]
  constexpr int kC = chunk<D, false>();

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal walk first
  const int q0 = qt * kTile;
  const int kvh = h / (p.h / p.kh);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Strides& st = p.st;
  const bf16* qb = p.q + b * st.q[0] + h * st.q[1];
  const bf16* ob = p.o + b * st.o[0] + h * st.o[1];
  const bf16* dob = p.dout + b * st.dout[0] + h * st.dout[1];
  const bf16* kb = p.k + b * st.k[0] + kvh * st.k[1];
  const bf16* vb = p.v + b * st.v[0] + kvh * st.v[1];
  const int64_t bh = static_cast<int64_t>(b) * p.h + h;

  // causal: key tiles 0..qt; else all
  const int n_kt = p.causal ? qt + 1 : n_tiles(p.s);

  load_tile<D>(qs, qb, st.q[2], q0, p.s, tid);
  load_tile<D>(dos, dob, st.dout[2], q0, p.s, tid);
  load_tile<D>(ks, kb, st.k[2], 0, p.s, tid);
  load_tile<D>(vs, vb, st.v[2], 0, p.s, tid);
  cp_async_commit();

  // delta_i = sum_d do_id * o_id: two threads a row, 16 bytes at a time
  {
    const int r = tid / 2;
    const int pos = q0 + r;
    float acc = 0.f;
    if (pos < p.s) {
      const bf16* dr = dob + pos * st.dout[2];
      const bf16* orow = ob + pos * st.o[2];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int c = (tid & 1) * (D / 16) + j;
        const uint4 dv = *reinterpret_cast<const uint4*>(dr + c * 8);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 df = __bfloat1622float2(d2[e]);
          const float2 of = __bfloat1622float2(o2[e]);
          acc = fmaf(df.x, of.x, acc);
          acc = fmaf(df.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      p.delta[bh * p.s_pad + pos] = acc;
    }
  }

  const int g = lane / 4;
  const int t = lane & 3;
  const int wr = warp * 16;         // the warp's first row in the tile
  const int row0 = q0 + wr + g;     // the lane's rows: row0, row0 + 8
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the sum
  float dl[2] = {0.f, 0.f};
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<D>(ks + (buf ^ 1) * kTile * D, kb, st.k[2], (kt + 1) * kTile,
                   p.s, tid);
      load_tile<D>(vs + (buf ^ 1) * kTile * D, vb, st.v[2], (kt + 1) * kTile,
                   p.s, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      dl[0] = delta_s[wr + g];
      dl[1] = delta_s[wr + g + 8];
    }
    const bf16* kt_s = ks + buf * kTile * D;
    const bf16* vt_s = vs + buf * kTile * D;
    const int k0 = kt * kTile;
    const bool masked = (p.causal && k0 + kTile - 1 > q0) || k0 + kTile > p.s;

#pragma unroll
    for (int c = 0; c < kTile / kC; ++c) {
      // a chunk wholly above the diagonal for the warp's rows adds nothing
      if (p.causal && k0 + c * kC > q0 + wr + 15) continue;
      float s[kC / 8][4];
      product_abt<D, kC>(s, qs, wr, kt_s, c * kC, lane);
      if (masked) {
#pragma unroll
        for (int n = 0; n < kC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + c * kC + n * 8 + 2 * t + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (col >= p.s || (p.causal && col > row)) s[n][e] = -INFINITY;
          }
        }
      }
      // the running max; dq so far and the sum rescaled to it
      float mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kC / 8; ++n) {
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx * p.scale_log2);
        // every row sees key 0 in its first chunk, so m_new is finite
        // from then on; the guard keeps a fully masked chunk at 0
        mu[i] = m_new == -INFINITY ? 0.f : m_new;
        const float r = exp2f(m[i] - mu[i]);
        l[i] *= r;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          dq[n][2 * i] *= r;
          dq[n][2 * i + 1] *= r;
        }
        m[i] = m_new;
      }
      float dp[kC / 8][4];
      product_abt<D, kC>(dp, dos, wr, vt_s, c * kC, lane);
      // dS' = 2^(s' - m) * (dP - delta), scaled: dS times the row's
      // l * 2^(m_final - m), as the A operand of dS' . K
      uint32_t dsa[kC / 16][4];
#pragma unroll
      for (int n = 0; n < kC / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = exp2f(fmaf(s[n][2 * i], p.scale_log2, -mu[i]));
          const float p1 = exp2f(fmaf(s[n][2 * i + 1], p.scale_log2, -mu[i]));
          l[i] += p0 + p1;
          dsa[n / 2][(n & 1) * 2 + i] =
              pack_bf16(p0 * (dp[n][2 * i] - dl[i]) * p.scale,
                        p1 * (dp[n][2 * i + 1] - dl[i]) * p.scale);
        }
      }
      product_ab<D, kC>(dq, dsa, kt_s, c * kC, lane);
    }
    __syncthreads();  // this step's buffers are free for step + 2
  }

  // each row's sum over its 4 lanes: lse (log2 units) into the scratch,
  // and dq divided by the sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (t == 0) p.lse[bh * p.s_pad + row0 + 8 * i] = m[i] + log2f(sum);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      dq[n][2 * i] *= inv;
      dq[n][2 * i + 1] *= inv;
    }
  }
  store_rows<D>(dq, qs, wr, p.dq + bh * p.s * D, q0 + wr, p.s, lane);
}

// (2) dk and dv of one key tile, the group's query heads summed in order.
// Two warpgroups: warpgroup w takes steps w, w + 2, w + 4, ... of the walk
// (a step: one query tile of one head), each with its own ring and its own
// dk and dv for the tile's 64 keys (warp w % 4 owns keys 16 (w % 4)..);
// warpgroup 1's sums are then added to warpgroup 0's, in that order.
template <int D>
__global__ void __launch_bounds__(kDkvThreads) dkv_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [kTile][D], later dk
  bf16* vs = ks + kTile * D;                   // [kTile][D], later dv
  bf16* rings = vs + kTile * D;                // per warpgroup: q, do
  float* stats = reinterpret_cast<float*>(rings + 2 * 4 * kTile * D);
  constexpr int kC = chunk<D, true>();

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;  // the first key tiles walk the most
  const int k0 = kt * kTile;
  const int group = p.h / p.kh;
  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int wtid = tid % kThreads;  // the thread within its warpgroup
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const Strides& st = p.st;
  bf16* qs = rings + wg * 4 * kTile * D;       // [2][kTile][D]
  bf16* dos = qs + 2 * kTile * D;              // [2][kTile][D]
  float* lse_s = stats + wg * 4 * kTile;       // [2][kTile]
  float* dl_s = lse_s + 2 * kTile;             // [2][kTile]

  const int first_qt = p.causal ? kt : 0;
  const int n_qt = n_tiles(p.s) - first_qt;
  const int n_steps = group * n_qt;
  const int n_turns = (n_steps + 1) / 2;  // a step of each warpgroup a turn

  // step i: head kvh * group + i / n_qt, query tile first_qt + i % n_qt,
  // into this warpgroup's buffer `buf`
  auto load_step = [&](int i, int buf) {
    if (i >= n_steps) return;
    const int h = kvh * group + i / n_qt;
    const int q0 = (first_qt + i % n_qt) * kTile;
    load_tile<D>(qs + buf * kTile * D, p.q + b * st.q[0] + h * st.q[1],
                 st.q[2], q0, p.s, wtid);
    load_tile<D>(dos + buf * kTile * D,
                 p.dout + b * st.dout[0] + h * st.dout[1], st.dout[2], q0,
                 p.s, wtid);
    if (wtid < 2 * kTile / 4) {  // 16 chunks of lse, then 16 of delta
      const int64_t at = (static_cast<int64_t>(b) * p.h + h) * p.s_pad + q0;
      const int c = wtid % (kTile / 4);
      float* dst = (wtid < kTile / 4 ? lse_s : dl_s) + buf * kTile + 4 * c;
      const float* src = (wtid < kTile / 4 ? p.lse : p.delta) + at + 4 * c;
      cp_async16(dst, src, true);
    }
  };

  if (wg == 0) {
    load_tile<D>(ks, p.k + b * st.k[0] + kvh * st.k[1], st.k[2], k0, p.s,
                 wtid);
  } else {
    load_tile<D>(vs, p.v + b * st.v[0] + kvh * st.v[1], st.v[2], k0, p.s,
                 wtid);
  }
  load_step(wg, 0);
  cp_async_commit();

  const int g = lane / 4;
  const int t = lane & 3;
  const int wr = warp * 16;       // the warp's first key row in the tile
  const int key0 = k0 + wr + g;   // the lane's keys: key0, key0 + 8
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int turn = 0; turn < n_turns; ++turn) {
    const int buf = turn & 1;
    const int step = 2 * turn + wg;
    if (turn + 1 < n_turns) {
      load_step(step + 2, buf ^ 1);
      cp_async_commit();  // every thread commits a group, empty or not
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (step < n_steps) {
      const int q0 = (first_qt + step % n_qt) * kTile;
      const bf16* qt_s = qs + buf * kTile * D;
      const bf16* dot_s = dos + buf * kTile * D;
      const float* lse_t = lse_s + buf * kTile;
      const float* dl_t = dl_s + buf * kTile;
      const bool masked = (p.causal && q0 == k0) || q0 + kTile > p.s;

#pragma unroll
      for (int c = 0; c < kTile / kC; ++c) {
        // a chunk of queries all before the warp's keys adds nothing
        if (p.causal && q0 + c * kC + kC - 1 < k0 + wr) continue;
        // S^T = K . Q^T: the warp's 16 keys x kC queries
        float s[kC / 8][4];
        product_abt<D, kC>(s, ks, wr, qt_s, c * kC, lane);
        uint32_t pa[kC / 16][4];
        float pr[kC / 8][4];
#pragma unroll
        for (int n = 0; n < kC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c * kC + n * 8 + 2 * t + (e & 1);  // in the tile
            const int key = key0 + (e >> 1) * 8;
            const bool out = masked && (q0 + qi >= p.s ||
                                        (p.causal && key > q0 + qi));
            pr[n][e] = out ? 0.f
                           : exp2f(fmaf(s[n][e], p.scale_log2, -lse_t[qi]));
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            pa[n / 2][(n & 1) * 2 + i] = pack_bf16(pr[n][2 * i],
                                                   pr[n][2 * i + 1]);
          }
        }
        product_ab<D, kC>(dv, pa, dot_s, c * kC, lane);
        // dP^T = V . dO^T, then dS^T = P^T * (dP^T - delta), scaled
        product_abt<D, kC>(s, vs, wr, dot_s, c * kC, lane);
#pragma unroll
        for (int n = 0; n < kC / 8; ++n) {
          const int qi = c * kC + n * 8 + 2 * t;
          const float d0 = dl_t[qi];
          const float d1 = dl_t[qi + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            pa[n / 2][(n & 1) * 2 + i] =
                pack_bf16(pr[n][2 * i] * (s[n][2 * i] - d0) * p.scale,
                          pr[n][2 * i + 1] * (s[n][2 * i + 1] - d1) * p.scale);
          }
        }
        product_ab<D, kC>(dk, pa, qt_s, c * kC, lane);
      }
    }
    __syncthreads();  // this turn's buffers are free for turn + 2
  }

  // warpgroup 1's dk and dv through shared memory (the rings are free),
  // in the accumulators' own order, then added to warpgroup 0's
  float* fold = reinterpret_cast<float*>(rings);  // [2][4][D / 8][4][32]
  auto at = [&](int which, int n, int e) {
    return (((which * 4 + warp) * (D / 8) + n) * 4 + e) * 32 + lane;
  };
  if (wg == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fold[at(0, n, e)] = dk[n][e];
        fold[at(1, n, e)] = dv[n][e];
      }
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] += fold[at(0, n, e)];
      dv[n][e] += fold[at(1, n, e)];
    }
  }
  const int64_t base = (static_cast<int64_t>(b) * p.kh + kvh) * p.s * D;
  store_rows<D>(dk, ks, wr, p.dk + base, k0 + wr, p.s, lane);
  store_rows<D>(dv, vs, wr, p.dv + base, k0 + wr, p.s, lane);
}

template <int D>
int launch(const Args& a, const Launch* l, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, l[0].smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dkv_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 l[1].smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dq_kernel<D><<<l[0].grid, l[0].block, l[0].smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<D><<<l[1].grid, l[1].block, l[1].smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cp.async moves 16-byte rows: every base pointer 16-byte aligned and every
// stride a multiple of 8 elements.
bool aligned(const void* const* ptrs, int n, const Strides& st) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  }
  for (int i = 0; i < 3; ++i) {
    if (st.q[i] % 8 || st.k[i] % 8 || st.v[i] % 8 || st.o[i] % 8 ||
        st.dout[i] % 8) {
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

constexpr int kThreads = 256;  // 16 x 16

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
  float* lse;    // [B, H, S] (of the [B, H, s_pad] scratch)
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

// dq's and dkv's shared memory: Q, K, V, dO tiles of [kTile][D + 1] and
// one (dq) or two (dkv) [kTile][kTile + 1] score tiles, then lse and delta.
constexpr int smem_bytes(int d, bool dkv) {
  return (4 * kTile * (d + 1) + (dkv ? 2 : 1) * kTile * (kTile + 1) +
          2 * kTile) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
int launch_typed(const Args<T>& args, const Launch* l, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l[0].smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               l[1].smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D><<<l[0].grid, l[0].block, l[0].smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<T, D><<<l[1].grid, l[1].block, l[1].smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

template <typename T, typename A>
void fill(A& a, const void* q, const void* k, const void* v, const void* o,
          const void* dout, void* dq, void* dk, void* dv, void* lse,
          void* delta, const Strides& st, int h, int kh, int s_len,
          float scale, int causal) {
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
}

template <int D>
int run(const tc::Args& a, const Launch* l, cudaStream_t s) {
  return tc::launch<D>(a, l, s);
}

template <int D>
int run(const f32::Args<float>& a, const Launch* l, cudaStream_t s) {
  return f32::launch_typed<float, D>(a, l, s);
}

template <typename A>
int by_dim(int d, const A& a, const Launch* l, cudaStream_t s) {
  switch (d) {
    case 16: return run<16>(a, l, s);
    case 32: return run<32>(a, l, s);
    case 64: return run<64>(a, l, s);
    default: return run<128>(a, l, s);
  }
}

// Entries: tc::dq_kernel<16, 32, 64, 128> (0-3), tc::dkv_kernel (4-7),
// f32::dq_kernel<float, D> (8-11), f32::dkv_kernel<float, D> (12-15). Two
// launches, dq then dkv, over the kTile-position tiles of S: on the tensor
// cores a block per (query or kv head, row, tile), on the CUDA cores per
// (tile, row x head); each launch's whole shared memory opted in. -1 where
// the launch refuses the shape.
int make_plan(int b, int h, int kh, int s_len, int d, int dtype,
              Launch* out) {
  const int slot = d == 16 ? 0 : d == 32 ? 1 : d == 64 ? 2 : d == 128 ? 3
                                                                       : -1;
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh || s_len <= 0 || slot < 0 ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  const int tiles = n_tiles(s_len);
  if (dtype == 1) {
    const int dq = 6 * kTile * d * 2 + kTile * 4;
    const int dkv = 10 * kTile * d * 2 + 8 * kTile * 4;
    out[0] = {slot, dim3(h, b, tiles), dim3(tc::kThreads), dq, 1, 1};
    out[1] = {4 + slot, dim3(kh, b, tiles), dim3(tc::kDkvThreads), dkv, 1,
              1};
  } else {
    out[0] = {8 + slot, dim3(tiles, b * h), dim3(f32::kThreads),
              f32::smem_bytes(d, false), 1, 1};
    out[1] = {12 + slot, dim3(tiles, b * kh), dim3(f32::kThreads),
              f32::smem_bytes(d, true), 1, 1};
  }
  return 2;
}

}  // namespace

// q, o, do [B, H, S, D] and k, v [B, K, S, D] of the dtype (0 float32 on
// the CUDA cores, 1 bfloat16 on the tensor cores: base pointers 16-byte
// aligned, strides multiples of 8), read through `strides`: 15 int64
// element strides, (batch, head, position) of q, k, v, o and do in that
// order (the head dimension contiguous). dq [B, H, S, D] and dk, dv
// [B, K, S, D] contiguous of the dtype; lse and delta float32 scratch
// [B, H, S rounded up to 64]. Two launches on `stream`; returns a CUDA
// error code (0 = launched; cudaErrorInvalidValue for a shape, head dim,
// dtype or bf16 alignment the kernels do not take).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    const int64_t* strides, int b, int h, int kh, int s_len, int d,
    float scale, int causal, int dtype, void* stream) {
  Launch l[2];
  if (make_plan(b, h, kh, s_len, d, dtype, l) != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
    st.dout[i] = q_dims[i] > 1 ? strides[12 + i] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    f32::Args<float> a;
    fill<float>(a, q, k, v, o, dout, dq, dk, dv, lse, delta, st, h, kh,
                s_len, scale, causal);
    return by_dim(d, a, l, s);
  }
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  if (!tc::aligned(ptrs, 8, st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tc::Args a;
  fill<tc::bf16>(a, q, k, v, o, dout, dq, dk, dv, lse, delta, st, h, kh,
                 s_len, scale, causal);
  a.s_pad = n_tiles(s_len) * kTile;
  a.scale_log2 = scale * 1.4426950408889634f;
  return by_dim(d, a, l, s);
}

// The plan of flash_attention_bwd_launch at these sizes (see make_plan):
// writes each launch's kPlanFields ints to `plan` and returns their number
// (-1 where the launch refuses the shape).
extern "C" int flash_attention_bwd_plan(int b, int h, int kh, int s_len,
                                        int d, int dtype, int* plan) {
  Launch l[2];
  const int n = make_plan(b, h, kh, s_len, d, dtype, l);
  return n < 0 ? n : write_plan(l, n, plan);
}
