// Short-sequence attention (S <= 256) forward and backward for Hopper
// (sm_90a), over q, k and v given as operand descriptors, and the
// out-projection y = o·Wo^T + bo of the packed path.
//
// Replaces two TPU kernels of clip_dplm_tpu/ops/short_attention.py, which
// compute the same attention from differently laid out operands:
//
//   - _fwd_kernel_qkv / _bwd_kernel_qkv (pallas_call in _fwd_call_qkv and
//     _bwd_call_qkv), the body of fused_short_attention_qkv_proj: q, k and v
//     are the three column blocks of one packed (B, S, 3D) qkv, with
//     rotate-half RoPE on q and k and the out-projection after;
//   - _fwd_kernel / _bwd_kernel (pallas_call in _fwd_call and _bwd_call),
//     behind fused_short_attention (separate (B, S, D) q, k, v) and
//     fused_short_attention_heads ((B, H, S, Dh) heads): no RoPE, no
//     projection.
//
// Every kernel below takes each of q, k, v, o, dO, dq, dk and dv as an
// `Operand`: a base pointer and batch, head and row strides in elements.
// The packed qkv, the separate tensors (a qkv.chunk(3, -1) view among them,
// read in place with its row stride of 3D) and the head-split tensors are
// three sets of strides of the same kernels. Separate operands take no RoPE
// (cos_t = sin_t = null) and no projection GEMM. The TPU kernels run G batch
// rows per program with all heads unrolled (and, packed, the projection in
// the same program); here the work is these launches:
//
//   short_attn_kernel: one block of 8 warps per (query tile of up to 64
//     rows, head, batch row). K and V of the head for the whole sequence
//     (S <= 256) are staged in shared memory with 16-byte loads where the
//     strides allow it; RoPE, where given, is applied to q and k while
//     staging, in f32, rounded to bf16 (as the TPU kernel does). Scores are
//     f32 with the additive -1e30 key bias, the softmax is exact (no online
//     rescaling: all keys are resident), p is rounded to bf16 for p·V with
//     f32 accumulation, and the row is divided by max(l, 1e-30).
//   dense_gemm_kernel (csrc/dense_gemm.cuh, shared with the fused Dense
//     block), packed path only: y = bf16(o·Wo^T + bo) with f32 accumulation,
//     Wo in (out, in) layout, the bias added before the one rounding.
//
// Bounds on the H100: at the serving shapes (S = 128, Dh = 64) a block does
// 2·64·128·64·2 = 2.1 MFLOP on 16 KB of K/V and 8 KB of q, far below the
// tensor cores' ratio of ~295 FLOP per byte, so the loads (K/V re-read by
// each query tile, mostly from L2) and the latency of the block's serial
// phases (stage, q·k^T, softmax, p·V) bound it. WMMA 16x16x16 bf16 tiles
// keep the products on the tensor cores; shared-memory rows are padded so
// that fragment loads do not conflict on banks. Fusing the projection into
// the attention launch, and cp.async/TMA with wgmma, are later work.
//
// With a probabilities buffer (the saved mode of the TPU kernels, taken where
// a backward follows and the JAX package's size rule allows it) the kernel
// also writes bf16(p / l) of its query rows into a (B, H, S, S) buffer: p in
// f32, divided by l before the one rounding, as the TPU kernels' probs_ref.
//
// Backward: replaces _bwd_kernel_qkv and _bwd_kernel in both of their modes,
// for every S <= 256 and Dh (a multiple of 8, <= 128) the forward takes. The
// out-projection's part of the packed TPU kernel (dO = dy·Wo^T) is the shared
// GEMM, launched by the wrapper; dWo and dbo are plain matmuls there, as the
// JAX package leaves them to XLA. The TPU kernels walk whole heads in VMEM.
// Each output is written once by one block (no atomics: two launches are
// equal byte for byte):
//
//   short_attn_bwd_head_kernel (recompute mode, where its layout fits:
//     S <= 208 at Dh = 64, the flagship's and DPLM's S = 128 among them):
//     one block of 16 warps per (head, batch row) holds K, V and the f32
//     dK/dV of the whole head and walks the query tiles, recomputing the
//     softmax as below; five (S, S, Dh) products a head, the fastest of the
//     recompute kernels there (PERF.md, the findings of slices 3 and 7).
//
// Past that bound, and always in saved mode, a head's f32 dK/dV does not fit
// one block's shared memory beside K and V, so the work is two launches:
//
//   short_attn_bwd_dq_kernel<saved>: one block of 8 warps (16 where its
//     tiles take a whole SM's shared memory, as at Dh = 128) per (query
//     tile, head, batch row) holds K and V of the head for the whole
//     sequence and forms full rows: dP = dO·V^T; recompute mode: the
//     forward's softmax bit for bit (q/k RoPE'd where given and rounded to
//     bf16, f32 scores · scale + key bias, max, exp, l = max(Σp, 1e-30),
//     prob = p / l) and delta = rowsum(dO∘o) from the saved o; saved mode:
//     prob read from the bf16 buffer and delta = Σ dP·prob. Then ds =
//     bf16(prob·(dP − delta)·scale) and dQ = ds·K, through the inverse
//     rotation in f32 where RoPE was given. It writes the row statistics (m,
//     l, delta; saved mode delta only) to a (B, H, 3, S) f32 scratch.
//   short_attn_bwd_dkv_kernel<saved>: one block of 8 or 16 warps per (key
//     tile of 64, head, batch row) holds K and V of its keys and their f32
//     dK/dV, and walks the query tiles: dP = dO·V^T for its keys, prob
//     recomputed from the row's m and l (the same operations as above) or
//     read, ds as above, dK += ds^T·Q and dV += bf16(prob)^T·dO; dK leaves
//     through the inverse rotation where RoPE was given.
//
// These are the TPU kernels' rounding points. The saved mode skips the
// score product and the softmax and reads no o; it does its dP product twice
// (once a kernel), as the recompute mode does its score and dP products.
// At DPLM's training shape (B=256, S=128, D=640, H=10) the backward moves
// qkv, dO, the probabilities and dqkv (~377 MB in saved mode) and does ~5
// (S, S, Dh) products a head on WMMA tiles, far under the tensor cores' ~295
// FLOP/B: memory and the blocks' serial phases bound it.

#include <initializer_list>

#include "dense_gemm.cuh"

using namespace nvcuda;

// One attention operand: row s of head h of batch row b starts at
// p + b·sb + h·sh + s·ss (strides in elements; the Dh elements of a row are
// contiguous). The C entries take it by pointer; Python mirrors it in
// ops/_build.py::Operand.
struct Operand {
  void* p;
  int64_t sb, sh, ss;
};

namespace clip_dplm {
namespace {

constexpr int kAttnThreads = 256;  // the attention kernel: 8 warps
constexpr int kAttnWarps = kAttnThreads / kWarp;
// the dQ and dK/dV kernels: 8 warps a block, two blocks an SM where their
// tiles fit half of its shared memory, so that one block's staging overlaps
// the other's products; 16 warps where the tiles take one block an SM
// (PERF.md, the findings of slice 7). kBwdPair threads an SM either way.
constexpr int kBwdPair = 512;
constexpr size_t kHalfSmem = 115712;  // (228 KB per SM) / 2, less 1 KB reserved a block
// the one-block-a-head recompute backward: 16 warps, so that the one block
// an SM that its shared memory allows hides more of the latency of its
// serial phases (PERF.md, the findings of slice 3)
constexpr int kHeadThreads = 512;
constexpr int kHeadWarps = kHeadThreads / kWarp;


template <typename T = const bf16>
__device__ inline T* row_of(const Operand& t, int b, int h, int s) {
  return static_cast<T*>(t.p) + b * t.sb + h * t.sh + s * t.ss;
}

// Shared-memory layout of one attention block. Row pitches are padded (+8
// bf16, +4 f32) so that the rows of a 16x16 fragment fall on different banks.
struct AttnSmem {
  int ld_kv, ld_s, ld_o, ld_p;
  size_t k, v, q, so, p, l, bias, total;
  __host__ __device__ AttnSmem(int Sp, int Dp, int QT) {
    ld_kv = Dp + 8;
    ld_s = Sp + 4;
    ld_o = Dp + 4;
    ld_p = Sp + 8;
    const int ld_so = ld_s > ld_o ? ld_s : ld_o;
    size_t off = 0;
    k = off;    off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    v = off;    off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    q = off;    off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    so = off;   off += align128(size_t(QT) * ld_so * sizeof(float));  // scores, then o
    p = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    l = off;    off += align128(size_t(QT) * sizeof(float));
    bias = off; off += align128(size_t(Sp) * sizeof(float));
    total = off;
  }
};

__global__ void __launch_bounds__(kAttnThreads)
short_attn_kernel(const Operand q, const Operand k, const Operand v,
                  const uint8_t* __restrict__ mask, const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t, const Operand o, bf16* __restrict__ probs,
                  int S, int H, int Dh, float scale, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const AttnSmem lay(Sp, Dp, QT);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  float* sS = reinterpret_cast<float*>(smem + lay.so);
  float* sO = sS;  // o reuses the score rows once p is formed
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  float* sL = reinterpret_cast<float*>(smem + lay.l);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const int ldkv = lay.ld_kv, lds = lay.ld_s, ldo = lay.ld_o, ldp = lay.ld_p;

  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
  stage_rows(sK, ldkv, row_of(k, b, h, 0), k.ss, Sp, S, Dh, Dp, cos_t, sin_t, 0);
  stage_rows(sV, ldkv, row_of(v, b, h, 0), v.ss, Sp, S, Dh, Dp, nullptr, nullptr, 0);
  stage_rows(sQ, ldkv, row_of(q, b, h, q0), q.ss, QT, S - q0, Dh, Dp, cos_t, sin_t, q0);
  for (int j = threadIdx.x; j < Sp; j += kAttnThreads) sBias[j] = key_bias(mask_row, j, S);
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // scores: (QT x Dp) · (Dp x Sp), f32 accumulation
  {
    const int nC = Sp / 16, tiles = (QT / 16) * nC;
    for (int t = warp; t < tiles; t += kAttnWarps) {
      const int r = t / nC, c = t % nC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + r * 16 * ldkv + kk, ldkv);
        wmma::load_matrix_sync(bt, sK + c * 16 * ldkv + kk, ldkv);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(sS + r * 16 * lds + c * 16, acc, lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // exact softmax per query row; p stays unnormalized until the end
  for (int r = warp; r < QT; r += kAttnWarps) {
    float* srow = sS + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < Sp; j += kWarp) {
      const float s = srow[j] * scale + sBias[j];
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Sp; j += kWarp) {
      const float p = expf(srow[j] - m);
      sP[r * ldp + j] = __float2bfloat16(p);
      srow[j] = p;  // f32 p, for the saved probabilities (each lane its own j)
      l += p;
    }
    l = fmaxf(warp_sum(l), 1e-30f);
    if (lane == 0) sL[r] = l;
    if (probs != nullptr && q0 + r < S) {
      bf16* prow = probs + ((size_t(b) * H + h) * S + q0 + r) * S;
      for (int j = lane; j < S; j += kWarp) prow[j] = __float2bfloat16(srow[j] / l);
    }
  }
  __syncthreads();

  // o = p · V: (QT x Sp) · (Sp x Dp), written over the score rows
  {
    const int nC = Dp / 16, tiles = (QT / 16) * nC;
    for (int t = warp; t < tiles; t += kAttnWarps) {
      const int r = t / nC, c = t % nC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Sp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + r * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(bv, sV + kk * ldkv + c * 16, ldkv);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sO + r * 16 * ldo + c * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // o rows in 8-element (16-byte) chunks; Dh % 8 == 0
  const int cpr = Dh / 8;
  for (int idx = threadIdx.x; idx < QT * cpr; idx += kAttnThreads) {
    const int r = idx / cpr, d0 = (idx % cpr) * 8, i = q0 + r;
    if (i >= S) continue;
    const float inv = 1.f / sL[r];
    const float* src = sO + r * ldo + d0;
    uint4 u;
    __nv_bfloat162* u2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) u2[e] = __floats2bfloat162_rn(src[2 * e] * inv, src[2 * e + 1] * inv);
    *reinterpret_cast<uint4*>(row_of<bf16>(o, b, h, i) + d0) = u;
  }
}

// Shared-memory layout of one dQ block (query tile of QT rows): K and V of
// the head for the whole sequence, the Q and dO tiles, the probabilities
// (saved mode: bf16 as read; recompute mode: f32 scores, then p, with the
// pitch of dP so that one product call stores both), dP (then dQ), ds, and
// the key bias (recompute mode). Python mirrors it in
// ops/short_attention.py::_bwd_dq_smem_bytes.
struct BwdQSmem {
  int ld_kv, ld_s, ld_acc, ld_p, ld_sq;
  size_t k, v, q, dout, p, dp, ds, bias, total;
  __host__ __device__ BwdQSmem(int Sp, int Dp, int QT, bool saved) {
    ld_kv = Dp + 8;
    ld_s = Sp + 4;
    ld_acc = Dp + 4;
    ld_p = Sp + 8;
    ld_sq = ld_s > ld_acc ? ld_s : ld_acc;
    size_t off = 0;
    k = off;    off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    v = off;    off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    q = off;    off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    dout = off; off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    p = off;    off += align128(saved ? size_t(QT) * ld_p * sizeof(bf16)
                                      : size_t(QT) * ld_sq * sizeof(float));
    dp = off;   off += align128(size_t(QT) * ld_sq * sizeof(float));  // dP, then dQ
    ds = off;   off += align128(size_t(QT) * ld_p * sizeof(bf16));
    bias = off; off += saved ? 0 : align128(size_t(Sp) * sizeof(float));
    total = off;
  }
};

// Shared-memory layout of one dK/dV block (key tile of KT rows, query tiles
// of QT rows): K, V and the f32 dK, dV of its keys, the Q and dO tiles, the
// scores (recompute mode), dP, bf16 prob and ds, the key bias (recompute
// mode) and the query rows' m, l, delta. Python mirrors it in
// ops/short_attention.py::_bwd_dkv_smem_bytes.
struct BwdKVSmem {
  int ld_kv, ld_acc, ld_s, ld_p;
  size_t k, v, q, dout, dk, dv, s, dp, pb, ds, bias, stats, total;
  __host__ __device__ BwdKVSmem(int KT, int Dp, int QT, bool saved) {
    ld_kv = Dp + 8;
    ld_acc = Dp + 4;
    ld_s = KT + 4;
    ld_p = KT + 8;
    size_t off = 0;
    k = off;     off += align128(size_t(KT) * ld_kv * sizeof(bf16));
    v = off;     off += align128(size_t(KT) * ld_kv * sizeof(bf16));
    q = off;     off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    dout = off;  off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    dk = off;    off += align128(size_t(KT) * ld_acc * sizeof(float));
    dv = off;    off += align128(size_t(KT) * ld_acc * sizeof(float));
    s = off;     off += saved ? 0 : align128(size_t(QT) * ld_s * sizeof(float));
    dp = off;    off += align128(size_t(QT) * ld_s * sizeof(float));
    pb = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    ds = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    bias = off;  off += saved ? 0 : align128(size_t(KT) * sizeof(float));
    stats = off; off += align128(size_t(3) * QT * sizeof(float));
    total = off;
  }
};

// Query rows per dQ block: the most (64, 48, 32, 16) whose layout fits half
// the SM's shared memory (two blocks an SM), else the most that fit one
// block's; 0 when even 16 rows do not fit.
__host__ inline int bwd_dq_rows(int Sp, int Dp, bool saved) {
  for (size_t cap : {kHalfSmem, kMaxSmem})
    for (int QT = Sp < 64 ? Sp : 64; QT >= 16; QT -= 16)
      if (BwdQSmem(Sp, Dp, QT, saved).total <= cap) return QT;
  return 0;
}

// Key rows (64) and query rows per dK/dV block, the query tile chosen as in
// bwd_dq_rows; 0 when it does not fit.
__host__ inline void bwd_dkv_rows(int Sp, int Dp, bool saved, int* KT, int* QT) {
  *KT = Sp < 64 ? Sp : 64;
  for (size_t cap : {kHalfSmem, kMaxSmem})
    for (*QT = *KT; *QT >= 16; *QT -= 16)
      if (BwdKVSmem(*KT, Dp, *QT, saved).total <= cap) return;
  *KT = *QT = 0;
}

// Rows [0, n_rows) x columns [0, n_cols) of a bf16 tile into shared memory
// (row pitch ld) from src (row stride `stride` elements); entries outside
// [0, valid_rows) x [0, valid_cols) are zero. 16-byte vectors where the
// layout allows it (n_cols is a multiple of 16).
__device__ inline void stage_tile(bf16* dst, int ld, const bf16* src, size_t stride, int n_rows,
                                  int n_cols, int valid_rows, int valid_cols) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (stride % 8 == 0 && valid_cols % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int cpr = n_cols / 8;
    for (int idx = tid; idx < n_rows * cpr; idx += nt) {
      const int r = idx / cpr, c0 = (idx % cpr) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (r < valid_rows && c0 < valid_cols)
        u = *reinterpret_cast<const uint4*>(src + r * stride + c0);
      *reinterpret_cast<uint4*>(dst + r * ld + c0) = u;
    }
  } else {
    for (int idx = tid; idx < n_rows * n_cols; idx += nt) {
      const int r = idx / n_cols, c = idx % n_cols;
      dst[r * ld + c] = (r < valid_rows && c < valid_cols) ? src[r * stride + c]
                                                           : __float2bfloat16(0.f);
    }
  }
}

// C (rows x cols, f32, pitch ldc) = A (rows x kdim, bf16, pitch lda) · B^T
// where B is (cols x kdim, pitch ldb): WMMA 16x16x16 tiles shared out over
// the block's warps; with two products (A2, B2, C2 non-null) both at once.
__device__ inline void mm_abt(const bf16* A, int lda, const bf16* Bm, int ldb, float* C, int ldc,
                              const bf16* A2, const bf16* B2, float* C2, int rows, int cols,
                              int kdim, int warp, int n_warps) {
  const int nC = cols / 16, tiles = (rows / 16) * nC, n = C2 == nullptr ? tiles : 2 * tiles;
  for (int t = warp; t < n; t += n_warps) {
    const bool second = t >= tiles;
    const int r = (t % tiles) / nC, c = (t % tiles) % nC;
    const bf16* a_p = second ? A2 : A;
    const bf16* b_p = second ? B2 : Bm;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < kdim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(a, a_p + r * 16 * lda + kk, lda);
      wmma::load_matrix_sync(bt, b_p + c * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync((second ? C2 : C) + r * 16 * ldc + c * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

// Rows [0, n_rows) of an f32 gradient tile (row pitch ld) to bf16 rows of
// dst (row pitch row_stride), in 8-element chunks (Dh % 8 == 0). With cos/sin
// (position pos0 + r) the rows pass through the inverse rotate-half RoPE
// first: [g1·cos + g2·sin, g2·cos − g1·sin], in f32.
__device__ inline void write_grad_rows(bf16* dst, size_t row_stride, const float* src, int ld,
                                       int n_rows, int Dh, const float* cos_t,
                                       const float* sin_t, int pos0) {
  const int half = Dh / 2, cpr = Dh / 8;
  for (int idx = threadIdx.x; idx < n_rows * cpr; idx += blockDim.x) {
    const int r = idx / cpr, d0 = (idx % cpr) * 8;
    const float* g = src + r * ld;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = d0 + e;
      if (cos_t == nullptr) {
        v[e] = g[d];
      } else {
        const size_t p = size_t(pos0 + r) * half;
        const int i = d < half ? d : d - half;
        v[e] = d < half ? g[d] * cos_t[p + i] + g[d + half] * sin_t[p + i]
                        : g[d] * cos_t[p + i] - g[i] * sin_t[p + i];
      }
    }
    store8(dst + r * row_stride + d0, v);
  }
}

// Shared-memory layout of one block of the one-block-a-head recompute
// backward: K, V and the f32 dK, dV of the whole head, the Q and dO tiles,
// the scores (then dQ), dP, bf16 prob and ds, the key bias and delta. Python
// mirrors it in ops/short_attention.py::_bwd_head_smem_bytes.
struct BwdHeadSmem {
  int ld_kv, ld_acc, ld_s, ld_p;
  size_t k, v, q, dout, dk, dv, s, dp, pb, ds, bias, delta, total;
  __host__ __device__ BwdHeadSmem(int Sp, int Dp, int QT) {
    ld_kv = Dp + 8;
    ld_acc = Dp + 4;
    ld_s = Sp + 4;
    ld_p = Sp + 8;
    const int ld_sq = ld_s > ld_acc ? ld_s : ld_acc;
    size_t off = 0;
    k = off;     off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    v = off;     off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    q = off;     off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    dout = off;  off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    dk = off;    off += align128(size_t(Sp) * ld_acc * sizeof(float));
    dv = off;    off += align128(size_t(Sp) * ld_acc * sizeof(float));
    s = off;     off += align128(size_t(QT) * ld_sq * sizeof(float));  // scores, then dQ
    dp = off;    off += align128(size_t(QT) * ld_s * sizeof(float));
    pb = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    ds = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    bias = off;  off += align128(size_t(Sp) * sizeof(float));
    delta = off; off += align128(size_t(QT) * sizeof(float));
    total = off;
  }
};

// Query rows per block of the one-block-a-head recompute kernel: 64, halved
// while its layout does not fit one block's shared memory; 0 when even 16
// rows do not fit (S > 208 at Dh = 64), and then the dQ and dK/dV launches
// run.
__host__ inline int bwd_head_rows(int Sp, int Dp) {
  int QT = Sp < 64 ? Sp : 64;
  while (QT > 16 && BwdHeadSmem(Sp, Dp, QT).total > kMaxSmem) QT /= 2;
  return BwdHeadSmem(Sp, Dp, QT).total <= kMaxSmem ? QT : 0;
}

__global__ void __launch_bounds__(kHeadThreads)
short_attn_bwd_head_kernel(const Operand q, const Operand k, const Operand v,
                           const uint8_t* __restrict__ mask, const float* __restrict__ cos_t,
                           const float* __restrict__ sin_t, const Operand o, const Operand dout,
                           const Operand dq, const Operand dk, const Operand dv, int S, int Dh,
                           float scale, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  const int h = blockIdx.x, b = blockIdx.y;
  const BwdHeadSmem lay(Sp, Dp, QT);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  float* sDK = reinterpret_cast<float*>(smem + lay.dk);
  float* sDV = reinterpret_cast<float*>(smem + lay.dv);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDQ = sS;  // the dQ tile reuses the score rows once ds is formed
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  bf16* sPB = reinterpret_cast<bf16*>(smem + lay.pb);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);
  const int ldkv = lay.ld_kv, ldacc = lay.ld_acc, lds = lay.ld_s, ldp = lay.ld_p;

  const bf16* o_base = row_of(o, b, h, 0);
  const bf16* do_base = row_of(dout, b, h, 0);
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
  stage_rows(sK, ldkv, row_of(k, b, h, 0), k.ss, Sp, S, Dh, Dp, cos_t, sin_t, 0);
  stage_rows(sV, ldkv, row_of(v, b, h, 0), v.ss, Sp, S, Dh, Dp, nullptr, nullptr, 0);
  for (int j = threadIdx.x; j < Sp; j += kHeadThreads) sBias[j] = key_bias(mask_row, j, S);
  for (int i = threadIdx.x; i < Sp * ldacc; i += kHeadThreads) sDK[i] = sDV[i] = 0.f;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int q0 = 0; q0 < S; q0 += QT) {
    __syncthreads();  // the previous tile is done with sQ, sDO and the dQ rows
    stage_rows(sQ, ldkv, row_of(q, b, h, q0), q.ss, QT, S - q0, Dh, Dp, cos_t, sin_t, q0);
    stage_rows(sDO, ldkv, do_base + q0 * dout.ss, dout.ss, QT, S - q0, Dh, Dp, nullptr, nullptr,
               0);
    __syncthreads();

    // delta = rowsum(dO∘o) in f32; padding rows have dO = 0
    for (int r = warp; r < QT; r += kHeadWarps) {
      float acc = 0.f;
      if (q0 + r < S)
        for (int d = lane; d < Dh; d += kWarp)
          acc += __bfloat162float(sDO[r * ldkv + d]) *
                 __bfloat162float(o_base[(q0 + r) * o.ss + d]);
      acc = warp_sum(acc);
      if (lane == 0) sDelta[r] = acc;
    }
    // scores = Q·K^T and dP = dO·V^T, (QT x Dp)·(Dp x Sp) each, f32 accumulation
    {
      const int nC = Sp / 16, tiles = (QT / 16) * nC;
      for (int t = warp; t < 2 * tiles; t += kHeadWarps) {
        const bool is_dp = t >= tiles;
        const int r = (t % tiles) / nC, c = (t % tiles) % nC;
        const bf16* A = is_dp ? sDO : sQ;
        const bf16* Bt = is_dp ? sV : sK;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < Dp; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(a, A + r * 16 * ldkv + kk, ldkv);
          wmma::load_matrix_sync(bt, Bt + c * 16 * ldkv + kk, ldkv);
          wmma::mma_sync(acc, a, bt, acc);
        }
        wmma::store_matrix_sync((is_dp ? sDP : sS) + r * 16 * lds + c * 16, acc, lds,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // the forward's softmax, bit for bit; then prob = p / l, ds
    for (int r = warp; r < QT; r += kHeadWarps) {
      float* srow = sS + r * lds;
      const float* dprow = sDP + r * lds;
      float m = -INFINITY;
      for (int j = lane; j < Sp; j += kWarp) {
        const float s = srow[j] * scale + sBias[j];
        srow[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < Sp; j += kWarp) {
        const float p = expf(srow[j] - m);
        srow[j] = p;
        l += p;
      }
      l = fmaxf(warp_sum(l), 1e-30f);
      const float delta = sDelta[r];
      for (int j = lane; j < Sp; j += kWarp) {
        const float prob = srow[j] / l;
        sPB[r * ldp + j] = __float2bfloat16(prob);
        sDS[r * ldp + j] = __float2bfloat16(prob * (dprow[j] - delta) * scale);
      }
    }
    __syncthreads();

    // dQ = ds·K (QT x Dp, into the score rows); dK += ds^T·Q; dV += bf16(prob)^T·dO
    {
      const int nC = Dp / 16, tq = (QT / 16) * nC, tk = (Sp / 16) * nC;
      for (int t = warp; t < tq + 2 * tk; t += kHeadWarps) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        if (t < tq) {
          const int r = t / nC, c = t % nC;
          wmma::fill_fragment(acc, 0.f);
          for (int kk = 0; kk < Sp; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
            wmma::load_matrix_sync(a, sDS + r * 16 * ldp + kk, ldp);
            wmma::load_matrix_sync(bk, sK + kk * ldkv + c * 16, ldkv);
            wmma::mma_sync(acc, a, bk, acc);
          }
          wmma::store_matrix_sync(sDQ + r * 16 * ldacc + c * 16, acc, ldacc,
                                  wmma::mem_row_major);
        } else {
          const bool is_dv = t - tq >= tk;
          const int u = (t - tq) % tk, r = u / nC, c = u % nC;  // r: key tile
          float* acc_p = (is_dv ? sDV : sDK) + r * 16 * ldacc + c * 16;
          const bf16* P = is_dv ? sPB : sDS;
          const bf16* X = is_dv ? sDO : sQ;
          wmma::load_matrix_sync(acc, acc_p, ldacc, wmma::mem_row_major);
          for (int kk = 0; kk < QT; kk += 16) {
            // A = P^T: element (key i, query j) is P[j][i], column-major with pitch ldp
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bx;
            wmma::load_matrix_sync(a, P + kk * ldp + r * 16, ldp);
            wmma::load_matrix_sync(bx, X + kk * ldkv + c * 16, ldkv);
            wmma::mma_sync(acc, a, bx, acc);
          }
          wmma::store_matrix_sync(acc_p, acc, ldacc, wmma::mem_row_major);
        }
      }
    }
    __syncthreads();
    const int rows = S - q0 < QT ? S - q0 : QT;
    write_grad_rows(row_of<bf16>(dq, b, h, q0), dq.ss, sDQ, ldacc, rows, Dh, cos_t, sin_t, q0);
  }
  __syncthreads();
  write_grad_rows(row_of<bf16>(dk, b, h, 0), dk.ss, sDK, ldacc, S, Dh, cos_t, sin_t, 0);
  write_grad_rows(row_of<bf16>(dv, b, h, 0), dv.ss, sDV, ldacc, S, Dh, nullptr, nullptr, 0);
}

template <bool kSaved, int kThreads>
__global__ void __launch_bounds__(kThreads, kBwdPair / kThreads)
short_attn_bwd_dq_kernel(const Operand q, const Operand k, const Operand v,
                         const uint8_t* __restrict__ mask, const float* __restrict__ cos_t,
                         const float* __restrict__ sin_t, const Operand o,
                         const bf16* __restrict__ probs, const Operand dout,
                         float* __restrict__ stats, const Operand dq, int S, int H, int Dh,
                         float scale, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kWarps = kThreads / kWarp;
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int qt = QT < Sp - q0 ? QT : Sp - q0;  // rows of this tile, a multiple of 16
  const BwdQSmem lay(Sp, Dp, QT, kSaved);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  bf16* sPB = reinterpret_cast<bf16*>(smem + lay.p);  // saved mode
  float* sS = reinterpret_cast<float*>(smem + lay.p);  // recompute mode
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  float* sDQ = sDP;  // dQ reuses the dP rows once ds is formed
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const int ldkv = lay.ld_kv, ldacc = lay.ld_acc, ldp = lay.ld_p, ldsq = lay.ld_sq;

  const size_t bh = size_t(b) * H + h;
  stage_rows(sK, ldkv, row_of(k, b, h, 0), k.ss, Sp, S, Dh, Dp, cos_t, sin_t, 0);
  stage_rows(sV, ldkv, row_of(v, b, h, 0), v.ss, Sp, S, Dh, Dp, nullptr, nullptr, 0);
  stage_rows(sQ, ldkv, row_of(q, b, h, q0), q.ss, qt, S - q0, Dh, Dp, cos_t, sin_t, q0);
  stage_rows(sDO, ldkv, row_of(dout, b, h, q0), dout.ss, qt, S - q0, Dh, Dp, nullptr, nullptr,
             0);
  if (kSaved) {
    stage_tile(sPB, ldp, probs + (bh * S + q0) * S, S, qt, Sp, S - q0, S);
  } else {
    const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
    for (int j = threadIdx.x; j < Sp; j += kThreads) sBias[j] = key_bias(mask_row, j, S);
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // dP = dO·V^T (qt x Sp); recompute mode also the scores Q·K^T
  if (kSaved)
    mm_abt(sDO, ldkv, sV, ldkv, sDP, ldsq, nullptr, nullptr, nullptr, qt, Sp, Dp, warp,
           kWarps);
  else
    mm_abt(sDO, ldkv, sV, ldkv, sDP, ldsq, sQ, sK, sS, qt, Sp, Dp, warp, kWarps);
  __syncthreads();

  // per query row: prob, delta, ds; the row statistics for the dK/dV kernel
  float* st = stats + bh * 3 * S;  // planes m, l, delta
  for (int r = warp; r < qt; r += kWarps) {
    const int i = q0 + r;
    const float* dprow = sDP + r * ldsq;
    bf16* dsrow = sDS + r * ldp;
    if (kSaved) {
      const bf16* prow = sPB + r * ldp;
      float acc = 0.f;
      for (int j = lane; j < Sp; j += kWarp) acc += dprow[j] * __bfloat162float(prow[j]);
      const float delta = warp_sum(acc);
      for (int j = lane; j < Sp; j += kWarp)
        dsrow[j] = __float2bfloat16(__bfloat162float(prow[j]) * (dprow[j] - delta) * scale);
      if (lane == 0 && i < S) st[2 * S + i] = delta;
    } else {
      // the forward's softmax, bit for bit
      float* srow = sS + r * ldsq;
      float m = -INFINITY;
      for (int j = lane; j < Sp; j += kWarp) {
        const float s = srow[j] * scale + sBias[j];
        srow[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < Sp; j += kWarp) {
        const float p = expf(srow[j] - m);
        srow[j] = p;
        l += p;
      }
      l = fmaxf(warp_sum(l), 1e-30f);
      // delta = rowsum(dO∘o) in f32 from the saved o; padding rows have dO = 0
      float acc = 0.f;
      if (i < S) {
        const bf16* orow = row_of(o, b, h, i);
        for (int d = lane; d < Dh; d += kWarp)
          acc += __bfloat162float(sDO[r * ldkv + d]) * __bfloat162float(orow[d]);
      }
      const float delta = warp_sum(acc);
      for (int j = lane; j < Sp; j += kWarp)
        dsrow[j] = __float2bfloat16(srow[j] / l * (dprow[j] - delta) * scale);
      if (lane == 0 && i < S) {
        st[i] = m;
        st[S + i] = l;
        st[2 * S + i] = delta;
      }
    }
  }
  __syncthreads();

  // dQ = ds·K (qt x Dp), into the dP rows
  {
    const int nC = Dp / 16, tiles = (qt / 16) * nC;
    for (int t = warp; t < tiles; t += kWarps) {
      const int r = t / nC, c = t % nC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Sp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(a, sDS + r * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(bk, sK + kk * ldkv + c * 16, ldkv);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(sDQ + r * 16 * ldacc + c * 16, acc, ldacc, wmma::mem_row_major);
    }
  }
  __syncthreads();
  const int rows = S - q0 < qt ? S - q0 : qt;
  write_grad_rows(row_of<bf16>(dq, b, h, q0), dq.ss, sDQ, ldacc, rows, Dh, cos_t, sin_t, q0);
}

template <bool kSaved, int kThreads>
__global__ void __launch_bounds__(kThreads, kBwdPair / kThreads)
short_attn_bwd_dkv_kernel(const Operand q, const Operand k, const Operand v,
                          const uint8_t* __restrict__ mask, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, const bf16* __restrict__ probs,
                          const Operand dout, const float* __restrict__ stats, const Operand dk,
                          const Operand dv, int S, int H, int Dh, float scale, int KT, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kWarps = kThreads / kWarp;
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int kt = KT < Sp - k0 ? KT : Sp - k0;  // keys of this tile, a multiple of 16
  const BwdKVSmem lay(KT, Dp, QT, kSaved);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  float* sDK = reinterpret_cast<float*>(smem + lay.dk);
  float* sDV = reinterpret_cast<float*>(smem + lay.dv);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  bf16* sPB = reinterpret_cast<bf16*>(smem + lay.pb);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  float* sM = reinterpret_cast<float*>(smem + lay.stats);
  float* sL = sM + QT;
  float* sDelta = sL + QT;
  const int ldkv = lay.ld_kv, ldacc = lay.ld_acc, lds = lay.ld_s, ldp = lay.ld_p;

  const size_t bh = size_t(b) * H + h;
  const float* st = stats + bh * 3 * S;
  stage_rows(sK, ldkv, row_of(k, b, h, k0), k.ss, kt, S - k0, Dh, Dp, cos_t, sin_t, k0);
  stage_rows(sV, ldkv, row_of(v, b, h, k0), v.ss, kt, S - k0, Dh, Dp, nullptr, nullptr, 0);
  if (!kSaved) {
    const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
    for (int j = threadIdx.x; j < kt; j += kThreads) sBias[j] = key_bias(mask_row, k0 + j, S);
  }
  for (int i = threadIdx.x; i < kt * ldacc; i += kThreads) sDK[i] = sDV[i] = 0.f;

  const int warp = threadIdx.x / kWarp;
  for (int q0 = 0; q0 < S; q0 += QT) {
    const int qt = QT < Sp - q0 ? QT : Sp - q0;
    __syncthreads();  // the previous tile is done with sQ, sDO, sPB and sDS
    stage_rows(sQ, ldkv, row_of(q, b, h, q0), q.ss, qt, S - q0, Dh, Dp, cos_t, sin_t, q0);
    stage_rows(sDO, ldkv, row_of(dout, b, h, q0), dout.ss, qt, S - q0, Dh, Dp, nullptr, nullptr,
               0);
    for (int r = threadIdx.x; r < qt; r += kThreads) {
      const bool valid = q0 + r < S;
      sM[r] = valid && !kSaved ? st[q0 + r] : 0.f;
      sL[r] = valid && !kSaved ? st[S + q0 + r] : 1.f;
      sDelta[r] = valid ? st[2 * S + q0 + r] : 0.f;
    }
    if (kSaved) stage_tile(sPB, ldp, probs + (bh * S + q0) * S + k0, S, qt, kt, S - q0, S - k0);
    __syncthreads();

    // dP = dO·V^T (qt x kt); recompute mode also the scores Q·K^T
    if (kSaved)
      mm_abt(sDO, ldkv, sV, ldkv, sDP, lds, nullptr, nullptr, nullptr, qt, kt, Dp, warp,
             kWarps);
    else
      mm_abt(sDO, ldkv, sV, ldkv, sDP, lds, sQ, sK, sS, qt, kt, Dp, warp, kWarps);
    __syncthreads();

    // prob (recomputed from the row's m and l with the dQ kernel's
    // operations, or read) and ds; padding query rows take 0
    for (int idx = threadIdx.x; idx < qt * kt; idx += kThreads) {
      const int r = idx / kt, j = idx % kt;
      float prob;
      if (kSaved) {
        prob = __bfloat162float(sPB[r * ldp + j]);
      } else {
        prob = 0.f;
        if (q0 + r < S) {
          const float s = sS[r * lds + j] * scale + sBias[j];
          prob = expf(s - sM[r]) / sL[r];
        }
        sPB[r * ldp + j] = __float2bfloat16(prob);
      }
      sDS[r * ldp + j] = __float2bfloat16(prob * (sDP[r * lds + j] - sDelta[r]) * scale);
    }
    __syncthreads();

    // dK += ds^T·Q, dV += bf16(prob)^T·dO (kt x Dp each)
    {
      const int nC = Dp / 16, tk = (kt / 16) * nC;
      for (int t = warp; t < 2 * tk; t += kWarps) {
        const bool is_dv = t >= tk;
        const int u = t % tk, r = u / nC, c = u % nC;  // r: key tile
        float* acc_p = (is_dv ? sDV : sDK) + r * 16 * ldacc + c * 16;
        const bf16* P = is_dv ? sPB : sDS;
        const bf16* X = is_dv ? sDO : sQ;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, acc_p, ldacc, wmma::mem_row_major);
        for (int kk = 0; kk < qt; kk += 16) {
          // A = P^T: element (key i, query j) is P[j][i], column-major with pitch ldp
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bx;
          wmma::load_matrix_sync(a, P + kk * ldp + r * 16, ldp);
          wmma::load_matrix_sync(bx, X + kk * ldkv + c * 16, ldkv);
          wmma::mma_sync(acc, a, bx, acc);
        }
        wmma::store_matrix_sync(acc_p, acc, ldacc, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  const int rows = S - k0 < kt ? S - k0 : kt;
  write_grad_rows(row_of<bf16>(dk, b, h, k0), dk.ss, sDK, ldacc, rows, Dh, cos_t, sin_t, k0);
  write_grad_rows(row_of<bf16>(dv, b, h, k0), dv.ss, sDV, ldacc, rows, Dh, nullptr, nullptr, 0);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Operand t of (B, S, H·Dh) rows `row` elements apart, starting `offset`
// elements into base: the packed qkv's q, k, v (row 3D, offsets 0, D, 2D)
// and the packed path's o and dO (row D).
Operand bsd(const void* base, int64_t offset, int64_t row, int S, int Dh) {
  return {static_cast<bf16*>(const_cast<void*>(base)) + offset, S * row, Dh, row};
}

// The forward: o, and the probabilities where probs is not null.
int launch_fwd(const Operand& q, const Operand& k, const Operand& v, const void* mask,
               const void* cos_t, const void* sin_t, const Operand& o, void* probs, int B, int S,
               int H, int Dh, float scale, cudaStream_t stream) {
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  int QT = 64;  // query rows per block; fewer when K/V of the head fill shared memory
  while (QT > 16 && AttnSmem(Sp, Dp, QT).total > kMaxSmem) QT /= 2;
  const size_t bytes = AttnSmem(Sp, Dp, QT).total;
  if (bytes > kMaxSmem || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(short_attn_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + QT - 1) / QT, H, B);
  short_attn_kernel<<<grid, kAttnThreads, bytes, stream>>>(
      q, k, v, static_cast<const uint8_t*>(mask), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), o, static_cast<bf16*>(probs), S, H, Dh, scale, QT);
  return static_cast<int>(cudaGetLastError());
}

// The dQ and dK/dV launches; probs null = recompute mode (o, mask read),
// else saved mode.
template <bool kSaved>
int launch_bwd_pair(const Operand& q, const Operand& k, const Operand& v, const void* mask,
                    const void* cos_t, const void* sin_t, const Operand& o, const void* probs,
                    const Operand& dout, void* stats, const Operand& dq, const Operand& dk,
                    const Operand& dv, int B, int S, int H, int Dh, float scale,
                    cudaStream_t stream) {
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  const int QT = bwd_dq_rows(Sp, Dp, kSaved);
  int KT, QT2;
  bwd_dkv_rows(Sp, Dp, kSaved, &KT, &QT2);
  if (QT == 0 || KT == 0 || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes_q = BwdQSmem(Sp, Dp, QT, kSaved).total;
  const size_t bytes_kv = BwdKVSmem(KT, Dp, QT2, kSaved).total;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const bf16* pr = static_cast<const bf16*>(probs);
  float* st = static_cast<float*>(stats);
  // 8 warps where a block's tiles fit half the SM (two blocks an SM), else 16
  const auto dq_launch = [&](auto kernel, int threads) {
    cudaError_t e = allow_smem(kernel, bytes_q);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((S + QT - 1) / QT, H, B), threads, bytes_q, stream>>>(
        q, k, v, m, c, s, o, pr, dout, st, dq, S, H, Dh, scale, QT);
    return cudaGetLastError();
  };
  const auto dkv_launch = [&](auto kernel, int threads) {
    cudaError_t e = allow_smem(kernel, bytes_kv);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((S + KT - 1) / KT, H, B), threads, bytes_kv, stream>>>(
        q, k, v, m, c, s, pr, dout, st, dk, dv, S, H, Dh, scale, KT, QT2);
    return cudaGetLastError();
  };
  cudaError_t err = bytes_q <= kHalfSmem ? dq_launch(short_attn_bwd_dq_kernel<kSaved, 256>, 256)
                                         : dq_launch(short_attn_bwd_dq_kernel<kSaved, 512>, 512);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bytes_kv <= kHalfSmem ? dkv_launch(short_attn_bwd_dkv_kernel<kSaved, 256>, 256)
                              : dkv_launch(short_attn_bwd_dkv_kernel<kSaved, 512>, 512);
  return static_cast<int>(err);
}

// The recompute-mode backward: one block a head where its layout fits, else
// the dQ and dK/dV launches.
int launch_bwd_recompute(const Operand& q, const Operand& k, const Operand& v, const void* mask,
                         const void* cos_t, const void* sin_t, const Operand& o,
                         const Operand& dout, void* stats, const Operand& dq, const Operand& dk,
                         const Operand& dv, int B, int S, int H, int Dh, float scale,
                         cudaStream_t stream) {
  const int QT = bwd_head_rows(round_up(S, 16), round_up(Dh, 16));
  if (QT == 0)
    return launch_bwd_pair<false>(q, k, v, mask, cos_t, sin_t, o, nullptr, dout, stats, dq, dk,
                                  dv, B, S, H, Dh, scale, stream);
  if (B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = BwdHeadSmem(round_up(S, 16), round_up(Dh, 16), QT).total;
  cudaError_t err = allow_smem(short_attn_bwd_head_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  short_attn_bwd_head_kernel<<<dim3(H, B), kHeadThreads, bytes, stream>>>(
      q, k, v, static_cast<const uint8_t*>(mask), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), o, dout, dq, dk, dv, S, Dh, scale, QT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// Packed qkv (B, S, 3D) bf16; mask (B, S) uint8 or null; cos/sin (S, Dh/2)
// f32 or null (no RoPE); o (B, S, D) bf16; probs (B, H, S, S) bf16 or null
// (not saved). Requires Dh % 8 == 0, Dh <= 128, S <= 256.
extern "C" int short_attention_qkv_fwd(const void* qkv, const void* mask, const void* cos_t,
                                       const void* sin_t, void* o, void* probs, int B, int S,
                                       int H, int Dh, float scale, void* stream) {
  const int64_t D = int64_t(H) * Dh;
  return launch_fwd(bsd(qkv, 0, 3 * D, S, Dh), bsd(qkv, D, 3 * D, S, Dh),
                    bsd(qkv, 2 * D, 3 * D, S, Dh), mask, cos_t, sin_t, bsd(o, 0, D, S, Dh), probs,
                    B, S, H, Dh, scale, static_cast<cudaStream_t>(stream));
}

// Backward of short_attention_qkv_fwd from its residuals, recompute mode:
// qkv, mask, cos/sin as there; o (B, S, D) bf16 the forward's output; dout
// (B, S, D) bf16 its cotangent; stats (B, H, 3, S) f32 scratch (read only by
// the two-launch split); dqkv (B, S, 3D) bf16 out.
extern "C" int short_attention_qkv_bwd(const void* qkv, const void* mask, const void* cos_t,
                                       const void* sin_t, const void* o, const void* dout,
                                       void* stats, void* dqkv, int B, int S, int H, int Dh,
                                       float scale, void* stream) {
  const int64_t D = int64_t(H) * Dh;
  return launch_bwd_recompute(
      bsd(qkv, 0, 3 * D, S, Dh), bsd(qkv, D, 3 * D, S, Dh), bsd(qkv, 2 * D, 3 * D, S, Dh), mask,
      cos_t, sin_t, bsd(o, 0, D, S, Dh), bsd(dout, 0, D, S, Dh), stats,
      bsd(dqkv, 0, 3 * D, S, Dh), bsd(dqkv, D, 3 * D, S, Dh), bsd(dqkv, 2 * D, 3 * D, S, Dh), B,
      S, H, Dh, scale, static_cast<cudaStream_t>(stream));
}

// The same from the saved probabilities (B, H, S, S) bf16 instead of o and
// the mask (saved mode).
extern "C" int short_attention_qkv_bwd_probs(const void* qkv, const void* cos_t,
                                             const void* sin_t, const void* probs,
                                             const void* dout, void* stats, void* dqkv, int B,
                                             int S, int H, int Dh, float scale, void* stream) {
  const int64_t D = int64_t(H) * Dh;
  const Operand none{nullptr, 0, 0, 0};
  return launch_bwd_pair<true>(
      bsd(qkv, 0, 3 * D, S, Dh), bsd(qkv, D, 3 * D, S, Dh), bsd(qkv, 2 * D, 3 * D, S, Dh),
      nullptr, cos_t, sin_t, none, probs, bsd(dout, 0, D, S, Dh), stats,
      bsd(dqkv, 0, 3 * D, S, Dh), bsd(dqkv, D, 3 * D, S, Dh), bsd(dqkv, 2 * D, 3 * D, S, Dh), B,
      S, H, Dh, scale, static_cast<cudaStream_t>(stream));
}

// Separate operands (fused_short_attention, fused_short_attention_heads):
// q, k, v, o, dout, dq, dk, dv bf16 operands of B batch rows, H heads, S rows
// of Dh elements (row pitch a multiple of 8 and 16-byte aligned rows for the
// outputs, which the wrapper allocates); no RoPE. mask (B, S) uint8 or null.
// The bounds are the packed entries'.
extern "C" int short_attention_sep_fwd(const Operand* q, const Operand* k, const Operand* v,
                                       const void* mask, const Operand* o, int B, int S, int H,
                                       int Dh, float scale, void* stream) {
  return launch_fwd(*q, *k, *v, mask, nullptr, nullptr, *o, nullptr, B, S, H, Dh, scale,
                    static_cast<cudaStream_t>(stream));
}

// The saving forward: also the probabilities (B, H, S, S) bf16.
extern "C" int short_attention_sep_fwd_save(const Operand* q, const Operand* k, const Operand* v,
                                            const void* mask, const Operand* o, void* probs, int B,
                                            int S, int H, int Dh, float scale, void* stream) {
  return launch_fwd(*q, *k, *v, mask, nullptr, nullptr, *o, probs, B, S, H, Dh, scale,
                    static_cast<cudaStream_t>(stream));
}

// The recompute backward from o (the forward's output) and dout (its
// cotangent); stats (B, H, 3, S) f32 scratch; dq, dk, dv out.
extern "C" int short_attention_sep_bwd(const Operand* q, const Operand* k, const Operand* v,
                                       const void* mask, const Operand* o, const Operand* dout,
                                       void* stats, const Operand* dq, const Operand* dk,
                                       const Operand* dv, int B, int S, int H, int Dh,
                                       float scale, void* stream) {
  return launch_bwd_recompute(*q, *k, *v, mask, nullptr, nullptr, *o, *dout, stats, *dq, *dk,
                              *dv, B, S, H, Dh, scale, static_cast<cudaStream_t>(stream));
}

// The backward from the saved probabilities (B, H, S, S) bf16.
extern "C" int short_attention_sep_bwd_probs(const Operand* q, const Operand* k,
                                             const Operand* v, const void* probs,
                                             const Operand* dout, void* stats, const Operand* dq,
                                             const Operand* dk, const Operand* dv, int B, int S,
                                             int H, int Dh, float scale, void* stream) {
  const Operand none{nullptr, 0, 0, 0};
  return launch_bwd_pair<true>(*q, *k, *v, nullptr, nullptr, nullptr, none, probs, *dout, stats,
                               *dq, *dk, *dv, B, S, H, Dh, scale,
                               static_cast<cudaStream_t>(stream));
}

// Shared memory in bytes of the backward's dQ (kernel 0) or dK/dV (kernel 1)
// block at (S, Dh) in the given mode, or of the one-block-a-head recompute
// kernel's block (kernel 2); 0 where it does not fit.
extern "C" int short_attention_bwd_smem(int S, int Dh, int saved, int kernel) {
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  if (kernel == 2) {
    const int QT = bwd_head_rows(Sp, Dp);
    return QT == 0 ? 0 : static_cast<int>(BwdHeadSmem(Sp, Dp, QT).total);
  }
  if (kernel == 0) {
    const int QT = bwd_dq_rows(Sp, Dp, saved != 0);
    return QT == 0 ? 0 : static_cast<int>(BwdQSmem(Sp, Dp, QT, saved != 0).total);
  }
  int KT, QT;
  bwd_dkv_rows(Sp, Dp, saved != 0, &KT, &QT);
  return KT == 0 ? 0 : static_cast<int>(BwdKVSmem(KT, Dp, QT, saved != 0).total);
}

// x (M, K), w (N, K), bias (N), y (M, N), all bf16.
extern "C" int short_attention_out_proj(const void* x, const void* w, const void* bias, void* y,
                                        int M, int N, int K, void* stream) {
  return static_cast<int>(launch_dense_gemm<false>(x, w, bias, y, M, N, K, false,
                                                   static_cast<cudaStream_t>(stream)));
}
