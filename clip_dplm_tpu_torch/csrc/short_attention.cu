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
//   short_attn_fwd_kernel<Dp>: one block of two warpgroups per (128 query
//     rows, head, batch row), so at S <= 128 (the flagship, DPLM training
//     and the sampler) one block covers a whole head and K and V of the head
//     are read once; at 128 < S <= 256 two blocks do. One thread issues TMA
//     boxes (cp.async.bulk.tensor over a 4-D tensor map an operand, built
//     from its strides) for Q, K and the whole head's V into SW128-swizzled
//     tiles, completing on two mbarriers (Q with K, then V, whose copy runs
//     under the score product); a base or stride off 16 bytes stages by
//     elements instead. RoPE, where given, rotates q and k in place once
//     they land, in f32, rounded to bf16 (as the TPU kernel does). S = Q·K^T
//     and O = P·V are wgmma m64n64k16 (wgmma.cuh): Q and K K-major from
//     shared memory, P from registers, V MN-major. The softmax is the
//     reference's exact one in registers: s = S·scale + key bias (0, the
//     finite -1e30 of a masked key, -inf past S), m the max over every key
//     of the row (quad shuffles) before any exponential, p = expf(s − m)
//     rounded to bf16 for P·V with f32 accumulation, l = Σ p unrounded, and
//     o = bf16(O / max(l, 1e-30)). A thread holds its rows' whole score
//     row: 64 registers at S <= 128, where the instance fits 128 registers
//     and two blocks share an SM, 128 at S <= 256 (one block an SM;
//     recomputing the scores over the resident K instead, one pass for m and
//     one for P·V, was 17-27 % slower there: PERF.md, section 6).
//   dense_gemm_kernel (csrc/dense_gemm.cuh, shared with the fused Dense
//     block), packed path only: y = bf16(o·Wo^T + bo) with f32 accumulation,
//     Wo in (out, in) layout, the bias added before the one rounding.
//
// Bounds on the H100: at the flagship's (B=1024, S=128, D=512, H=8) the
// forward does 4·B·S²·D = 34 GFLOP (0.035 ms at 989 TFLOP/s) on 537 MB of
// q, k, v and o (0.16 ms at 3.35 TB/s), 805 MB with the probabilities: it is
// bound by memory, by a factor of 5-7. So K and V are read once a head, the
// copies cost the warps no instructions, and nothing but the probabilities
// and o leaves the registers on its way out.
//
// With a probabilities buffer (the saved mode of the TPU kernels, taken where
// a backward follows and the JAX package's size rule allows it) the kernel
// also writes bf16(p / l) of its query rows into a (B, H, S, S) buffer: p in
// f32, divided by l before the one rounding, as the TPU kernels' probs_ref,
// through a 64 x 64 staging tile a warpgroup so that rows leave in 16-byte
// stores. Both modes compute o by the same instructions, so o is equal bit
// for bit with and without it.
//
// Backward: replaces _bwd_kernel_qkv and _bwd_kernel in both of their modes,
// for every S <= 256 and Dh (a multiple of 8, <= 128) the forward takes. The
// out-projection's part of the packed TPU kernel (dO = dy·Wo^T) is the shared
// GEMM, launched by the wrapper; dWo and dbo are plain matmuls there, as the
// JAX package leaves them to XLA. The TPU kernels walk whole heads in VMEM.
// Each output is written once by one block (no atomics: two launches are
// equal byte for byte):
//
//   short_attn_bwd_block_kernel<Dp, NT, kSaved> (both modes at S <= 128: the
//     flagship's and DPLM's S = 128, DPLM's CLI at S = 64): one block of NT
//     warpgroups per (head, batch row), as the TPU kernel's one program a
//     head. Q, K, V, dO and the probabilities (saved mode) or o (recompute
//     mode) of the head arrive by TMA once. Recompute mode first forms delta
//     = rowsum(dO∘o) from o, then the forward's scores and exact softmax in
//     registers (the forward's score_tiles and softmax_tiles, query rows as
//     M), prob = p / l in f32, and writes bf16(prob) where o was; saved mode
//     reads the probabilities. dP (a key tile at a time in recompute mode,
//     where the f32 prob of every key tile holds the registers), delta (saved
//     mode: Σ dP·prob) and ds are formed once, in registers (wgmma, query
//     rows as M), and dQ = ds·K from them; dV = P^T·dO and dK = dS^T·Q take
//     the keys as M, reading P and then ds (written over P) transposed
//     through wgmma's MN-major A. At DPLM's training shape (B=256, S=128,
//     D=640, H=10) the saved call moves qkv, dO, the probabilities and dqkv,
//     ~377 MB (0.11 ms at 3.35 TB/s), and does four (S, S, Dh) products a
//     head, 21 GFLOP (0.02 ms at 989 TFLOP/s); the recompute call reads o
//     instead of the probabilities (335 MB) and does five products: memory
//     bounds both, so each byte is read once and the products and the
//     stores overlap.
//   short_attn_bwd_head_kernel (recompute mode at 128 < S where its layout
//     fits: S <= 208 at Dh = 64): one block of 16 warps per (head, batch
//     row) holds K, V and the f32 dK/dV of the whole head and walks the query
//     tiles on WMMA, recomputing the softmax as below.
//
// Past those bounds a head's f32 dK/dV does not fit one block's shared
// memory beside K and V, so the work is two launches:
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
// score product and the softmax and reads no o; the pair does its dP product
// twice (once a kernel), as the recompute mode does its score and dP
// products, on WMMA tiles through shared memory. Each launcher counts its
// calls by design (short_attention_saved_bwd_calls,
// short_attention_recompute_bwd_calls), what a check reads to show which
// kernels a call ran.

#include <string.h>

#include <initializer_list>

#include "dense_gemm.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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

// the dQ and dK/dV kernels: 8 warps a block, two blocks an SM where their
// tiles fit half of its shared memory, so that one block's staging overlaps
// the other's products; 16 warps where the tiles take one block an SM
// (PERF.md, the findings of slice 7). kBwdPair threads an SM either way.
constexpr int kBwdPair = 512;
constexpr size_t kHalfSmem = 115712;  // (228 KB per SM) / 2, less 1 KB reserved a block
// the WMMA one-block-a-head recompute backward: 16 warps, so that the one block
// an SM that its shared memory allows hides more of the latency of its
// serial phases (PERF.md, the findings of slice 3)
constexpr int kHeadThreads = 512;
constexpr int kHeadWarps = kHeadThreads / kWarp;


template <typename T = const bf16>
__device__ inline T* row_of(const Operand& t, int b, int h, int s) {
  return static_cast<T*>(t.p) + b * t.sb + h * t.sh + s * t.ss;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kMaxSeq = 256;
constexpr int kFwdThreads = 256;  // two warpgroups
constexpr int kFwdRows = 128;     // query rows of a block, 64 a warpgroup
constexpr int kKeyTile = 64;      // keys of one m64n64 score accumulator
constexpr unsigned kBox = 64 * 64 * sizeof(bf16);  // bytes of one 64 x 64 TMA box

// Shared memory of a forward block at n_kt key tiles and padded width Dp,
// as offsets from a 1024-byte-aligned base: the Q tile (128 x Dp), K and V
// of the whole head (n_kt·64 x Dp each), all SW128-swizzled (tma.cuh: swz);
// in saved mode a 64 x 64 staging tile of probabilities a warpgroup; the key
// bias; two mbarriers (Q with K, then V).
struct FwdSmem {
  size_t q, k, v, p, bias, bar, total;
  __host__ __device__ FwdSmem(int n_kt, int Dp, bool saved) {
    const size_t kv = size_t(n_kt) * kKeyTile * Dp * sizeof(bf16);
    q = 0;
    k = q + size_t(kFwdRows) * Dp * sizeof(bf16);
    v = k + kv;
    p = v + kv;
    bias = p + (saved ? 2 * size_t(kBox) : 0);
    bar = bias + size_t(n_kt) * kKeyTile * sizeof(float);
    total = bar + 2 * sizeof(uint64_t) + 1024;  // + the base's alignment
  }
};

// Rows [r0, r0 + rows) of head h of batch row b of operand t into a swizzled
// rows x Dp tile by element loads, for what TMA cannot take (a base or a
// stride off 16 bytes); rows past n_valid and columns in [Dh, Dp) are zero.
template <int Dp>
__device__ inline void stage_operand(bf16* dst, const Operand& t, int b, int h, int r0, int rows,
                                     int n_valid, int Dh) {
  for (int idx = threadIdx.x; idx < rows * Dp; idx += blockDim.x) {
    const int r = idx / Dp, d = idx % Dp;
    dst[swz(rows, r, d)] =
        (r < n_valid && d < Dh) ? row_of(t, b, h, r0 + r)[d] : __float2bfloat16(0.f);
  }
}

// One 64 x 64 box of an operand's 4-D tensor map, whose dimensions are
// (Dh, H, S, B) where head_inner, else (Dh, S, H, B).
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map, bool head_inner,
                                         int col, int row, int h, int b, uint64_t* bar) {
  if (head_inner)
    tma_box_4d(dst, map, col, h, row, b, bar);
  else
    tma_box_4d(dst, map, col, row, h, b, bar);
}

// Rotate-half RoPE in place over rows [r0, r1) of a swizzled rows x Dp tile
// and, where tile2 is given, the same rows of tile2 (rows2 x Dp) with the same
// cos/sin (q and k at the same positions), row r at position pos0 + r:
// [t1·cos − t2·sin, t2·cos + t1·sin] in f32, rounded to bf16, the arithmetic
// of stage_rows (common.cuh).
__device__ inline void rope_in_place(bf16* tile, int rows, bf16* tile2, int rows2, int r0, int r1,
                                     int Dh, const float* cos_t, const float* sin_t, int pos0) {
  const int half = Dh / 2;
  if (half % 8 == 0) {
    const int cpr = half / 8;  // 8-element chunks per half row
    for (int idx = threadIdx.x; idx < (r1 - r0) * cpr; idx += blockDim.x) {
      const int r = r0 + idx / cpr, d0 = (idx % cpr) * 8;
      float c[8], sn[8];
      const float4* cp = reinterpret_cast<const float4*>(cos_t + size_t(pos0 + r) * half + d0);
      const float4* sp = reinterpret_cast<const float4*>(sin_t + size_t(pos0 + r) * half + d0);
      *reinterpret_cast<float4*>(c) = cp[0];
      *reinterpret_cast<float4*>(c + 4) = cp[1];
      *reinterpret_cast<float4*>(sn) = sp[0];
      *reinterpret_cast<float4*>(sn + 4) = sp[1];
      for (int which = 0; which < 2; ++which) {
        bf16* t = which == 0 ? tile : tile2;
        if (t == nullptr) continue;
        const int n = which == 0 ? rows : rows2;
        bf16* p1 = t + swz(n, r, d0);
        bf16* p2 = t + swz(n, r, half + d0);
        float a[8], bb[8], lo[8], hi[8];
        load8(p1, a);
        load8(p2, bb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          lo[e] = a[e] * c[e] - bb[e] * sn[e];
          hi[e] = bb[e] * c[e] + a[e] * sn[e];
        }
        store8(p1, lo);
        store8(p2, hi);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < (r1 - r0) * half; idx += blockDim.x) {
      const int r = r0 + idx / half, i = idx % half;
      const float c = cos_t[size_t(pos0 + r) * half + i];
      const float sn = sin_t[size_t(pos0 + r) * half + i];
      for (int which = 0; which < 2; ++which) {
        bf16* t = which == 0 ? tile : tile2;
        if (t == nullptr) continue;
        const int n = which == 0 ? rows : rows2;
        bf16* p1 = t + swz(n, r, i);
        bf16* p2 = t + swz(n, r, half + i);
        const float x1 = __bfloat162float(*p1), x2 = __bfloat162float(*p2);
        *p1 = __float2bfloat16(x1 * c - x2 * sn);
        *p2 = __float2bfloat16(x2 * c + x1 * sn);
      }
    }
  }
}

// s[j] = Q·K^T of key tile j (those below n_kt) for the warpgroup's 64 rows
// (qw: its rows of the QRows x Dp Q tile), both operands K-major from shared
// memory, then s·scale + the key bias.
template <int Dp, int NT, int QRows = kFwdRows>
__device__ __forceinline__ void score_tiles(float (&s)[NT][32], const bf16* qw, const bf16* sK,
                                            const float* sBias, int n_kt, int Sp, int Dh,
                                            float scale, int t) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_kt) continue;
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {
      if (kk * 16 >= Dh) continue;
      const int col = (kk % 4) * 16;  // a k16 step inside the 64-wide block kk / 4
      wgmma_m64n64k16_ss(s[j], gmma_desc(qw + (kk / 4) * QRows * 64 + col, 16, 1024),
                         gmma_desc(sK + (kk / 4) * Sp * 64 + j * kKeyTile * 64 + col, 16, 1024),
                         kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(s[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_kt) continue;
    const float* tb = sBias + j * kKeyTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(tb + 8 * n + 2 * t);
      s[j][4 * n] = fmaf(s[j][4 * n], scale, bb.x);
      s[j][4 * n + 1] = fmaf(s[j][4 * n + 1], scale, bb.y);
      s[j][4 * n + 2] = fmaf(s[j][4 * n + 2], scale, bb.x);
      s[j][4 * n + 3] = fmaf(s[j][4 * n + 3], scale, bb.y);
    }
  }
}

// The row max m over every key, then p = expf(s − m) in place and l = Σ p
// (unrounded) of rows g and g+8, each reduced over the quad of lanes that
// holds the row; l at least 1e-30.
template <int NT>
__device__ __forceinline__ void softmax_tiles(float (&s)[NT][32], int n_kt, float (&l)[2]) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_kt) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        m[i] = fmaxf(m[i], fmaxf(s[j][4 * n + 2 * i], s[j][4 * n + 2 * i + 1]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    l[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_kt) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[j][4 * n + 2 * i] = expf(s[j][4 * n + 2 * i] - m[i]);
        s[j][4 * n + 2 * i + 1] = expf(s[j][4 * n + 2 * i + 1] - m[i]);
        l[i] += s[j][4 * n + 2 * i] + s[j][4 * n + 2 * i + 1];
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
}

// O = P·V over the key tiles: P from registers (the S accumulator of n-tiles
// 2kk, 2kk+1 of key tile j, rounded to bf16, is the A fragment of its kk-th
// 16 keys), V MN-major from shared memory.
template <int Dp, int NT>
__device__ __forceinline__ void pv_tiles(float (&acc)[Dp / 64][32], const float (&s)[NT][32],
                                         const bf16* sV, int n_kt, int Sp, int Dh) {
#pragma unroll
  for (int nb = 0; nb < Dp / 64; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  uint32_t pa[NT][4][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_kt) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[j][kk][0] = pack_bf16(s[j][8 * kk], s[j][8 * kk + 1]);
      pa[j][kk][1] = pack_bf16(s[j][8 * kk + 2], s[j][8 * kk + 3]);
      pa[j][kk][2] = pack_bf16(s[j][8 * kk + 4], s[j][8 * kk + 5]);
      pa[j][kk][3] = pack_bf16(s[j][8 * kk + 6], s[j][8 * kk + 7]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_kt) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < Dp / 64; ++nb)
        if (nb * 64 < Dh)
          wgmma_m64n64k16_rs<1>(
              acc[nb], pa[j][kk],
              gmma_desc(sV + nb * Sp * 64 + (j * kKeyTile + kk * 16) * 64, Sp * 128, 1024), true);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < Dp / 64; ++nb) fence_regs(acc[nb]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[j][kk]);  // A stays put until the wait
}

// p / l for p in [0, 1] and l in [1, 256] (l sums exp(s − m), the row max
// giving 1), from r = 1 / l correctly rounded: q = p·r, then one correction
// by the residual p − q·l, exact in an FMA, which makes q the correctly
// rounded quotient wherever it is a normal number (Markstein's theorem);
// the division's own instruction sequence cost the saving forward ~30 %.
__device__ __forceinline__ float div_by(float p, float l, float r) {
  const float q = p * r;
  return fmaf(fmaf(-q, l, p), r, q);
}

// bf16(p / l) of the key tiles into the warpgroup's rows of the
// probabilities (prow: its first row; rows_valid of its 64 rows below S):
// through the warpgroup's 64 x 64 staging tile sPw, so that rows leave in
// 16-byte stores (vec: S % 8 == 0), element stores otherwise.
template <int NT>
__device__ __forceinline__ void write_probs(const float (&s)[NT][32], int n_kt,
                                            const float (&l)[2], bf16* sPw, bf16* prow,
                                            int rows_valid, int S, bool vec, int wg, int wrow,
                                            int g, int t) {
  const int ltid = threadIdx.x % 128;
  const float r[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= n_kt) continue;
    wg_sync(wg);  // the last tile's reads of sPw are done
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(sPw + swz(64, wrow + g + 8 * i, 8 * n + 2 * t)) =
            pack_bf16(div_by(s[j][4 * n + 2 * i], l[i], r[i]),
                      div_by(s[j][4 * n + 2 * i + 1], l[i], r[i]));
    wg_sync(wg);
    const int c0 = j * kKeyTile;
    for (int idx = ltid; idx < 64 * 8; idx += 128) {
      const int rr = idx >> 3, col = c0 + 8 * (idx & 7);
      if (rr >= rows_valid || col >= S) continue;
      const bf16* src = sPw + swz(64, rr, col - c0);
      bf16* dst = prow + size_t(rr) * S + col;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && col + e < S; ++e) dst[e] = src[e];
      }
    }
  }
}

// One block per (128 query rows, head, batch row); a warpgroup owns 64 of
// the rows. NT: the key tiles of 64 a thread holds the scores of, 2 (S <=
// 128: 64 registers, so that the instance fits 128 and two blocks an SM) or
// 4 (S <= 256). tma: q, k, v arrive by TMA through the tensor maps; else by
// element loads. head_inner: bit i set where operand i's map is (Dh, H, S,
// B), else (Dh, S, H, B).
template <int Dp, int NT>
__global__ void __launch_bounds__(kFwdThreads, 1)
short_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Operand q, const Operand k,
                      const Operand v, const uint8_t* __restrict__ mask,
                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                      const Operand o, bf16* __restrict__ probs, int S, int H, int Dh, float scale,
                      bool tma, int head_inner) {
  constexpr int kBlocks = Dp / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_kt = (S + kKeyTile - 1) / kKeyTile, Sp = n_kt * kKeyTile;
  const FwdSmem lay(n_kt, Dp, probs != nullptr);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);

  const int q0 = blockIdx.x * kFwdRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % kWarp, row0 = (tid / kWarp) * 16;
  const int g = lane >> 2, t = lane & 3;  // the accumulator's row group and column pair
  const int q_rows = S - q0 < kFwdRows ? S - q0 : kFwdRows;  // query rows below S
  const int n_blk = (Dh + 63) / 64;  // 64-column blocks holding a column below Dh

  // Q and K on bar[0], V on bar[1], each box issued once by one thread: K
  // and V of the head are read once for all 128 rows
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    mbar_fence_init();
    if (tma) {
      const int q_boxes = (q_rows + 63) / 64;  // no box for a warpgroup with no row
      mbar_expect_tx(&bar[0], unsigned(q_boxes + n_kt) * n_blk * kBox);
      for (int blk = 0; blk < n_blk; ++blk) {
        for (int rt = 0; rt < q_boxes; ++rt)
          tma_rows(sQ + blk * kFwdRows * 64 + rt * 64 * 64, &tm_q, head_inner & 1, blk * 64,
                   q0 + rt * 64, h, b, &bar[0]);
        for (int kt = 0; kt < n_kt; ++kt)
          tma_rows(sK + blk * Sp * 64 + kt * 64 * 64, &tm_k, head_inner & 2, blk * 64, kt * 64,
                   h, b, &bar[0]);
      }
      mbar_expect_tx(&bar[1], unsigned(n_kt) * n_blk * kBox);
      for (int blk = 0; blk < n_blk; ++blk)
        for (int kt = 0; kt < n_kt; ++kt)
          tma_rows(sV + blk * Sp * 64 + kt * 64 * 64, &tm_v, head_inner & 4, blk * 64, kt * 64,
                   h, b, &bar[1]);
    }
  }
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
  for (int j = tid; j < Sp; j += kFwdThreads) sBias[j] = key_bias(mask_row, j, S);
  if (!tma) {
    stage_operand<Dp>(sQ, q, b, h, q0, kFwdRows, q_rows, Dh);
    stage_operand<Dp>(sK, k, b, h, 0, Sp, S, Dh);
    stage_operand<Dp>(sV, v, b, h, 0, Sp, S, Dh);
    fence_proxy_async();  // st.shared, read by wgmma
  }
  __syncthreads();  // the barriers' init, the bias, the element-staged tiles
  if (tma) mbar_wait(&bar[0], 0);
  if (cos_t != nullptr) {  // RoPE on q and k, in place; one cos/sin read for both
    if (q0 == 0) {            // where their rows share positions
      rope_in_place(sQ, kFwdRows, sK, Sp, 0, q_rows, Dh, cos_t, sin_t, 0);
      rope_in_place(sK, Sp, nullptr, 0, q_rows, S, Dh, cos_t, sin_t, 0);
    } else {
      rope_in_place(sQ, kFwdRows, nullptr, 0, 0, q_rows, Dh, cos_t, sin_t, q0);
      rope_in_place(sK, Sp, nullptr, 0, 0, S, Dh, cos_t, sin_t, 0);
    }
    fence_proxy_async();
    __syncthreads();
  }
  if (wg * 64 >= q_rows) return;  // a warpgroup with no query row; no block barrier follows

  // The reference's exact softmax over all keys, in registers: a thread
  // holds its rows' whole score row, NT key tiles of 64.
  const bf16* qw = sQ + wg * 64 * 64;  // the warpgroup's rows of each 64-column block
  float s[NT][32], l[2];
  score_tiles<Dp, NT>(s, qw, sK, sBias, n_kt, Sp, Dh, scale, t);
  softmax_tiles(s, n_kt, l);
  if (probs != nullptr) {
    const int rows_valid = q_rows - wg * 64 < 64 ? q_rows - wg * 64 : 64;
    bf16* sPw = reinterpret_cast<bf16*>(smem + lay.p) + wg * 64 * 64;
    bf16* prow = probs + ((size_t(b) * H + h) * S + q0 + wg * 64) * size_t(S);
    write_probs(s, n_kt, l, sPw, prow, rows_valid, S, S % 8 == 0, wg, (tid / kWarp % 4) * 16, g,
                t);
  }
  if (tma) mbar_wait(&bar[1], 0);
  float acc[kBlocks][32];  // O, one m64n64 accumulator per 64-wide block of d
  pv_tiles<Dp, NT>(acc, s, sV, n_kt, Sp, Dh);

  // o = O / l in bf16 through this warp's own rows of sQ (the warpgroup's
  // products that read them are done), then 16-byte stores (Dh % 8 == 0,
  // 16-byte-aligned rows of o)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / l[i];
    const int r = row0 + g + 8 * i;
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (nb * 64 + n * 8 < Dh)
          *reinterpret_cast<uint32_t*>(sQ + swz(kFwdRows, r, nb * 64 + 8 * n + 2 * t)) =
              pack_bf16(acc[nb][4 * n + 2 * i] * inv, acc[nb][4 * n + 2 * i + 1] * inv);
  }
  __syncwarp();
  const int chunks = Dh / 8;
  for (int idx = lane; idx < 16 * chunks; idx += kWarp) {
    const int r = idx / chunks, c = idx % chunks, i = q0 + row0 + r;
    if (i >= S) continue;
    *reinterpret_cast<uint4*>(row_of<bf16>(o, b, h, i) + 8 * c) =
        *reinterpret_cast<const uint4*>(sQ + swz(kFwdRows, row0 + r, 8 * c));
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

// ---------------------------------------------------------------------------
// Backward in either mode, one block a head (S <= 128)
// ---------------------------------------------------------------------------

constexpr int kBlockMaxSeq = 128;  // the one-block backward's bound: two key tiles

// Shared memory of a block of short_attn_bwd_block_kernel at R = 64·NT rows
// (query rows and keys alike) and padded width Dp, as offsets from a
// 1024-byte-aligned base: Q, K, V and dO of the head (R x Dp each), then the
// probabilities (R x R, query rows by keys), all SW128-swizzled, then, in
// recompute mode, the key bias, and one mbarrier. In recompute mode o (R x
// Dp) lands where the probabilities go, which are written over it once delta
// has read it (the region takes the larger of the two: o at R = 64, Dp =
// 128). ds takes the probabilities' place once dV has read them, and K and
// V, side by side, take each f32 output tile on its way out. Python mirrors
// it in ops/short_attention.py::_block_smem_bytes.
struct BwdBlockSmem {
  size_t q, k, v, dout, p, bias, bar, total;
  __host__ __device__ BwdBlockSmem(int NT, int Dp, bool saved) {
    const size_t tile = size_t(NT) * 64 * Dp * sizeof(bf16);
    const size_t probs = size_t(NT) * 64 * NT * 64 * sizeof(bf16);
    q = 0;
    k = tile;
    v = 2 * tile;
    dout = 3 * tile;
    p = 4 * tile;
    bias = p + (saved || probs >= tile ? probs : tile);
    bar = bias + (saved ? 0 : size_t(NT) * 64 * sizeof(float));
    total = bar + sizeof(uint64_t) + 1024;  // + the base's alignment
  }
};

// Element (r, c) of an R x Dp f32 staging tile: row-major, the 8-column
// groups of row r XOR-ed with r % 4, so that the accumulators' float2 stores
// (eight rows a warp) take two wavefronts and a row's 8-column group stays
// contiguous.
template <int Dp>
__device__ __forceinline__ int stage_at(int r, int c) {
  return r * Dp + (c ^ ((r & 3) << 3));
}

// The warp's 16 rows (r0 .. r0+15) of m64n64 accumulators acc[nb] (columns
// nb·64 ..) into the f32 staging tile; columns past Dh are skipped.
template <int Dp>
__device__ __forceinline__ void stage_acc(float* st, const float (&acc)[Dp / 64][32], int r0, int g,
                                          int t, int Dh) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nb = 0; nb < Dp / 64; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (nb * 64 + 8 * n < Dh)
          *reinterpret_cast<float2*>(st + stage_at<Dp>(r0 + g + 8 * i, nb * 64 + 8 * n + 2 * t)) =
              make_float2(acc[nb][4 * n + 2 * i], acc[nb][4 * n + 2 * i + 1]);
}

// Rows [0, n_rows) of the f32 staging tile to bf16 rows of head h of batch
// row b of operand t, eight columns a thread (16-byte stores; Dh % 8 == 0);
// with cos/sin, through the inverse rotate-half RoPE first, row r at
// position r, in f32: write_grad_rows' arithmetic. Where the half width is a
// multiple of 8, a thread takes a chunk of each half, so that its cos/sin
// come in four 16-byte loads.
template <int Dp>
__device__ inline void write_staged(const Operand& t, int b, int h, const float* st, int n_rows,
                                    int Dh, const float* cos_t, const float* sin_t) {
  const int half = Dh / 2;
  const auto load8f = [&](int r, int d, float* v) {  // 8 contiguous columns from d
    const float4* src = reinterpret_cast<const float4*>(st + stage_at<Dp>(r, d));
    *reinterpret_cast<float4*>(v) = src[0];
    *reinterpret_cast<float4*>(v + 4) = src[1];
  };
  if (cos_t != nullptr && half % 8 == 0) {
    const int cph = half / 8;  // 8-column chunks a half row
    for (int idx = threadIdx.x; idx < n_rows * cph; idx += blockDim.x) {
      const int r = idx / cph, d0 = (idx % cph) * 8;
      float lo[8], hi[8], c[8], sn[8], o1[8], o2[8];
      const float4* cp = reinterpret_cast<const float4*>(cos_t + size_t(r) * half + d0);
      const float4* sp = reinterpret_cast<const float4*>(sin_t + size_t(r) * half + d0);
      *reinterpret_cast<float4*>(c) = cp[0];
      *reinterpret_cast<float4*>(c + 4) = cp[1];
      *reinterpret_cast<float4*>(sn) = sp[0];
      *reinterpret_cast<float4*>(sn + 4) = sp[1];
      load8f(r, d0, lo);
      load8f(r, d0 + half, hi);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o1[e] = lo[e] * c[e] + hi[e] * sn[e];
        o2[e] = hi[e] * c[e] - lo[e] * sn[e];
      }
      bf16* row = row_of<bf16>(t, b, h, r);
      store8(row + d0, o1);
      store8(row + half + d0, o2);
    }
    return;
  }
  const int cpr = Dh / 8;
  for (int idx = threadIdx.x; idx < n_rows * cpr; idx += blockDim.x) {
    const int r = idx / cpr, d0 = (idx % cpr) * 8;
    float v[8], w[8];
    load8f(r, d0, v);
    if (cos_t != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = d0 + e, i = d < half ? d : d - half;
        const size_t p = size_t(r) * half + i;
        const float other = st[stage_at<Dp>(r, d < half ? d + half : i)];
        w[e] = d < half ? v[e] * cos_t[p] + other * sin_t[p] : v[e] * cos_t[p] - other * sin_t[p];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = w[e];
    }
    store8(row_of<bf16>(t, b, h, r) + d0, v);
  }
}

// One block a head (h, b) for S <= 128: the TPU kernels' backward, dp =
// dO·V^T, delta (saved mode: Σ dp·prob over the row's keys; recompute mode:
// Σ dO·o over the row's columns), ds = bf16(prob·(dp − delta)·scale), dq =
// ds·K, dk = ds^T·Q, dv = bf16(prob)^T·dO, each operand read from device
// memory once. Recompute mode takes prob = p / l in f32 from the forward's
// scores and softmax, recomputed in registers; saved mode reads bf16 prob.
// NT warpgroups (one a 64-row tile, R = 64·NT rows): Q, K, V, dO and the
// probabilities or o arrive by TMA behind one mbarrier (tma: the 4-D operand
// maps, head_inner as in the forward, o's the fifth, tm_x; tma_p, saved mode:
// the probabilities' 3-D map in tm_x, S % 8 == 0), or by element loads into
// the same layout; RoPE, where given, rotates q and k in place. The
// transposed A of dV and dK is read by the descriptor (wgmma's MN-major A)
// rather than through ldmatrix.trans into registers: it costs no instruction
// or register, which keeps Dp = 64 at 128 registers and two blocks an SM.
//   query-major: warpgroup w takes query rows 64w..64w+63; recompute mode:
//     the scores (SS, every key tile), the softmax and the f32 prob in
//     registers, bf16(prob) stored where o was; dP (SS) in registers, of
//     every key tile (saved mode) or one at a time (recompute mode); delta by
//     quad shuffles; ds in registers, rounded to bf16 as the A fragment of
//     dQ = ds·K (K MN-major);
//   key-major: warpgroup w takes keys 64w..64w+63; dV = P^T·dO, then, with
//     ds written over the probabilities, dK = dS^T·Q: A MN-major (the
//     transpose bit), dO and Q MN-major.
// Each output leaves its accumulators through the f32 staging tile over K
// and V (the inverse RoPE there for dQ and dK) and is written once, rows in
// 16-byte stores, dQ's under the dV products and dV's under the dK products;
// no atomics. Padding rows and keys (past S) are zero in Q, K, V, dO and o
// and take the key bias −inf, so their ds is 0 with no mask.
template <int Dp, int NT, bool kSaved>
__global__ void __launch_bounds__(NT * 128, Dp == 64 ? 4 / NT : 1)
short_attn_bwd_block_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_x, const Operand q,
                            const Operand k, const Operand v, const Operand dout, const Operand o,
                            const bf16* __restrict__ probs, const uint8_t* __restrict__ mask,
                            const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                            const Operand dq, const Operand dk, const Operand dv, int S, int H,
                            int Dh, float scale, bool tma, bool tma_p, int head_inner) {
  constexpr int R = NT * 64, kBlocks = Dp / 64;
  constexpr int kOps = kSaved ? 4 : 5;  // operands by the 4-D maps: q, k, v, dO (and o)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const BwdBlockSmem lay(NT, Dp, kSaved);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);  // (o, then) the probabilities, then ds
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);  // recompute mode
  float* sStage = reinterpret_cast<float*>(smem + lay.k);  // K and V, once free
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % kWarp;
  const int r0 = (tid / kWarp) * 16;      // the warp's first accumulator row of the R rows
  const int g = lane >> 2, t = lane & 3;  // the accumulator's row group and column pair
  const int n_blk = (Dh + 63) / 64;       // 64-column blocks holding a column below Dh
  const size_t bh = size_t(b) * H + h;
  // RoPE with a half width a multiple of 8: an item is an 8-column chunk of
  // each half of row r of q and of k; this thread's items' cos/sin (at most
  // Dp/32: R rows x Dp/16 chunks over 2R threads) are read while the copies
  // land
  constexpr int kRopeItems = Dp / 32;
  const int half = Dh / 2, cph = Dh / 16;
  const bool rope8 = cos_t != nullptr && half % 8 == 0;
  float rc[kRopeItems][8], rs[kRopeItems][8];
  if (rope8) {
#pragma unroll
    for (int u = 0; u < kRopeItems; ++u) {
      const int idx = tid + u * NT * 128;
      if (idx >= S * cph) continue;
      const size_t at = size_t(idx / cph) * half + (idx % cph) * 8;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<float4*>(rc[u] + 4 * e) = reinterpret_cast<const float4*>(cos_t + at)[e];
        *reinterpret_cast<float4*>(rs[u] + 4 * e) = reinterpret_cast<const float4*>(sin_t + at)[e];
      }
    }
  }

  if (tid == 0) {
    mbar_init(bar);
    mbar_fence_init();
    if (tma || tma_p)
      mbar_expect_tx(bar, (tma ? unsigned(kOps) * NT * n_blk * kBox : 0u) +
                              (tma_p ? unsigned(NT) * R * 128 : 0u));
    if (tma) {
      const CUtensorMap* maps[5] = {&tm_q, &tm_k, &tm_v, &tm_do, &tm_x};
      bf16* tiles[5] = {sQ, sK, sV, sDO, sP};
#pragma unroll
      for (int i = 0; i < kOps; ++i)
        for (int blk = 0; blk < n_blk; ++blk)
          for (int rt = 0; rt < NT; ++rt)
            tma_rows(tiles[i] + blk * R * 64 + rt * 64 * 64, maps[i], head_inner & (1 << i),
                     blk * 64, rt * 64, h, b, bar);
    }
    if (tma_p) tma_tile<R>(sP, &tm_x, 0, int(bh), S, bar);  // NT boxes of 64 keys x R rows
  }
  if (!tma) {
    stage_operand<Dp>(sQ, q, b, h, 0, R, S, Dh);
    stage_operand<Dp>(sK, k, b, h, 0, R, S, Dh);
    stage_operand<Dp>(sV, v, b, h, 0, R, S, Dh);
    stage_operand<Dp>(sDO, dout, b, h, 0, R, S, Dh);
    if (!kSaved) stage_operand<Dp>(sP, o, b, h, 0, R, S, Dh);
  }
  if (!kSaved) {
    const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
    for (int j = tid; j < R; j += NT * 128) sBias[j] = key_bias(mask_row, j, S);
  } else if (!tma_p) {
    // the probabilities: zero outside S x S, as TMA's out-of-bounds fill; 8
    // loads in flight a thread
    constexpr int kThreads = NT * 128, kBatch = 8;
    static_assert(R * R % (kBatch * kThreads) == 0, "whole batches of loads");
    const bf16* ph = probs + bh * S * S;
    for (int base = tid; base < R * R; base += kBatch * kThreads) {
      bf16 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = (base + u * kThreads) / R, c = (base + u * kThreads) % R;
        x[u] = r < S && c < S ? ph[size_t(r) * S + c] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        sP[swz(R, (base + u * kThreads) / R, (base + u * kThreads) % R)] = x[u];
    }
  }
  if (!tma || !tma_p) fence_proxy_async();  // st.shared, read by wgmma
  __syncthreads();  // the barrier's init, the element-staged tiles
  if (tma || tma_p) mbar_wait(bar, 0);
  // recompute mode: delta = Σ dO·o over the row's columns (rows g and g+8,
  // the quad's lanes on alternate 8-column chunks, then reduced over the
  // quad), read before the probabilities are written over o
  float delta[2] = {0.f, 0.f};
  if constexpr (!kSaved) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      for (int c = t; c < Dh / 8; c += 4) {
        float x[8], y[8];
        load8(sDO + swz(R, r, 8 * c), x);
        load8(sP + swz(R, r, 8 * c), y);
#pragma unroll
        for (int e = 0; e < 8; ++e) delta[i] = fmaf(x[e], y[e], delta[i]);
      }
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
  }
  if (rope8) {  // in place, rope_in_place's arithmetic
#pragma unroll
    for (int u = 0; u < kRopeItems; ++u) {
      const int idx = tid + u * NT * 128;
      if (idx >= S * cph) continue;
      const int r = idx / cph, d0 = (idx % cph) * 8;
      bf16* tiles[2] = {sQ, sK};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        bf16* p1 = tiles[w] + swz(R, r, d0);
        bf16* p2 = tiles[w] + swz(R, r, half + d0);
        float a[8], bb[8], lo[8], hi[8];
        load8(p1, a);
        load8(p2, bb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          lo[e] = a[e] * rc[u][e] - bb[e] * rs[u][e];
          hi[e] = bb[e] * rc[u][e] + a[e] * rs[u][e];
        }
        store8(p1, lo);
        store8(p2, hi);
      }
    }
  } else if (cos_t != nullptr) {  // q and k at the same positions: one cos/sin read for both
    rope_in_place(sQ, R, sK, R, 0, S, Dh, cos_t, sin_t, 0);
  }
  if (cos_t != nullptr || !kSaved) {  // recompute mode: also every read of o is done
    fence_proxy_async();
    __syncthreads();
  }

  const bf16* dow = sDO + wg * 64 * 64;
  // ds in bf16 as the A fragments of its 16-key steps (accumulator n-tiles
  // 2kk, 2kk+1 of key tile j), kept until ds replaces the probabilities
  uint32_t ds[NT][4][4];
  if constexpr (kSaved) {
    // Query-major: dP = dO·V^T for the warpgroup's 64 rows over every key
    // tile, both operands K-major. Padding rows and keys are zero in dO, V
    // and the probabilities, so their ds is 0.
    float s[NT][32];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk) {
        if (kk * 16 >= Dh) continue;
        const int col = (kk % 4) * 16;  // a k16 step inside the 64-wide block kk / 4
        wgmma_m64n64k16_ss(s[j], gmma_desc(dow + (kk / 4) * R * 64 + col, 16, 1024),
                           gmma_desc(sV + (kk / 4) * R * 64 + j * 64 * 64 + col, 16, 1024),
                           kk > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(s[j]);

    // delta = Σ dP·prob over the row's keys (rows g and g+8, reduced over
    // the quad of lanes that holds them), then ds = prob·(dP − delta)·scale
    // in place
    const auto prob2 = [&](int j, int n, int i) {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          sP + swz(R, r0 + g + 8 * i, j * 64 + 8 * n + 2 * t)));
    };
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 p = prob2(j, n, i);
          delta[i] += s[j][4 * n + 2 * i] * p.x + s[j][4 * n + 2 * i + 1] * p.y;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 p = prob2(j, n, i);
          s[j][4 * n + 2 * i] = p.x * (s[j][4 * n + 2 * i] - delta[i]) * scale;
          s[j][4 * n + 2 * i + 1] = p.y * (s[j][4 * n + 2 * i + 1] - delta[i]) * scale;
        }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][kk][e] = pack_bf16(s[j][8 * kk + 2 * e], s[j][8 * kk + 2 * e + 1]);
  } else {
    // The forward's scores and exact softmax for the warpgroup's 64 rows over
    // every key tile, in its order; prob = p / l in f32 (div_by, as the
    // saving forward divides) kept in registers, and bf16(prob) written over
    // o, each thread where its accumulator entries sit (key tile j, n-tiles
    // 2kk and 2kk+1, rows g and g+8)
    float s[NT][32], l[2];
    score_tiles<Dp, NT, R>(s, sQ + wg * 64 * 64, sK, sBias, NT, R, Dh, scale, t);
    softmax_tiles<NT>(s, NT, l);
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * kk + 2 * e, i = e & 1;
          s[j][x] = div_by(s[j][x], l[i], rl[i]);
          s[j][x + 1] = div_by(s[j][x + 1], l[i], rl[i]);
          *reinterpret_cast<uint32_t*>(
              sP + swz(R, r0 + g + 8 * i, j * 64 + 16 * kk + 8 * (e >> 1) + 2 * t)) =
              pack_bf16(s[j][x], s[j][x + 1]);
        }
    fence_proxy_async();  // st.shared, read by the dV products after the next block barrier
    // dP = dO·V^T a key tile at a time, then that tile's ds = prob·(dP −
    // delta)·scale with the f32 prob, packed at once: the f32 prob of every
    // tile and one dP tile hold the registers, not two full sets
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Dp / 16; ++kk) {
        if (kk * 16 >= Dh) continue;
        const int col = (kk % 4) * 16;  // a k16 step inside the 64-wide block kk / 4
        wgmma_m64n64k16_ss(dp, gmma_desc(dow + (kk / 4) * R * 64 + col, 16, 1024),
                           gmma_desc(sV + (kk / 4) * R * 64 + j * 64 * 64 + col, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * kk + 2 * e, i = e & 1;
          ds[j][kk][e] = pack_bf16(s[j][x] * (dp[x] - delta[i]) * scale,
                                   s[j][x + 1] * (dp[x + 1] - delta[i]) * scale);
        }
    }
  }

  // dQ = ds·K: A from registers, K MN-major
  float acc[kBlocks][32];  // dQ, then dV, then dK: one m64n64 accumulator a 64-column block
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kBlocks; ++nb)
        if (nb * 64 < Dh)
          wgmma_m64n64k16_rs<1>(acc[nb], ds[j][kk],
                                gmma_desc(sK + nb * R * 64 + (j * 64 + kk * 16) * 64, R * 128,
                                          1024),
                                true);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) fence_regs(acc[nb]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(ds[j][kk]);  // A stays put until the wait
  __syncthreads();  // every product on K and V is done: they take the staging tile
  stage_acc<Dp>(sStage, acc, r0, g, t, Dh);
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) fence_regs(acc[nb]);
  __syncthreads();

  // Key-major: dV = P^T·dO for the warpgroup's 64 keys over every query row
  // (A: the warpgroup's 64-key column block of the probabilities, MN-major;
  // dO MN-major), issued before dQ leaves, whose stores it overlaps
  const bf16* pw = sP + wg * R * 64;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb)
      if (nb * 64 < Dh)
        wgmma_m64n64k16_ss<1, 1>(acc[nb], gmma_desc(pw + kk * 16 * 64, R * 128, 1024),
                                 gmma_desc(sDO + nb * R * 64 + kk * 16 * 64, R * 128, 1024),
                                 kk > 0);
  wgmma_commit();
  write_staged<Dp>(dq, b, h, sStage, S, Dh, cos_t, sin_t);
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) fence_regs(acc[nb]);
  __syncthreads();  // dQ has left the staging tile; no dV product reads the probabilities
  stage_acc<Dp>(sStage, acc, r0, g, t, Dh);
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) fence_regs(acc[nb]);
  // ds over the probabilities, each thread where it read them
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(sP + swz(R, r0 + g + 8 * (e & 1),
                                               j * 64 + 16 * kk + 8 * (e >> 1) + 2 * t)) =
            ds[j][kk][e];
  fence_proxy_async();  // st.shared, read by wgmma
  __syncthreads();

  // dK = dS^T·Q, as dV, issued before dV leaves
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb)
      if (nb * 64 < Dh)
        wgmma_m64n64k16_ss<1, 1>(acc[nb], gmma_desc(pw + kk * 16 * 64, R * 128, 1024),
                                 gmma_desc(sQ + nb * R * 64 + kk * 16 * 64, R * 128, 1024),
                                 kk > 0);
  wgmma_commit();
  write_staged<Dp>(dv, b, h, sStage, S, Dh, nullptr, nullptr);
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb) fence_regs(acc[nb]);
  __syncthreads();  // dV has left the staging tile
  stage_acc<Dp>(sStage, acc, r0, g, t, Dh);
  __syncthreads();
  write_staged<Dp>(dk, b, h, sStage, S, Dh, cos_t, sin_t);
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

// The forward at padded width Dp: o, and the probabilities where probs is
// not null. q, k, v go by TMA where every base is 16-byte aligned and every
// stride a positive multiple of 8 elements: a 4-D tensor map an operand,
// (Dh, S, H, B) or, where its head stride is the smaller (the packed qkv and
// its chunk views), (Dh, H, S, B); else by element loads.
// The 4-D tensor maps of n operands for 64 x 64 boxes: (Dh, S, H, B) or,
// where an operand's head stride is the smaller (the packed qkv and its chunk
// views), (Dh, H, S, B), with bit i of *head_inner set. False where a base or
// a stride is off 16 bytes (or not positive): the kernel then loads by
// elements.
bool operand_maps(const Operand* const* ops, int n, CUtensorMap* maps, int B, int S, int H,
                  int Dh, int* head_inner) {
  memset(maps, 0, n * sizeof(CUtensorMap));
  bool tma = true;
  *head_inner = 0;
  for (int i = 0; i < n && tma; ++i) {
    const Operand& t = *ops[i];
    tma = (reinterpret_cast<uintptr_t>(t.p) & 15) == 0 && t.sb > 0 && t.sh > 0 && t.ss > 0 &&
          (t.sb | t.sh | t.ss) % 8 == 0;
    const bool hi = t.sh < t.ss;
    const cuuint64_t dims[4] = {cuuint64_t(Dh), cuuint64_t(hi ? H : S), cuuint64_t(hi ? S : H),
                                cuuint64_t(B)};
    const cuuint64_t strides[3] = {cuuint64_t(hi ? t.sh : t.ss) * 2,
                                   cuuint64_t(hi ? t.ss : t.sh) * 2, cuuint64_t(t.sb) * 2};
    const cuuint32_t box[4] = {64, hi ? 1u : 64u, hi ? 64u : 1u, 1};
    tma = tma && tensor_map(&maps[i], t.p, 4, dims, strides, box);
    *head_inner |= int(hi) << i;
  }
  return tma;
}

template <int Dp>
int launch_fwd_dp(const Operand& q, const Operand& k, const Operand& v, const void* mask,
                  const void* cos_t, const void* sin_t, const Operand& o, void* probs, int B,
                  int S, int H, int Dh, float scale, cudaStream_t stream) {
  const Operand* ops[3] = {&q, &k, &v};
  CUtensorMap maps[3];
  int head_inner;
  const bool tma = operand_maps(ops, 3, maps, B, S, H, Dh, &head_inner);
  const int n_kt = (S + kKeyTile - 1) / kKeyTile;
  const size_t bytes = FwdSmem(n_kt, Dp, probs != nullptr).total;
  auto kernel = n_kt <= 2 ? short_attn_fwd_kernel<Dp, 2> : short_attn_fwd_kernel<Dp, 4>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kFwdRows - 1) / kFwdRows, H, B);
  kernel<<<grid, kFwdThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], q, k, v, static_cast<const uint8_t*>(mask),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), o,
      static_cast<bf16*>(probs), S, H, Dh, scale, tma, head_inner);
  return static_cast<int>(cudaGetLastError());
}

// The forward: o, and the probabilities where probs is not null. Requires
// 1 <= S <= 256, Dh a multiple of 8 up to 128, B and H <= 65535.
int launch_fwd(const Operand& q, const Operand& k, const Operand& v, const void* mask,
               const void* cos_t, const void* sin_t, const Operand& o, void* probs, int B, int S,
               int H, int Dh, float scale, cudaStream_t stream) {
  if (S < 1 || S > kMaxSeq || Dh < 8 || Dh % 8 || Dh > 128 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = Dh <= 64 ? launch_fwd_dp<64> : launch_fwd_dp<128>;
  return launch(q, k, v, mask, cos_t, sin_t, o, probs, B, S, H, Dh, scale, stream);
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

// The one-block backward at padded width Dp and NT key tiles (S <= 64·NT),
// either mode: q, k, v, dO and, in recompute mode, o by TMA where
// operand_maps maps them; saved mode: the probabilities by TMA where their
// row pitch S is a multiple of 8 elements and their base 16-byte aligned.
template <int Dp, int NT, bool kSaved>
int launch_bwd_block_dp(const Operand& q, const Operand& k, const Operand& v, const void* mask,
                        const void* cos_t, const void* sin_t, const Operand& o, const void* probs,
                        const Operand& dout, const Operand& dq, const Operand& dk,
                        const Operand& dv, int B, int S, int H, int Dh, float scale,
                        cudaStream_t stream) {
  const Operand* ops[5] = {&q, &k, &v, &dout, &o};
  CUtensorMap maps[5] = {};
  int head_inner;
  const bool tma = operand_maps(ops, kSaved ? 4 : 5, maps, B, S, H, Dh, &head_inner);
  const bool tma_p = kSaved && S % 8 == 0 && (reinterpret_cast<uintptr_t>(probs) & 15) == 0 &&
                     int64_t(B) * H <= INT32_MAX &&
                     tensor_map(&maps[4], probs, S, S, B * H, NT * 64);
  const size_t bytes = BwdBlockSmem(NT, Dp, kSaved).total;
  const auto kernel = short_attn_bwd_block_kernel<Dp, NT, kSaved>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), NT * 128, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], q, k, v, dout, o,
      static_cast<const bf16*>(probs), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), dq, dk, dv, S, H, Dh,
      scale, tma, tma_p, head_inner);
  return static_cast<int>(cudaGetLastError());
}

// The one-block backward's instance for (S, Dh): Dp = 64 or 128, one or two
// key tiles.
template <bool kSaved>
int launch_bwd_block(const Operand& q, const Operand& k, const Operand& v, const void* mask,
                     const void* cos_t, const void* sin_t, const Operand& o, const void* probs,
                     const Operand& dout, const Operand& dq, const Operand& dk, const Operand& dv,
                     int B, int S, int H, int Dh, float scale, cudaStream_t stream) {
  auto launch = Dh <= 64 ? (S <= 64 ? launch_bwd_block_dp<64, 1, kSaved>
                                    : launch_bwd_block_dp<64, 2, kSaved>)
                         : (S <= 64 ? launch_bwd_block_dp<128, 1, kSaved>
                                    : launch_bwd_block_dp<128, 2, kSaved>);
  return launch(q, k, v, mask, cos_t, sin_t, o, probs, dout, dq, dk, dv, B, S, H, Dh, scale,
                stream);
}

// Calls of launch_bwd_saved that launched each design since the library was
// loaded (0: one block a head, 1: the dQ and dK/dV pair), and of
// launch_bwd_recompute (0: one block a head, 1: the WMMA head kernel, 2: the
// pair): what a check reads to show which kernels a call ran.
int g_saved_bwd_calls[2] = {0, 0};
int g_recompute_bwd_calls[3] = {0, 0, 0};

bool bwd_in_bounds(int B, int S, int H, int Dh) {
  return S >= 1 && S <= kMaxSeq && Dh >= 8 && Dh % 8 == 0 && Dh <= 128 && B <= 65535 &&
         H <= 65535;
}

// The backward from the saved probabilities: one block a head
// (short_attn_bwd_block_kernel) at S <= 128, else the dQ and dK/dV launches,
// which pass delta between them through stats ((B, H, 3, S) f32, null where
// the one-block kernel runs). Requires 1 <= S <= 256, Dh a multiple of 8 up
// to 128, B and H <= 65535.
int launch_bwd_saved(const Operand& q, const Operand& k, const Operand& v, const void* cos_t,
                     const void* sin_t, const void* probs, const Operand& dout, void* stats,
                     const Operand& dq, const Operand& dk, const Operand& dv, int B, int S, int H,
                     int Dh, float scale, cudaStream_t stream) {
  if (!bwd_in_bounds(B, S, H, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Operand none{nullptr, 0, 0, 0};
  if (S <= kBlockMaxSeq) {
    const int err = launch_bwd_block<true>(q, k, v, nullptr, cos_t, sin_t, none, probs, dout, dq,
                                           dk, dv, B, S, H, Dh, scale, stream);
    g_saved_bwd_calls[0] += err == 0;
    return err;
  }
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_bwd_pair<true>(q, k, v, nullptr, cos_t, sin_t, none, probs, dout, stats,
                                        dq, dk, dv, B, S, H, Dh, scale, stream);
  g_saved_bwd_calls[1] += err == 0;
  return err;
}

// The recompute-mode backward from o and the mask: one block a head
// (short_attn_bwd_block_kernel) at S <= 128; past it the WMMA head kernel
// where its layout fits (bwd_head_rows), else the dQ and dK/dV launches,
// which pass m, l and delta through stats ((B, H, 3, S) f32, null where they
// do not run). The bounds are launch_bwd_saved's.
int launch_bwd_recompute(const Operand& q, const Operand& k, const Operand& v, const void* mask,
                         const void* cos_t, const void* sin_t, const Operand& o,
                         const Operand& dout, void* stats, const Operand& dq, const Operand& dk,
                         const Operand& dv, int B, int S, int H, int Dh, float scale,
                         cudaStream_t stream) {
  if (!bwd_in_bounds(B, S, H, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= kBlockMaxSeq) {
    const int err = launch_bwd_block<false>(q, k, v, mask, cos_t, sin_t, o, nullptr, dout, dq, dk,
                                            dv, B, S, H, Dh, scale, stream);
    g_recompute_bwd_calls[0] += err == 0;
    return err;
  }
  const int QT = bwd_head_rows(round_up(S, 16), round_up(Dh, 16));
  if (QT == 0) {
    if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_bwd_pair<false>(q, k, v, mask, cos_t, sin_t, o, nullptr, dout, stats,
                                           dq, dk, dv, B, S, H, Dh, scale, stream);
    g_recompute_bwd_calls[2] += err == 0;
    return err;
  }
  const size_t bytes = BwdHeadSmem(round_up(S, 16), round_up(Dh, 16), QT).total;
  cudaError_t err = allow_smem(short_attn_bwd_head_kernel, bytes);
  if (err == cudaSuccess) {
    short_attn_bwd_head_kernel<<<dim3(H, B), kHeadThreads, bytes, stream>>>(
        q, k, v, static_cast<const uint8_t*>(mask), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), o, dout, dq, dk, dv, S, Dh, scale, QT);
    err = cudaGetLastError();
  }
  g_recompute_bwd_calls[1] += err == cudaSuccess;
  return static_cast<int>(err);
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
// (B, S, D) bf16 its cotangent; stats (B, H, 3, S) f32 scratch, read only by
// the dQ and dK/dV pair (null allowed where it does not run); dqkv (B, S, 3D)
// bf16 out.
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
// the mask (saved mode); stats is read only past S = 128 (null allowed up to
// it).
extern "C" int short_attention_qkv_bwd_probs(const void* qkv, const void* cos_t,
                                             const void* sin_t, const void* probs,
                                             const void* dout, void* stats, void* dqkv, int B,
                                             int S, int H, int Dh, float scale, void* stream) {
  const int64_t D = int64_t(H) * Dh;
  return launch_bwd_saved(
      bsd(qkv, 0, 3 * D, S, Dh), bsd(qkv, D, 3 * D, S, Dh), bsd(qkv, 2 * D, 3 * D, S, Dh), cos_t,
      sin_t, probs, bsd(dout, 0, D, S, Dh), stats, bsd(dqkv, 0, 3 * D, S, Dh),
      bsd(dqkv, D, 3 * D, S, Dh), bsd(dqkv, 2 * D, 3 * D, S, Dh), B, S, H, Dh, scale,
      static_cast<cudaStream_t>(stream));
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
// cotangent); stats as in short_attention_qkv_bwd; dq, dk, dv out.
extern "C" int short_attention_sep_bwd(const Operand* q, const Operand* k, const Operand* v,
                                       const void* mask, const Operand* o, const Operand* dout,
                                       void* stats, const Operand* dq, const Operand* dk,
                                       const Operand* dv, int B, int S, int H, int Dh,
                                       float scale, void* stream) {
  return launch_bwd_recompute(*q, *k, *v, mask, nullptr, nullptr, *o, *dout, stats, *dq, *dk,
                              *dv, B, S, H, Dh, scale, static_cast<cudaStream_t>(stream));
}

// The backward from the saved probabilities (B, H, S, S) bf16; stats as in
// short_attention_qkv_bwd_probs.
extern "C" int short_attention_sep_bwd_probs(const Operand* q, const Operand* k,
                                             const Operand* v, const void* probs,
                                             const Operand* dout, void* stats, const Operand* dq,
                                             const Operand* dk, const Operand* dv, int B, int S,
                                             int H, int Dh, float scale, void* stream) {
  return launch_bwd_saved(*q, *k, *v, nullptr, nullptr, probs, *dout, stats, *dq, *dk, *dv, B, S,
                          H, Dh, scale, static_cast<cudaStream_t>(stream));
}

// Shared memory in bytes of the backward's dQ (kernel 0) or dK/dV (kernel 1)
// block at (S, Dh) in the given mode, of the WMMA one-block-a-head recompute
// kernel's block (kernel 2; at any S where it fits, though it runs only past
// S = 128), or of the one-block kernel's in saved mode (kernel 3) or in
// recompute mode (kernel 4); 0 where it does not fit or does not run.
extern "C" int short_attention_bwd_smem(int S, int Dh, int saved, int kernel) {
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  if (kernel == 3 || kernel == 4) {
    if (S < 1 || S > kBlockMaxSeq || Dh < 1 || Dh > 128) return 0;
    return static_cast<int>(BwdBlockSmem(S <= 64 ? 1 : 2, Dh <= 64 ? 64 : 128, kernel == 3).total);
  }
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

// Calls of the backward from the probabilities, either entry, that launched
// one block a head (design 0) or the dQ and dK/dV pair (design 1) since the
// library was loaded.
extern "C" int short_attention_saved_bwd_calls(int design) {
  return design == 0 || design == 1 ? g_saved_bwd_calls[design] : -1;
}

// Calls of the recompute backward, either entry, that launched one block a
// head (design 0), the WMMA head kernel (design 1) or the dQ and dK/dV pair
// (design 2) since the library was loaded.
extern "C" int short_attention_recompute_bwd_calls(int design) {
  return design >= 0 && design <= 2 ? g_recompute_bwd_calls[design] : -1;
}

// x (M, K), w (N, K), bias (N), y (M, N), all bf16.
extern "C" int short_attention_out_proj(const void* x, const void* w, const void* bias, void* y,
                                        int M, int N, int K, void* stream) {
  return static_cast<int>(launch_dense_gemm<false>(x, w, bias, y, M, N, K, false,
                                                   static_cast<cudaStream_t>(stream)));
}
