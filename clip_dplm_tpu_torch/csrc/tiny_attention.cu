// Packed-qkv attention for tiny sequences (S <= 64), forward and backward,
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces clip_dplm_tpu/ops/short_attention.py::_tiny_fwd_kernel and
// _tiny_bwd_kernel (pallas_call in _tiny_fwd_call and _tiny_bwd_call, public
// entry fused_tiny_attention_proj): the tf_clip perturbation tower's 10 DEG
// tokens and the transformer tower's 8 tokens. The TPU kernel packs 128/16
// samples into one 128x128 score tile per head under a block-diagonal bias,
// because its matrix unit wants 128-row tiles. Here S is padded to 16·NS
// (NS = ceil(S / 16), a template argument) in registers only: rows past S
// are read from a 16-byte zero chunk, never from device memory.
//
// What bounds it: bytes. At B=4096, S=10, D=512 a call moves 42 MB (qkv in,
// o out; the backward 84 MB with o, dO in and dqkv out), 0.050 / 0.100 ms at
// 3.35 TB/s, against 0.002 ms of bf16 products. The design keeps the copies
// streaming and takes the products off the critical path:
// - A block is a producer warp and G·NS consumer warps, one a 16-row tile of
//   a head, for a group of G heads (G | H; G·NS at most 8, 12 at NS = 3; G
//   chosen, with the ring's shared memory, for the most consumer warps an SM).
//   A unit of work is one sample's head group; the grid is persistent (units
//   strided over the resident blocks).
// - The producer brings a unit's rows in with cp.async.bulk (one copy a row
//   of qkv when G = H, else one a row and part; dO and o likewise) into a ring
//   of `stages` (2 where it fits) on mbarriers, so that the next unit loads
//   while this one computes; the mask row becomes a key bias array there
//   (plain loads: mask rows are S bytes, not 16-byte aligned). Row pitches
//   are an odd number of 16-byte chunks, so ldmatrix reads without bank
//   conflicts.
// - Each consumer warp does its tile's products with mma.sync m16n8k16 (bf16
//   in, f32 accumulate; the last 8 columns of a Dh % 16 == 8 contraction with
//   m16n8k8), the softmax in registers with quad shuffles, and writes its
//   outputs back over inputs no warp reads again (o over q; dq over q, dk
//   over o, dv over v) with 4-byte stores; the producer then stores them with
//   cp.async.bulk, one copy a row and part, and refills the stage.
// - Forward, a query tile: s = q·k^T (accumulator fragments), p rounded to
//   bf16 straight into the A fragments of p·V (flash-attention 2's
//   accumulator-to-A reuse), o = (p·V) / l a 64-column chunk at a time.
// - Backward, the head's NS warps between named barriers: (a) query tile j:
//   the forward's m and l and delta = rowsum(dO∘o) into shared memory; (b) key
//   tile j: s^T = k·q^T and dp^T = v·dO^T, so that prob^T and ds^T come out as
//   the A fragments of dV = prob^T·dO and dK = ds^T·Q; ds^T goes to the head's
//   tile in shared memory; (c) query tile j: dQ = ds·K, ds from that tile by
//   ldmatrix.trans.
// - dV is formed from the f32 prob exactly: prob = hi + mid + lo with hi =
//   bf16(prob), mid = bf16(prob - hi), lo = bf16(prob - hi - mid) (24 bits of
//   significand in three 8-bit pieces), three products with bf16 dO, each
//   exact in f32; only the order of summation differs from an f32 product.
//
// Rounding points (the TPU kernel's): scores q·k^T·scale + key bias in f32
// (-1e30 for a masked key, -inf past S); m = max, p = exp(s - m), l =
// max(Σp, 1e-30) from the f32 p; o = (bf16(p)·V) / l in f32, rounded to bf16
// once. Backward: the same s, m, p, l, prob = p / l (f32); dp = dO·V^T; delta
// = rowsum(dO∘o) from the saved o; ds = bf16(prob·(dp - delta)·scale); dQ =
// ds·K, dK = ds^T·Q, dV = prob^T·dO, each rounded to bf16 once. No float
// atomics: two launches on the same inputs are equal byte for byte.
//
// TINY_ABLATE (experiments/tiny_ab.py's --variant; 0 in the package): 1 moves
// the bytes and computes nothing, 2 forms dV from bf16(prob) alone.

#include <array>
#include <map>
#include <mutex>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

#ifndef TINY_ABLATE
#define TINY_ABLATE 0
#endif

namespace clip_dplm {
namespace {

// Consumer warps a block at NS = S16 / 16 (one a 16-row tile of a head, so
// G <= this / NS heads a unit). At NS = 3 the 13 warps put four on some of
// the SM's four schedulers, which leaves each thread at most 128 registers.
__host__ __device__ constexpr int tiny_cap(int NS) { return NS == 3 ? 12 : 8; }
template <int NS>
constexpr int kTinyThreads = (tiny_cap(NS) + 1) * kWarp;
constexpr int kTinyHeader = 128;  // the zero chunk at 0, the barriers at 64
constexpr int kTinyBias = 256;    // a stage's 64 key-bias floats, before its rows

struct TinyArgs {
  const bf16* qkv;
  const uint8_t* mask;
  const bf16* o;
  const bf16* dout;
  bf16* out;  // o (forward) or dqkv (backward)
  int B, S, H, Dh;
  int G, stages;     // heads a unit, ring stages
  int pq, pd;        // row pitches in bytes: q, k, v of the group; dO, o of the group
  int stage_bytes;   // bias, S rows of pq, S rows of pd
  int head_bytes;    // the backward's per-head ds^T tile and row stats
  float scale;
};

// A row of `bytes` (a multiple of 16) rounded up to an odd number of 16-byte
// chunks: eight consecutive rows then start in eight different bank groups.
__host__ __device__ inline int tiny_pitch(int bytes) { return ((bytes / 16) | 1) * 16; }

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read shared memory / are complete
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a·b on m16n8k16 (bf16 in, f32 accumulate), and on m16n8k8
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row r, element column c of a row-major bf16 operand in shared memory (row r
// at base + r·pitch bytes), or the zero chunk for a row past S.
__device__ __forceinline__ const void* row_at(const unsigned char* base, int pitch, int r, int c,
                                              int S, const void* zero) {
  return r < S ? static_cast<const void*>(base + r * pitch + 2 * c) : zero;
}

// acc[n] += A[row0, row0 + 16) · B[8n, 8n + 8)^T over Dh columns, for the
// 2·NS eight-row tiles of B: A and B are row-major (rows, Dh) operands in
// shared memory (A by ldmatrix, B by ldmatrix as mma's column-major B).
template <int NS>
__device__ __forceinline__ void tile_by_rows(float (&acc)[2 * NS][4], const unsigned char* A,
                                             int pa, int row0, const unsigned char* Bm, int pb,
                                             int S, int Dh, const void* zero, int lane) {
  const int ra = row0 + (lane & 15), ca = (lane >> 4) * 8;
  const int rb = (lane & 7) + ((lane >> 4) << 3), cb = ((lane >> 3) & 1) * 8;
  int k = 0;
#pragma unroll 1
  for (; k + 16 <= Dh; k += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, row_at(A, pa, ra, k + ca, S, zero));
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, row_at(Bm, pb, 16 * j + rb, k + cb, S, zero));
      mma_k16(acc[2 * j], a, b[0], b[1]);
      mma_k16(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
  if (k < Dh) {  // Dh % 16 == 8: the last 8 columns on m16n8k8
    uint32_t a[2];
    ldsm_x2(a, row_at(A, pa, row0 + (lane & 15), k, S, zero));
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t b[2];
      ldsm_x2(b, row_at(Bm, pb, 16 * j + (lane & 15), k, S, zero));
      mma_k8(acc[2 * j], a[0], a[1], b[0]);
      mma_k8(acc[2 * j + 1], a[0], a[1], b[1]);
    }
  }
}

// acc[n] += Σ_f a[f] · Bm[:, c0 + 8n, + 8) for the CW-column chunk at c0
// (columns past Dh skipped): a holds NA sets of A fragments of a (16, 16·NS)
// left operand (the contraction over Bm's 16·NS rows), Bm a row-major
// (rows, Dh) operand read by ldmatrix.trans.
template <int NS, int NA, int CW>
__device__ __forceinline__ void tile_by_cols(float (&acc)[CW / 8][4],
                                             const uint32_t (&a)[NA][NS][4],
                                             const unsigned char* Bm, int pb, int c0, int S,
                                             int Dh, const void* zero, int lane) {
  const int rb = (lane & 7) + ((lane >> 3) & 1) * 8, cb = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
#pragma unroll
    for (int np = 0; np < CW / 16; ++np) {
      const int c = c0 + 16 * np;
      if (c + 16 <= Dh) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, row_at(Bm, pb, 16 * kk + rb, c + cb, S, zero));
#pragma unroll
        for (int f = NA - 1; f >= 0; --f) {
          mma_k16(acc[2 * np], a[f][kk], b[0], b[1]);
          mma_k16(acc[2 * np + 1], a[f][kk], b[2], b[3]);
        }
      } else if (c < Dh) {
        uint32_t b[2];
        ldsm_x2_trans(b, row_at(Bm, pb, 16 * kk + (lane & 15), c, S, zero));
#pragma unroll
        for (int f = NA - 1; f >= 0; --f) mma_k16(acc[2 * np], a[f][kk], b[0], b[1]);
      }
    }
  }
}

// The C fragments of rows row0 + g and row0 + g + 8 (divided by d0 and d1
// with kDiv) as bf16 into the CW-column chunk at c0 of dst (row r at dst +
// r·pitch); rows past S and columns past Dh are left alone.
template <bool kDiv, int CW>
__device__ __forceinline__ void store_tile(unsigned char* dst, int pitch, int row0, int c0,
                                           const float (&acc)[CW / 8][4], float d0, float d1,
                                           int S, int Dh, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < CW / 8; ++n) {
    if (c0 + 8 * n >= Dh) break;
    const int c = c0 + 8 * n + 2 * t;
    if (row0 + g < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + g) * pitch + 2 * c) =
          kDiv ? __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0)
               : __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (row0 + g + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + g + 8) * pitch + 2 * c) =
          kDiv ? __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1)
               : __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// The softmax of a query tile's scores in place: s = s·scale + key bias,
// then p = exp(s - m) per row (rows g and g + 8 of the tile); m and l =
// max(Σp, 1e-30) of both rows out.
template <int NS>
__device__ __forceinline__ void tile_softmax(float (&s)[2 * NS][4], const float* bias,
                                             float scale, float (&m)[2], float (&l)[2],
                                             int lane) {
  const int t = lane & 3;
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < 2 * NS; ++n) {
    const float2 kb = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[n][2 * h] = s[n][2 * h] * scale + kb.x;
      s[n][2 * h + 1] = s[n][2 * h + 1] * scale + kb.y;
      m[h] = fmaxf(m[h], fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    }
  }
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
#pragma unroll
  for (int n = 0; n < 2 * NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - m[e >> 1]);
      l[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = fmaxf(quad_sum(l[h]), 1e-30f);
}

// Query tile m0 / 16 of head w of a unit, forward: o over q's columns.
template <int NS>
__device__ __forceinline__ void fwd_tile(const TinyArgs& a, unsigned char* stage, int w, int m0,
                                         const void* zero, int lane) {
  const int S = a.S, Dh = a.Dh, GD = a.G * Dh;
  const float* bias = reinterpret_cast<const float*>(stage);
  unsigned char* rows = stage + kTinyBias;
  unsigned char* q = rows + 2 * w * Dh;
  const unsigned char* k = rows + 2 * (GD + w * Dh);
  const unsigned char* v = rows + 2 * (2 * GD + w * Dh);
  float s[2 * NS][4] = {};
  tile_by_rows<NS>(s, q, a.pq, m0, k, a.pq, S, Dh, zero, lane);
  float m[2], l[2];
  tile_softmax<NS>(s, bias, a.scale, m, l, lane);
  uint32_t p[1][NS][4];  // bf16(p): the A fragments of p·V
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    p[0][kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    p[0][kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    p[0][kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    p[0][kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  __syncwarp();  // every lane has read q's rows of this tile: o goes over them
#pragma unroll 1
  for (int c0 = 0; c0 < Dh; c0 += 64) {
    float acc[8][4] = {};
    tile_by_cols<NS, 1, 64>(acc, p, v, a.pq, c0, S, Dh, zero, lane);
    store_tile<true, 64>(q, a.pq, m0, c0, acc, l[0], l[1], S, Dh, lane);
  }
}

// The NS warps of a head meet (named barrier 1 + w; a warp alone at NS = 1).
template <int NS>
__device__ __forceinline__ void head_sync(int w) {
  if (NS == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "r"(NS * kWarp) : "memory");
}

// prob as bf16 parts: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid), each difference exact in f32, so that hi + mid + lo == x for every
// normal x whose lowest bits stay normal in bf16 (x >= 2^-102, ~2e-31).
template <int NP>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&out)[NP]) {
#pragma unroll
  for (int f = 0; f < NP; ++f) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[f] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 back = __bfloat1622float2(h);
    x -= back.x;
    y -= back.y;
  }
}

// Tile j of head w of a unit, backward (the head's NS warps, one a tile of
// 16 rows, pass by pass between barriers): dq over q's columns, dk over o's,
// dv over v's. buf: the head's ds^T tile (16·NS keys by 16·NS queries, bf16)
// and its query rows' m, l and delta.
template <int NS>
__device__ __forceinline__ void bwd_tile(const TinyArgs& a, unsigned char* stage, int w, int j,
                                         unsigned char* buf, const void* zero, int lane) {
  constexpr int S16 = 16 * NS, LDS = S16 + 8;  // the ds^T tile's pitch in elements
  constexpr int kParts = TINY_ABLATE == 2 ? 1 : 3;
  // output columns a chunk: 32 from NS = 3, so that the B fragments the
  // compiler loads ahead stay within 128 registers (four warps a scheduler)
  constexpr int CW = NS >= 3 ? 32 : 64;
  const int S = a.S, Dh = a.Dh, GD = a.G * Dh, g = lane >> 2, t = lane & 3;
  const float* bias = reinterpret_cast<const float*>(stage);
  unsigned char* rows = stage + kTinyBias;
  unsigned char* drows = rows + S * a.pq;
  unsigned char* q = rows + 2 * w * Dh;
  const unsigned char* k = rows + 2 * (GD + w * Dh);
  unsigned char* v = rows + 2 * (2 * GD + w * Dh);
  const unsigned char* dO = drows + 2 * w * Dh;
  unsigned char* o = drows + 2 * (GD + w * Dh);
  bf16* dsT = reinterpret_cast<bf16*>(buf);
  float* rm = reinterpret_cast<float*>(buf + S16 * LDS * 2);
  float* rl = rm + S16;  // +inf past S: prob = 0 there
  float* rd = rl + S16;  // 0 past S

  // (a) query tile j: the forward's m and l, and delta = rowsum(dO∘o)
  {
    const int m0 = 16 * j;
    float s[2 * NS][4] = {};
    tile_by_rows<NS>(s, q, a.pq, m0, k, a.pq, S, Dh, zero, lane);
    float m[2], l[2];
    tile_softmax<NS>(s, bias, a.scale, m, l, lane);
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        rm[r] = r < S ? m[h] : 0.f;
        rl[r] = r < S ? l[h] : INFINITY;
      }
    }
    // lane j: row m0 + j % 16, every other 8-column chunk from (j / 16)·8
    const int r = m0 + (lane & 15);
    float d = 0.f;
    if (r < S)
      for (int c = (lane >> 4) * 8; c < Dh; c += 16) {
        float x[8], y[8];
        load8(reinterpret_cast<const bf16*>(dO + r * a.pd + 2 * c), x);
        load8(reinterpret_cast<const bf16*>(o + r * a.pd + 2 * c), y);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(x[e], y[e], d);
      }
    d += __shfl_xor_sync(0xffffffffu, d, 16);
    if (lane < 16) rd[r] = d;
  }
  head_sync<NS>(w);

  // (b) key tile j: s^T and dp^T; prob^T and ds^T as A fragments; dV, dK
  {
    const int k0 = 16 * j;
    float sT[2 * NS][4] = {}, dpT[2 * NS][4] = {};
    tile_by_rows<NS>(sT, k, a.pq, k0, q, a.pq, S, Dh, zero, lane);
    tile_by_rows<NS>(dpT, v, a.pq, k0, dO, a.pd, S, Dh, zero, lane);
    const float kb[2] = {bias[k0 + g], bias[k0 + g + 8]};
    uint32_t pf[kParts][NS][4], dsf[1][NS][4];
#pragma unroll
    for (int n = 0; n < 2 * NS; ++n) {
      const int qc = 8 * n + 2 * t;
      const float2 m2 = *reinterpret_cast<const float2*>(rm + qc);
      const float2 l2 = *reinterpret_cast<const float2*>(rl + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(rd + qc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // key row k0 + g + 8h, query columns qc, qc + 1
        const float p0 = expf(sT[n][2 * h] * a.scale + kb[h] - m2.x) / l2.x;
        const float p1 = expf(sT[n][2 * h + 1] * a.scale + kb[h] - m2.y) / l2.y;
        const int f = (n & 1) * 2 + h;  // A fragment register of k-step n / 2
        uint32_t parts[kParts];
        split_pair<kParts>(p0, p1, parts);
#pragma unroll
        for (int x = 0; x < kParts; ++x) pf[x][n >> 1][f] = parts[x];
        dsf[0][n >> 1][f] = pack_bf16(p0 * (dpT[n][2 * h] - d2.x) * a.scale,
                                      p1 * (dpT[n][2 * h + 1] - d2.y) * a.scale);
        *reinterpret_cast<uint32_t*>(dsT + (k0 + g + 8 * h) * LDS + qc) = dsf[0][n >> 1][f];
      }
    }
#pragma unroll 1
    for (int c0 = 0; c0 < Dh; c0 += CW) {
      float acc[CW / 8][4] = {};
      tile_by_cols<NS, kParts, CW>(acc, pf, dO, a.pd, c0, S, Dh, zero, lane);
      store_tile<false, CW>(v, a.pq, k0, c0, acc, 1.f, 1.f, S, Dh, lane);
    }
#pragma unroll 1
    for (int c0 = 0; c0 < Dh; c0 += CW) {
      float acc[CW / 8][4] = {};
      tile_by_cols<NS, 1, CW>(acc, dsf, q, a.pq, c0, S, Dh, zero, lane);
      store_tile<false, CW>(o, a.pd, k0, c0, acc, 1.f, 1.f, S, Dh, lane);
    }
  }
  head_sync<NS>(w);

  // (c) query tile j: dQ = ds·K, ds from the ds^T tile by ldmatrix.trans
  {
    const int m0 = 16 * j;
    uint32_t dsa[1][NS][4];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      ldmatrix_x4_trans(dsa[0][kk], dsT + (16 * kk + (lane & 7) + (lane >> 4) * 8) * LDS + m0 +
                                        ((lane >> 3) & 1) * 8);
#pragma unroll 1
    for (int c0 = 0; c0 < Dh; c0 += CW) {
      float acc[CW / 8][4] = {};
      tile_by_cols<NS, 1, CW>(acc, dsa, k, a.pq, c0, S, Dh, zero, lane);
      store_tile<false, CW>(q, a.pq, m0, c0, acc, 1.f, 1.f, S, Dh, lane);
    }
  }
}

// The producer's half of unit u into a stage: the sample's key bias (plain
// loads of its mask row), then its rows by cp.async.bulk, completing on bar.
template <bool kBwd>
__device__ __forceinline__ void tiny_load(const TinyArgs& a, unsigned char* stage, uint64_t* bar,
                                          int u, int lane) {
  const int NG = a.H / a.G, b = u / NG, h0 = (u % NG) * a.G, S = a.S, D = a.H * a.Dh;
  const int seg = a.G * a.Dh * 2;  // bytes of the group's q (k, v, dO, o) in a row
  float* bias = reinterpret_cast<float*>(stage);
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + size_t(b) * S;
  for (int j = lane; j < kTinyBias / 4; j += kWarp) bias[j] = key_bias(mrow, j, S);
  __syncwarp();
  const bool whole = a.G == a.H;  // a row's q, k and v of every head: one span
  const int nq = whole ? S : 3 * S, n = nq + (kBwd ? 2 * S : 0);
  if (lane == 0) mbar_expect_tx(bar, S * seg * (kBwd ? 5 : 3));
  __syncwarp();
  unsigned char* rows = stage + kTinyBias;
  for (int c = lane; c < n; c += kWarp) {
    if (c < nq) {
      const int r = whole ? c : c / 3, part = whole ? 0 : c % 3;
      bulk_load(rows + r * a.pq + part * seg,
                a.qkv + (size_t(b) * S + r) * 3 * D + part * D + h0 * a.Dh,
                whole ? 3 * seg : seg, bar);
    } else {
      const int r = (c - nq) / 2, part = (c - nq) % 2;
      bulk_load(rows + S * a.pq + r * a.pd + part * seg,
                (part ? a.o : a.dout) + (size_t(b) * S + r) * D + h0 * a.Dh, seg, bar);
    }
  }
}

// The outputs of unit u from its stage by cp.async.bulk: o over q's columns;
// dq over q's, dk over o's, dv over v's.
template <bool kBwd>
__device__ __forceinline__ void tiny_store(const TinyArgs& a, const unsigned char* stage, int u,
                                           int lane) {
  const int NG = a.H / a.G, b = u / NG, h0 = (u % NG) * a.G, S = a.S, D = a.H * a.Dh;
  const int seg = a.G * a.Dh * 2;
  const unsigned char* rows = stage + kTinyBias;
  if (!kBwd) {
    for (int r = lane; r < S; r += kWarp)
      bulk_store(a.out + (size_t(b) * S + r) * D + h0 * a.Dh, rows + r * a.pq, seg);
  } else {
    for (int c = lane; c < 3 * S; c += kWarp) {
      const int r = c / 3, part = c % 3;
      const unsigned char* src =
          part == 1 ? rows + S * a.pq + r * a.pd + seg : rows + r * a.pq + part * seg;
      bulk_store(a.out + (size_t(b) * S + r) * 3 * D + part * D + h0 * a.Dh, src, seg);
    }
  }
}

// The producer warp: for each of the block's units, the stores of the unit
// the stage held before (once its consumers are done), then the unit's loads.
template <bool kBwd>
__device__ __forceinline__ void tiny_producer(const TinyArgs& a, unsigned char* smem,
                                              uint64_t* full, uint64_t* empty, int lane) {
  const int units = a.B * (a.H / a.G);
  const int n = units > int(blockIdx.x) ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  for (int i = 0; i < n + a.stages; ++i) {
    const int st = i % a.stages;
    unsigned char* stage = smem + kTinyHeader + st * a.stage_bytes;
    if (i >= a.stages && i - a.stages < n) {
      mbar_wait(&empty[st], (i / a.stages - 1) & 1);
      tiny_store<kBwd>(a, stage, blockIdx.x + (i - a.stages) * gridDim.x, lane);
      bulk_commit();
      bulk_wait_read();  // the stage is free for the next unit's rows
      __syncwarp();
    }
    if (i < n) tiny_load<kBwd>(a, stage, &full[st], blockIdx.x + i * gridDim.x, lane);
  }
  bulk_wait_all();
}

__device__ __forceinline__ void tiny_init(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                          int stages, int warps) {
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem)[threadIdx.x] = 0u;  // the zero chunk
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], warps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The consumers' loop over the block's units: wait for the stage, run the
// warp's tile of its head, publish its outputs to the async proxy and
// release the stage.
template <int NS, bool kBwd>
__device__ __forceinline__ void tiny_consume(const TinyArgs& a, unsigned char* smem,
                                             uint64_t* full, uint64_t* empty, int warp,
                                             int lane) {
  const int units = a.B * (a.H / a.G), w = warp / NS, j = warp % NS;
  unsigned char* buf = smem + kTinyHeader + a.stages * a.stage_bytes + w * a.head_bytes;
  int i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int st = i % a.stages;
    unsigned char* stage = smem + kTinyHeader + st * a.stage_bytes;
    mbar_wait(&full[st], (i / a.stages) & 1);
#if TINY_ABLATE != 1
    if (kBwd)
      bwd_tile<NS>(a, stage, w, j, buf, smem, lane);
    else
      fwd_tile<NS>(a, stage, w, 16 * j, smem, lane);
#endif
    fence_proxy_async();  // st.shared outputs, read by the bulk stores
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

template <int NS>
__global__ void __launch_bounds__(kTinyThreads<NS>, NS <= 2 ? 2 : 1)
tiny_attn_fwd_kernel(const TinyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 64);
  uint64_t* empty = full + 2;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  tiny_init(smem, full, empty, a.stages, a.G * NS);
  if (warp == a.G * NS)
    tiny_producer<false>(a, smem, full, empty, lane);
  else
    tiny_consume<NS, false>(a, smem, full, empty, warp, lane);
}

template <int NS>
__global__ void __launch_bounds__(kTinyThreads<NS>, NS == 1 ? 2 : 1)
tiny_attn_bwd_kernel(const TinyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 64);
  uint64_t* empty = full + 2;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  tiny_init(smem, full, empty, a.stages, a.G * NS);
  if (warp == a.G * NS)
    tiny_producer<true>(a, smem, full, empty, lane);
  else
    tiny_consume<NS, true>(a, smem, full, empty, warp, lane);
}

// A launch's shape: the head group, the ring, the layout and the resident
// blocks an SM.
struct TinyPlan {
  int G, stages, pq, pd, stage_bytes, head_bytes, blocks, sms;
  size_t smem;
};

inline TinyPlan tiny_layout(bool bwd, int S, int G, int Dh, int stages) {
  const int S16 = round_up(S, 16);
  TinyPlan p{};
  p.G = G;
  p.stages = stages;
  p.pq = tiny_pitch(3 * G * Dh * 2);
  p.pd = bwd ? tiny_pitch(2 * G * Dh * 2) : 0;
  p.stage_bytes = static_cast<int>(align128(kTinyBias + size_t(S) * (p.pq + p.pd)));
  p.head_bytes = bwd ? static_cast<int>(align128(size_t(S16) * (S16 + 8) * 2 + 3 * S16 * 4)) : 0;
  p.smem = kTinyHeader + size_t(stages) * p.stage_bytes + size_t(G) * p.head_bytes;
  return p;
}

// The plan of a shape, cached: two ring stages where any group fits them
// (else one), and among the groups G | H (G·NS <= tiny_cap(NS)) the one with
// the most consumer warps resident on an SM (ties: the larger group).
cudaError_t tiny_plan(const void* kernel, bool bwd, int S, int H, int Dh, TinyPlan* out) {
  static std::mutex mu;
  static std::map<std::array<int, 6>, TinyPlan> cache;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int NS = (S + 15) / 16, gmax = tiny_cap(NS) / NS;
  const std::array<int, 6> key{dev, int(bwd), NS, S, H, Dh};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  int sms;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  TinyPlan best{};
  int best_warps = 0;
  for (int stages = 2; stages >= 1 && best_warps == 0; --stages)
    for (int G = H < gmax ? H : gmax; G >= 1; --G) {
      if (H % G) continue;
      TinyPlan p = tiny_layout(bwd, S, G, Dh, stages);
      if (p.smem > kMaxSmem) continue;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.blocks, kernel,
                                                          (G * NS + 1) * kWarp, p.smem);
      if (err != cudaSuccess) return err;
      if (p.blocks * G * NS > best_warps) {
        best = p;
        best_warps = p.blocks * G * NS;
      }
    }
  if (best_warps == 0) return cudaErrorInvalidValue;
  best.sms = sms;
  cache[key] = best;
  *out = best;
  return cudaSuccess;
}

template <bool kBwd, int NS>
cudaError_t tiny_run(TinyArgs a, cudaStream_t stream) {
  const auto kernel = kBwd ? tiny_attn_bwd_kernel<NS> : tiny_attn_fwd_kernel<NS>;
  TinyPlan p;
  const cudaError_t err =
      tiny_plan((const void*)kernel, kBwd, a.S, a.H, a.Dh, &p);
  if (err != cudaSuccess) return err;
  a.G = p.G;
  a.stages = p.stages;
  a.pq = p.pq;
  a.pd = p.pd;
  a.stage_bytes = p.stage_bytes;
  a.head_bytes = p.head_bytes;
  const int units = a.B * (a.H / p.G), resident = p.blocks * p.sms;
  kernel<<<units < resident ? units : resident, (p.G * NS + 1) * kWarp, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kBwd>
int tiny_launch(const TinyArgs& a, void* stream) {
  if (a.S < 1 || a.S > 64 || a.Dh % 8 || a.Dh < 8 || a.Dh > 256 || a.B < 1 || a.H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((a.S + 15) / 16) {
    case 1: return static_cast<int>(tiny_run<kBwd, 1>(a, s));
    case 2: return static_cast<int>(tiny_run<kBwd, 2>(a, s));
    case 3: return static_cast<int>(tiny_run<kBwd, 3>(a, s));
    default: return static_cast<int>(tiny_run<kBwd, 4>(a, s));
  }
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// qkv (B, S, 3D) bf16 in [q | k | v] layout; mask (B, S) uint8 or null;
// o (B, S, D) bf16 out. Requires 1 <= S <= 64, Dh a multiple of 8 up to 256.
extern "C" int tiny_attention_fwd(const void* qkv, const void* mask, void* o, int B, int S, int H,
                                  int Dh, float scale, void* stream) {
  TinyArgs a{};
  a.qkv = static_cast<const bf16*>(qkv);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<bf16*>(o);
  a.B = B, a.S = S, a.H = H, a.Dh = Dh, a.scale = scale;
  return tiny_launch<false>(a, stream);
}

// Backward of tiny_attention_fwd: qkv and mask as there; o (B, S, D) its
// output; dout (B, S, D) the cotangent of o; dqkv (B, S, 3D) bf16 out.
extern "C" int tiny_attention_bwd(const void* qkv, const void* mask, const void* o,
                                  const void* dout, void* dqkv, int B, int S, int H, int Dh,
                                  float scale, void* stream) {
  TinyArgs a{};
  a.qkv = static_cast<const bf16*>(qkv);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.out = static_cast<bf16*>(dqkv);
  a.B = B, a.S = S, a.H = H, a.Dh = Dh, a.scale = scale;
  return tiny_launch<true>(a, stream);
}
