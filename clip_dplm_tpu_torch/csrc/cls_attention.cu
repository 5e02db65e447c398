// CLS-query attention from packed (B, S, 3D) qkv, forward and backward, for
// Hopper (sm_90a): the attention output of query row 0 only, all heads,
// (B, 1, D) out.
//
// Replaces clip_dplm_tpu/ops/short_attention.py::_cls_fwd_kernel (pallas_call
// in _cls_attn_core) and ::_cls_bwd_kernel (pallas_call in _cls_attn_bwd),
// the kernels of fused_cls_attention that TransformerBlock's out_rows == 1
// path runs in the last block of each token tower. With one query per head
// the work is rank-1 reductions, all in f32 from the bf16 inputs:
//   s[t, h] = scale · Σ_{d∈h} k[t, d]·q0[d] + bias[t], a softmax over t per
//   head (prob = p / max(Σp, 1e-30), kept in f32 as the Pallas kernel keeps
//   it), o[d] = Σ_t prob[t, h(d)]·v[t, d], rounded once;
// and the backward recomputes the softmax (no residuals beyond qkv and the
// mask): dp[t, h] = Σ_{d∈h} v[t, d]·do[d], delta = Σ_t prob·dp, ds =
// prob·(dp − delta)·scale; dq row 0 = Σ_t ds[t, h(d)]·k[t, d] and the other q
// rows are written as zeros (dqkv flows on into the qkv Dense backward as a
// dense tensor); dk[t, d] = ds[t, h(d)]·q0[d]; dv[t, d] = prob[t, h(d)]·do[d].
// The TPU kernel routes every per-head reduction through constant head-mask
// matrices (hsum/hexp), a workaround for Mosaic's layouts; here every sum is
// taken in a fixed order and no atomics are used, so runs repeat bit for bit.
//
// Both directions are bound by memory on the H100 (~4-8 FLOP per element
// pair). At the flagship shape (B = 1024, S = 128, D = 512, H = 8) the
// forward reads K and V once (268 MB, ~0.08 ms at 3.35 TB/s); the backward
// adds the (B, S, 3D) dqkv write (402 MB, a third of it the zero q rows,
// which the TPU kernel writes too): 671 MB, ~0.20 ms.
//
// The forward (cls_attn_fwd_kernel) is one block of 256 threads a batch row,
// reading K and V with 16-byte loads from device memory.
//
// The backward (cls_attn_bwd_group_kernel) is one block a (batch row, group of
// whole heads), the group at most kClsGroupCols = 64 columns wide (one head
// where Dh is wider), of 256 threads from S = 96 and 128 below. One thread
// copies the group's K and V columns for all S keys into shared memory by TMA,
// one box each behind one mbarrier (the maps unswizzled: no tensor core reads
// them); meanwhile the block writes the q part's zero rows with coalesced
// 16-byte stores and stages q0, dout and the key bias in f32. Then everything
// comes from shared memory in one pass: the scores and dp with lanes along
// each head's 16-byte chunks (rows of the tile dense, so a quarter warp reads
// 128 contiguous bytes) reduced with shuffles; the softmax, delta and ds a
// warp a head; dq0 = Σ_t ds·k from the staged K in a fixed order, its partials
// over V's tile, which nothing reads after the scores; dv and dk stored from
// registers as whole 128-byte row segments of 16-byte stores. Every byte of K
// and V is read once and every byte of dqkv written once. At the flagship a
// block holds 34,952 bytes and 256 threads of 40 registers, six blocks an SM
// by either, so one block's copies overlap another's arithmetic and stores.
// Where the group's K and V do not fit (S past 256, the most rows of one TMA
// box; a group wider than 256 columns; past 227 KB) the row design takes the
// call (cls_attn_bwd_kernel: one block of 256 threads a batch row, every phase
// reading device memory, K twice);
// cls_attention_bwd_calls counts each design's calls.

#include "common.cuh"
#include "tma.cuh"

namespace clip_dplm {
namespace {

constexpr int kClsThreads = 256;
constexpr int kClsWarps = kClsThreads / kWarp;

// Thread groups that split the key rows of a column reduction: each of the
// D/8 chunks gets kClsThreads / (D/8) threads (at least one).
__host__ __device__ inline int cls_groups(int D) {
  const int g = kClsThreads / (D / 8);
  return g > 0 ? g : 1;
}

// Shared-memory layout of one block (one batch row). Python mirrors it in
// ops/short_attention.py::_cls_smem_bytes.
struct ClsSmem {
  int ld_s;
  size_t q, dout, s, dp, part, bias, total;
  __host__ __device__ ClsSmem(int S, int D, int H, bool bwd) {
    ld_s = S + 1;  // odd pitch: the score stores of neighbouring heads spread over banks
    size_t off = 0;
    q = off;    off += align128(size_t(D) * sizeof(float));
    dout = off; off += bwd ? align128(size_t(D) * sizeof(float)) : 0;
    s = off;    off += align128(size_t(H) * ld_s * sizeof(float));
    dp = off;   off += bwd ? align128(size_t(H) * ld_s * sizeof(float)) : 0;
    part = off; off += align128(size_t(cls_groups(D)) * D * sizeof(float));
    bias = off; off += align128(size_t(S) * sizeof(float));
    total = off;
  }
};

// n values of a bf16 row (n % 8 == 0, 16-byte aligned) into f32 shared memory.
__device__ inline void stage_f32(float* dst, const bf16* src, int n) {
  for (int c = threadIdx.x; c < n / 8; c += blockDim.x) load8(src + c * 8, dst + c * 8);
}

// s[h][t] = scale · Σ_{d∈h} k[t, d]·q[d] + bias[t] and, with dq_vec, dp[h][t] =
// Σ_{d∈h} v[t, d]·dq_vec[d]: one thread per (t, h), 16-byte loads along the head.
__device__ inline void cls_scores(const bf16* k_base, const bf16* v_base, size_t row_stride,
                                  const float* q, const float* dvec, const float* bias, int S,
                                  int H, int Dh, float scale, float* s, float* dp, int ld_s) {
  for (int idx = threadIdx.x; idx < S * H; idx += blockDim.x) {
    const int t = idx / H, h = idx % H;
    const bf16* kr = k_base + t * row_stride + h * Dh;
    const bf16* vr = v_base + t * row_stride + h * Dh;
    const float* qh = q + h * Dh;
    float acc = 0.f, acc_dp = 0.f;
    for (int d0 = 0; d0 < Dh; d0 += 8) {
      float kv[8];
      load8(kr + d0, kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += kv[e] * qh[d0 + e];
      if (dvec != nullptr) {
        float vv[8];
        load8(vr + d0, vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc_dp += vv[e] * dvec[h * Dh + d0 + e];
      }
    }
    s[h * ld_s + t] = acc * scale + bias[t];
    if (dvec != nullptr) dp[h * ld_s + t] = acc_dp;
  }
}

// Softmax over t of each head's row, in place (one warp per head, `warps`
// warps in the block); with dp, also delta = Σ_t prob·dp and dp := prob·(dp −
// delta)·scale (= ds).
__device__ inline void cls_softmax(float* s, float* dp, int ld_s, int S, int H, float scale,
                                   int warps = kClsWarps) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int h = warp; h < H; h += warps) {
    float* row = s + h * ld_s;
    float m = -INFINITY;
    for (int t = lane; t < S; t += kWarp) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < S; t += kWarp) {
      const float p = expf(row[t] - m);
      row[t] = p;
      l += p;
    }
    l = fmaxf(warp_sum(l), 1e-30f);
    float delta = 0.f;
    for (int t = lane; t < S; t += kWarp) {
      const float prob = row[t] / l;
      row[t] = prob;
      if (dp != nullptr) delta += prob * dp[h * ld_s + t];
    }
    if (dp == nullptr) continue;
    delta = warp_sum(delta);
    for (int t = lane; t < S; t += kWarp) {
      float* g = dp + h * ld_s + t;
      *g = row[t] * (*g - delta) * scale;
    }
  }
}

// out[d] = Σ_t w[h(d)][t]·x[t, d] in f32: threads (group g, chunk c) sum the
// rows t ≡ g (mod G) of their 8-column chunk, then the G partials are added
// in group order. Ends with the block synchronized.
__device__ inline void cls_column_sum(const bf16* x_base, size_t row_stride, const float* w,
                                      int ld_s, int S, int D, int Dh, float* part, float* out) {
  const int C = D / 8, G = cls_groups(D);
  for (int idx = threadIdx.x; idx < G * C; idx += blockDim.x) {
    const int g = idx / C, c = idx % C;
    const float* wh = w + (c * 8 / Dh) * ld_s;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = g; t < S; t += G) {
      float xv[8];
      load8(x_base + t * row_stride + c * 8, xv);
      const float p = wh[t];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += p * xv[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) part[g * D + c * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = 0.f;
    for (int g = 0; g < G; ++g) v += part[g * D + d];
    out[d] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kClsThreads)
cls_attn_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                    bf16* __restrict__ out, int S, int H, int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, D3 = 3 * D, b = blockIdx.x;
  const ClsSmem lay(S, D, H, false);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sPart = reinterpret_cast<float*>(smem + lay.part);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const bf16* base = qkv + size_t(b) * S * D3;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;

  stage_f32(sQ, base, D);
  for (int t = threadIdx.x; t < S; t += kClsThreads) sBias[t] = key_bias(mask_row, t, S);
  __syncthreads();
  cls_scores(base + D, base + 2 * D, D3, sQ, nullptr, sBias, S, H, Dh, scale, sS, nullptr,
             lay.ld_s);
  __syncthreads();
  cls_softmax(sS, nullptr, lay.ld_s, S, H, scale);
  __syncthreads();
  cls_column_sum(base + 2 * D, D3, sS, lay.ld_s, S, D, Dh, sPart, sQ);  // o over q0's slot
  for (int d = threadIdx.x; d < D; d += kClsThreads)
    out[size_t(b) * D + d] = __float2bfloat16(sQ[d]);
}

__global__ void __launch_bounds__(kClsThreads)
cls_attn_bwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                    const bf16* __restrict__ dout, bf16* __restrict__ dqkv, int S, int H, int Dh,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, D3 = 3 * D, C = D / 8, b = blockIdx.x;
  const ClsSmem lay(S, D, H, true);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sDo = reinterpret_cast<float*>(smem + lay.dout);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDs = reinterpret_cast<float*>(smem + lay.dp);
  float* sPart = reinterpret_cast<float*>(smem + lay.part);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const int ld_s = lay.ld_s;
  const bf16* base = qkv + size_t(b) * S * D3;
  bf16* g_base = dqkv + size_t(b) * S * D3;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;

  stage_f32(sQ, base, D);
  stage_f32(sDo, dout + size_t(b) * D, D);
  for (int t = threadIdx.x; t < S; t += kClsThreads) sBias[t] = key_bias(mask_row, t, S);
  __syncthreads();
  cls_scores(base + D, base + 2 * D, D3, sQ, sDo, sBias, S, H, Dh, scale, sS, sDs, ld_s);
  __syncthreads();
  cls_softmax(sS, sDs, ld_s, S, H, scale);
  __syncthreads();

  // dk, dv for every row; dq rows 1.. are zeros
  for (int idx = threadIdx.x; idx < S * C; idx += kClsThreads) {
    const int t = idx / C, c = idx % C, h = c * 8 / Dh;
    const float ds = sDs[h * ld_s + t], prob = sS[h * ld_s + t];
    float dk[8], dv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dk[e] = ds * sQ[c * 8 + e];
      dv[e] = prob * sDo[c * 8 + e];
    }
    bf16* row = g_base + size_t(t) * D3 + c * 8;
    store8(row + D, dk);
    store8(row + 2 * D, dv);
    if (t > 0) *reinterpret_cast<uint4*>(row) = make_uint4(0, 0, 0, 0);
  }
  // dq row 0 = Σ_t ds[h(d)][t]·k[t, d]
  cls_column_sum(base + D, D3, sDs, ld_s, S, D, Dh, sPart, sDo);
  for (int c = threadIdx.x; c < C; c += kClsThreads) store8(g_base + c * 8, sDo + c * 8);
}

// ---------------------------------------------------------------------------
// The backward, one block a (batch row, head group)
// ---------------------------------------------------------------------------

constexpr int kGrpWideRows = 96;  // S from which a group block takes 256 threads, below 128
constexpr int kGrpMaxRows = 256;  // the rows of one TMA box
constexpr int kGrpMaxCols = 256;  // the columns of one TMA box
constexpr int kClsGroupCols = 64;  // a group's width where heads are narrower

// Threads of one group block: 256 where S is long enough to keep them busy
// (at S = 128 five such blocks an SM by registers outrun six of 128, limited
// by shared memory), 128 at short S, where the softmax's one warp a head and
// the series of phases leave a wide block idle.
__host__ __device__ inline int cls_group_threads(int S) { return S >= kGrpWideRows ? 256 : 128; }

// Whole heads a group (at most kClsGroupCols columns; one head where Dh is
// wider, and no more than H), its width in columns and the groups of a row.
// The last group holds the heads left over.
struct ClsGroups {
  int heads, cols, n;
  __host__ __device__ ClsGroups(int H, int Dh) {
    heads = kClsGroupCols / Dh < 1 ? 1 : (kClsGroupCols / Dh > H ? H : kClsGroupCols / Dh);
    cols = heads * Dh;
    n = (H + heads - 1) / heads;
  }
};

// Shared-memory layout of one group block. Python mirrors it in
// ops/short_attention.py::cls_bwd_group_smem_bytes.
struct ClsGroupSmem {
  size_t k, v, q, dout, prob, ds, bias, bar, total;
  __host__ __device__ ClsGroupSmem(int S, int cols, int heads) {
    const size_t tile = size_t(S) * cols * sizeof(bf16);
    const size_t part = size_t(cls_group_threads(S)) * 8 * sizeof(float);
    size_t off = 0;
    k = off;    off += align128(tile);
    v = off;    off += align128(tile > part ? tile : part);  // V's box, then dq0's partials
    q = off;    off += align128(size_t(cols) * sizeof(float));
    dout = off; off += align128(size_t(cols) * sizeof(float));
    prob = off; off += align128(size_t(heads) * S * sizeof(float));
    ds = off;   off += align128(size_t(heads) * S * sizeof(float));  // dp, then ds
    bias = off; off += align128(size_t(S) * sizeof(float));
    bar = off;  off += sizeof(uint64_t);
    total = off + 128;  // the base aligned to 128 bytes inside the allocation
  }
};

__host__ __device__ inline bool cls_group_fits(int S, int H, int Dh, size_t* bytes) {
  const ClsGroups grp(H, Dh);
  *bytes = ClsGroupSmem(S, grp.cols, grp.heads).total;
  return S >= 1 && S <= kGrpMaxRows && grp.cols <= kGrpMaxCols && *bytes <= kMaxSmem;
}

// tm_k, tm_v: the k and v parts of qkv as (D, S, B) maps, boxes of the
// group's cols x S rows. Grid: B x groups, the groups of a row side by side;
// kThreads = cls_group_threads(S).
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
cls_attn_bwd_group_kernel(const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                          const bf16* __restrict__ dout, bf16* __restrict__ dqkv, int S, int H,
                          int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int D = H * Dh, D3 = 3 * D, tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const ClsGroups grp(H, Dh);
  const int b = blockIdx.x / grp.n, gi = blockIdx.x % grp.n, c0 = gi * grp.cols;
  const int hg = min(grp.heads, H - gi * grp.heads);  // this group's heads
  const int ld = grp.cols, Ch = Dh / 8, C = hg * Ch;  // tile pitch; chunks a head, a group
  const ClsGroupSmem lay(S, grp.cols, grp.heads);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sDo = reinterpret_cast<float*>(smem + lay.dout);
  float* sP = reinterpret_cast<float*>(smem + lay.prob);
  float* sDs = reinterpret_cast<float*>(smem + lay.ds);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  float* sPart = reinterpret_cast<float*>(smem + lay.v);  // V is read only by the scores
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const bf16* base = qkv + size_t(b) * S * D3;
  bf16* g_base = dqkv + size_t(b) * S * D3;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;

  if (tid == 0) {
    mbar_init(bar);
    mbar_fence_init();
    mbar_expect_tx(bar, 2u * S * grp.cols * sizeof(bf16));
    tma_box_3d(sK, &tm_k, c0, 0, b, bar);
    tma_box_3d(sV, &tm_v, c0, 0, b, bar);
  }
  // while the boxes land: q0, dout and the key bias in f32, and the q part's
  // rows 1..S-1 as zeros
  for (int c = tid; c < C; c += kThreads) {
    load8(base + c0 + c * 8, sQ + c * 8);
    load8(dout + size_t(b) * D + c0 + c * 8, sDo + c * 8);
  }
  for (int t = tid; t < S; t += kThreads) sBias[t] = key_bias(mask_row, t, S);
  for (int i = tid; i < (S - 1) * C; i += kThreads)
    *reinterpret_cast<uint4*>(g_base + size_t(1 + i / C) * D3 + c0 + (i % C) * 8) =
        make_uint4(0, 0, 0, 0);
  __syncthreads();  // the barrier's init, q0, dout and the bias published
  mbar_wait(bar, 0);

  // s = scale·k·q0 + bias and dp = v·do for each (key t, head h): L lanes a
  // pair, each along every L-th of the head's chunks, summed by shuffles.
  // Pairs run t-major, so the lanes of a warp read whole rows in order.
  const int L = Ch >= 8 ? 8 : (Ch >= 4 ? 4 : (Ch >= 2 ? 2 : 1));
  const int n = S * hg * L;
  for (int i0 = warp * kWarp; i0 < n; i0 += kThreads) {  // warp-uniform trip count
    const int i = i0 + lane, pair = i / L, sub = i % L, t = pair / hg, h = pair % hg;
    float acc = 0.f, acc_dp = 0.f;
    if (i < n) {
      for (int c = h * Ch + sub; c < (h + 1) * Ch; c += L) {
        float kv[8], vv[8];
        load8(sK + t * ld + c * 8, kv);
        load8(sV + t * ld + c * 8, vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc += kv[e] * sQ[c * 8 + e];
          acc_dp += vv[e] * sDo[c * 8 + e];
        }
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
      acc_dp += __shfl_xor_sync(0xffffffffu, acc_dp, o);
    }
    if (i < n && sub == 0) {
      sP[h * S + t] = acc * scale + sBias[t];
      sDs[h * S + t] = acc_dp;
    }
  }
  __syncthreads();
  cls_softmax(sP, sDs, S, S, hg, scale, kThreads / kWarp);  // prob in sP, ds in sDs
  __syncthreads();

  // dv = prob ⊗ do
  for (int i = tid; i < S * C; i += kThreads) {
    const int t = i / C, c = i % C;
    const float p = sP[(c / Ch) * S + t];
    float dv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) dv[e] = p * sDo[c * 8 + e];
    store8(g_base + size_t(t) * D3 + 2 * D + c0 + c * 8, dv);
  }
  // dq0 = Σ_t ds·k from the staged K: thread (g, c) sums the rows t ≡ g (mod
  // G) of chunk c into V's tile, then the G partials are added in order
  const int G = kThreads / C;
  if (tid < G * C) {
    const int g = tid / C, c = tid % C;
    const float* dsh = sDs + (c / Ch) * S;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = g; t < S; t += G) {
      float kv[8];
      load8(sK + t * ld + c * 8, kv);
      const float d = dsh[t];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += d * kv[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sPart[(g * C + c) * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {  // dq row 0
    float dq[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) dq[e] += sPart[(g * C + c) * 8 + e];
    store8(g_base + c0 + c * 8, dq);
  }
  // dk = ds ⊗ q0
  for (int i = tid; i < S * C; i += kThreads) {
    const int t = i / C, c = i % C;
    const float d = sDs[(c / Ch) * S + t];
    float dk[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) dk[e] = d * sQ[c * 8 + e];
    store8(g_base + size_t(t) * D3 + D + c0 + c * 8, dk);
  }
}

cudaError_t cls_launch_check(int B, int S, int H, int Dh, bool bwd, size_t* bytes) {
  *bytes = ClsSmem(S, H * Dh, H, bwd).total;
  if (*bytes > kMaxSmem || Dh % 8 || S < 1 || B < 1) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Calls of the backward that launched the group design (0) or the row
// design (1) since the library was loaded.
int g_bwd_calls[2] = {0, 0};

// The backward: the group design where the group's K and V fit
// (cls_group_fits), else the row design.
int launch_cls_bwd(const bf16* qkv, const uint8_t* mask, const bf16* dout, bf16* dqkv, int B,
                   int S, int H, int Dh, float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || Dh < 8 || Dh % 8) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes;
  cudaError_t err;
  if (!cls_group_fits(S, H, Dh, &bytes)) {
    err = cls_launch_check(B, S, H, Dh, true, &bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(cls_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cls_attn_bwd_kernel<<<B, kClsThreads, bytes, stream>>>(qkv, mask, dout, dqkv, S, H, Dh,
                                                           scale);
    err = cudaGetLastError();
    g_bwd_calls[1] += err == cudaSuccess;
    return static_cast<int>(err);
  }
  const ClsGroups grp(H, Dh);
  if (size_t(B) * grp.n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int D = H * Dh;
  // the k and v parts of qkv as (D, S, B): rows 3D apart, batch rows S·3D
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(3) * D * 2, cuuint64_t(S) * 3 * D * 2};
  const cuuint32_t box[3] = {cuuint32_t(grp.cols), cuuint32_t(S), 1};
  CUtensorMap tm_k, tm_v;
  if (!tensor_map(&tm_k, qkv + D, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&tm_v, qkv + 2 * D, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);  // e.g. qkv off 16 bytes
  const int threads = cls_group_threads(S);
  const auto kernel =
      threads == 256 ? cls_attn_bwd_group_kernel<256> : cls_attn_bwd_group_kernel<128>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * grp.n, threads, bytes, stream>>>(
      tm_k, tm_v, qkv, mask, dout, dqkv, S, H, Dh, scale);
  err = cudaGetLastError();
  g_bwd_calls[0] += err == cudaSuccess;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// qkv (B, S, 3D) bf16; mask (B, S) uint8 or null; out (B, 1, D) bf16.
// Requires Dh % 8 == 0.
extern "C" int cls_attention_fwd(const void* qkv, const void* mask, void* out, int B, int S,
                                 int H, int Dh, float scale, void* stream) {
  size_t bytes;
  cudaError_t err = cls_launch_check(B, S, H, Dh, false, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cls_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cls_attn_fwd_kernel<<<B, kClsThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      S, H, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}

// dout (B, 1, D) bf16 the cotangent of cls_attention_fwd's output; dqkv
// (B, S, 3D) bf16 out, every element written. qkv and dqkv 16-byte aligned.
extern "C" int cls_attention_bwd(const void* qkv, const void* mask, const void* dout, void* dqkv,
                                 int B, int S, int H, int Dh, float scale, void* stream) {
  return launch_cls_bwd(static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
                        static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), B, S, H, Dh,
                        scale, static_cast<cudaStream_t>(stream));
}

// Calls of the backward that launched the group design (0) or the row
// design (1) since the library was loaded.
extern "C" int cls_attention_bwd_calls(int design) {
  return design == 0 || design == 1 ? g_bwd_calls[design] : -1;
}

// Shared memory in bytes of the block the backward launches at (S, H, Dh):
// the group design's where it fits, else the row design's; 0 where neither
// runs.
extern "C" int cls_attention_bwd_smem(int S, int H, int Dh) {
  size_t bytes;
  if (S < 1 || H < 1 || Dh < 8 || Dh % 8) return 0;
  if (cls_group_fits(S, H, Dh, &bytes)) return static_cast<int>(bytes);
  return cls_launch_check(1, S, H, Dh, true, &bytes) == cudaSuccess ? static_cast<int>(bytes)
                                                                     : 0;
}
