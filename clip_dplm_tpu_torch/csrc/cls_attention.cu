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
//
// The TPU kernel routes every per-head reduction through constant head-mask
// matrices (hsum/hexp), a workaround for Mosaic's layouts; here one block per
// batch row gives each thread whole heads or 8-column chunks and reduces
// through shared memory in a fixed order, so runs repeat bit for bit.
//
// Bounds on the H100: at the flagship shape (B = 1024, S = 128, D = 512,
// H = 8) the forward reads K and V once (268 MB, ~0.08 ms at 3.35 TB/s) for
// ~4 FLOP per element pair, and the backward adds the (B, S, 3D) dqkv write
// (402 MB): both are bound by memory. K and V rows stream with 16-byte loads;
// the q part is read for row 0 only.

#include "common.cuh"

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

// Softmax over t of each head's row, in place (one warp per head); with dp,
// also delta = Σ_t prob·dp and dp := prob·(dp − delta)·scale (= ds).
__device__ inline void cls_softmax(float* s, float* dp, int ld_s, int S, int H, float scale) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int h = warp; h < H; h += kClsWarps) {
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

cudaError_t cls_launch_check(int B, int S, int H, int Dh, bool bwd, size_t* bytes) {
  *bytes = ClsSmem(S, H * Dh, H, bwd).total;
  if (*bytes > kMaxSmem || Dh % 8 || S < 1 || B < 1) return cudaErrorInvalidValue;
  return cudaSuccess;
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
// (B, S, 3D) bf16 out, every element written.
extern "C" int cls_attention_bwd(const void* qkv, const void* mask, const void* dout, void* dqkv,
                                 int B, int S, int H, int Dh, float scale, void* stream) {
  size_t bytes;
  cudaError_t err = cls_launch_check(B, S, H, Dh, true, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cls_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cls_attn_bwd_kernel<<<B, kClsThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), S, H, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}
