// Packed-qkv attention for tiny sequences (S <= 64) in f32, forward and
// backward, and the f32 GEMM of its out-projection, for Hopper (sm_90a).
//
// Replaces clip_dplm_tpu/ops/short_attention.py::_tiny_fwd_kernel and
// _tiny_bwd_kernel (pallas_call in _tiny_fwd_call and _tiny_bwd_call) where
// qkv is f32: the probe classifiers' TransformerProbe (models/classifiers.py)
// builds its two TransformerBlocks with dtype float32, and the TPU kernel
// computes in whatever dtype qkv has, its out-projection included.
//
// Everything is true f32 on the FMA units: the tensor cores would take f32
// operands only as TF32 (a 10-bit significand), which the f32 parity cannot
// absorb. The design is the simple one:
// - One warp owns one (sample, head) unit; a block holds kF32Warps of them.
//   The unit's scores (S x S, S <= 64) stay in shared memory; q, k, v, dO are
//   staged kF32Chunk head-dim columns at a time (rows padded by one float, so
//   lanes that read different rows hit different banks). Scores accumulate
//   over the chunks in order, so each is one sequential f32 sum over Dh.
// - Forward: s = q·k^T·scale + key bias; m = max, p = exp(s - m), l =
//   max(Σp, 1e-30), one lane a row, sums in key order; o = (p·V) / l, the
//   division after the product (the TPU kernel's rounding points; p·V in f32
//   since p is "rounded" to qkv's dtype, f32).
// - Backward: the same s, p, l, prob = p / l; delta = rowsum(dO∘o) from the
//   saved o; dp = dO·V^T; ds = prob·(dp - delta)·scale; dQ = ds·K, dK =
//   ds^T·Q, dV = prob^T·dO.
// - The out-projection y = o·Wo^T + bo and the backward's dO = dy·Wo run
//   through f32_gemm_kernel, a tiled FFMA GEMM (64x64 tiles, 16-deep k steps,
//   4x4 outputs a thread, a sequential sum over k, the bias added after it).
//   It is a kernel of its own, not fused into the attention, because a unit
//   here is one head and the projection reads every head of a row.
// No float atomics: two launches on the same inputs are equal byte for byte.

#include "common.cuh"

namespace clip_dplm {
namespace {

constexpr int kF32Warps = 4;   // (sample, head) units a block, one a warp
constexpr int kF32Chunk = 32;  // head-dim columns staged at a time
constexpr int kF32Pitch = kF32Chunk + 1;

struct TinyF32Args {
  const float* qkv;
  const uint8_t* mask;
  const float* o;
  const float* dout;
  float* out;  // o (forward) or dqkv (backward)
  int B, S, H, Dh;
  float scale;
};

// Floats of shared memory one warp uses: the scores (and, backward, ds),
// two per-row vectors and two staged chunks.
__host__ __device__ inline int tiny_f32_warp_floats(int S, bool bwd) {
  return (bwd ? 2 : 1) * S * (S + 1) + 2 * S + 2 * S * kF32Pitch;
}

// Columns [0, w) of rows 0..S-1 (row r at src + r * stride) into dst.
__device__ inline void stage_chunk(float* dst, const float* src, size_t stride, int S, int w,
                                   int lane) {
  for (int idx = lane; idx < S * w; idx += kWarp) {
    const int r = idx / w, c = idx - r * w;
    dst[r * kF32Pitch + c] = src[r * stride + c];
  }
}

// acc[i][j] (+)= Σ_d x[i][d]·y[j][d] over one staged chunk of width w, for the
// warp's (i, j) pairs.
__device__ inline void chunk_dots(float* acc, int P, const float* x, const float* y, int S, int w,
                                  bool first, int lane) {
  for (int idx = lane; idx < S * S; idx += kWarp) {
    const int i = idx / S, j = idx - i * S;
    float a = first ? 0.f : acc[i * P + j];
    for (int d = 0; d < w; ++d) a = fmaf(x[i * kF32Pitch + d], y[j * kF32Pitch + d], a);
    acc[i * P + j] = a;
  }
}

// The unit's scores into sc, then p = exp(s - m) in place and l per row.
__device__ void tiny_f32_probs(const TinyF32Args& a, const float* base, size_t row,
                               const uint8_t* mrow, float* sc, float* rl, float* xa, float* xb,
                               int lane) {
  const int S = a.S, P = S + 1, D = a.H * a.Dh;
  for (int c0 = 0; c0 < a.Dh; c0 += kF32Chunk) {
    const int w = min(kF32Chunk, a.Dh - c0);
    stage_chunk(xa, base + c0, row, S, w, lane);
    stage_chunk(xb, base + D + c0, row, S, w, lane);
    __syncwarp();
    chunk_dots(sc, P, xa, xb, S, w, c0 == 0, lane);
    __syncwarp();
  }
  for (int i = lane; i < S; i += kWarp) {
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) {
      const float s =
          sc[i * P + j] * a.scale + ((mrow == nullptr || mrow[j]) ? 0.f : kMaskBias);
      sc[i * P + j] = s;
      m = fmaxf(m, s);
    }
    float l = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p = expf(sc[i * P + j] - m);
      sc[i * P + j] = p;
      l += p;
    }
    rl[i] = fmaxf(l, 1e-30f);
  }
  __syncwarp();
}

__device__ void tiny_f32_fwd_unit(const TinyF32Args& a, int b, int h, float* sm, int lane) {
  const int S = a.S, P = S + 1, Dh = a.Dh, D = a.H * Dh;
  float* sc = sm;
  float* rl = sc + S * P;
  float* xa = rl + 2 * S;
  float* xb = xa + S * kF32Pitch;
  const size_t row = size_t(3) * D;
  const float* base = a.qkv + size_t(b) * S * row + size_t(h) * Dh;
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + size_t(b) * S;
  tiny_f32_probs(a, base, row, mrow, sc, rl, xa, xb, lane);
  float* ob = a.out + size_t(b) * S * D + size_t(h) * Dh;
  for (int c0 = 0; c0 < Dh; c0 += kF32Chunk) {
    const int w = min(kF32Chunk, Dh - c0);
    stage_chunk(xa, base + 2 * D + c0, row, S, w, lane);
    __syncwarp();
    for (int idx = lane; idx < S * w; idx += kWarp) {
      const int i = idx / w, d = idx - i * w;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(sc[i * P + j], xa[j * kF32Pitch + d], acc);
      ob[size_t(i) * D + c0 + d] = acc / rl[i];
    }
    __syncwarp();
  }
}

__device__ void tiny_f32_bwd_unit(const TinyF32Args& a, int b, int h, float* sm, int lane) {
  const int S = a.S, P = S + 1, Dh = a.Dh, D = a.H * Dh;
  float* pr = sm;           // p, then prob
  float* ds = pr + S * P;   // dp, then ds
  float* rl = ds + S * P;   // l
  float* dl = rl + S;       // delta
  float* xa = dl + S;
  float* xb = xa + S * kF32Pitch;
  const size_t row = size_t(3) * D;
  const float* base = a.qkv + size_t(b) * S * row + size_t(h) * Dh;
  const float* ob = a.o + size_t(b) * S * D + size_t(h) * Dh;
  const float* gb = a.dout + size_t(b) * S * D + size_t(h) * Dh;
  const uint8_t* mrow = a.mask == nullptr ? nullptr : a.mask + size_t(b) * S;
  tiny_f32_probs(a, base, row, mrow, pr, rl, xa, xb, lane);
  for (int idx = lane; idx < S * S; idx += kWarp) {
    const int i = idx / S, j = idx - i * S;
    pr[i * P + j] = pr[i * P + j] / rl[i];
  }
  for (int c0 = 0; c0 < Dh; c0 += kF32Chunk) {
    const int w = min(kF32Chunk, Dh - c0);
    stage_chunk(xa, gb + c0, D, S, w, lane);  // dO
    stage_chunk(xb, ob + c0, D, S, w, lane);  // o
    __syncwarp();
    for (int i = lane; i < S; i += kWarp) {
      float acc = c0 == 0 ? 0.f : dl[i];
      for (int d = 0; d < w; ++d) acc = fmaf(xa[i * kF32Pitch + d], xb[i * kF32Pitch + d], acc);
      dl[i] = acc;
    }
    __syncwarp();
    stage_chunk(xb, base + 2 * D + c0, row, S, w, lane);  // v
    __syncwarp();
    chunk_dots(ds, P, xa, xb, S, w, c0 == 0, lane);
    __syncwarp();
  }
  for (int idx = lane; idx < S * S; idx += kWarp) {
    const int i = idx / S, j = idx - i * S;
    ds[i * P + j] = pr[i * P + j] * (ds[i * P + j] - dl[i]) * a.scale;
  }
  __syncwarp();
  float* out = a.out + size_t(b) * S * row + size_t(h) * Dh;
  for (int c0 = 0; c0 < Dh; c0 += kF32Chunk) {
    const int w = min(kF32Chunk, Dh - c0);
    stage_chunk(xa, base + c0, row, S, w, lane);          // q
    stage_chunk(xb, base + D + c0, row, S, w, lane);      // k
    __syncwarp();
    for (int idx = lane; idx < S * w; idx += kWarp) {
      const int r = idx / w, d = idx - r * w;
      float dq = 0.f, dk = 0.f;
      for (int t = 0; t < S; ++t) {
        dq = fmaf(ds[r * P + t], xb[t * kF32Pitch + d], dq);  // Σ_j ds[r][j]·k[j]
        dk = fmaf(ds[t * P + r], xa[t * kF32Pitch + d], dk);  // Σ_i ds[i][r]·q[i]
      }
      out[size_t(r) * row + c0 + d] = dq;
      out[size_t(r) * row + D + c0 + d] = dk;
    }
    __syncwarp();
    stage_chunk(xa, gb + c0, D, S, w, lane);  // dO
    __syncwarp();
    for (int idx = lane; idx < S * w; idx += kWarp) {
      const int r = idx / w, d = idx - r * w;
      float dv = 0.f;
      for (int t = 0; t < S; ++t) dv = fmaf(pr[t * P + r], xa[t * kF32Pitch + d], dv);
      out[size_t(r) * row + 2 * D + c0 + d] = dv;
    }
    __syncwarp();
  }
}

template <bool kBwd>
__global__ void __launch_bounds__(kF32Warps * kWarp)
    tiny_attn_f32_kernel(const TinyF32Args a) {
  extern __shared__ float smem_f32[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int unit = blockIdx.x * kF32Warps + warp;
  if (unit >= a.B * a.H) return;
  float* sm = smem_f32 + size_t(warp) * tiny_f32_warp_floats(a.S, kBwd);
  if (kBwd)
    tiny_f32_bwd_unit(a, unit / a.H, unit % a.H, sm, lane);
  else
    tiny_f32_fwd_unit(a, unit / a.H, unit % a.H, sm, lane);
}

template <bool kBwd>
int tiny_f32_launch(const TinyF32Args& a, void* stream) {
  if (a.S < 1 || a.S > 64 || a.Dh % 8 || a.Dh < 8 || a.Dh > 256 || a.B < 1 || a.H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(kF32Warps) * tiny_f32_warp_floats(a.S, kBwd) * sizeof(float);
  const auto kernel = tiny_attn_f32_kernel<kBwd>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long units = static_cast<long long>(a.B) * a.H;
  const unsigned blocks = static_cast<unsigned>((units + kF32Warps - 1) / kF32Warps);
  kernel<<<blocks, kF32Warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kGT = 64;  // the GEMM's output tile (rows and columns)
constexpr int kGK = 16;  // its k step

// C (M, N) = A (M, K)·op(B) [+ bias (N)], all row-major f32. b_trans: B is
// (N, K) and op(B) = B^T; else B is (K, N). A 16x16 thread block computes a
// 64x64 tile, each thread the 4x4 outputs (ty + 16i, tx + 16j).
__global__ void __launch_bounds__(256)
    f32_gemm_kernel(const float* A, const float* Bm, const float* bias, float* C, int M, int N,
                    int K, int b_trans) {
  __shared__ float As[kGK][kGT + 4];
  __shared__ float Bs[kGK][kGT + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kGT, n0 = blockIdx.y * kGT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kGK) {
    for (int e = tid; e < kGT * kGK; e += 256) {
      const int r = e / kGK, c = e % kGK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[size_t(gm) * K + gk] : 0.f;
    }
    for (int e = tid; e < kGT * kGK; e += 256) {
      if (b_trans) {
        const int r = e / kGK, c = e % kGK, gn = n0 + r, gk = k0 + c;
        Bs[c][r] = (gn < N && gk < K) ? Bm[size_t(gn) * K + gk] : 0.f;
      } else {
        const int c = e / kGT, r = e % kGT, gn = n0 + r, gk = k0 + c;
        Bs[c][r] = (gn < N && gk < K) ? Bm[size_t(gk) * N + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) C[size_t(m) * N + n] = acc[i][j] + (bias == nullptr ? 0.f : bias[n]);
    }
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// qkv (B, S, 3D) f32 in [q | k | v] layout; mask (B, S) uint8 or null;
// o (B, S, D) f32 out. Requires 1 <= S <= 64, Dh a multiple of 8 up to 256.
extern "C" int tiny_attention_fwd_f32(const void* qkv, const void* mask, void* o, int B, int S,
                                      int H, int Dh, float scale, void* stream) {
  TinyF32Args a{};
  a.qkv = static_cast<const float*>(qkv);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<float*>(o);
  a.B = B, a.S = S, a.H = H, a.Dh = Dh, a.scale = scale;
  return tiny_f32_launch<false>(a, stream);
}

// Backward of tiny_attention_fwd_f32: qkv and mask as there; o (B, S, D) its
// output; dout (B, S, D) the cotangent of o; dqkv (B, S, 3D) f32 out.
extern "C" int tiny_attention_bwd_f32(const void* qkv, const void* mask, const void* o,
                                      const void* dout, void* dqkv, int B, int S, int H, int Dh,
                                      float scale, void* stream) {
  TinyF32Args a{};
  a.qkv = static_cast<const float*>(qkv);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.out = static_cast<float*>(dqkv);
  a.B = B, a.S = S, a.H = H, a.Dh = Dh, a.scale = scale;
  return tiny_f32_launch<true>(a, stream);
}

// C (M, N) = A (M, K)·op(B) + bias, f32: b_trans 1 takes B as (N, K) (the
// out-projection o·Wo^T + bo), 0 as (K, N) (dO = dy·Wo, bias null).
extern "C" int f32_gemm(const void* A, const void* B, const void* bias, void* C, int M, int N,
                        int K, int b_trans, void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kGT - 1) / kGT, (N + kGT - 1) / kGT);
  f32_gemm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(bias), static_cast<float*>(C), M, N, K, b_trans);
  return static_cast<int>(cudaGetLastError());
}
