// Packed-qkv attention for tiny sequences (S < 64), forward and backward,
// for Hopper (sm_90a).
//
// Replaces clip_dplm_tpu/ops/short_attention.py::_tiny_fwd_kernel and
// _tiny_bwd_kernel (pallas_call in _tiny_fwd_call and _tiny_bwd_call, public
// entry fused_tiny_attention_proj): the tf_clip perturbation tower's 10 DEG
// tokens and the transformer tower's 8 tokens. The TPU kernel packs 128/16
// samples into one 128x128 score tile per head under a block-diagonal bias,
// because its matrix unit wants 128-row tiles (8x the score FLOPs). Here one
// warp owns one (sample, head): it stages that head's q, k, v rows (and, in
// the backward, dO and o) into its own slice of shared memory with 16-byte
// loads, and does every product of the head on the CUDA cores in f32. S is
// never padded in device memory, and there is no cross-sample work at all.
//
// Why f32 FMAs and not tensor-core tiles: at S = 10, Dh = 64 a head's five
// (S, S, Dh) products are 32,000 FMAs, next to 3 KB of bf16 it must read, so
// the kernel is bound by bytes (qkv in, o out: 0.05 ms at B=4096, D=512)
// and the arithmetic fits under that on the CUDA cores; f32 products also
// keep the TPU kernel's rounding points exactly, including dV formed from the
// f32 probabilities and the f32 dO. The out-projection (y = o·Wo^T + bo) and
// dO = dy·Wo are the package's bf16 GEMM (csrc/dense_gemm.cuh), launched by
// the wrapper around these kernels.
//
// Rounding points (the TPU kernel's): scores q·k^T·scale + key bias in f32
// (-1e30 for a masked key); m = max, p = exp(s - m), l = max(Σp, 1e-30) from
// the f32 p; o = (bf16(p)·V) / l in f32, rounded to bf16 once. Backward:
// the same s, m, p, l, prob = p / l (f32); dp = dO·V^T; delta = rowsum(dO∘o)
// from the saved o; ds = bf16(prob·(dp - delta)·scale); dQ = ds·K, dK =
// ds^T·Q, dV = prob^T·dO, each rounded to bf16 once.

#include "common.cuh"

namespace clip_dplm {
namespace {

constexpr int kTinyMaxWarps = 8;
// shared memory a block aims at, so that several blocks share an SM
constexpr size_t kTinySmemBudget = 96 * 1024;

// bf16 row pitch: 16-byte rows, each shifted one 16-byte bank group from the
// last, so that eight lanes reading eight rows do not conflict
__host__ __device__ inline int tiny_ld_x(int Dh) { return Dh + 8; }
// f32 score row pitch: odd, so that lanes walking their own rows do not
// conflict; column S holds the row's l in the forward
__host__ __device__ inline int tiny_ld_s(int S) { return S + 1 + (S & 1); }

// One warp's slice of shared memory: n_x bf16 (S x Dh) arrays, then n_s f32
// (S x S) arrays.
struct TinySmem {
  size_t x, s, total;
  __host__ __device__ TinySmem(int S, int Dh, int n_x, int n_s) {
    x = size_t(S) * tiny_ld_x(Dh) * sizeof(bf16);
    s = size_t(S) * tiny_ld_s(S) * sizeof(float);
    total = align128(n_x * x + n_s * s);
  }
};

// Rows [0, S) of a (S x Dh) bf16 slice (row r at src + r * row_stride) into
// dst (pitch ld), 16 bytes a lane; Dh % 8 == 0.
__device__ inline void warp_stage(bf16* dst, int ld, const bf16* src, size_t row_stride, int S,
                                  int Dh, int lane) {
  const int cpr = Dh / 8;
  for (int idx = lane; idx < S * cpr; idx += kWarp) {
    const int r = idx / cpr, c = (idx % cpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// f32 dot product of two bf16 rows of length Dh (Dh % 8 == 0).
__device__ inline float dot_rows(const bf16* a, const bf16* b, int Dh) {
  float acc = 0.f;
  for (int c = 0; c < Dh; c += 8) {
    float x[8], y[8];
    load8(a + c, x);
    load8(b + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
  }
  return acc;
}

__device__ inline float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ inline void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Scores of the warp's head into sS (pitch lds): s = q·k^T·scale + key bias.
__device__ inline void tiny_scores(float* sS, int lds, const bf16* sQ, const bf16* sK, int ldx,
                                   const uint8_t* mask_row, int S, int Dh, float scale,
                                   int lane) {
  for (int idx = lane; idx < S * S; idx += kWarp) {
    const int i = idx / S, j = idx % S;
    sS[i * lds + j] = dot_rows(sQ + i * ldx, sK + j * ldx, Dh) * scale + key_bias(mask_row, j, S);
  }
}

__global__ void __launch_bounds__(kTinyMaxWarps * kWarp)
tiny_attn_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ o, int B, int S, int H, int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pair = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (pair >= B * H) return;  // the warps never synchronise with each other
  const int b = pair / H, h = pair % H, D = H * Dh, D3 = 3 * D;
  const TinySmem lay(S, Dh, 3, 1);
  unsigned char* mine = smem + warp * lay.total;
  bf16* sQ = reinterpret_cast<bf16*>(mine);
  bf16* sK = reinterpret_cast<bf16*>(mine + lay.x);
  bf16* sV = reinterpret_cast<bf16*>(mine + 2 * lay.x);
  float* sS = reinterpret_cast<float*>(mine + 3 * lay.x);
  const int ldx = tiny_ld_x(Dh), lds = tiny_ld_s(S);

  const bf16* rows = qkv + size_t(b) * S * D3 + h * Dh;
  warp_stage(sQ, ldx, rows, D3, S, Dh, lane);
  warp_stage(sK, ldx, rows + D, D3, S, Dh, lane);
  warp_stage(sV, ldx, rows + 2 * D, D3, S, Dh, lane);
  __syncwarp();
  tiny_scores(sS, lds, sQ, sK, ldx, mask == nullptr ? nullptr : mask + size_t(b) * S, S, Dh,
              scale, lane);
  __syncwarp();
  // softmax, a lane per row: p rounded to bf16 for p·V, l from the f32 p
  for (int i = lane; i < S; i += kWarp) {
    float* row = sS + i * lds;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, row[j]);
    float l = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p = expf(row[j] - m);
      l += p;
      row[j] = bf16r(p);
    }
    row[S] = fmaxf(l, 1e-30f);
  }
  __syncwarp();
  // o = (p·V) / l, two columns a lane
  for (int i = 0; i < S; ++i) {
    const float* prow = sS + i * lds;
    const float l = prow[S];
    for (int d0 = 2 * lane; d0 < Dh; d0 += 2 * kWarp) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < S; ++j) {
        const float p = prow[j];
        const float2 v = bf2(sV + j * ldx + d0);
        a0 = fmaf(p, v.x, a0);
        a1 = fmaf(p, v.y, a1);
      }
      store2(o + (size_t(b) * S + i) * D + h * Dh + d0, a0 / l, a1 / l);
    }
  }
}

__global__ void __launch_bounds__(kTinyMaxWarps * kWarp)
tiny_attn_bwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                     const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, int B, int S, int H, int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pair = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (pair >= B * H) return;
  const int b = pair / H, h = pair % H, D = H * Dh, D3 = 3 * D;
  const TinySmem lay(S, Dh, 5, 2);
  unsigned char* mine = smem + warp * lay.total;
  bf16* sQ = reinterpret_cast<bf16*>(mine);
  bf16* sK = reinterpret_cast<bf16*>(mine + lay.x);
  bf16* sV = reinterpret_cast<bf16*>(mine + 2 * lay.x);
  bf16* sDO = reinterpret_cast<bf16*>(mine + 3 * lay.x);
  bf16* sO = reinterpret_cast<bf16*>(mine + 4 * lay.x);
  float* sP = reinterpret_cast<float*>(mine + 5 * lay.x);  // scores, then prob
  float* sDS = sP + lay.s / sizeof(float);                 // dp, then ds
  const int ldx = tiny_ld_x(Dh), lds = tiny_ld_s(S);

  const bf16* rows = qkv + size_t(b) * S * D3 + h * Dh;
  const size_t r0 = size_t(b) * S * D + h * Dh;
  warp_stage(sQ, ldx, rows, D3, S, Dh, lane);
  warp_stage(sK, ldx, rows + D, D3, S, Dh, lane);
  warp_stage(sV, ldx, rows + 2 * D, D3, S, Dh, lane);
  warp_stage(sDO, ldx, dout + r0, D, S, Dh, lane);
  warp_stage(sO, ldx, o + r0, D, S, Dh, lane);
  __syncwarp();
  tiny_scores(sP, lds, sQ, sK, ldx, mask == nullptr ? nullptr : mask + size_t(b) * S, S, Dh,
              scale, lane);
  for (int idx = lane; idx < S * S; idx += kWarp) {
    const int i = idx / S, j = idx % S;
    sDS[i * lds + j] = dot_rows(sDO + i * ldx, sV + j * ldx, Dh);
  }
  __syncwarp();
  // a lane per row: the forward's softmax, prob = p / l, delta, ds
  for (int i = lane; i < S; i += kWarp) {
    float* prow = sP + i * lds;
    float* drow = sDS + i * lds;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, prow[j]);
    float l = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p = expf(prow[j] - m);
      l += p;
      prow[j] = p;
    }
    l = fmaxf(l, 1e-30f);
    const float delta = dot_rows(sDO + i * ldx, sO + i * ldx, Dh);
    for (int j = 0; j < S; ++j) {
      const float prob = prow[j] / l;
      prow[j] = prob;
      drow[j] = bf16r(prob * (drow[j] - delta) * scale);
    }
  }
  __syncwarp();
  // dQ = ds·K, dK = ds^T·Q, dV = prob^T·dO: two columns a lane
  bf16* g = dqkv + size_t(b) * S * D3 + h * Dh;
  for (int i = 0; i < S; ++i) {
    for (int d0 = 2 * lane; d0 < Dh; d0 += 2 * kWarp) {
      float q0 = 0.f, q1 = 0.f, k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      for (int j = 0; j < S; ++j) {
        const float ds_ij = sDS[i * lds + j], ds_ji = sDS[j * lds + i];
        const float pr_ji = sP[j * lds + i];
        const float2 kk = bf2(sK + j * ldx + d0), qq = bf2(sQ + j * ldx + d0);
        const float2 dd = bf2(sDO + j * ldx + d0);
        q0 = fmaf(ds_ij, kk.x, q0);
        q1 = fmaf(ds_ij, kk.y, q1);
        k0 = fmaf(ds_ji, qq.x, k0);
        k1 = fmaf(ds_ji, qq.y, k1);
        v0 = fmaf(pr_ji, dd.x, v0);
        v1 = fmaf(pr_ji, dd.y, v1);
      }
      bf16* gi = g + size_t(i) * D3 + d0;
      store2(gi, q0, q1);
      store2(gi + D, k0, k1);
      store2(gi + 2 * D, v0, v1);
    }
  }
}

// Warps per block: as many (up to 8) as fit the budget; at least one.
inline int tiny_warps(size_t per_warp) {
  const size_t n = kTinySmemBudget / per_warp;
  return n < 1 ? 1 : (n > kTinyMaxWarps ? kTinyMaxWarps : static_cast<int>(n));
}

template <typename Kernel>
cudaError_t tiny_prepare(Kernel kernel, size_t per_warp, int B, int H, int* warps,
                         size_t* bytes, dim3* grid) {
  *warps = tiny_warps(per_warp);
  *bytes = per_warp * *warps;
  if (*bytes > kMaxSmem) return cudaErrorInvalidValue;
  *grid = dim3((B * H + *warps - 1) / *warps);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// qkv (B, S, 3D) bf16 in [q | k | v] layout; mask (B, S) uint8 or null;
// o (B, S, D) bf16 out. Requires 1 <= S <= 64, Dh % 8 == 0.
extern "C" int tiny_attention_fwd(const void* qkv, const void* mask, void* o, int B, int S, int H,
                                  int Dh, float scale, void* stream) {
  if (S < 1 || S > 64 || Dh % 8 || B * H < 1) return static_cast<int>(cudaErrorInvalidValue);
  int warps;
  size_t bytes;
  dim3 grid;
  cudaError_t err = tiny_prepare(tiny_attn_fwd_kernel, TinySmem(S, Dh, 3, 1).total, B, H,
                                 &warps, &bytes, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  tiny_attn_fwd_kernel<<<grid, warps * kWarp, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), B,
      S, H, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}

// Backward of tiny_attention_fwd: qkv and mask as there; o (B, S, D) its
// output; dout (B, S, D) the cotangent of o; dqkv (B, S, 3D) bf16 out.
extern "C" int tiny_attention_bwd(const void* qkv, const void* mask, const void* o,
                                  const void* dout, void* dqkv, int B, int S, int H, int Dh,
                                  float scale, void* stream) {
  if (S < 1 || S > 64 || Dh % 8 || B * H < 1) return static_cast<int>(cudaErrorInvalidValue);
  int warps;
  size_t bytes;
  dim3 grid;
  cudaError_t err = tiny_prepare(tiny_attn_bwd_kernel, TinySmem(S, Dh, 5, 2).total, B, H,
                                 &warps, &bytes, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  tiny_attn_bwd_kernel<<<grid, warps * kWarp, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), B, S,
      H, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}
