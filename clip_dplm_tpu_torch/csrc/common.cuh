// Helpers shared by the kernels of clip_dplm_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace clip_dplm {

typedef __nv_bfloat16 bf16;

constexpr int kWarp = 32;
// Dynamic shared memory one block may use on Hopper (sm_90): 227 KB.
constexpr size_t kMaxSmem = 232448;
// The saved raw similarity's int16 fixed point, q = rint(raw · kRawQScale)
// (the reference's RAW_QSCALE: cosines of bf16-rounded unit vectors stay
// below ~1.008), and its reciprocal, each rounded once from double as the
// reference's f32 arithmetic sees it: lse_walk.cu writes q, fused_infonce.cu
// and raw_grad.cu read it.
constexpr float kRawQScale = static_cast<float>(32767.0 / 1.01);
constexpr float kRawQInv = static_cast<float>(1.0 / (32767.0 / 1.01));
constexpr float kLog2e = 1.4426950408889634f;
// Additive bias of a masked key. Finite, as in the reference: a row whose
// keys are all masked gets uniform weights, not NaN.
constexpr float kMaskBias = -1e30f;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__device__ inline float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Additive key bias: 0 for a real key, kMaskBias for a masked one, and -inf
// for a padding column past the last key, so that padding never takes weight.
__device__ inline float key_bias(const uint8_t* mask_row, int j, int n_keys) {
  if (j >= n_keys) return -INFINITY;
  return (mask_row == nullptr || mask_row[j]) ? 0.f : kMaskBias;
}

// Copy rows [0, n_rows) of a (rows x Dh) bf16 slice into shared memory with
// row pitch `ld` (row r of the slice starts at src + r * row_stride). With
// cos/sin tables ((Dh/2) floats per position, position pos0 + r) the
// rotate-half RoPE [t1*cos - t2*sin, t2*cos + t1*sin] is applied in f32 and
// rounded to bf16. Rows >= n_valid and columns in [Dh, Dp) are zero. Uses
// 16-byte vectors where the layout allows it, single elements otherwise.
__device__ inline void stage_rows(bf16* dst, int ld, const bf16* src, size_t row_stride,
                                  int n_rows, int n_valid, int Dh, int Dp, const float* cos_t,
                                  const float* sin_t, int pos0) {
  const int tid = threadIdx.x, nt = blockDim.x, half = Dh / 2;
  const bool vec = Dh % 8 == 0 && row_stride % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (cos_t != nullptr && vec && half % 8 == 0) {
    const int cpr = half / 8;  // 8-element chunks per half row
    for (int idx = tid; idx < n_rows * cpr; idx += nt) {
      const int r = idx / cpr, d0 = (idx % cpr) * 8;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (r < n_valid) {
        const bf16* row = src + r * row_stride;
        const uint4 u1 = *reinterpret_cast<const uint4*>(row + d0);
        const uint4 u2 = *reinterpret_cast<const uint4*>(row + half + d0);
        const float4* cp = reinterpret_cast<const float4*>(cos_t + size_t(pos0 + r) * half + d0);
        const float4* sp = reinterpret_cast<const float4*>(sin_t + size_t(pos0 + r) * half + d0);
        const float4 ca = cp[0], cb = cp[1], sa = sp[0], sb = sp[1];
        const float cv[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
        const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&u1);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u2);
        __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&lo);
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(a2[e]), b = __bfloat1622float2(b2[e]);
          const float c0 = cv[2 * e], c1 = cv[2 * e + 1], s0 = sv[2 * e], s1 = sv[2 * e + 1];
          l2[e] = __floats2bfloat162_rn(a.x * c0 - b.x * s0, a.y * c1 - b.y * s1);
          h2[e] = __floats2bfloat162_rn(b.x * c0 + a.x * s0, b.y * c1 + a.y * s1);
        }
      }
      *reinterpret_cast<uint4*>(dst + r * ld + d0) = lo;
      *reinterpret_cast<uint4*>(dst + r * ld + half + d0) = hi;
    }
  } else if (cos_t == nullptr && vec) {
    const int cpr = Dh / 8;
    for (int idx = tid; idx < n_rows * cpr; idx += nt) {
      const int r = idx / cpr, d0 = (idx % cpr) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (r < n_valid) u = *reinterpret_cast<const uint4*>(src + r * row_stride + d0);
      *reinterpret_cast<uint4*>(dst + r * ld + d0) = u;
    }
  } else {
    for (int idx = tid; idx < n_rows * Dh; idx += nt) {
      const int r = idx / Dh, d = idx % Dh;
      float x = 0.f;
      if (r < n_valid) {
        const bf16* row = src + r * row_stride;
        x = __bfloat162float(row[d]);
        if (cos_t != nullptr) {
          const int i = d < half ? d : d - half;
          const float c = cos_t[size_t(pos0 + r) * half + i];
          const float s = sin_t[size_t(pos0 + r) * half + i];
          x = d < half ? x * c - __bfloat162float(row[d + half]) * s
                       : x * c + __bfloat162float(row[d - half]) * s;
        }
      }
      dst[r * ld + d] = __float2bfloat16(x);
    }
  }
  const int pad = Dp - Dh;
  for (int idx = tid; idx < n_rows * pad; idx += nt)
    dst[(idx / pad) * ld + Dh + idx % pad] = __float2bfloat16(0.f);
}

// bf16 round trip of an f32 value (round to nearest even), as a cast to
// bf16 and back in the reference.
__device__ inline float bf16r(float x) { return __bfloat162float(__float2bfloat16(x)); }

// 16-byte asynchronous copy global -> shared; with pred false the 16 bytes
// are zero-filled and nothing is read.
__device__ inline void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight bf16 values at p (16-byte aligned) as f32, and back.
__device__ inline void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ inline void store8(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// All threads of the cluster (barrier.cluster, release / acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The card's SM count, read once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// The most blocks of one cluster (the portable limit): the ranges a walk
// may be split into.
constexpr int kMaxSplits = 8;

// Ranges a walk of blocks of 64 own entries is split into, one block of a
// cluster each, for n_own own entries and n_walk walked ones (raw_grad.cu's
// passes from the raw, row_ce.cu's symmetric pass;
// ops/fused_infonce.py::_from_raw_splits mirrors it): one while the blocks
// fill half the card, else as many as fill it with one block an SM, at most
// one a 64-entry walked tile and a cluster's kMaxSplits.
inline int from_raw_splits(int n_own, int n_walk, int sms) {
  const int blocks = (n_own + 63) / 64, tiles = (n_walk + 63) / 64;
  if (2 * blocks > sms) return 1;
  return std::max(1, std::min(std::min(kMaxSplits, sms / blocks), tiles));
}

}  // namespace clip_dplm
