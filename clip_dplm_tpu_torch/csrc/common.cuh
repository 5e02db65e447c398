// Helpers shared by the attention kernels of clip_dplm_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace clip_dplm {

typedef __nv_bfloat16 bf16;

constexpr int kWarp = 32;
// Dynamic shared memory one block may use on Hopper (sm_90): 227 KB.
constexpr size_t kMaxSmem = 232448;
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

}  // namespace clip_dplm
