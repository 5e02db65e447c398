// Warpgroup matrix products (wgmma, sm_90a) over shared-memory tiles in the
// 128-byte-swizzled layout, and their synchronisation.
//
// The tiles are the ones `swz` lays out (tma.cuh): a Rows x Dp
// bf16 tile is Dp/64 blocks of Rows x 64 side by side; inside a block row r
// is 128 bytes and its 16-byte chunk c sits at chunk c ^ (r % 8). Every
// block starts on a 1024-byte boundary, so the swizzle is a function of the
// address bits, as wgmma's SW128 mode reads it.
//
// Descriptor fields (CuTe's GmmaDescriptor, cute/arch/mma_sm90_desc.hpp, and
// make_gmma_desc in cute/atom/mma_traits_sm90_gmma.hpp), in 16-byte units:
// start address [0, 14), leading byte offset (LBO) [16, 30), stride byte
// offset (SBO) [32, 46), base offset [49, 52) (0: atoms 1024-aligned), layout
// [62, 64) (1: SW128).
// - K-major (Layout_K_SW128_Atom: 8 rows of 64 K-elements): SBO = 1024 bytes
//   between 8-row groups, LBO unused (1). A k16 step inside the 64-wide
//   block adds its 32 bytes to the start address; the next block is
//   Rows·128 bytes on.
// - MN-major (Layout_MN_SW128_Atom: 64 MN-elements by 8 K-rows): SBO = 1024
//   bytes between 8-row K groups, LBO = the distance between 64-wide MN
//   blocks. A k16 step is 16 rows, 2048 bytes.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace clip_dplm {

// Two f32 values as one register of bf16 (lo in the low half): an A fragment
// entry of a product with A from registers.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x in one MUFU.EX2 (2^-inf = 0; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 matrices of 16-bit entries from shared memory (lane L gives the
// address of row L % 8 of matrix L / 8; register i holds matrix i's row g,
// entries 2t and 2t + 1, g = lane / 4, t = lane % 4): the A fragment of
// mma's m16n8k16 (and of wgmma's A from registers) for the right row
// addresses. The _trans form transposes each matrix as it loads: register i
// holds matrix i's entries (2t, g) and (2t + 1, g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
}

__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// wgmma reads shared memory through the async proxy: threads that wrote a
// tile with st.shared or cp.async fence before the barrier that publishes it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The 128 threads of warpgroup wg (named barriers 1 and 2; immediate ids, so
// that ptxas reserves only those).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence, commit or wait (the products write them
// asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments in registers, which must not change (nor be
// reused) before the wait that retires their product.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// m64n64k16, bf16 in, f32 accumulate, d += a·b (d = a·b when accumulate is
// false). Accumulator: warp w of the warpgroup holds rows 16w..16w+15; d[4n
// .. 4n+1] are (row g, columns 8n+2t, +1) and d[4n+2 .. 4n+3] (row g+8, same
// columns), g = lane / 4, t = lane % 4: the mma.sync m16n8 layout, eight
// n-tiles side by side.
#define CLIP_DPLM_D32                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define CLIP_DPLM_D32_LIST                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// A and B from shared memory, each K-major unless its flag says MN-major
// (kTransA: A is M x K with M contiguous, as a transposed operand P^T read
// from P's rows; wgmma transposes 16-bit types only). An MN-major A of 64
// rows is one 64-wide MN block: its descriptor's LBO is not read.
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CLIP_DPLM_D32_LIST
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : CLIP_DPLM_D32
      : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)), "n"(kTransA), "n"(kTransB));
}

// A from registers (the mma.sync m16n8k16 A fragment of the warp's 16 rows:
// a[0] (row g, k 2t..2t+1), a[1] (row g+8, same k), a[2] (row g, k 2t+8..),
// a[3] (row g+8, k 2t+8..)), B from shared memory; kTransB: B is MN-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CLIP_DPLM_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : CLIP_DPLM_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(int(accumulate)),
        "n"(kTransB));
}

#undef CLIP_DPLM_D32
#undef CLIP_DPLM_D32_LIST

// m64n128k16 with A and B from shared memory, bf16 in, f32 accumulate: the
// accumulator layout of m64n64k16 with sixteen n-tiles (d[4n .. 4n+3] at
// columns 8n+2t, +1 of rows g and g+8 of the warp's 16). A is K-major;
// kTransB: B is MN-major (its descriptor's LBO the distance between its two
// 64-column blocks), else K-major.
#define CLIP_DPLM_D64                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
      "+f"(d[63])
#define CLIP_DPLM_D64_LIST                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CLIP_DPLM_D64_LIST
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : CLIP_DPLM_D64
      : "l"(desc_a), "l"(desc_b), "r"(int(accumulate)), "n"(kTransB));
}

#undef CLIP_DPLM_D64
#undef CLIP_DPLM_D64_LIST

// m64n256k16 with A from registers (the fragment of m64n64k16_rs) and B from
// shared memory, bf16 in, f32 accumulate: the accumulator layout of
// m64n64k16 with 32 n-tiles, so d[32b .. 32b + 31] are columns 64b .. 64b +
// 63. kTransB: B is MN-major (its descriptor's LBO the distance between its
// 64-column blocks), else K-major.
#define CLIP_DPLM_D128 \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
      "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), \
      "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), \
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define CLIP_DPLM_D128_LIST \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, " \
  "%123, %124, %125, %126, %127" \
  "}"
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " CLIP_DPLM_D128_LIST
      ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : CLIP_DPLM_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(int(accumulate)),
        "n"(kTransB));
}

#undef CLIP_DPLM_D128
#undef CLIP_DPLM_D128_LIST

}  // namespace clip_dplm
