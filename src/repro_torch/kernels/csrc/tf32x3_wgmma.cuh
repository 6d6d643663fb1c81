// 3xTF32 warpgroup MMA pieces shared by the CIN kernels (cin_fused.cu,
// the forward, and cin_fused_bwd_w.cu, the weight gradient): a float32
// product on the TF32 tensor cores as lo*hi + hi*lo + hi*hi of its
// operands' TF32 parts, `wgmma` m64n208k8 with A from registers and B from
// shared memory, B streamed as [208 x 8] K-major tile pairs (hi, lo) by
// bulk asynchronous copies counted on mbarriers.
//
// A B tile is 208 rows (wgmma N) by 8 K indices in the no-swizzle
// core-matrix layout: core matrices of 8 rows x 4 floats (16 bytes), the
// two along K 128 bytes apart, successive 8-row groups 256 bytes apart.
// Element e of a tile is row tile_row(e), K index tile_col(e).
#pragma once

#include <cstdint>

namespace tf32x3 {

constexpr int kBN = 208;                     // B rows per tile (wgmma N)
constexpr int kBTile = kBN * 8;              // floats of one [208 x 8] tile
constexpr int kStep = 2 * kBTile;            // floats per K step (hi, lo)
constexpr unsigned kStepBytes = kStep * 4;   // 13,312

__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

__device__ __forceinline__ int tile_row(int e) {
  return (e >> 6) * 8 + ((e >> 2) & 7);
}
__device__ __forceinline__ int tile_col(int e) {
  return ((e >> 5) & 1) * 4 + (e & 3);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (below float32's precision): both TF32, hi = rna(x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a [208 x 8] K-major B tile at shared address `addr`, no
// swizzle: core matrices of 8 rows x 16 bytes, the two along K 128 bytes
// apart (leading byte offset), successive 8-row groups 256 bytes apart
// (stride byte offset); all fields in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// One K step's B tile pair, global -> shared, counted on `bar`.
__device__ __forceinline__ void load_step(uint32_t dst, const float* src,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(kStepBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(kStepBytes),
      "r"(bar) : "memory");
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
// An A fragment read by an MMA still in flight: a use here keeps its
// registers from being reused before the wait that retires that MMA.
__device__ __forceinline__ void keep(const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4]) {
  asm volatile("" ::"r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]),
               "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]));
}
// Keep the accumulators in place across the asynchronous MMAs.
__device__ __forceinline__ void pin(float (&d)[104]) {
#pragma unroll
  for (int i = 0; i < 104; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += a . B for one m64n208k8 TF32 warpgroup MMA: a from registers
// (the m16n8k8 A layout, one 16-row slice per warp), B [208 x 8] K-major
// in shared memory, addressed by `desc`.
__device__ __forceinline__ void wgmma_n208(float (&d)[104], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
      "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace tf32x3
