// The warp-level tensor-core products shared by every kernel of the port
// (sm_90a, mma.sync): bf16 x bf16 on m16n8k16 and tf32 x tf32 on m16n8k8,
// both accumulating in f32. Fragment layouts (PTX ISA, "Matrix Fragments
// for mma.m16n8k16 / mma.m16n8k8"), with g = lane / 4, t = lane % 4:
//   A (16 x k, row-major): a0 (g, kp), a1 (g+8, kp), a2 (g, kp+H),
//                          a3 (g+8, kp+H);
//   B (k x 8, col-major):  b0 (kp, g), b1 (kp+H, g);
//   C (16 x 8):            c0, c1 (g, 2t, 2t+1), c2, c3 (g+8, 2t, 2t+1);
// where kp = 2t and each register holds the pair (k, k+1) for bf16
// (H = 8), and kp = t with one value per register for tf32 (H = 4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd {

typedef __nv_bfloat16 bf16;

// An f32 value rounded to tf32 (10 explicit mantissa bits, to nearest,
// ties away), as the tensor cores take it.
__device__ __forceinline__ float tf32_round(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b, bf16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b, float) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace hvd
