// 3xTF32 products on mma.sync.m16n8k8 tiles: fp32 operands split in
// registers into a tf32 "big" and "small" part, three tf32 products a k8
// step summed from zero on the tensor core and added to an fp32 sum.
// Shared by the fp32 forms of the flash forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu).
#pragma once

#include "common.cuh"

// ldmatrix of fp32 tiles: an 8 x 4 block of 32-bit words per matrix, lane l
// receiving word l % 4 of row l / 4 (the tf32 fragments' pattern).
__device__ __forceinline__ void ldsm_x4_f32(uint32_t* r, const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// x = big + small in tf32: big = x rounded to tf32, small = the remainder
// rounded the same way, both as cvt.rna.tf32.f32 rounds a finite value (to
// nearest, ties away from zero) but in two integer operations: half a tf32
// ulp (0x1000) added to the bits, then the low 13 bits cleared. big is
// cleared, so that x - big is exact; small keeps its low 13 bits, which the
// tensor core ignores, completing the rounding (CUTLASS's
// round_half_ulp_truncate).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t* x, uint32_t* big, uint32_t* small) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// c (16 x 8) += a (16 x 8, row-major) . b (8 x 8, column-major) in tf32 with
// fp32 accumulators. With g = lane / 4, t = lane % 4: a[0] = A[g][t],
// a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4]; b[0] = B[t][g],
// b[1] = B[t+4][g]; c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1].
__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same with c = 0 on input.
__device__ __forceinline__ void mma_tf32_1688_0(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// c += a b in 3xTF32: small.big, big.small, big.big (small.small dropped),
// in that order, summed on the tensor core from zero, then added to c in
// fp32 (round to nearest). The tensor core's fp32 sum truncates: carried in
// c over the depth, its error grows with c (about 1e-5 of the result over a
// few hundred k8 steps); from zero, each step's error is relative to that
// step's own sum.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab, const uint32_t* as,
                                           const uint32_t* bb, const uint32_t* bs) {
  float d[4];
  mma_tf32_1688_0(d, as, bb);
  mma_tf32_1688(d, ab, bs);
  mma_tf32_1688(d, ab, bb);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

