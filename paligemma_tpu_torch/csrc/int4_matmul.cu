// Int4 weight-only matmul with the nibbles unpacked inside the kernel.
//
// Replaces paligemma_tpu/kernels/ablation/quant4.py:_int4_matmul_kernel.
// Weights (K, N) are stored as (K/2, N) int8 in "K-halves" packing:
// packed[k, n] holds q[k, n] in its low nibble and q[k + K/2, n] in its
// high nibble, both signed (-8..7):
//
//   out(M, N) = cast_bf16((x[:, :K/2] . low + x[:, K/2:] . high) fp32 * s(N))
//
// The TPU kernel unpacks through int32 shifts on its vector unit (Mosaic
// rejects int8 shifts), which made it slower than the int8 path there. On
// Hopper the unpack is two byte shifts per weight in registers
// ((int8)(p << 4) >> 4 for the low nibble, p >> 4 for the high one), done
// once per staged tile: each stage of packed rows feeds two products into
// the same fp32 accumulators (wq_gemm.cuh, which states what bounds it).
// At decode rows it reads half the bytes of the int8 matmul.
#include "wq_gemm.cuh"

PG_EXPORT int pg_int4_matmul(const void* x, const void* w4p, const void* s, void* part, void* out,
                             int M, int K, int N, int k_chunk, void* stream) {
  return wq_gemm_launch<WQ_INT4>(x, w4p, s, part, out, M, K, N, k_chunk, (cudaStream_t)stream);
}
