// W8A16 matmul with the int8 weights dequantized inside the kernel, for
// either weight layout:
//
//   out(M, N) = cast_bf16((x(M, K) . w8) fp32 * s(N)),
//   w8 stored (K, N) (layout 0) or (N, K) (layout 1, "N-major")
//
// Replaces paligemma_tpu/kernels/ablation/quant_pallas.py:_int8_matmul_kernel
// and :_int8_matmul_nmajor_kernel, which differ only in the weights'
// layout. kernels/ablation/_wq_gemm.py plans each call by rows:
//
// * M > 16 (prefill and training rows, bound by the products): the wgmma +
//   TMA tile of wq_wgmma.cuh (which states its design): 128 output columns
//   by 64, 128, 136 or 256 rows of x, the weights converted to bf16 in registers as
//   wgmma's A operand (out^T = W^T x^T), K split over a cluster where the
//   tiles leave SMs idle, else persistent CTAs.
// * M <= 16 (decode rows, bound by the weight bytes): (K, N) weights run on
//   the int8 GEMV's tile (int8_gemv.cuh, mode 0: pg_int8_gemv); (N, K)
//   weights on wq_wgmma.cuh's tile with 16 rows of x (wgmma's n16).
#include "wq_wgmma.cuh"

// x (M, K) bf16, w8 (K, N) or (N, K) int8, s (N,) fp32, out (M, N) bf16;
// rows (256, 136, 128, 64, or 16 for (N, K) weights at M <= 16), cluster, kst and
// ctas from kernels/ablation/_wq_gemm.py's plan.
PG_EXPORT int pg_int8_matmul(const void* x, const void* w8, const void* s, void* out, int M, int K,
                             int N, int nmajor, int rows, int cluster, int kst, int ctas,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return nmajor ? wq_launch<WQ_NK>(x, w8, s, out, M, K, N, rows, cluster, kst, ctas, st)
                : wq_launch<WQ_KN>(x, w8, s, out, M, K, N, rows, cluster, kst, ctas, st);
}

// The most clusters of `cluster` CTAs of wq_wgmma.cuh's tile (layout 0-2:
// int8 (K, N), int8 (N, K), int4; rows 16-256) that the card holds at once,
// into *out; launches nothing (for measurement: the plan's cluster cap).
PG_EXPORT int pg_wq_max_clusters(int layout, int rows, int cluster, int* out) {
  if (layout == WQ_NK) return wq_max_clusters<WQ_NK>(rows, cluster, out);
  if (layout == WQ_INT4) return wq_max_clusters<WQ_INT4>(rows, cluster, out);
  return wq_max_clusters<WQ_KN>(rows, cluster, out);
}
