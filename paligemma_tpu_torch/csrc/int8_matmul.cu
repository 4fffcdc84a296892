// W8A16 matmul with the int8 weights dequantized inside the kernel, for
// either weight layout:
//
//   out(M, N) = cast_bf16((x(M, K) . w8) fp32 * s(N)),
//   w8 stored (K, N) (layout 0) or (N, K) (layout 1, "N-major")
//
// Replaces paligemma_tpu/kernels/ablation/quant_pallas.py:_int8_matmul_kernel
// and :_int8_matmul_nmajor_kernel, which differ only in the weights'
// layout; on Hopper one templated kernel serves both (wq_gemm.cuh, which
// states what bounds it and how the tile is laid out). The N-major layout
// stages each output column's 64 K values with contiguous 16-byte loads;
// the (K, N) layout stages 16 columns of one K row per load and transposes
// them into shared memory.
#include "wq_gemm.cuh"

// The split-K sum of the fp32 partials (nsplit, M, N) of this kernel and of
// int4_matmul.cu, in split order, scaled and cast to bf16
// (kernels/ablation/_wq_gemm.py).
__global__ void wq_split_sum_kernel(const float* __restrict__ part, int nsplit, int M, int N,
                                    const float* __restrict__ s, bf16* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * N) return;
  const int j = (int)(idx % N);
  float acc = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) acc += part[(size_t)sp * M * N + idx];
  out[idx] = f2bf(acc * s[j]);
}

PG_EXPORT int pg_wq_split_sum(const void* part, int nsplit, int M, int N, const void* s, void* out,
                              void* stream) {
  const size_t total = (size_t)M * N;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  wq_split_sum_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)part, nsplit, M, N,
                                                                (const float*)s, (bf16*)out);
  return (int)cudaGetLastError();
}

PG_EXPORT int pg_int8_matmul(const void* x, const void* w8, const void* s, void* part, void* out,
                             int M, int K, int N, int k_chunk, int nmajor, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return nmajor ? wq_gemm_launch<WQ_NK>(x, w8, s, part, out, M, K, N, k_chunk, st)
                : wq_gemm_launch<WQ_KN>(x, w8, s, part, out, M, K, N, k_chunk, st);
}
