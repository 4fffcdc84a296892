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
// rejects int8 shifts), which made it slower than the int8 path there.
//
// Two kernels, by rows:
//
// * M <= 16 (decode rows), pg_int4_gemv: bound by reading the packed
//   weights (K N / 2 bytes, 16.4 us for Gemma-2B's four projections at
//   3.35 TB/s). It is the int8 GEMV's tensor-core tile (gemv_tile.cuh) in
//   its GT_INT4 form: the weight is mma.sync's A operand, read as 16-byte
//   row pieces (a warp reads 128 contiguous bytes of each stored row), each
//   stored row feeding two products into the same accumulators (low nibbles
//   against x at k, high ones against x at k + K/2); K is split over the
//   CTAs of a cluster as kernels/gemv_plan.py plans (K/2, N), reduced
//   through distributed shared memory in rank order, and the scale and the
//   bf16 cast run in the same launch. M takes 8-row tiles on the grid.
// * M > 16 (prefill and training rows), pg_int4_matmul: bound by the
//   products (2 M K N flops); the wgmma + TMA tile of wq_wgmma.cuh, which
//   converts each stored row's low and high nibbles into two register A
//   operands of wgmma against x at k and at K/2 + k.
#include "wq_wgmma.cuh"

// x (M, K) bf16, w4p (K/2, N) int8, s (N,) fp32, out (M, N) bf16; rows
// (256, 136, 128 or 64), cluster, kst (stages of 64 stored rows) and ctas from
// kernels/ablation/_wq_gemm.py's plan.
PG_EXPORT int pg_int4_matmul(const void* x, const void* w4p, const void* s, void* out, int M,
                             int K, int N, int rows, int cluster, int kst, int ctas,
                             void* stream) {
  return wq_launch<WQ_INT4>(x, w4p, s, out, M, K, N, rows, cluster, kst, ctas,
                            (cudaStream_t)stream);
}

// N % 16 == 0, w4p 16-byte aligned (one 16-byte load per stored row), K %
// 8 == 0 and x 8-byte aligned (one 8-byte load per x fragment, both halves).
__global__ void __launch_bounds__(32 * GT_MAX_WARPS, 2)
    int4_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w4p,
                     const float* __restrict__ s, bf16* __restrict__ out, int M, int K, int N,
                     int k_per_cta) {
  __shared__ GemvSmem sm;
  const int rank = cluster_rank(), cs = cluster_size();
  const int tile = blockIdx.x / cs;
  const int b0 = blockIdx.z * GT_BT;
  const int nb = min(GT_BT, M - b0);
  const int kbeg = rank * k_per_cta;  // stored rows
  const int kend = min(K / 2, kbeg + k_per_cta);
  const int g = (threadIdx.x & 31) >> 2;
  gemv_tile_sums<true, GT_INT4>(sm, x, w4p, K, N, b0, nb, tile * GT_COLS + 16 * g, kbeg, kend,
                                true);
  cluster_sync_all();
  // rank r scales and casts its share of the tile's columns
  const int per = (GT_COLS + cs - 1) / cs;
  const int c_lo = rank * per;
  const int width = min(GT_COLS, c_lo + per) - c_lo;
  for (int idx = threadIdx.x; idx < nb * width; idx += blockDim.x) {
    const int r = idx / width, c = c_lo + idx % width;
    const int j = tile * GT_COLS + c;
    if (j < N) out[(size_t)(b0 + r) * N + j] = f2bf(gt_cluster_sum(sm, r, c, cs) * s[j]);
  }
  cluster_sync_all();  // every rank has read this CTA's sums
}

// x (M, K) bf16, w4p (K/2, N) int8, s (N,) fp32, out (M, N) bf16; cluster,
// warps and k_per_cta (stored rows) from kernels/gemv_plan.py's plan of
// (K/2, N).
PG_EXPORT int pg_int4_gemv(const void* x, const void* w4p, const void* s, void* out, int M,
                           int K, int N, int cluster, int warps, int k_per_cta, void* stream) {
  if (N % 16 || K % 8 || (uintptr_t)w4p % 16 || (uintptr_t)x % 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + GT_COLS - 1) / GT_COLS * cluster, 1, (M + GT_BT - 1) / GT_BT);
  return gt_launch(&int4_gemv_kernel, grid, cluster, warps, (cudaStream_t)stream,
                   (const bf16*)x, (const int8_t*)w4p, (const float*)s, (bf16*)out, M, K, N,
                   k_per_cta);
}
