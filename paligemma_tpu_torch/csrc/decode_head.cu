// Fused int8 LM head + argmax for greedy decode.
//
// Replaces paligemma_tpu/kernels/decode_head.py:_kernel (head_argmax_fused):
//   ids(B) = argmax_j round_bf16((y(B, K) . w8(K, N)) fp32 * s(j)),
// first index among equal maxima, columns j >= n_valid never win, and the
// winning logit is returned beside the id.
//
// What bounds it: reading the 2048 x 257152 int8 head (~527 MB) once per
// step; the (B, 257152) logits are never written to device memory. Pass 1
// gives each block a 128-column vocab tile and runs the same GEMV tile code
// (common.cuh gemv_tile, same K split) as int8_gemv.cu, so its rounded
// logits are bit-identical to the logits path's; each block writes one
// (max, first index of max) per row. Pass 2 reduces the per-block pairs of a
// row; blocks are scanned in vocab order and a later block must be strictly
// greater, so the lowest index wins ties, as in the TPU kernel.
#include <math_constants.h>

#include "common.cuh"

template <int BT>
__global__ void __launch_bounds__(GV_TX* GV_TY)
    head_argmax_pass1(const bf16* __restrict__ y, const int8_t* __restrict__ w,
                      const float* __restrict__ s, float* __restrict__ part_max,
                      int* __restrict__ part_idx, int B, int K, int N, int n_valid, int k_chunk) {
  __shared__ GemvSmem<BT> sm;
  __shared__ float lg[BT][GV_TILE_N];
  const int col0 = blockIdx.x * GV_TILE_N;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const int tid = threadIdx.y * GV_TX + threadIdx.x;
  constexpr int PER = (BT * GV_TILE_N + GV_TX * GV_TY - 1) / (GV_TX * GV_TY);
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  // same K partition and the same summation order as int8_gemv's
  // partial + epilogue kernels
  for (int kbeg = 0; kbeg < K; kbeg += k_chunk) {
    const int kend = min(K, kbeg + k_chunk);
    gemv_tile<BT>(sm, y, w, K, N, b0, nb, col0, kbeg, kend);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * GV_TX * GV_TY;
      if (idx < BT * GV_TILE_N) {
        const int r = idx / GV_TILE_N, cl = idx - r * GV_TILE_N;
        acc[i] += gemv_tile_sum<BT>(sm, r, cl);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * GV_TX * GV_TY;
    if (idx < BT * GV_TILE_N) {
      const int r = idx / GV_TILE_N, cl = idx - r * GV_TILE_N;
      const int col = col0 + cl;
      float v = -CUDART_INF_F;
      if (col < n_valid) v = bf2f(f2bf(acc[i] * s[col]));  // activation-dtype round
      lg[r][cl] = v;
    }
  }
  __syncthreads();
  // warp r reduces row r of the tile (BT <= GV_TY warps)
  const int warp = threadIdx.y, lane = threadIdx.x;
  if (warp < nb) {
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int cl = lane; cl < GV_TILE_N; cl += GV_TX) {
      const float v = lg[warp][cl];
      const int j = col0 + cl;
      if (v > best || (v == best && j < bi)) { best = v; bi = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    if (lane == 0) {
      part_max[(size_t)blockIdx.x * B + b0 + warp] = best;
      part_idx[(size_t)blockIdx.x * B + b0 + warp] = bi;
    }
  }
}

__global__ void head_argmax_pass2(const float* __restrict__ part_max,
                                  const int* __restrict__ part_idx, int nblk, int B,
                                  int* __restrict__ ids, float* __restrict__ maxv) {
  const int b = blockIdx.x;
  __shared__ float sv[256];
  __shared__ int si[256];
  float best = -CUDART_INF_F;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
    const float v = part_max[(size_t)i * B + b];
    const int j = part_idx[(size_t)i * B + b];
    if (v > best || (v == best && j < bi)) { best = v; bi = j; }
  }
  sv[threadIdx.x] = best;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int step = blockDim.x / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) {
      const float ov = sv[threadIdx.x + step];
      const int oi = si[threadIdx.x + step];
      if (ov > sv[threadIdx.x] || (ov == sv[threadIdx.x] && oi < si[threadIdx.x])) {
        sv[threadIdx.x] = ov;
        si[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    ids[b] = si[0] == 0x7fffffff ? 0 : si[0];
    maxv[b] = sv[0];
  }
}

PG_EXPORT int pg_head_argmax(const void* y, const void* w8, const void* s, void* part_max,
                             void* part_idx, void* ids, void* maxv, int B, int K, int N,
                             int n_valid, int k_chunk, void* stream) {
  const int bt = B >= 8 ? 8 : (B >= 4 ? 4 : (B >= 2 ? 2 : 1));
  const int nblk = (N + GV_TILE_N - 1) / GV_TILE_N;
  dim3 grid(nblk, (B + bt - 1) / bt);
  dim3 block(GV_TX, GV_TY);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* yp = (const bf16*)y;
  const int8_t* wp = (const int8_t*)w8;
  const float* sp = (const float*)s;
  float* pm = (float*)part_max;
  int* pi = (int*)part_idx;
  switch (bt) {
    case 8: head_argmax_pass1<8><<<grid, block, 0, st>>>(yp, wp, sp, pm, pi, B, K, N, n_valid, k_chunk); break;
    case 4: head_argmax_pass1<4><<<grid, block, 0, st>>>(yp, wp, sp, pm, pi, B, K, N, n_valid, k_chunk); break;
    case 2: head_argmax_pass1<2><<<grid, block, 0, st>>>(yp, wp, sp, pm, pi, B, K, N, n_valid, k_chunk); break;
    default: head_argmax_pass1<1><<<grid, block, 0, st>>>(yp, wp, sp, pm, pi, B, K, N, n_valid, k_chunk); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_argmax_pass2<<<B, 256, 0, st>>>(pm, pi, nblk, B, (int*)ids, (float*)maxv);
  return (int)cudaGetLastError();
}
