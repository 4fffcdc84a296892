// Fused int8 LM head + argmax for greedy decode.
//
// Replaces paligemma_tpu/kernels/decode_head.py:_kernel (head_argmax_fused):
//   ids(B) = argmax_j round_bf16((y(B, K) . w8(K, N)) fp32 * s(j)),
// first index among equal maxima, columns j >= n_valid never win, and the
// winning logit is returned beside the id.
//
// What bounds it: reading the 2048 x 257152 int8 head (~527 MB) once per
// step; the (B, 257152) logits are never written to device memory. One
// launch: the GEMV tile of gemv_tile.cuh runs over the plan of the logits
// path's int8_gemv at the unpadded vocab (kernels/gemv_plan.py), so its
// fp32 sums, and the rounded logits, are bit-identical to the logits
// path's; each rank of a cluster takes a share of its tile's columns and
// reduces each row to (max, first index of max), which it folds into the
// row's 64-bit key in device memory by an integer atomicMax: the logit's
// bits made order-preserving above, ~index below, so the larger logit wins
// and equal logits go to the lower index, as in the TPU kernel, in any
// order of the CTAs. The last CTA to finish (a counter) turns the keys
// into ids and logits and zeroes the keys and the counter for the next
// call.
//
// The fp32 form (pg_head_argmax_fp32, --dtype float32) takes fp32 y through
// the tile's three-term split (gemv_tile_sums_f32) over the same plan, and
// the rounding of the logits to the activation dtype is the identity, as
// in the TPU kernel at fp32: its ids are the argmax of the fp32 logits
// path's GEMV (pg_int8_gemv_fp32, mode 0) bit for bit. The 64-bit key holds
// all 32 bits of an fp32 logit.
#include <math_constants.h>

#include "gemv_tile.cuh"

// A logit and its column as one key: larger keys are larger logits, and
// at equal logits lower columns.
__device__ __forceinline__ unsigned long long head_key(float v, int col) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (uint32_t)(0xffffffffu - (uint32_t)col);
}

template <class T, bool FAST>
__global__ void __launch_bounds__(32 * GT_MAX_WARPS, 2)
    head_argmax_kernel(const T* __restrict__ y, const int8_t* __restrict__ w,
                       const float* __restrict__ s, unsigned long long* __restrict__ keys,
                       unsigned int* __restrict__ done, int* __restrict__ ids,
                       float* __restrict__ maxv, int B, int K, int N, int n_valid,
                       int k_per_cta, int x8) {
  __shared__ GemvSmem sm;
  __shared__ unsigned long long row_key[GT_BT];
  __shared__ bool last;
  const int rank = cluster_rank(), cs = cluster_size();
  const int col0 = (blockIdx.x / cs) * GT_COLS;
  const int b0 = blockIdx.z * GT_BT;
  const int nb = min(GT_BT, B - b0);
  const int kbeg = rank * k_per_cta;
  const int kend = min(K, kbeg + k_per_cta);
  const int g = (threadIdx.x & 31) >> 2;
  if constexpr (sizeof(T) == 4)  // x8: 16-byte loads of fp32 y
    gemv_tile_sums_f32<FAST>(sm, y, w, K, N, b0, nb, col0 + 16 * g, kbeg, kend, x8 != 0);
  else
    gemv_tile_sums<FAST>(sm, y, w, K, N, b0, nb, col0 + 16 * g, kbeg, kend, x8 != 0);
  cluster_sync_all();
  // this rank's columns [c_lo, c_hi) of the tile, as activation-dtype
  // logits (padded columns -inf) in sm.red, free after the barrier
  float(*lg)[GT_COLS] = sm.red[0];
  const int per = (GT_COLS + cs - 1) / cs;
  const int c_lo = rank * per;
  const int c_hi = min(GT_COLS, c_lo + per);
  for (int idx = threadIdx.x; idx < nb * (c_hi - c_lo); idx += blockDim.x) {
    const int r = idx / (c_hi - c_lo), c = c_lo + idx % (c_hi - c_lo);
    const float acc = gt_cluster_sum(sm, r, c, cs);
    lg[r][c] = col0 + c < n_valid ? to_f32(from_f32<T>(acc * s[col0 + c])) : -CUDART_INF_F;
  }
  __syncthreads();
  // warp w reduces rows w, w + warps, ...
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nb; r += blockDim.x >> 5) {
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int c = c_lo + lane; c < c_hi; c += 32) {
      const float v = lg[r][c];
      if (v > best || (v == best && col0 + c < bi)) { best = v; bi = col0 + c; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    if (lane == 0) row_key[r] = head_key(best, bi);
  }
  cluster_sync_all();  // every rank has read this CTA's sums; row_key is set
  // one warp folds the CTA's rows into the keys at once, then counts the
  // CTA as done once they are visible
  if (warp == 0) {
    if (lane < nb) {
      atomicMax(&keys[b0 + lane], row_key[lane]);
      __threadfence();
    }
    __syncwarp();
    if (lane == 0) last = atomicAdd(done, 1u) == gridDim.x * gridDim.y * gridDim.z - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const unsigned long long key = atomicExch(&keys[b], 0ull);
    const uint32_t ord = (uint32_t)(key >> 32);
    const uint32_t u = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
    ids[b] = key == 0ull ? 0 : (int)(0xffffffffu - (uint32_t)key);
    maxv[b] = key == 0ull ? -CUDART_INF_F : __uint_as_float(u);
  }
  if (threadIdx.x == 0) atomicExch(done, 0u);
}

// y (B, K) bf16, w8 (K, N) int8 with N a multiple of 128 (the padded
// vocab), s (N,) fp32, columns >= n_valid never win; cluster, warps and
// k_per_cta from the plan of the unpadded vocab; ws: B 64-bit keys and a
// counter, all zero (each call leaves them so).
template <class T>
static int launch_head(const void* y, const void* w8, const void* s, void* ws, void* ids,
                       void* maxv, int B, int K, int N, int n_valid, int cluster, int warps,
                       int k_per_cta, void* stream) {
  const dim3 grid((N / GT_COLS) * cluster, 1, (B + GT_BT - 1) / GT_BT);
  const bool fast = N % 16 == 0 && (uintptr_t)w8 % 16 == 0;
  const int x8 = K % 4 == 0 && (uintptr_t)y % (4 * sizeof(T)) == 0;
  auto kernel = &head_argmax_kernel<T, false>;
  if (fast) kernel = &head_argmax_kernel<T, true>;
  unsigned long long* keys = (unsigned long long*)ws;
  return gt_launch(kernel, grid, cluster, warps, (cudaStream_t)stream, (const T*)y,
                   (const int8_t*)w8, (const float*)s, keys, (unsigned int*)(keys + B), (int*)ids,
                   (float*)maxv, B, K, N, n_valid, k_per_cta, x8);
}

PG_EXPORT int pg_head_argmax(const void* y, const void* w8, const void* s, void* ws, void* ids,
                             void* maxv, int B, int K, int N, int n_valid, int cluster, int warps,
                             int k_per_cta, void* stream) {
  return launch_head<bf16>(y, w8, s, ws, ids, maxv, B, K, N, n_valid, cluster, warps, k_per_cta,
                           stream);
}

// The fp32 form: y (B, K) fp32, the rest as pg_head_argmax.
PG_EXPORT int pg_head_argmax_fp32(const void* y, const void* w8, const void* s, void* ws,
                                  void* ids, void* maxv, int B, int K, int N, int n_valid,
                                  int cluster, int warps, int k_per_cta, void* stream) {
  return launch_head<float>(y, w8, s, ws, ids, maxv, B, K, N, n_valid, cluster, warps,
                            k_per_cta, stream);
}
