// The LoRA shrink of multi-LoRA decode: each row's masked adapter basis.
//
// Replaces the adapter-basis dots of the TPU kernel
// paligemma_tpu/kernels/decode_layer.py:_kernel_all with lora=True (and of
// paligemma_tpu/kernels/decode_layer_paged.py:_kernel_paged, which uses
// the same operands):
//
//   z (B, nG) = cast_bf16(x (B, K) . A (K, nG), fp32 sums) * mask
//   mask[b, c] = ((c % G) / rank == ids[b])
//
// A is the concat basis of kernels/decode_layer.repack_lora_bank_fused (the
// N+1 adapters' A columns side by side, G = (N+1) * rank padded, one G
// block per target: q | k | v over the hidden size for qkv, the o basis
// over the attention width, gate | up, down over the intermediate size),
// fp32 or bf16, each element rounded to bf16 on load as the TPU kernel
// casts its operands to the activation dtype. The mask keeps the row's own
// adapter block; bank row 0 is the zero adapter, so a base-model row gets
// z = 0 and a delta of exactly 0. The expand (z . B) runs in the epilogue
// of the int8 GEMV of the same projection (csrc/int8_gemv.cuh).
//
// What bounds it: the bytes of A (0.26-2.1 MB per target group at
// Gemma-2B with 3 fp32 adapters of rank 8: 0.08-0.63 us at 3.35 TB/s); x
// and z are a few KB, the products 2 B K nG flops. At these sizes a launch
// is latency: one launch, with every load of A in flight at once. A CTA of
// 256 or 512 threads covers LS_COLS columns of A and one rank's K range of
// a cluster of up to 8 CTAs (kernels/lora.ShrinkPlan, from (K, nG) alone:
// up to 2048 rows a rank). Its threads read A in 16-byte vectors (4 fp32 or
// 8 bf16 columns of one row), LOADS rows each in flight (128 bytes),
// against x's rows of the batch tile copied to shared memory (cp.async, all
// in flight at once). Each thread sums its rows in order; the warp's row
// lanes are added by a fixed butterfly of shuffles, the warps in order in
// shared memory, and the cluster's ranks in rank order through distributed
// shared memory by the last rank, which applies the mask and the one bf16
// cast. So the sum over K is one fp32 sum cast once, as the TPU kernel sums
// the down basis over the whole intermediate dimension before its one cast,
// and its order depends on (K, nG) and A's dtype only.
//
// With a norm (NORM: the TPU kernel's shrink reads the normalized row, as
// its qkv and gate/up dots do) the staged rows are y = bf16((x * r) * (1 +
// w)) instead of x, with r and y computed by gemv_tile.cuh's gt_row_rsqrt
// and gt_norm8: the bits the GEMV of the same row multiplies.
//
// The fp32 form (pg_lora_shrink_fp32, --dtype float32): x, the norm weight
// and z are fp32, and every cast to the activation dtype is the identity, as
// the TPU kernel's casts are at fp32. A is read as it is (an fp32 element
// is not rounded; bf16 widens exactly), the staged rows are fp32 (half as
// many K rows a chunk: LS_XBYTES of shared memory either way), the norm is
// gemv_tile.cuh's fp32 prologue (gt_row_rsqrt_f32, gt_norm4: the y of the
// fp32 GEMV of the same row, unrounded), and z leaves the cluster's fp32 sum
// times the mask, unrounded. The products are FFMA on the CUDA cores, as at
// bf16: 2 B K nG flops (0.3 MFLOP at B8 for the qkv group) are nothing
// beside the launch, which bounds the shrink at both types.
#include "gemv_tile.cuh"

#define LS_MAX_THREADS 512  // threads per CTA: 256 or 512 (kernels/lora.ShrinkPlan)
#define LS_COLS 8           // columns of A per CTA
#define LS_XBYTES 4096      // bytes of each staged row of x: 2048 bf16 or 1024 fp32 K rows

template <typename TX>
struct __align__(16) ShrinkSmem {
  static constexpr int XROWS = LS_XBYTES / sizeof(TX);  // K rows of x staged at a time
  TX xs[GT_BT][XROWS];                             // x (or y) rows b0 .. b0+7 at the chunk's K rows
  float rnorm[GT_BT];                              // NORM: each row's rsqrt(mean(x^2) + eps)
  float red[LS_MAX_THREADS / 32][GT_BT][LS_COLS];  // each warp's sums
  float sum[GT_BT][LS_COLS];                       // the CTA's sums, read by the cluster
};

// 16 bytes of A as CPT values in the activation type TX: fp32 A rounded to
// bf16 for bf16 x, as it is for fp32 x; bf16 A widened (exact)
template <typename TX>
__device__ __forceinline__ void a_values(const uint4& v, float (&w)[4]) {
  const float f[4] = {__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                      __uint_as_float(v.w)};
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = to_f32(from_f32<TX>(f[c]));
}
template <typename TX>
__device__ __forceinline__ void a_values(const uint4& v, float (&w)[8]) {
  bf16x8_to_float(v, w);
}

// 16 bytes of y = norm(x) at x's 16 bytes xp and the norm weight's wp
__device__ __forceinline__ uint4 norm16(const bf16* xp, const bf16* wp, float r) {
  return gt_norm8(ldg_16(xp), ldg_16(wp), r);
}
__device__ __forceinline__ uint4 norm16(const float* xp, const float* wp, float r) {
  const float4 y = gt_norm4(ldg_f4(xp), ldg_f4(wp), r);
  return make_uint4(__float_as_uint(y.x), __float_as_uint(y.y), __float_as_uint(y.z),
                    __float_as_uint(y.w));
}

// Reduce-scatter over the lanes that differ in bits M, M/2, .., MIN: at
// each step a lane keeps half of its N values and adds its partner's; after
// it the lane with bits (..) holds the sums of values base .. base + N_end
// - 1, base = the sum of N_step / 2 over the steps whose bit it has. The
// order of every sum is fixed by the lanes alone.
template <int N, int M, int MIN>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (M >= MIN) {
    const bool upper = lane & M;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    reduce_scatter<N / 2, M / 2, MIN>(v, lane);
  }
}

// TX: the activation type of x, the norm weight and z (bf16, or fp32: the
// fp32 form). CPT: A's columns per 16-byte load (4 fp32, 8 bf16); TPR =
// LS_COLS / CPT threads share a K row, so the CTA has THREADS / TPR row lanes.
template <typename TX, typename TA, int THREADS, bool NORM>
__global__ void __launch_bounds__(THREADS, 1)
    lora_shrink_kernel(const TX* __restrict__ x, const TA* __restrict__ a,
                       const int* __restrict__ ids, TX* __restrict__ z, int B, int K, int NG,
                       int G, int rank_size, int k_per_cta, typename GtNorm<TX>::type norm) {
  constexpr int CPT = 16 / sizeof(TA), TPR = LS_COLS / CPT, LANES = THREADS / TPR;
  constexpr int LOADS = 32 / CPT;  // rows of A in flight per thread: 128 bytes
  constexpr int V = GT_BT * CPT;  // a thread's sums: batch row x column
  constexpr int XROWS = ShrinkSmem<TX>::XROWS, EPV = 16 / sizeof(TX);  // x elements a 16 bytes
  __shared__ ShrinkSmem<TX> sm;
  const int rank = cluster_rank(), cs = cluster_size();
  const int col0 = (blockIdx.x / cs) * LS_COLS;
  const int b0 = blockIdx.z * GT_BT;
  const int nb = min(GT_BT, B - b0);
  const int kbeg = rank * k_per_cta, kend = min(K, kbeg + k_per_cta);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = tid / TPR, ch = tid % TPR;  // row lane, column part
  const TA* ap = a + col0 + ch * CPT;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if constexpr (NORM) {  // each row's r, one warp a row
    for (int r = warp; r < nb; r += THREADS / 32) {
      const float rs = gt_row_rsqrt_t(x + (size_t)(b0 + r) * K, K, norm.eps);
      if (lane == 0) sm.rnorm[r] = rs;
    }
  }
  for (int c0 = kbeg; c0 < kend; c0 += XROWS) {
    const int c1 = min(kend, c0 + XROWS);
    const int mine = c1 - c0 > rl ? (c1 - c0 - rl + LANES - 1) / LANES : 0;  // rows of this lane
    uint4 wv[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i)  // in flight while x is staged
      if (i < mine)
        wv[i] = *reinterpret_cast<const uint4*>(ap + (size_t)(c0 + rl + i * LANES) * NG);
    __syncthreads();  // the previous chunk of x is no longer read (NORM: r is written)
    const int nv = (c1 - c0) / EPV;  // 16-byte pieces of a row
    for (int i = tid; i < GT_BT * nv; i += THREADS) {  // rows past B read as zeros
      const int r = i / nv, kv = (i % nv) * EPV;
      const TX* src = x + (size_t)(b0 + min(r, nb - 1)) * K + c0 + kv;
      if constexpr (NORM)
        *reinterpret_cast<uint4*>(&sm.xs[r][kv]) =
            r < nb ? norm16(src, norm.w + c0 + kv, sm.rnorm[r]) : make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async_16(&sm.xs[r][kv], src, r < nb);
    }
    if constexpr (!NORM) {
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int i0 = 0; i0 < mine; i0 += LOADS) {
      if (i0 > 0) {
#pragma unroll
        for (int i = 0; i < LOADS; ++i)
          if (i0 + i < mine)
            wv[i] = *reinterpret_cast<const uint4*>(
                ap + (size_t)(c0 + rl + (i0 + i) * LANES) * NG);
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        if (i0 + i >= mine) break;
        const int k = rl + (i0 + i) * LANES;
        float w[CPT];
        a_values<TX>(wv[i], w);
#pragma unroll
        for (int r = 0; r < GT_BT; ++r) {
          const float xr = to_f32(sm.xs[r][k]);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r * CPT + c] = fmaf(xr, w[c], acc[r * CPT + c]);
        }
      }
    }
  }
  // the warp's row lanes (lane bits log2(TPR) .. 4): each lane keeps 2 sums
  reduce_scatter<V, 16, TPR>(acc, lane);
  const int base = (lane / TPR) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (base + i) / CPT, c = (base + i) % CPT;
    sm.red[warp][r][ch * CPT + c] = acc[i];
  }
  __syncthreads();
  if (tid < GT_BT * LS_COLS) {
    const int r = tid / LS_COLS, c = tid % LS_COLS;
    float v = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) v += sm.red[w][r][c];
    sm.sum[r][c] = v;
  }
  cluster_sync_all();
  if (rank == cs - 1 && tid < nb * LS_COLS) {
    const int r = tid / LS_COLS, c = tid % LS_COLS, col = col0 + c;
    float v = 0.f;
    for (int q = 0; q < cs; ++q) v += ld_cluster_f32(&sm.sum[r][c], q);
    const float m = (col % G) / rank_size == ids[b0 + r] ? 1.f : 0.f;
    z[(size_t)(b0 + r) * NG + col] = from_f32<TX>(to_f32(from_f32<TX>(v)) * m);
  }
  cluster_sync_all();  // the last rank has read every rank's sums
}

template <typename TX, typename TA, int THREADS>
static int launch_shrink(const void* x, const void* a, const void* ids, void* z, int B, int K,
                         int NG, int G, int rank, int cluster, int k_per_cta, const void* nw,
                         float eps, void* stream) {
  const dim3 grid(NG / LS_COLS * cluster, 1, (B + GT_BT - 1) / GT_BT);
  auto kernel = nw != nullptr ? &lora_shrink_kernel<TX, TA, THREADS, true>
                              : &lora_shrink_kernel<TX, TA, THREADS, false>;
  const typename GtNorm<TX>::type norm{(const TX*)nw, eps};
  return cluster_launch(kernel, grid, THREADS, cluster, 0, (cudaStream_t)stream, (const TX*)x,
                        (const TA*)a, (const int*)ids, (TX*)z, B, K, NG, G, rank, k_per_cta,
                        norm);
}

template <typename TX>
static int shrink(const void* x, const void* a, int a_f32, const void* ids, void* z, int B, int K,
                  int NG, int G, int rank, int cluster, int k_per_cta, int threads,
                  const void* nw, float eps, void* stream) {
  if (threads == 256)
    return a_f32 ? launch_shrink<TX, float, 256>(x, a, ids, z, B, K, NG, G, rank, cluster,
                                                 k_per_cta, nw, eps, stream)
                 : launch_shrink<TX, bf16, 256>(x, a, ids, z, B, K, NG, G, rank, cluster,
                                                k_per_cta, nw, eps, stream);
  if (threads != LS_MAX_THREADS) return (int)cudaErrorInvalidValue;
  return a_f32 ? launch_shrink<TX, float, 512>(x, a, ids, z, B, K, NG, G, rank, cluster,
                                               k_per_cta, nw, eps, stream)
               : launch_shrink<TX, bf16, 512>(x, a, ids, z, B, K, NG, G, rank, cluster,
                                              k_per_cta, nw, eps, stream);
}

// x (B, K) bf16, a (K, NG) fp32 (a_f32) or bf16, ids (B,) int32, z (B, NG)
// bf16 out; NG % 8 == 0, K % 8 == 0, x and a 16-byte aligned; cluster,
// k_per_cta (a multiple of 8) and threads (256 or 512) from
// kernels/lora.ShrinkPlan; nw (K,) bf16, 16-byte aligned, or null: the
// norm of x by nw and eps before the product.
PG_EXPORT int pg_lora_shrink(const void* x, const void* a, int a_f32, const void* ids, void* z,
                             int B, int K, int NG, int G, int rank, int cluster, int k_per_cta,
                             int threads, const void* nw, float eps, void* stream) {
  return shrink<bf16>(x, a, a_f32, ids, z, B, K, NG, G, rank, cluster, k_per_cta, threads, nw,
                      eps, stream);
}

// The fp32 form: x (B, K), z (B, NG) and nw (K,) fp32, the rest as
// pg_lora_shrink.
PG_EXPORT int pg_lora_shrink_fp32(const void* x, const void* a, int a_f32, const void* ids,
                                  void* z, int B, int K, int NG, int G, int rank, int cluster,
                                  int k_per_cta, int threads, const void* nw, float eps,
                                  void* stream) {
  return shrink<float>(x, a, a_f32, ids, z, B, K, NG, G, rank, cluster, k_per_cta, threads, nw,
                       eps, stream);
}
