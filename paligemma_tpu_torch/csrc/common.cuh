// Shared helpers for the hand-written Hopper kernels of paligemma_tpu_torch.
//
// Every C entry point launches on the stream it is given, allocates nothing
// (the Python wrapper passes outputs and scratch), and returns
// cudaGetLastError() so a refused launch is reported at its call site.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PG_EXPORT extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

// Finite "minus infinity" of the online softmax, as in the TPU kernel
// (kernels/flash_attention.py NEG_INF): exp(NEG_INF - m) underflows to 0
// without the inf - inf = nan of a true -inf.
#define PG_NEG_INF (-1e30f)

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// An fp32 value in the activation type T (bf16: rounded to nearest even;
// fp32: itself), and back: the kernels with an fp32 form (--dtype float32)
// take T as a template parameter, and at T = float every cast is the
// identity, as the TPU kernels' casts to the activation dtype are at fp32.
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return f2bf(v); }
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 8 bf16 values held in one 16-byte vector, converted to fp32.
__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float gelu_tanh_f(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// ---------------------------------------------------------------------------
// One warp-wide bf16 tensor-core product, mma.sync.m16n8k16 with fp32
// accumulators: c (16x8) += a (16x16, row-major) . b (16x8, column-major).
// With g = lane / 4 and t = lane % 4, the fragments hold
//   a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//   a[2] = A[g][2t+8..+9],   a[3] = A[g+8][2t+8..+9],
//   b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..+9][g],
//   c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1],
// each 32-bit register two bf16 with the lower index in the low half.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values (lo at the lower index) in one 32-bit register.
__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two fp32 values rounded to bf16 (round to nearest even) in one register.
__device__ __forceinline__ uint32_t pack_f32_bf16x2(float lo, float hi) {
  return pack_bf16x2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// The 32-bit register at a 4-byte aligned bf16 address in shared memory.
__device__ __forceinline__ uint32_t ld_bf16x2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// Tile movement for the mma.sync kernels (flash_attention_bwd.cu).
//
// ldmatrix: a warp reads four 8x8 bf16 matrices from shared memory; lanes
// 8i .. 8i+7 give the addresses of the 8 rows (16 contiguous bytes each) of
// matrix i, and register i of lane l receives matrix i's row l / 4, columns
// 2(l % 4) and 2(l % 4) + 1. With .trans lane l receives rows 2(l % 4) and
// 2(l % 4) + 1 of column l / 4 instead, i.e. the transposed matrix's
// fragment. So, with lr = lane % 8 and lm = lane / 8 and a row-major tile T:
//   A fragment of rows r0.., columns c0.. (m16 x k16): row r0 + (lm & 1) * 8
//     + lr, column c0 + (lm >> 1) * 8, plain;
//   B fragments of two n8 tiles n0, n0 + 8 at depth c0.. with T[n][k]
//     (B = T^T): row n0 + (lm >> 1) * 8 + lr, column c0 + (lm & 1) * 8, plain;
//     registers 0-1 are tile n0's b[0..1], 2-3 tile n0 + 8's;
//   the same with T[k][n] (B = T): row k0 + (lm & 1) * 8 + lr, column n0 +
//     (lm >> 1) * 8, .trans.
// Rows padded to a stride of 16 bytes mod 128 keep all four free of bank
// conflicts.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Asynchronous copies from device to shared memory (sm_80+): 16, 8 or 4
// bytes (both addresses aligned to the size); with ok false nothing is
// read (src may be any valid address) and the destination is zero-filled,
// which is how a tile's ragged edge is padded.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight
// (a __syncthreads() after it makes every thread's copies visible).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Clusters (sm_90): this CTA's rank, the cluster's size, a barrier of every
// thread of the cluster (release / acquire: shared-memory writes before it
// are visible to the other ranks after it), and a load from another rank's
// shared memory.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// The two halves of cluster_sync_all: arrive (release) and wait
// (acquire), so that work runs between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float ld_cluster_f32(const float* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_addr(p)), "r"((uint32_t)rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Launch CTAs of `threads` threads and `smem` bytes of dynamic shared
// memory in clusters of `cs` along x (cudaLaunchKernelEx); returns the
// launch's error, or else cudaGetLastError().
template <typename... KArgs, typename... Args>
inline int cluster_launch(void (*kernel)(KArgs...), dim3 grid, int threads, int cs, int smem,
                          cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
