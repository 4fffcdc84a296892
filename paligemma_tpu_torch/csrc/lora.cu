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
// of the int8 GEMV of the same projection (csrc/int8_gemv.cu).
//
// What bounds it: the bytes of A (0.26-2.1 MB per target group at
// Gemma-2B with 3 fp32 adapters of rank 8); x and z are a few KB. The
// design reads each A element once per batch tile of up to 8 rows, a warp
// reading 32 consecutive columns of one A row against the tile's rows of x
// staged in shared memory, and splits K over blocks (fp32 partials, 64-512
// rows each) so that every group puts enough blocks on the SMs. A second
// small kernel adds the partials in split order, so the sum over K is one
// fp32 sum cast once, as the TPU kernel sums the down basis over the whole
// intermediate dimension before its one cast.
#include "common.cuh"

#define LS_TX 32      // columns per block
#define LS_TY 8       // K rows in flight per block
#define LS_KC_MAX 512  // K rows per split, at most

__device__ __forceinline__ float bf16_rounded(float v) { return bf2f(f2bf(v)); }
__device__ __forceinline__ float bf16_rounded(bf16 v) { return bf2f(v); }

template <int BT, typename TA>
__global__ void __launch_bounds__(LS_TX* LS_TY)
    lora_shrink_partial_kernel(const bf16* __restrict__ x, const TA* __restrict__ a,
                               float* __restrict__ part, int B, int K, int NG, int k_chunk) {
  __shared__ float xs[BT][LS_KC_MAX];
  __shared__ float red[LS_TY][BT][LS_TX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * LS_TX + tx;
  const int col = blockIdx.x * LS_TX + tx;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, B - b0);
  const int kbeg = split * k_chunk;
  const int kc = min(K, kbeg + k_chunk) - kbeg;
  for (int i = tid; i < BT * kc; i += LS_TX * LS_TY) {
    const int r = i / kc, kk = i - r * kc;
    xs[r][kk] = r < nb ? bf2f(x[(size_t)(b0 + r) * K + kbeg + kk]) : 0.f;
  }
  __syncthreads();
  float acc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = 0.f;
  if (col < NG) {
    const TA* ap = a + (size_t)kbeg * NG + col;
    for (int k = ty; k < kc; k += LS_TY) {
      const float w = bf16_rounded(ap[(size_t)k * NG]);
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = fmaf(xs[r][k], w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) red[ty][r][tx] = acc[r];
  __syncthreads();
  if (col < NG) {
    // thread (tx, ty) sums row ty of the tile over the LS_TY partials, in order
    for (int r = ty; r < nb; r += LS_TY) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < LS_TY; ++y) s += red[y][r][tx];
      part[((size_t)split * B + b0 + r) * NG + col] = s;
    }
  }
}

__global__ void lora_shrink_finish_kernel(const float* __restrict__ part, int nsplit, int B,
                                          int NG, const int* __restrict__ ids, int G, int rank,
                                          bf16* __restrict__ z) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * NG) return;
  const int b = (int)(idx / NG), c = (int)(idx - (size_t)b * NG);
  float acc = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) acc += part[((size_t)sp * B + b) * NG + c];
  const float m = ((c % G) / rank == ids[b]) ? 1.f : 0.f;
  z[idx] = f2bf(bf2f(f2bf(acc)) * m);
}

template <typename TA>
static void shrink_partial(const bf16* x, const TA* a, float* part, int B, int K, int NG,
                           int k_chunk, cudaStream_t st) {
  const int nsplit = (K + k_chunk - 1) / k_chunk;
  const int bt = B >= 8 ? 8 : (B >= 4 ? 4 : (B >= 2 ? 2 : 1));
  dim3 grid((NG + LS_TX - 1) / LS_TX, nsplit, (B + bt - 1) / bt);
  dim3 block(LS_TX, LS_TY);
  switch (bt) {
    case 8: lora_shrink_partial_kernel<8, TA><<<grid, block, 0, st>>>(x, a, part, B, K, NG, k_chunk); break;
    case 4: lora_shrink_partial_kernel<4, TA><<<grid, block, 0, st>>>(x, a, part, B, K, NG, k_chunk); break;
    case 2: lora_shrink_partial_kernel<2, TA><<<grid, block, 0, st>>>(x, a, part, B, K, NG, k_chunk); break;
    default: lora_shrink_partial_kernel<1, TA><<<grid, block, 0, st>>>(x, a, part, B, K, NG, k_chunk); break;
  }
}

// x (B, K) bf16, a (K, NG) fp32 (a_f32) or bf16, part (nsplit, B, NG) fp32
// scratch, ids (B,) int32, z (B, NG) bf16 out; NG % G == 0, k_chunk <= 512.
PG_EXPORT int pg_lora_shrink(const void* x, const void* a, int a_f32, void* part, const void* ids,
                             void* z, int B, int K, int NG, int G, int rank, int k_chunk,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a_f32)
    shrink_partial((const bf16*)x, (const float*)a, (float*)part, B, K, NG, k_chunk, st);
  else
    shrink_partial((const bf16*)x, (const bf16*)a, (float*)part, B, K, NG, k_chunk, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (K + k_chunk - 1) / k_chunk;
  const size_t total = (size_t)B * NG;
  const int threads = 256;
  lora_shrink_finish_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const float*)part, nsplit, B, NG, (const int*)ids, G, rank, (bf16*)z);
  return (int)cudaGetLastError();
}
