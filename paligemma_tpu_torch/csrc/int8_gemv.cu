// int8 weight-only GEMV for single-token decode, with fused epilogues.
//
// Replaces the weight streams of the TPU kernel
// paligemma_tpu/kernels/decode_layer.py:_kernel_all (the int8 qkv, o-proj,
// gate/up and down dots with their per-channel scales) and serves the int8
// LM-head logits of paligemma_tpu/models/gemma.py:lm_head on the logits path.
//
//   out(B, N) = cast_bf16((x(B, K) . w8(K, N)) fp32 * s(N))      mode 0
//   out       = cast_bf16(residual + cast_bf16(...))              mode 1
//   out(B, I) = cast_bf16(gelu_tanh(g_j) * u_j), N = 2I,          mode 2
//               g_j = column j, u_j = column I + j (fused gateup)
//   out(B, N) = (x . w8) fp32 * s, written as fp32                mode 3
//
// Mode 3, the fp32 partial, serves the tensor-parallel decode: it replaces
// the o-proj partial of paligemma_tpu/kernels/decode_layer_tp.py:_attn_kernel
// and the down-proj partial of paligemma_tpu/kernels/decode_mlp.py:_kernel
// under out_dtype=float32. Each rank's partial leaves here uncast; the ranks'
// sum is cast once after the all-reduce, so on one rank the result has the
// bits of mode 1's cast-then-add.
//
// What bounds it: at decode batches (tens of rows) each weight byte is used B times, far below
// the ~295 flop/byte where the card turns compute-bound, so it is bound by
// reading w8 from device memory. The design reads each weight byte once per
// batch tile in 128-byte coalesced warp rows, and splits K over blocks so
// that even the 2048-column projections put enough blocks on the 132 SMs;
// fp32 partials (k_split, B, N) go to scratch and a second small kernel sums
// them in split order and applies the scale and the epilogue (the partials
// are ~1% of the weight bytes at these shapes).
#include "common.cuh"

template <int BT>
__global__ void __launch_bounds__(GV_TX* GV_TY)
    int8_gemv_partial_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                             float* __restrict__ part, int B, int K, int N, int k_chunk) {
  __shared__ GemvSmem<BT> sm;
  const int col0 = blockIdx.x * GV_TILE_N;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, B - b0);
  const int kbeg = split * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  gemv_tile<BT>(sm, x, w, K, N, b0, nb, col0, kbeg, kend);
  const int tid = threadIdx.y * GV_TX + threadIdx.x;
  for (int idx = tid; idx < nb * GV_TILE_N; idx += GV_TX * GV_TY) {
    const int r = idx / GV_TILE_N, cl = idx - r * GV_TILE_N;
    const int col = col0 + cl;
    if (col < N) part[((size_t)split * B + b0 + r) * N + col] = gemv_tile_sum<BT>(sm, r, cl);
  }
}

__global__ void int8_gemv_epilogue_kernel(const float* __restrict__ part, int nsplit, int B,
                                          int N, const float* __restrict__ s,
                                          const bf16* __restrict__ residual,
                                          void* __restrict__ out, int mode) {
  const int n_out = mode == 2 ? N / 2 : N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * n_out) return;
  const int b = (int)(idx / n_out), j = (int)(idx - (size_t)b * n_out);
  float acc = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) acc += part[((size_t)sp * B + b) * N + j];
  if (mode == 2) {
    float up = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) up += part[((size_t)sp * B + b) * N + n_out + j];
    const float g = acc * s[j];
    const float u = up * s[n_out + j];
    ((bf16*)out)[idx] = f2bf(gelu_tanh_f(g) * u);
    return;
  }
  if (mode == 3) {
    ((float*)out)[idx] = acc * s[j];
    return;
  }
  bf16 v = f2bf(acc * s[j]);
  if (mode == 1) v = f2bf(bf2f(residual[idx]) + bf2f(v));
  ((bf16*)out)[idx] = v;
}

PG_EXPORT int pg_int8_gemv_partial(const void* x, const void* w8, void* part, int B, int K, int N,
                                   int k_chunk, void* stream) {
  const int nsplit = (K + k_chunk - 1) / k_chunk;
  const int bt = B >= 8 ? 8 : (B >= 4 ? 4 : (B >= 2 ? 2 : 1));
  dim3 grid((N + GV_TILE_N - 1) / GV_TILE_N, nsplit, (B + bt - 1) / bt);
  dim3 block(GV_TX, GV_TY);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xp = (const bf16*)x;
  const int8_t* wp = (const int8_t*)w8;
  float* pp = (float*)part;
  switch (bt) {
    case 8: int8_gemv_partial_kernel<8><<<grid, block, 0, st>>>(xp, wp, pp, B, K, N, k_chunk); break;
    case 4: int8_gemv_partial_kernel<4><<<grid, block, 0, st>>>(xp, wp, pp, B, K, N, k_chunk); break;
    case 2: int8_gemv_partial_kernel<2><<<grid, block, 0, st>>>(xp, wp, pp, B, K, N, k_chunk); break;
    default: int8_gemv_partial_kernel<1><<<grid, block, 0, st>>>(xp, wp, pp, B, K, N, k_chunk); break;
  }
  return (int)cudaGetLastError();
}

PG_EXPORT int pg_int8_gemv_epilogue(const void* part, int nsplit, int B, int N, const void* s,
                                    const void* residual, void* out, int mode, void* stream) {
  const int n_out = mode == 2 ? N / 2 : N;
  const size_t total = (size_t)B * n_out;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  int8_gemv_epilogue_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)part, nsplit, B, N, (const float*)s, (const bf16*)residual, out, mode);
  return (int)cudaGetLastError();
}
