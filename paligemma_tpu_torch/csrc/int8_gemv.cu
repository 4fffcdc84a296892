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
// Modes 0-2 have a second epilogue kernel with the LoRA expand
// (pg_int8_gemv_epilogue_lora): the adapter delta of each row,
// d(b, j) = sum_g z(b, zoff(j) + g) * B(g, j) in fp32, with z (B, nz) the
// masked adapter basis of kernels/lora (csrc/lora.cu) and B (G, N) the
// alpha-folded adapter rows, fp32 or bf16, each element rounded to bf16 as
// the TPU kernel casts its operands. It is added where the TPU kernel
// (paligemma_tpu/kernels/decode_layer.py _kernel_all, lora=True) adds it:
//   mode 0 (qkv):     out = cast(cast(acc * s) + cast(d))
//   mode 1 (o, down): out = cast(cast(residual + cast(acc * s)) + cast(d))
//   mode 2 (gate/up): g = acc_g * s_g + d_g, u = acc_u * s_u + d_u in fp32,
//                     before the GeGLU
// A column reads only its own target's G rows of z: zoff(j) = G times the
// number of target boundaries seg1 <= seg2 at or below j (q | k | v for
// qkv, gate | up for gateup, one target for o and down). Each B element is
// read once per 8 rows (it is staged in shared memory for a tile of 32
// columns and 8 rows). The kernel without LoRA is untouched, so its bits
// are what they were.
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

// ---------------------------------------------------------------------------
// The epilogue with the LoRA expand (modes 0-2). A block covers EL_TX
// output columns and EL_TY rows, a thread one element; the tile's columns
// of B are staged in shared memory EL_GC adapter rows at a time, so each B
// element is read once per EL_TY rows.
// ---------------------------------------------------------------------------
#define EL_TX 32
#define EL_TY 8
#define EL_GC 64

struct LoraExpand {
  const bf16* z;   // (B, nz) masked adapter basis
  const void* lb;  // (G, N) adapter rows, fp32 (lb_f32) or bf16
  int lb_f32, G, nz, seg1, seg2;

  // element (g, col) of B, rounded to bf16
  __device__ __forceinline__ float b_at(int g, int col, int N) const {
    const size_t at = (size_t)g * N + col;
    return lb_f32 ? bf2f(f2bf(((const float*)lb)[at])) : bf2f(((const bf16*)lb)[at]);
  }
  // row b's G-wide block of z for output column col
  __device__ __forceinline__ const bf16* z_block(int b, int col) const {
    return z + (size_t)b * nz + G * ((col >= seg1) + (col >= seg2));
  }
};

__global__ void __launch_bounds__(EL_TX* EL_TY)
    int8_gemv_epilogue_lora_kernel(const float* __restrict__ part, int nsplit, int B, int N,
                                   const float* __restrict__ s, const bf16* __restrict__ residual,
                                   bf16* __restrict__ out, int mode, LoraExpand lora) {
  __shared__ float bs[2][EL_GC][EL_TX];  // B of the tile's columns (and up columns)
  const int n_out = mode == 2 ? N / 2 : N;
  const int nt = mode == 2 ? 2 : 1;  // columns of w8 per output element
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * EL_TX + tx;
  const int b = blockIdx.y * EL_TY + ty;
  const bool live = j < n_out && b < B;
  // the row's deltas at column j (and at up column n_out + j), summed over g in order
  float d[2] = {0.f, 0.f};
  for (int g0 = 0; g0 < lora.G; g0 += EL_GC) {
    const int gn = min(EL_GC, lora.G - g0);
    __syncthreads();  // the previous rows of B are no longer read
    for (int i = ty; i < nt * gn; i += EL_TY) {
      const int t = i / gn, g = i - t * gn;
      bs[t][g][tx] = j < n_out ? lora.b_at(g0 + g, j + t * n_out, N) : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < nt; ++t) {
        const bf16* zr = lora.z_block(b, j + t * n_out) + g0;
        for (int g = 0; g < gn; ++g) d[t] = fmaf(bf2f(zr[g]), bs[t][g][tx], d[t]);
      }
    }
  }
  if (!live) return;
  const size_t idx = (size_t)b * n_out + j;
  float acc = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) acc += part[((size_t)sp * B + b) * N + j];
  if (mode == 2) {
    float up = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) up += part[((size_t)sp * B + b) * N + n_out + j];
    // __fmul_rn: the product is rounded before the delta is added (no FMA
    // contraction), as the TPU kernel adds them
    const float g = __fmul_rn(acc, s[j]) + d[0];
    const float u = __fmul_rn(up, s[n_out + j]) + d[1];
    out[idx] = f2bf(gelu_tanh_f(g) * u);
    return;
  }
  bf16 v = f2bf(acc * s[j]);
  if (mode == 1) v = f2bf(bf2f(residual[idx]) + bf2f(v));
  out[idx] = f2bf(bf2f(v) + bf2f(f2bf(d[0])));
}

// Modes 0-2 with the LoRA expand: z (B, nz) bf16, lb (G, N) fp32 or bf16,
// column boundaries seg1 <= seg2 (N where there is none).
PG_EXPORT int pg_int8_gemv_epilogue_lora(const void* part, int nsplit, int B, int N,
                                         const void* s, const void* residual, void* out,
                                         int mode, const void* z, const void* lb, int lb_f32,
                                         int G, int nz, int seg1, int seg2, void* stream) {
  const int n_out = mode == 2 ? N / 2 : N;
  dim3 grid((n_out + EL_TX - 1) / EL_TX, (B + EL_TY - 1) / EL_TY);
  int8_gemv_epilogue_lora_kernel<<<grid, dim3(EL_TX, EL_TY), 0, (cudaStream_t)stream>>>(
      (const float*)part, nsplit, B, N, (const float*)s, (const bf16*)residual, (bf16*)out, mode,
      LoraExpand{(const bf16*)z, lb, lb_f32, G, nz, seg1, seg2});
  return (int)cudaGetLastError();
}
