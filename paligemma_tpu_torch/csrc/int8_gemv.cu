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
//   out(B, N) = (x . w8) fp32, unscaled, written as fp32          mode 4
//
// One launch per GEMV: the product runs on the tensor cores over the
// shared tile of gemv_tile.cuh, K is split over the CTAs of a thread-block
// cluster and reduced through distributed shared memory, and the epilogue
// of the mode runs in the same kernel. kernels/gemv_plan.py fixes the
// split: the cluster size and each CTA's K range, from (K, N) alone.
//
// Mode 4 feeds the LoRA expand (pg_int8_gemv_epilogue_lora, below, with
// nsplit = 1): modes 0-2 with a LoRA adapter write the cluster-reduced sums
// to scratch and that kernel adds each row's adapter delta: d(b, j) =
// sum_g z(b, zoff(j) + g) * B(g, j) in fp32, with z (B, nz) the masked
// adapter basis of kernels/lora (csrc/lora.cu) and B (G, N) the
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
// columns and 8 rows). With a zero delta its bits are those of the fused
// epilogue.
//
// Mode 3, the fp32 partial, serves the tensor-parallel decode: it replaces
// the o-proj partial of paligemma_tpu/kernels/decode_layer_tp.py:_attn_kernel
// and the down-proj partial of paligemma_tpu/kernels/decode_mlp.py:_kernel
// under out_dtype=float32. Each rank's partial leaves here uncast; the ranks'
// sum is cast once after the all-reduce, so on one rank the result has the
// bits of mode 1's cast-then-add.
//
// What bounds it: at decode batches each weight byte is used B times, far
// below the ~295 flop/byte where the card turns compute-bound, so it is
// bound by reading w8 from device memory (110 MB per layer of Gemma-2B:
// 32.9 us at 3.35 TB/s). The design keeps three 16-row steps of 16-byte
// weight loads in flight per warp and the plan puts ~16 warps on every SM
// (the rate follows the resident warps, not the depth of the pipeline),
// spends ~3 instructions per weight byte (the conversion; the products are
// 8 mma.sync per 2 KB), reads each weight byte once per 8 rows of x, and
// writes no partials to device memory.
#include "gemv_tile.cuh"

template <bool FAST>
__global__ void __launch_bounds__(32 * GT_MAX_WARPS, 2)
    int8_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ s, const bf16* __restrict__ residual,
                     void* __restrict__ out, int B, int K, int N, int mode, int k_per_cta,
                     int x8) {
  __shared__ GemvSmem sm;
  const int rank = cluster_rank(), cs = cluster_size();
  const int tile = blockIdx.x / cs;
  const int b0 = blockIdx.z * GT_BT;
  const int nb = min(GT_BT, B - b0);
  const int kbeg = rank * k_per_cta;
  const int kend = min(K, kbeg + k_per_cta);
  // tile-local column c is weight column tile * 128 + c, or with GeGLU
  // gate column tile * 64 + c (c < 64) and up column I + tile * 64 + c - 64
  const int inter = N / 2;
  const int g = (threadIdx.x & 31) >> 2;
  const int tile_out = mode == 2 ? GT_COLS / 2 : GT_COLS;  // output columns per tile
  const int qcol = mode == 2 ? (g < 4 ? 0 : inter) + tile * tile_out + 16 * (g & 3)
                             : tile * GT_COLS + 16 * g;
  gemv_tile_sums<FAST>(sm, x, w, K, N, b0, nb, qcol, kbeg, kend, x8 != 0);
  cluster_sync_all();
  // rank r applies the epilogue to its share of the tile's output columns
  const int n_out = mode == 2 ? inter : N;
  const int per = (tile_out + cs - 1) / cs;
  const int c_lo = rank * per;
  const int width = min(tile_out, c_lo + per) - c_lo;
  for (int idx = threadIdx.x; idx < nb * width; idx += blockDim.x) {
    const int r = idx / width, c = c_lo + idx % width;
    const int j = tile * tile_out + c;
    if (j >= n_out) continue;
    const float acc = gt_cluster_sum(sm, r, c, cs);
    const size_t o = (size_t)(b0 + r) * n_out + j;
    if (mode == 2) {
      // the products rounded before the GeGLU (no FMA contraction), as
      // the LoRA epilogue rounds them before it adds the delta
      const float gate = __fmul_rn(acc, s[j]);
      const float up = __fmul_rn(gt_cluster_sum(sm, r, c + GT_COLS / 2, cs), s[inter + j]);
      ((bf16*)out)[o] = f2bf(gelu_tanh_f(gate) * up);
    } else if (mode == 3) {
      ((float*)out)[o] = acc * s[j];
    } else if (mode == 4) {
      ((float*)out)[o] = acc;
    } else {
      bf16 v = f2bf(acc * s[j]);
      if (mode == 1) v = f2bf(bf2f(residual[o]) + bf2f(v));
      ((bf16*)out)[o] = v;
    }
  }
  cluster_sync_all();  // every rank has read this CTA's sums
}

// x (B, K) bf16, w8 (K, N) int8, s (N,) fp32, residual (B, N) bf16 (mode
// 1), out (B, N) or (B, N / 2) (mode 2); cluster, warps and k_per_cta from
// kernels/gemv_plan.py.
PG_EXPORT int pg_int8_gemv(const void* x, const void* w8, const void* s, const void* residual,
                           void* out, int B, int K, int N, int mode, int cluster, int warps,
                           int k_per_cta, void* stream) {
  const int tiles = mode == 2 ? (N / 2 + GT_COLS / 2 - 1) / (GT_COLS / 2)
                              : (N + GT_COLS - 1) / GT_COLS;
  const dim3 grid(tiles * cluster, 1, (B + GT_BT - 1) / GT_BT);
  const bool fast = N % (mode == 2 ? 32 : 16) == 0 && (uintptr_t)w8 % 16 == 0;
  const int x8 = K % 4 == 0 && (uintptr_t)x % 8 == 0;
  auto kernel = &int8_gemv_kernel<false>;
  if (fast) kernel = &int8_gemv_kernel<true>;
  return gt_launch(kernel, grid, cluster, warps, (cudaStream_t)stream, (const bf16*)x,
                   (const int8_t*)w8, (const float*)s, (const bf16*)residual, out, B, K, N, mode,
                   k_per_cta, x8);
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
