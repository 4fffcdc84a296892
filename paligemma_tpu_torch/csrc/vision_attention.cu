// One-shot softmax multi-head attention for the SigLIP vision tower.
//
// Replaces paligemma_tpu/kernels/ablation/vision_attention.py:_kernel
// (non-causal, unmasked MHA over all S patches, a block of heads per grid
// step). Per (batch, head):
//
//   s = q k^T * scale  (fp32),  p = exp(s - rowmax(s)),  l = rowsum(p)
//   out = (bf16(p) . v) / l      (p rounded to v's dtype before the product,
//                                 as the TPU kernel does; fp32 accumulators)
//
// What bounds it: at So400m's shapes (H = 16, D = 72) the work is 4 S^2 D H
// flops per layer, 4.8 GFLOP at S = 1024 against 4.7 MB of q/k/v/out, so
// the tensor cores bound it at S = 1024 and memory at S = 256. The design:
// one block per (16 query rows, head, batch row) keeps those rows' whole
// fp32 score row-block (16 x S) in dynamic shared memory, so the softmax is
// one-shot like the TPU kernel's (no online rescale). K of the head streams
// through shared memory in 64-key tiles (pass 1: scores by mma.sync, bf16
// in, fp32 out), then the softmax runs over the stored rows, then V streams
// through the same tile buffer (pass 2: p . v by mma.sync, each warp a
// quarter of the tile's keys; the four partial outputs are added in warp
// order at the end). Rows are staged with D padded to the next multiple of
// 16 (zeros) for the QK^T depth; no row is padded to the flash kernel's 256.
// Shared memory: 16 * (S + 4) * 4 bytes of scores + 16 * D * 16 bytes of
// partial outputs + 22 KB of tiles: 106 KB at S = 1024; S = 4096 does not
// fit (the wrapper raises).
#include "common.cuh"

#define VA_BQ 16                   // query rows per block: one m16 tile
#define VA_BK 64                   // keys per staged K / V tile
#define VA_WARPS 4                 // each warp: 16 keys of a tile
#define VA_THREADS (VA_WARPS * 32)
#define VA_DMAX 128
#define VA_LD (VA_DMAX + 8)  // bf16 row stride of the tiles: conflict-free fragment loads

__global__ void __launch_bounds__(VA_THREADS)
    vision_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H,
                       int D, float scale) {
  __shared__ __align__(16) bf16 qs[VA_BQ][VA_LD];
  __shared__ __align__(16) bf16 kv[VA_BK][VA_LD];
  __shared__ float lsum[VA_BQ];
  extern __shared__ __align__(16) float dyn[];
  const int sld = S + 4;          // fp32 row stride of the scores
  float* sc = dyn;                // (VA_BQ, sld) scores, then p
  float* ored = dyn + VA_BQ * sld;  // (VA_WARPS, VA_BQ, D) partial outputs

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * VA_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nchunk = D / 8;              // 16-byte chunks of a row
  const int dp = (D + 15) & ~15;         // QK^T depth, zero padded
  const int pchunk = dp / 8;
  const size_t srow = (size_t)H * D;     // elements between positions s and s+1
  const size_t head = (size_t)b * S * srow + (size_t)h * D;

  for (int i = tid; i < VA_BQ * pchunk; i += VA_THREADS) {
    const int r = i / pchunk, c = i - r * pchunk;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < nchunk) val = *reinterpret_cast<const uint4*>(q + head + (q0 + r) * srow + c * 8);
    *reinterpret_cast<uint4*>(&qs[r][c * 8]) = val;
  }
  __syncthreads();
  uint32_t qa[VA_DMAX / 16][4];
#pragma unroll
  for (int ks = 0; ks < VA_DMAX / 16; ++ks) {
    if (ks * 16 < dp) {
      qa[ks][0] = ld_bf16x2(&qs[g][ks * 16 + 2 * t]);
      qa[ks][1] = ld_bf16x2(&qs[g + 8][ks * 16 + 2 * t]);
      qa[ks][2] = ld_bf16x2(&qs[g][ks * 16 + 2 * t + 8]);
      qa[ks][3] = ld_bf16x2(&qs[g + 8][ks * 16 + 2 * t + 8]);
    }
  }

  // pass 1: scores of the 16 rows against every key
  for (int k0 = 0; k0 < S; k0 += VA_BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < VA_BK * pchunk; i += VA_THREADS) {
      const int j = i / pchunk, c = i - j * pchunk;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < nchunk) val = *reinterpret_cast<const uint4*>(k + head + (k0 + j) * srow + c * 8);
      *reinterpret_cast<uint4*>(&kv[j][c * 8]) = val;
    }
    __syncthreads();
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < VA_DMAX / 16; ++ks) {
      if (ks * 16 < dp) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* kp = &kv[warp * 16 + nt * 8 + g][ks * 16 + 2 * t];
          const uint32_t bb[2] = {ld_bf16x2(kp), ld_bf16x2(kp + 8)};
          mma_bf16_16816(acc[nt], qa[ks], bb);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int key = k0 + warp * 16 + nt * 8 + 2 * t;
      sc[g * sld + key] = acc[nt][0] * scale;
      sc[g * sld + key + 1] = acc[nt][1] * scale;
      sc[(g + 8) * sld + key] = acc[nt][2] * scale;
      sc[(g + 8) * sld + key + 1] = acc[nt][3] * scale;
    }
  }
  __syncthreads();

  // the one-shot softmax: warp w takes rows 4w .. 4w+3
  for (int r = warp * (VA_BQ / VA_WARPS); r < (warp + 1) * (VA_BQ / VA_WARPS); ++r) {
    float* row = sc + r * sld;
    float m = PG_NEG_INF;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = __expf(row[j] - m);
      row[j] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) lsum[r] = l;
  }

  // pass 2: bf16(p) . v; warp w takes keys 16w .. 16w+15 of each tile
  float o[VA_DMAX / 8][4];
#pragma unroll
  for (int nt = 0; nt < VA_DMAX / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  for (int k0 = 0; k0 < S; k0 += VA_BK) {
    __syncthreads();  // p is written / the previous tile is no longer read
    for (int i = tid; i < VA_BK * nchunk; i += VA_THREADS) {
      const int j = i / nchunk, c = i - j * nchunk;
      *reinterpret_cast<uint4*>(&kv[j][c * 8]) =
          *reinterpret_cast<const uint4*>(v + head + (k0 + j) * srow + c * 8);
    }
    __syncthreads();
    const int kk = warp * 16 + 2 * t;
    const float* p0 = sc + g * sld + k0 + kk;
    const float* p1 = sc + (g + 8) * sld + k0 + kk;
    const uint32_t a[4] = {pack_f32_bf16x2(p0[0], p0[1]), pack_f32_bf16x2(p1[0], p1[1]),
                           pack_f32_bf16x2(p0[8], p0[9]), pack_f32_bf16x2(p1[8], p1[9])};
#pragma unroll
    for (int nt = 0; nt < VA_DMAX / 8; ++nt) {
      if (nt * 8 < D) {
        const int n = nt * 8 + g;
        const uint32_t bb[2] = {pack_bf16x2(kv[kk][n], kv[kk + 1][n]),
                                pack_bf16x2(kv[kk + 8][n], kv[kk + 9][n])};
        mma_bf16_16816(o[nt], a, bb);
      }
    }
  }

  // add the four warps' partial outputs in warp order, normalize, store
#pragma unroll
  for (int nt = 0; nt < VA_DMAX / 8; ++nt) {
    if (nt * 8 < D) {
      const int col = nt * 8 + 2 * t;
      float* w0 = ored + ((size_t)warp * VA_BQ + g) * D + col;
      float* w1 = ored + ((size_t)warp * VA_BQ + g + 8) * D + col;
      w0[0] = o[nt][0];
      w0[1] = o[nt][1];
      w1[0] = o[nt][2];
      w1[1] = o[nt][3];
    }
  }
  __syncthreads();
  for (int i = tid; i < VA_BQ * D; i += VA_THREADS) {
    const int r = i / D, d = i - r * D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < VA_WARPS; ++w) acc += ored[((size_t)w * VA_BQ + r) * D + d];
    out[head + (q0 + r) * srow + d] = f2bf(acc / lsum[r]);
  }
}

// Dynamic shared memory the kernel needs at (S, D), in bytes.
static size_t vision_attn_smem(int S, int D) {
  return ((size_t)VA_BQ * (S + 4) + (size_t)VA_WARPS * VA_BQ * D) * sizeof(float);
}

// q, k, v, out: (B, S, H, D) bf16, contiguous; S % 64 == 0, D % 8 == 0,
// D <= 128 (the wrapper checks these and the shared-memory limit).
PG_EXPORT int pg_vision_attention(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int H, int D, float scale, void* stream) {
  const size_t smem = vision_attn_smem(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      vision_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / VA_BQ, H, B);
  vision_attn_kernel<<<grid, VA_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, H, D, scale);
  return (int)cudaGetLastError();
}

