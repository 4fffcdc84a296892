// Multi-head attention for the SigLIP vision tower, K/V streamed with an
// online softmax.
//
// Replaces paligemma_tpu/kernels/ablation/vision_attention.py:_kernel
// (non-causal, unmasked MHA over all S patches, a block of heads per grid
// step). Per (batch, head) it computes what the TPU kernel computes,
//
//   s = q k^T * scale  (fp32),  p = exp(s - rowmax(s)),  l = rowsum(p)
//   out = (bf16(p) . v) / l      (fp32 accumulators)
//
// but without holding a row's S scores: the TPU kernel's one-shot softmax
// needs every score of a row before its first exp, which on Hopper bounds
// S by shared memory. Here each warp owns 16 query rows and sweeps the
// head's keys in 64-key tiles, keeping a running max m and sum l per row
// in fp32 and an fp32 output accumulator that is rescaled by
// exp(m_old - m_new) whenever the max grows (flash attention's online
// softmax). p is rounded to bf16 against the running max, so the result
// differs from the one-shot softmax by bf16 rounding only; any S that is a
// multiple of the tile runs.
//
// What bounds it: at So400m's shapes (H = 16, D = 72) the work is 4 S^2 D H
// flops per layer, 4.8 GFLOP at S = 1024 and 77 GFLOP at S = 4096 against
// 4.7 / 19 MB of q/k/v/out, so the tensor cores bound it from S = 1024 up
// and memory at S = 256. The design: q.k^T and p.v by mma.sync (bf16 in,
// fp32 out), Q fragments held in registers for the whole sweep, the scores
// and p in registers (the C fragment of q.k^T is the A fragment of p.v), K
// and V tiles staged in shared memory and shared by the block's NW warps
// (16 * NW query rows per block), so each block reads the head's K and V
// once for 16 * NW rows. D is zero-padded to a multiple of 16 for the
// q.k^T depth; no row is padded to the flash kernel's 256.
#include "common.cuh"

#define VA_BK 64  // keys per staged K / V tile
#define VA_DMAX 128
#define VA_LD (VA_DMAX + 8)  // bf16 row stride of the tiles: conflict-free fragment loads

template <int NW>
__global__ void __launch_bounds__(NW * 32)
    vision_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H,
                       int D, float scale) {
  __shared__ __align__(16) bf16 ks[VA_BK][VA_LD];  // Q staging, then K tiles
  __shared__ __align__(16) bf16 vs[VA_BK][VA_LD];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * (16 * NW);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nchunk = D / 8;              // 16-byte chunks of a row
  const int dp = (D + 15) & ~15;         // q.k^T depth, zero padded
  const int pchunk = dp / 8;
  const size_t srow = (size_t)H * D;     // elements between positions s and s+1
  const size_t head = (size_t)b * S * srow + (size_t)h * D;

  // this block's 16 * NW query rows through shared memory into registers
  for (int i = tid; i < 16 * NW * pchunk; i += NW * 32) {
    const int r = i / pchunk, c = i - r * pchunk;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < nchunk) val = *reinterpret_cast<const uint4*>(q + head + (q0 + r) * srow + c * 8);
    *reinterpret_cast<uint4*>(&ks[r][c * 8]) = val;
  }
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[VA_DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < VA_DMAX / 16; ++kk) {
    if (kk * 16 < dp) {
      qa[kk][0] = ld_bf16x2(&ks[r0 + g][kk * 16 + 2 * t]);
      qa[kk][1] = ld_bf16x2(&ks[r0 + g + 8][kk * 16 + 2 * t]);
      qa[kk][2] = ld_bf16x2(&ks[r0 + g][kk * 16 + 2 * t + 8]);
      qa[kk][3] = ld_bf16x2(&ks[r0 + g + 8][kk * 16 + 2 * t + 8]);
    }
  }

  // rows g and g + 8 of the warp's 16: running max, this thread's share of
  // the running sum, and the output columns nt * 8 + 2t, + 1
  float m[2] = {PG_NEG_INF, PG_NEG_INF};
  float l[2] = {0.f, 0.f};
  float o[VA_DMAX / 8][4];
#pragma unroll
  for (int nt = 0; nt < VA_DMAX / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += VA_BK) {
    __syncthreads();  // the Q staging / the previous tiles are no longer read
    for (int i = tid; i < VA_BK * pchunk; i += NW * 32) {
      const int j = i / pchunk, c = i - j * pchunk;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (c < nchunk) {
        kv = *reinterpret_cast<const uint4*>(k + head + (k0 + j) * srow + c * 8);
        vv = *reinterpret_cast<const uint4*>(v + head + (k0 + j) * srow + c * 8);
      }
      *reinterpret_cast<uint4*>(&ks[j][c * 8]) = kv;
      *reinterpret_cast<uint4*>(&vs[j][c * 8]) = vv;
    }
    __syncthreads();

    // scores of the warp's 16 rows against the tile's 64 keys
    float sc[VA_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < VA_BK / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < VA_DMAX / 16; ++kk) {
        if (kk * 16 < dp) {
          const bf16* kp = &ks[nt * 8 + g][kk * 16 + 2 * t];
          const uint32_t bb[2] = {ld_bf16x2(kp), ld_bf16x2(kp + 8)};
          mma_bf16_16816(sc[nt], qa[kk], bb);
        }
      }
    }

    // online softmax: new row maxima over the quad that shares each row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < VA_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= scale;
      mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < VA_DMAX / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < VA_BK / 8; ++nt) {
      sc[nt][0] = __expf(sc[nt][0] - m[0]);
      sc[nt][1] = __expf(sc[nt][1] - m[0]);
      sc[nt][2] = __expf(sc[nt][2] - m[1]);
      sc[nt][3] = __expf(sc[nt][3] - m[1]);
      l[0] += sc[nt][0] + sc[nt][1];
      l[1] += sc[nt][2] + sc[nt][3];
    }

    // bf16(p) . v: keys kk * 16 .. + 15 are the C fragments of score tiles
    // 2kk and 2kk + 1, which are the A fragment of this product
#pragma unroll
    for (int kk = 0; kk < VA_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_f32_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_f32_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_f32_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_f32_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < VA_DMAX / 8; ++nt) {
        if (nt * 8 < D) {
          const int n = nt * 8 + g;
          const uint32_t bb[2] = {pack_bf16x2(vs[key][n], vs[key + 1][n]),
                                  pack_bf16x2(vs[key + 8][n], vs[key + 9][n])};
          mma_bf16_16816(o[nt], a, bb);
        }
      }
    }
  }

  // the row sums over the quad, then normalize and store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  bf16* o0 = out + head + (size_t)(q0 + r0 + g) * srow;
  bf16* o1 = out + head + (size_t)(q0 + r0 + g + 8) * srow;
#pragma unroll
  for (int nt = 0; nt < VA_DMAX / 8; ++nt) {
    if (nt * 8 < D) {
      const int col = nt * 8 + 2 * t;
      o0[col] = f2bf(o[nt][0] * inv0);
      o0[col + 1] = f2bf(o[nt][1] * inv0);
      o1[col] = f2bf(o[nt][2] * inv1);
      o1[col + 1] = f2bf(o[nt][3] * inv1);
    }
  }
}

// q, k, v, out: (B, S, H, D) bf16, contiguous, 16-byte aligned;
// S % (16 * warps) == 0 and S % 64 == 0, D % 8 == 0, D <= 128; warps in
// {1, 2, 4} query-row groups of 16 per block (the wrapper checks these).
PG_EXPORT int pg_vision_attention(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int H, int D, int warps, float scale, void* stream) {
  dim3 grid(S / (16 * warps), H, B);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  bf16* op = (bf16*)out;
  switch (warps) {
    case 4: vision_attn_kernel<4><<<grid, 128, 0, st>>>(qp, kp, vp, op, S, H, D, scale); break;
    case 2: vision_attn_kernel<2><<<grid, 64, 0, st>>>(qp, kp, vp, op, S, H, D, scale); break;
    default: vision_attn_kernel<1><<<grid, 32, 0, st>>>(qp, kp, vp, op, S, H, D, scale); break;
  }
  return (int)cudaGetLastError();
}
