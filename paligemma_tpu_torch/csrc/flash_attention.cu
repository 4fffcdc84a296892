// Prefix-LM flash attention, forward.
//
// Replaces paligemma_tpu/kernels/flash_attention.py:_flash_kernel (via
// _flash_forward / flash_attention). Key j is visible to query i of batch b
// iff  j < kv_len[b]  and  (j < prefix_len[b]  or  j <= i + q_offset).
// Query heads that share a KV head are folded into the rows of one block
// (row = g * Sq + i), as the TPU kernel does, so K/V tiles are read once per
// KV head. Online softmax in fp32 with NEG_INF = -1e30; a row with no
// visible key writes 0. With a non-null ``lse`` the kernel also writes each
// row's log-sum-exp of the scaled scores, fp32 (B, Hq, Sq), for the backward
// pass (csrc/flash_attention_bwd.cu); a row with no visible key gets 0, as
// in the TPU kernel. The store does not touch the arithmetic, so the output
// bits are the same with and without it.
//
// What bounds it at the LM prefill shape (Sq = Skv ~ 266, Hq = 8, Hkv = 1,
// D = 256): arithmetic, ~0.6 GFLOP per layer, done here as scalar fp32 FMAs
// from shared memory (no tensor cores yet: mma/wgmma is later work). Blocks
// of 16 folded rows give ~133 blocks per layer, one wave on 132 SMs. K and V
// tiles of 32 keys sit in shared memory with rows padded by 8 bf16, so the
// 8 threads of a row group read 8 different keys without bank conflicts.
// Any head_dim that is a multiple of 8 up to 256 works (D = 72 for SigLIP).
#include "common.cuh"

#define FA_BQ 16
#define FA_BK 32
#define FA_THREADS 128
#define FA_DMAX 256
#define FA_LD (FA_DMAX + 8)

__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ prefix_len,
                     const int* __restrict__ kv_len, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int D,
                     float scale, int q_offset) {
  __shared__ __align__(16) bf16 qs[FA_BQ][FA_LD];
  __shared__ __align__(16) bf16 ks[FA_BK][FA_LD];
  __shared__ __align__(16) bf16 vs[FA_BK][FA_LD];
  __shared__ float ps[FA_BQ][FA_BK];

  const int b = blockIdx.z, kvh = blockIdx.y, tile = blockIdx.x;
  const int group = Hq / Hkv, rows = group * Sq;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int nchunk = D / 8;

  for (int idx = tid; idx < FA_BQ * nchunk; idx += FA_THREADS) {
    const int rr = idx / nchunk, c = idx - rr * nchunk;
    const int row = tile * FA_BQ + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int g = row / Sq, i = row - g * Sq;
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + i) * Hq + kvh * group + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(&qs[rr][c * 8]) = val;
  }

  const int my_row = tile * FA_BQ + r;
  const int my_g = my_row / Sq, my_i = my_row - my_g * Sq;
  const int my_pos = my_i + q_offset;
  const int plen = prefix_len[b];
  const int klen = min(kv_len[b], Skv);

  float m = PG_NEG_INF, l = 0.f;
  float acc[4][8];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[cc][e] = 0.f;

  for (int k0 = 0; k0 < klen; k0 += FA_BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int idx = tid; idx < FA_BK * nchunk; idx += FA_THREADS) {
      const int jj = idx / nchunk, c = idx - jj * nchunk;
      const int key = k0 + jj;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < klen) {
        const size_t off = (((size_t)b * Skv + key) * Hkv + kvh) * D + c * 8;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[jj][c * 8]) = kv4;
      *reinterpret_cast<uint4*>(&vs[jj][c * 8]) = vv4;
    }
    __syncthreads();

    // scores of row r against keys sub, sub+8, sub+16, sub+24
    float s[4];
    bool allowed[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) s[t] = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      float qf[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(&qs[r][c * 8]), qf);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float kf[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(&ks[sub + 8 * t][c * 8]), kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[t] = fmaf(qf[e], kf[e], s[t]);
      }
    }
    float tmax = PG_NEG_INF;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int key = k0 + sub + 8 * t;
      allowed[t] = key < klen && (key < plen || key <= my_pos);
      s[t] = allowed[t] ? s[t] * scale : PG_NEG_INF;
      tmax = fmaxf(tmax, s[t]);
    }
    // the 8 threads of a row are adjacent lanes of one warp
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float p = allowed[t] ? __expf(s[t] - m_new) : 0.f;
      ps[r][sub + 8 * t] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // ps[r][*] is written and read by the same 8 lanes

#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int d0 = sub * 8 + 64 * cc;
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[cc][e] *= alpha;
        for (int j = 0; j < FA_BK; ++j) {
          const float p = ps[r][j];
          float vf[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(&vs[j][d0]), vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[cc][e] = fmaf(p, vf[e], acc[cc][e]);
        }
      }
    }
    __syncwarp();
  }

  if (my_row < rows) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* op = out + (((size_t)b * Sq + my_i) * Hq + kvh * group + my_g) * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int d0 = sub * 8 + 64 * cc;
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < 8; ++e) op[d0 + e] = f2bf(acc[cc][e] * inv);
      }
    }
    // (B, Hq, Sq) row of head kvh * group + my_g is folded row my_row of (b, kvh)
    if (lse != nullptr && sub == 0)
      lse[((size_t)b * Hkv + kvh) * rows + my_row] = l > 0.f ? m + logf(l) : 0.f;
  }
}

PG_EXPORT int pg_flash_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* prefix_len, const void* kv_len, void* out,
                                     void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                     float scale, int q_offset, void* stream) {
  const int rows = (Hq / Hkv) * Sq;
  dim3 grid((rows + FA_BQ - 1) / FA_BQ, Hkv, B);
  flash_fwd_kernel<<<grid, FA_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)prefix_len,
      (const int*)kv_len, (bf16*)out, (float*)lse, Sq, Skv, Hq, Hkv, D, scale, q_offset);
  return (int)cudaGetLastError();
}
