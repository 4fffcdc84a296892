// Prefix-LM flash attention, backward (FlashAttention-2).
//
// Replaces paligemma_tpu/kernels/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (via _flash_backward, under the custom VJP _flash). Same
// mask as the forward (csrc/flash_attention.cu): key j is visible to query i
// of batch b iff  j < kv_len[b]  and  (j < prefix_len[b]  or  j <= i + q_offset).
// Query heads sharing a KV head are folded into rows (row = g * Sq + i), as
// in the forward and the TPU kernels. Inputs: q, k, v, dO (bf16), the
// forward's lse and delta = rowsum(dO * O) (fp32, (B, Hq, Sq), i.e.
// (B, Hkv, rows)). Per visible (row, key) pair, in fp32:
//
//   p  = exp(scale * q.k - lse)        ds = p * (dO.v - delta)
//   dq = scale * sum_j ds k_j          dk = scale * sum_i ds q_i    dv = sum_i p dO_i
//
// p and ds stay fp32 (the TPU kernel rounds both to bf16 before its
// products); dq, dk and dv are rounded to bf16 once, at the end. A masked
// pair, a padded row and a row with no visible key contribute exactly 0.
//
// Kernels:
// * flash_bwd_dq_kernel: one block per (16 folded rows, KV head, batch); it
//   sweeps the key tiles up to the last key any of its rows sees.
// * flash_bwd_dkv_kernel: one block per (16 keys, KV head, batch, split);
//   it sweeps the folded rows of its split (all query heads of the KV head,
//   so the GQA/MQA sum over heads happens in the block, as in
//   _bwd_dkv_kernel), skipping row tiles that see none of its keys, and
//   writes fp32 partials. With Gemma's one KV head the grid would be only
//   Skv/16 * B blocks (64 at S=512, B=2: half a wave on 132 SMs), so the
//   rows are split into `nsplit` ranges, and flash_bwd_dkv_sum adds the
//   partials in split order (deterministic, no atomics), scales dk and
//   rounds to bf16.
//
// What bounds it at the training shape (B=2, S=512, Hq=8, Hkv=1, D=256):
// arithmetic, about 10 * 4096 * 512 * 256 * 2 = 10.7 GFLOP per layer if every
// pair were visible (~11 us at 989 TFLOP/s on the tensor cores); here it
// runs as scalar fp32 FMAs from shared memory, like the forward (mma/wgmma
// tiles are later work). 16-row / 16-key tiles of Q, dO, K and V (rows
// padded by 8 bf16 for conflict-free 16-byte reads) take 34-36 KB of static
// shared memory at any head_dim that is a multiple of 8 up to 256.
#include "common.cuh"

#define FB_T 16  // folded rows and keys per tile
#define FB_THREADS 128
#define FB_DMAX 256
#define FB_LD (FB_DMAX + 8)

typedef bf16 Tile[FB_LD];

// Folded rows row0 .. row0+FB_T-1 of a (B, Sq, Hq, D) tensor into smem, 0 past `rows`.
__device__ __forceinline__ void load_rows(Tile* dst, const bf16* __restrict__ src, int b, int kvh,
                                          int row0, int rows, int Sq, int Hq, int group, int D) {
  const int nchunk = D / 8;
  for (int idx = threadIdx.x; idx < FB_T * nchunk; idx += FB_THREADS) {
    const int rr = idx / nchunk, c = idx - rr * nchunk;
    const int row = row0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int g = row / Sq, i = row - g * Sq;
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * Sq + i) * Hq + kvh * group + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(&dst[rr][c * 8]) = val;
  }
}

// Keys k0 .. k0+FB_T-1 of a (B, Skv, Hkv, D) tensor into smem, 0 past `klen`.
__device__ __forceinline__ void load_keys(Tile* dst, const bf16* __restrict__ src, int b, int kvh,
                                          int k0, int klen, int Skv, int Hkv, int D) {
  const int nchunk = D / 8;
  for (int idx = threadIdx.x; idx < FB_T * nchunk; idx += FB_THREADS) {
    const int jj = idx / nchunk, c = idx - jj * nchunk;
    const int key = k0 + jj;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (key < klen)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * Skv + key) * Hkv + kvh) * D + c * 8);
    *reinterpret_cast<uint4*>(&dst[jj][c * 8]) = val;
  }
}

// One past the last key any folded row of the tile at row0 sees.
__device__ __forceinline__ int tile_key_end(int row0, int rows, int Sq, int q_offset, int plen,
                                            int klen) {
  const int last = min(row0 + FB_T, rows) - 1;
  if (last < row0) return 0;
  const int max_i = (row0 / Sq == last / Sq) ? last - (last / Sq) * Sq : Sq - 1;
  return min(klen, max(plen, max_i + q_offset + 1));
}

// p and ds of row r = tid / 8 against keys sub and sub + 8 (sub = tid % 8) of
// the key tile at k0: two dot products of length D per key.
__device__ __forceinline__ void score_pair(Tile* qs, Tile* dos, Tile* ks, Tile* vs, int D,
                                           float scale, float lse_r, float delta_r, bool row_ok,
                                           int pos, int plen, int klen, int k0, float* p,
                                           float* ds) {
  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7;
  float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
  for (int c = 0; c < D / 8; ++c) {
    float qf[8], of[8];
    bf16x8_to_float(*reinterpret_cast<const uint4*>(&qs[r][c * 8]), qf);
    bf16x8_to_float(*reinterpret_cast<const uint4*>(&dos[r][c * 8]), of);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float kf[8], vf[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(&ks[sub + 8 * t][c * 8]), kf);
      bf16x8_to_float(*reinterpret_cast<const uint4*>(&vs[sub + 8 * t][c * 8]), vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[t] = fmaf(qf[e], kf[e], s[t]);
        dp[t] = fmaf(of[e], vf[e], dp[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int key = k0 + sub + 8 * t;
    const bool allowed = row_ok && key < klen && (key < plen || key <= pos);
    p[t] = allowed ? __expf(s[t] * scale - lse_r) : 0.f;
    ds[t] = p[t] * (dp[t] - delta_r);
  }
}

__global__ void __launch_bounds__(FB_THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ prefix_len, const int* __restrict__ kv_len,
                        bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
                        float scale, int q_offset) {
  __shared__ __align__(16) bf16 qs[FB_T][FB_LD];
  __shared__ __align__(16) bf16 dos[FB_T][FB_LD];
  __shared__ __align__(16) bf16 ks[FB_T][FB_LD];
  __shared__ __align__(16) bf16 vs[FB_T][FB_LD];
  __shared__ float dss[FB_T][FB_T];

  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * FB_T;
  const int group = Hq / Hkv, rows = group * Sq;
  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7;
  load_rows(qs, q, b, kvh, row0, rows, Sq, Hq, group, D);
  load_rows(dos, dout, b, kvh, row0, rows, Sq, Hq, group, D);

  const int my_row = row0 + r;
  const bool row_ok = my_row < rows;
  const int my_g = my_row / Sq, my_i = my_row - my_g * Sq;
  const size_t stat = ((size_t)b * Hkv + kvh) * rows + my_row;
  const float lse_r = row_ok ? lse[stat] : 0.f, delta_r = row_ok ? delta[stat] : 0.f;
  const int plen = prefix_len[b], klen = min(kv_len[b], Skv);
  const int kend = tile_key_end(row0, rows, Sq, q_offset, plen, klen);

  float acc[4][8];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[cc][e] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += FB_T) {
    __syncthreads();  // the Q/dO loads are done, the previous K/V tile is no longer read
    load_keys(ks, k, b, kvh, k0, klen, Skv, Hkv, D);
    load_keys(vs, v, b, kvh, k0, klen, Skv, Hkv, D);
    __syncthreads();
    float p[2], ds[2];
    score_pair(qs, dos, ks, vs, D, scale, lse_r, delta_r, row_ok, my_i + q_offset, plen, klen, k0,
               p, ds);
    dss[r][sub] = ds[0];
    dss[r][sub + 8] = ds[1];
    __syncwarp();  // dss[r][*] is written and read by the same 8 lanes
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int d0 = sub * 8 + 64 * cc;
      if (d0 < D) {
        for (int j = 0; j < FB_T; ++j) {
          const float w = dss[r][j];
          float kf[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(&ks[j][d0]), kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[cc][e] = fmaf(w, kf[e], acc[cc][e]);
        }
      }
    }
    __syncwarp();
  }

  if (row_ok) {
    bf16* dp = dq + (((size_t)b * Sq + my_i) * Hq + kvh * group + my_g) * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int d0 = sub * 8 + 64 * cc;
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dp[d0 + e] = f2bf(acc[cc][e] * scale);
      }
    }
  }
}

__global__ void __launch_bounds__(FB_THREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ prefix_len, const int* __restrict__ kv_len,
                         float* __restrict__ part_dk, float* __restrict__ part_dv, int Sq,
                         int Skv, int Hq, int Hkv, int D, float scale, int q_offset,
                         int tiles_per_split) {
  __shared__ __align__(16) bf16 qs[FB_T][FB_LD];
  __shared__ __align__(16) bf16 dos[FB_T][FB_LD];
  __shared__ __align__(16) bf16 ks[FB_T][FB_LD];
  __shared__ __align__(16) bf16 vs[FB_T][FB_LD];
  __shared__ float ps[FB_T][FB_T];
  __shared__ float dss[FB_T][FB_T];

  const int nkt = (Skv + FB_T - 1) / FB_T;
  const int kt = blockIdx.x % nkt, split = blockIdx.x / nkt;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = kt * FB_T;
  const int group = Hq / Hkv, rows = group * Sq;
  const int r = threadIdx.x >> 3, sub = threadIdx.x & 7;  // r: row in the score pass, key after
  const int plen = prefix_len[b], klen = min(kv_len[b], Skv);

  float acc_dk[4][8], acc_dv[4][8];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_dk[cc][e] = acc_dv[cc][e] = 0.f;

  if (k0 < klen) {
    load_keys(ks, k, b, kvh, k0, klen, Skv, Hkv, D);
    load_keys(vs, v, b, kvh, k0, klen, Skv, Hkv, D);
    const int n_tiles = (rows + FB_T - 1) / FB_T;
    const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
    for (int t = split * tiles_per_split; t < t_end; ++t) {
      const int row0 = t * FB_T;
      if (tile_key_end(row0, rows, Sq, q_offset, plen, klen) <= k0) continue;  // block-uniform
      __syncthreads();  // the previous tile's Q/dO/p/ds are no longer read
      load_rows(qs, q, b, kvh, row0, rows, Sq, Hq, group, D);
      load_rows(dos, dout, b, kvh, row0, rows, Sq, Hq, group, D);
      const int my_row = row0 + r;
      const bool row_ok = my_row < rows;
      const int my_i = my_row - (my_row / Sq) * Sq;
      const size_t stat = ((size_t)b * Hkv + kvh) * rows + my_row;
      const float lse_r = row_ok ? lse[stat] : 0.f, delta_r = row_ok ? delta[stat] : 0.f;
      __syncthreads();
      float p[2], ds[2];
      score_pair(qs, dos, ks, vs, D, scale, lse_r, delta_r, row_ok, my_i + q_offset, plen, klen,
                 k0, p, ds);
      ps[r][sub] = p[0];
      ps[r][sub + 8] = p[1];
      dss[r][sub] = ds[0];
      dss[r][sub + 8] = ds[1];
      __syncthreads();
      // thread (key r, sub): dv[r] += p[i][r] dO[i], dk[r] += ds[i][r] q[i]
      for (int i = 0; i < FB_T; ++i) {
        const float pv = ps[i][r], dsv = dss[i][r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int d0 = sub * 8 + 64 * cc;
          if (d0 < D) {
            float of[8], qf[8];
            bf16x8_to_float(*reinterpret_cast<const uint4*>(&dos[i][d0]), of);
            bf16x8_to_float(*reinterpret_cast<const uint4*>(&qs[i][d0]), qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              acc_dv[cc][e] = fmaf(pv, of[e], acc_dv[cc][e]);
              acc_dk[cc][e] = fmaf(dsv, qf[e], acc_dk[cc][e]);
            }
          }
        }
      }
    }
  }

  const int key = k0 + r;
  if (key < Skv) {
    const size_t total = (size_t)gridDim.z * Hkv * Skv * D;
    const size_t off = split * total + (((size_t)b * Hkv + kvh) * Skv + key) * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int d0 = sub * 8 + 64 * cc;
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          part_dk[off + d0 + e] = acc_dk[cc][e];
          part_dv[off + d0 + e] = acc_dv[cc][e];
        }
      }
    }
  }
}

// dk = scale * sum of the dk partials, dv = sum of the dv partials, in split
// order; partials are (nsplit, B, Hkv, Skv, D), outputs (B, Skv, Hkv, D).
__global__ void flash_bwd_dkv_sum(const float* __restrict__ part_dk,
                                  const float* __restrict__ part_dv, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int nsplit, int B, int Skv, int Hkv,
                                  int D, float scale) {
  const size_t total = (size_t)B * Hkv * Skv * D;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = idx % D;
  size_t rest = idx / D;
  const int key = rest % Skv;
  rest /= Skv;
  const int kvh = rest % Hkv, b = rest / Hkv;
  float sk = 0.f, sv = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    sk += part_dk[s * total + idx];
    sv += part_dv[s * total + idx];
  }
  const size_t out = (((size_t)b * Skv + key) * Hkv + kvh) * D + d;
  dk[out] = f2bf(sk * scale);
  dv[out] = f2bf(sv);
}

PG_EXPORT int pg_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* prefix_len, const void* kv_len, void* dq,
                                        int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                        float scale, int q_offset, void* stream) {
  const int rows = (Hq / Hkv) * Sq;
  dim3 grid((rows + FB_T - 1) / FB_T, Hkv, B);
  flash_bwd_dq_kernel<<<grid, FB_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)prefix_len, (const int*)kv_len, (bf16*)dq, Sq, Skv, Hq,
      Hkv, D, scale, q_offset);
  return (int)cudaGetLastError();
}

PG_EXPORT int pg_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* prefix_len, const void* kv_len,
                                         void* part_dk, void* part_dv, void* dk, void* dv, int B,
                                         int Sq, int Skv, int Hq, int Hkv, int D, int nsplit,
                                         float scale, int q_offset, void* stream) {
  const int rows = (Hq / Hkv) * Sq;
  const int n_tiles = (rows + FB_T - 1) / FB_T;
  const int tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  const int nkt = (Skv + FB_T - 1) / FB_T;
  dim3 grid(nkt * nsplit, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, FB_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)prefix_len, (const int*)kv_len, (float*)part_dk,
      (float*)part_dv, Sq, Skv, Hq, Hkv, D, scale, q_offset, tiles_per_split);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t total = (size_t)B * Hkv * Skv * D;
  const int threads = 256;
  flash_bwd_dkv_sum<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>((const float*)part_dk, (const float*)part_dv,
                                              (bf16*)dk, (bf16*)dv, nsplit, B, Skv, Hkv, D,
                                              scale);
  return (int)cudaGetLastError();
}
