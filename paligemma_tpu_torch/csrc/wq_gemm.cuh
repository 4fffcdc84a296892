// Weight-only quantized matmul tile, shared by int8_matmul.cu (int8 weights
// stored (K, N) or (N, K)) and int4_matmul.cu (int4 weights nibble-packed
// as "K-halves").
//
//   out(M, N) = cast_bf16((x(M, K) . w(K, N)) fp32 * s(N))
//
// The weights are dequantized inside the kernel to bf16, which holds every
// int8 (-127..127) and int4 (-8..7) value exactly, so a bf16 tensor-core
// product with fp32 accumulators (mma.sync m16n8k16) computes the TPU
// kernels' function; the per-column scale is applied once, after the whole
// K sweep, as they do.
//
// What bounds it: at decode rows (M <= 16) reading the weights (K * N
// bytes for int8, half that for int4); at prefill and training rows (M in
// the hundreds to thousands) the products (2 M K N flops). The design: a
// block of 4 warps owns a BM x 64 output tile; each stage copies a 64-deep
// slice of x and of the weights from device memory into registers with
// 16-byte loads (the next stage's loads are in flight while this stage's
// products run), dequantizes the weights to bf16 and stores both operands
// in shared memory with rows padded by 8 bf16 (conflict-free fragment
// loads). Small M uses BM = 16 (no wasted rows in flight), larger M BM = 64.
// Where the output tiles alone leave the card's SMs idle, K is split over
// blocks into fp32 partials (split, M, N) that a second kernel adds in split
// order and scales (pg_wq_split_sum, int8_matmul.cu); otherwise the tile is
// scaled and stored directly.
#pragma once

#include "common.cuh"

#define WQ_BN 64
#define WQ_BK 64  // K rows per stage (packed rows for int4)
#define WQ_THREADS 128
#define WQ_LD (WQ_BK + 8)

enum WqLayout { WQ_KN = 0, WQ_NK = 1, WQ_INT4 = 2 };

// K rows of the weights' stored K axis ("Ks"): K for int8, K / 2 for int4.
// int4: packed[k, n] holds q[k, n] in its low nibble and q[k + K/2, n] in
// its high nibble, so a stage of packed rows [k0, k0 + 64) multiplies x's
// columns [k0, k0 + 64) (low) and [K/2 + k0, ...) (high).
template <int LAYOUT, int MT, int WARPS_M>
__global__ void __launch_bounds__(WQ_THREADS)
    wq_gemm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, float* __restrict__ part, bf16* __restrict__ out,
                   int M, int K, int N, int k_chunk) {
  constexpr int HALVES = LAYOUT == WQ_INT4 ? 2 : 1;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int BM = 16 * MT * WARPS_M;
  constexpr int NT = WQ_BN / (8 * WARPS_N);  // n8 tiles per warp
  constexpr int XV = BM * WQ_BK / 8 / WQ_THREADS;  // 16-byte x loads per thread and half
  constexpr int WV = WQ_BN * WQ_BK / 16 / WQ_THREADS;  // 16-byte weight loads per thread
  __shared__ __align__(16) bf16 xs[HALVES][BM][WQ_LD];
  __shared__ __align__(16) bf16 ws[HALVES][WQ_BN][WQ_LD];

  const int n0 = blockIdx.x * WQ_BN, split = blockIdx.y, m0 = blockIdx.z * BM;
  const int ks_len = LAYOUT == WQ_INT4 ? K / 2 : K;
  const int kbeg = split * k_chunk, kend = min(ks_len, kbeg + k_chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp - wm * WARPS_N;

  uint4 xr[HALVES][XV], wr[WV];
  auto load = [&](int k0) {
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int idx = tid + i * WQ_THREADS, r = idx >> 3, c = idx & 7;
        xr[hf][i] = m0 + r < M ? *reinterpret_cast<const uint4*>(
                                     x + (size_t)(m0 + r) * K + hf * (K / 2) + k0 + c * 8)
                               : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = tid + i * WQ_THREADS, r = idx >> 2, c = idx & 3;
      if (LAYOUT == WQ_NK)  // row r = output column n0 + r, 16 K values
        wr[i] = n0 + r < N ? *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + k0 + c * 16)
                           : make_uint4(0u, 0u, 0u, 0u);
      else  // row r = K row k0 + r, 16 output columns
        wr[i] = n0 + c * 16 < N ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c * 16)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int idx = tid + i * WQ_THREADS, r = idx >> 3, c = idx & 7;
        *reinterpret_cast<uint4*>(&xs[hf][r][c * 8]) = xr[hf][i];
      }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int idx = tid + i * WQ_THREADS, r = idx >> 2, c = idx & 3;
      const uint32_t wv[4] = {wr[i].x, wr[i].y, wr[i].z, wr[i].w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t u = wv[e >> 2] >> (8 * (e & 3));  // byte e in the low 8 bits
        const int q8 = (int8_t)u;
        if (LAYOUT == WQ_NK) {
          ws[0][r][c * 16 + e] = f2bf((float)q8);
        } else if (LAYOUT == WQ_KN) {
          ws[0][c * 16 + e][r] = f2bf((float)q8);
        } else {  // sign-extended low and high nibbles
          ws[0][c * 16 + e][r] = f2bf((float)((int)(int8_t)(u << 4) >> 4));
          ws[1][c * 16 + e][r] = f2bf((float)(q8 >> 4));
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += WQ_BK) {
    __syncthreads();  // the previous stage is no longer read
    store();
    __syncthreads();
    if (k0 + WQ_BK < kend) load(k0 + WQ_BK);  // in flight during the products
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int kk = 0; kk < WQ_BK; kk += 16) {
        uint32_t a[MT][4], bfr[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = wm * MT * 16 + mt * 16 + g;
          a[mt][0] = ld_bf16x2(&xs[hf][r][kk + 2 * t]);
          a[mt][1] = ld_bf16x2(&xs[hf][r + 8][kk + 2 * t]);
          a[mt][2] = ld_bf16x2(&xs[hf][r][kk + 2 * t + 8]);
          a[mt][3] = ld_bf16x2(&xs[hf][r + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = wn * NT * 8 + nt * 8 + g;
          bfr[nt][0] = ld_bf16x2(&ws[hf][c][kk + 2 * t]);
          bfr[nt][1] = ld_bf16x2(&ws[hf][c][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], bfr[nt]);
      }
  }

  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * MT * 16 + mt * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * NT * 8 + nt * 8 + 2 * t + (e & 1);
        if (m < M && n < N) {
          if (direct)
            out[(size_t)m * N + n] = f2bf(acc[mt][nt][e] * s[n]);
          else
            part[((size_t)split * M + m) * N + n] = acc[mt][nt][e];
        }
      }
}

// Rows per block of the two tile shapes (the wrapper sizes its split and
// partials with these): BM 16 for M <= 16, else BM 64.
#define WQ_BM_SMALL 16
#define WQ_BM_LARGE 64

template <int LAYOUT>
inline int wq_gemm_launch(const void* x, const void* w, const void* s, void* part, void* out,
                          int M, int K, int N, int k_chunk, cudaStream_t st) {
  const int ks_len = LAYOUT == WQ_INT4 ? K / 2 : K;
  const int nsplit = (ks_len + k_chunk - 1) / k_chunk;
  const bool small = M <= WQ_BM_SMALL;
  const int bm = small ? WQ_BM_SMALL : WQ_BM_LARGE;
  dim3 grid((N + WQ_BN - 1) / WQ_BN, nsplit, (M + bm - 1) / bm);
  const bf16* xp = (const bf16*)x;
  const int8_t* wp = (const int8_t*)w;
  if (small)
    wq_gemm_kernel<LAYOUT, 1, 1><<<grid, WQ_THREADS, 0, st>>>(
        xp, wp, (const float*)s, (float*)part, (bf16*)out, M, K, N, k_chunk);
  else
    wq_gemm_kernel<LAYOUT, 2, 2><<<grid, WQ_THREADS, 0, st>>>(
        xp, wp, (const float*)s, (float*)part, (bf16*)out, M, K, N, k_chunk);
  return (int)cudaGetLastError();
}
