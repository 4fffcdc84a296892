// Split-over-keys single-token attention, shared by decode_attention.cu
// (contiguous per-row KV cache with a validity mask), paged_attention.cu
// (KV pages addressed through a page table, keys [0, kv_len) visible) and
// seg_attention.cu (a dense (B, S, Hkv, D) cache with two visible segments).
//
// The kernels run the same two passes with the same arithmetic; only the
// address of key j, the rule that makes it visible and the test that skips
// a tile differ, and those come from the address policy (DenseKV, PagedKV
// or SegKV). So on the same keys the kernels return bit-identical outputs,
// which lets the dense and the paged serving engines emit identical tokens.
//
// Pass 1 (attn_split), one block per (32-key tile, row, KV head): the tile's
// K/V rows are staged in shared memory with independent 16-byte loads, the
// G query heads that share the KV head are scored against it, and the block
// writes an unnormalized (max, sum, output) triple. A tile the policy's
// skip() rules out (it holds no visible key) writes (PG_NEG_INF, 0, 0)
// without reading anything.
// Pass 2 (attn_combine), one block per (query head, row, KV head): the
// triples are merged in split order with the usual rescaling. An empty
// split adds exp(-1e30 - m) * 0 = +0 to every sum, an exact identity, so a
// window padded with empty splits gives the same bits as the unpadded one.
#pragma once

#include "common.cuh"

#define DA_KT 32        // keys per split block
#define DA_THREADS 256  // 8 warps
#define DA_HMAX 8       // query heads per KV head (Gemma-2B: 8)
#define DA_DMAX 256

// Contiguous per-row cache: key j of row b at b * stride_b + j * D; visible
// where valid[b, j] (a (B, W) mask).
struct DenseKV {
  const bf16* k;
  const bf16* v;
  const uint8_t* valid;
  long long stride_b;
  int D, W;
  __device__ __forceinline__ size_t row(int b, int, int j) const {
    return (size_t)b * stride_b + (size_t)j * D;
  }
  __device__ __forceinline__ bool visible(int b, int j) const {
    return valid[(size_t)b * W + j] != 0;
  }
  __device__ __forceinline__ bool skip(int, int k0, int) const { return k0 >= W; }
};

// Page pool (n_pages, ps, Hkv, D) of one layer (layer_off elements into a
// layer-stacked pool): key j of row b lives in page table[b, j / ps] at slot
// j % ps; keys [0, kv_len[b]) are visible and table entries past the last
// visible key are never read.
struct PagedKV {
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* kv_len;
  long long layer_off;
  int ps, tstride, Hkv, D;
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    const size_t page = (size_t)table[(size_t)b * tstride + j / ps];
    return (size_t)layer_off + ((page * ps + j % ps) * Hkv + hk) * (size_t)D;
  }
  __device__ __forceinline__ bool visible(int b, int j) const { return j < kv_len[b]; }
  __device__ __forceinline__ bool skip(int b, int k0, int) const { return k0 >= kv_len[b]; }
};

// Dense cache (B, S, Hkv, D) with three scalars per row: key j is visible
// iff j < seg0[b] or seg1[b] <= j < kv_len[b] (a right-padded prompt
// [0, seg0), a pad hole [seg0, seg1), the decode window [seg1, kv_len)).
// A tile [k0, k0 + nk) is skipped iff it holds no visible key: wholly past
// kv_len (and seg0), or wholly inside the hole, so the hole is never read.
struct SegKV {
  const bf16* k;
  const bf16* v;
  const int* seg0;
  const int* seg1;
  const int* kv_len;
  int S, Hkv, D;
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    return (((size_t)b * S + j) * Hkv + hk) * (size_t)D;
  }
  __device__ __forceinline__ bool visible(int b, int j) const {
    return j < seg0[b] || (j >= seg1[b] && j < kv_len[b]);
  }
  __device__ __forceinline__ bool skip(int b, int k0, int nk) const {
    const int s1 = max(seg1[b], k0);  // the second segment's part at or past k0
    return k0 >= seg0[b] && (s1 >= kv_len[b] || s1 >= k0 + nk);
  }
};

// grid (nsplit, B * Hkv); G query heads per KV head, q (B, Hkv * G, D).
// Without a floor of blocks per SM, ptxas keeps this kernel at 48 registers
// (5 blocks of 256 threads per SM, as many as its 42 KB of shared memory
// allow) and spills 8 bytes in one instantiation or the other; with a floor
// of 2 it takes 60 registers and spills nothing. Decode grids at B <= 8 hold
// 16-256 blocks, at most 2 per SM, so the lower occupancy costs nothing
// there (on an H100 the dense split then runs as fast as the untemplated
// kernel it replaced).
template <class KV>
__global__ void __launch_bounds__(DA_THREADS, 2)
    attn_split(const bf16* __restrict__ q, KV kv, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_o, int G, int Hkv, int D,
               int W, int nsplit, float scale) {
  __shared__ float qs[DA_HMAX][DA_DMAX];
  __shared__ __align__(16) bf16 ks[DA_KT][DA_DMAX];
  __shared__ __align__(16) bf16 vs[DA_KT][DA_DMAX];
  __shared__ float sc[DA_HMAX][DA_KT];
  __shared__ uint8_t ok[DA_KT];
  const int bh = blockIdx.y, split = blockIdx.x;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const int k0 = split * DA_KT;
  const int nk = min(DA_KT, W - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nchunk = D / 8;
  const size_t part = (size_t)bh * nsplit + split;
  if (kv.skip(b, k0, nk)) {  // no visible key in this tile: the combine's identity
    if (tid < G) {
      part_m[part * G + tid] = PG_NEG_INF;
      part_l[part * G + tid] = 0.f;
    }
    for (int i = tid; i < G * D; i += DA_THREADS) part_o[part * G * D + i] = 0.f;
    return;
  }
  const bf16* qb = q + ((size_t)b * Hkv * G + (size_t)hk * G) * D;
  for (int i = tid; i < DA_HMAX * DA_DMAX; i += DA_THREADS) {
    const int h = i / DA_DMAX, d = i - h * DA_DMAX;
    qs[h][d] = (h < G && d < D) ? bf2f(qb[(size_t)h * D + d]) : 0.f;
  }
  if (tid < nk) ok[tid] = kv.visible(b, k0 + tid);
  // stage the K/V tile with independent 16-byte loads (all in flight at once)
  for (int i = tid; i < nk * nchunk; i += DA_THREADS) {
    const int j = i / nchunk, c = i - j * nchunk;
    const size_t r = kv.row(b, hk, k0 + j) + c * 8;
    *reinterpret_cast<uint4*>(&ks[j][c * 8]) = *reinterpret_cast<const uint4*>(kv.k + r);
    *reinterpret_cast<uint4*>(&vs[j][c * 8]) = *reinterpret_cast<const uint4*>(kv.v + r);
  }
  __syncthreads();

  // scores: warp w takes keys w, w+8, ...; lane covers d = lane*8 .. +8
  const bool lane_on = lane < nchunk;
  for (int j = warp; j < nk; j += DA_THREADS / 32) {
    float kf[8];
    if (lane_on) bf16x8_to_float(*reinterpret_cast<const uint4*>(&ks[j][lane * 8]), kf);
    float dots[DA_HMAX];
#pragma unroll
    for (int h = 0; h < DA_HMAX; ++h) {
      float acc = 0.f;
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(qs[h][lane * 8 + e], kf[e], acc);
      }
      dots[h] = acc;
    }
#pragma unroll
    for (int h = 0; h < DA_HMAX; ++h) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dots[h] += __shfl_xor_sync(0xffffffffu, dots[h], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < DA_HMAX; ++h) sc[h][j] = dots[h] * scale;
    }
  }
  __syncthreads();

  // per-head max and sum over this split's visible keys: warp h, lane = key
  if (warp < G) {
    const bool on = lane < nk && ok[lane];
    float m = on ? sc[warp][lane] : PG_NEG_INF;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float p = on ? __expf(sc[warp][lane] - m) : 0.f;
    if (lane < DA_KT) sc[warp][lane] = p;
    float l = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      part_m[part * G + warp] = m;
      part_l[part * G + warp] = l;
    }
  }
  __syncthreads();

  // unnormalized p @ V from the staged tile: thread d accumulates every head
  const int d = tid;
  if (d < D) {
    float acc[DA_HMAX];
#pragma unroll
    for (int h = 0; h < DA_HMAX; ++h) acc[h] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float vv = bf2f(vs[j][d]);
#pragma unroll
      for (int h = 0; h < DA_HMAX; ++h) acc[h] = fmaf(sc[h][j], vv, acc[h]);
    }
    for (int h = 0; h < G; ++h) part_o[(part * G + h) * D + d] = acc[h];
  }
}

// grid (G, B * Hkv): merges the nsplit partials of one query head in split
// order into out (B, Hkv * G, D). (Templated on the address policy only so
// that each source instantiates a kernel of its own.)
template <class KV>
__global__ void attn_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                             const float* __restrict__ part_o, bf16* __restrict__ out, int G,
                             int D, int nsplit) {
  const int bh = blockIdx.y, h = blockIdx.x;
  const size_t base = (size_t)bh * nsplit;
  float mx = PG_NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[(base + s) * G + h]);
  float den = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t i = (base + s) * G + h;
    den += __expf(part_m[i] - mx) * part_l[i];
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = (base + s) * G + h;
      num += __expf(part_m[i] - mx) * part_o[i * D + d];
    }
    out[((size_t)bh * G + h) * D + d] = f2bf(num * inv);
  }
}

// Launches both passes on ``st``; returns cudaGetLastError().
template <class KV>
inline int attn_launch(const bf16* q, const KV& kv, float* part_m, float* part_l, float* part_o,
                       bf16* out, int B, int G, int Hkv, int D, int W, int nsplit, float scale,
                       cudaStream_t st) {
  attn_split<KV><<<dim3(nsplit, B * Hkv), DA_THREADS, 0, st>>>(q, kv, part_m, part_l, part_o, G,
                                                                Hkv, D, W, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_combine<KV><<<dim3(G, B * Hkv), 256, 0, st>>>(part_m, part_l, part_o, out, G, D, nsplit);
  return (int)cudaGetLastError();
}
