// Split-over-keys single-token attention, shared by decode_attention.cu
// (contiguous per-row KV cache with a validity mask), paged_attention.cu
// (KV pages addressed through a page table, keys [0, kv_len) visible) and
// seg_attention.cu (a dense (B, S, Hkv, D) cache with two visible segments).
//
// The kernels run the same two passes with the same arithmetic; only the
// address of key j, the rule that makes it visible and the test that skips
// a tile differ, and those come from the address policy (DenseKV, PagedKV
// or SegKV). A key's K/V row is read only where it is visible (zeros stand
// in for the others), so a tile's arithmetic sees the same values under
// every policy and on the same keys the kernels return bit-identical
// outputs, which lets the dense and the paged serving engines emit
// identical tokens.
//
// Pass 1 (attn_split), one block per (32-key tile, row, KV head): the K and
// V tile go to shared memory as two groups of cp.async copies, so the
// scores start while V is still in flight. The G <= 8 query heads of the KV
// head are the live rows of mma.sync m16n8k16 products: q.k^T by 8 warps
// (four 8-key tiles, two depth halves added in a fixed order), a per-head
// softmax over the tile's visible keys, then bf16(p).v by the warps' 32-
// column strips (p's rounding point is the TPU kernel's). The block writes
// an unnormalized (max, sum, output) triple; a tile the policy's skip()
// rules out (it holds no visible key) writes (PG_NEG_INF, 0, 0) without
// reading anything.
// Pass 2 (attn_combine), one block per (32 output columns, query head,
// row x KV head): split s is weighted by exp(m_s - max) and added by warp
// s % DA_MERGE in ascending s, and the warps' sums are added in warp order.
// The key tiles and this merge order depend on the split index only (not
// on W, B or the policy), and an empty split adds exp(-1e30 - m) * 0 = +0,
// an exact identity, so a window padded with empty splits gives the same
// bits as the unpadded one.
//
// The fp32 form (attn_split_f32 and attn_launch_f32, --dtype float32):
// fp32 q, K / V tiles and output. Its split pass keeps the 32-key tiles,
// the policies, the skipped tiles and the partials' layout, and computes
// in fp32 on the CUDA cores (the window's bytes bound it: 4.19 MB at B1
// W2048 D256, 1.25 us at 3.35 TB/s). Each split is a cluster of DA_F32_CS
// = 2 CTAs, rank r taking columns [r D/2, (r + 1) D/2) of the tile, so a
// B1 W2048 call puts 128 CTAs on the card, each staging 32 KB: after one
// round trip for its 32 keys' visibility and rows, its share of K, then of
// V, by cp.async with no load between them, scores starting while V is in
// flight.
// Thread (head h = warp, key = lane) sums its rank's share of q_h . k_key
// in four interleaved chains (a chunk's columns 0 .. 3, chunks in order,
// added (0 + 1) + (2 + 3)); after a cluster barrier each rank adds the two
// ranks' partial scores through distributed shared memory in rank order,
// so both hold the same bits and the same softmax; thread (column,
// four heads) then takes its rank's p.v over the tile's keys in order,
// p not rounded. The combine is the same kernel, writing fp32. So dense
// == paged and a verify row == its decode step hold bit for bit at fp32 as
// at bf16. The three policies have fp32 forms (DenseKV<.., float>,
// PagedKV<float>, SegKV<float>: 3b, B5 and B10 at fp32).
//
// The mixed forms (a KV cache whose dtype is not the activations'): a
// policy's element type E is the cache's, the pass's the activations'. A
// bf16 q over an fp32 cache runs the bf16 pass on the tile rounded to bf16
// (nearest even) as it is staged, the TPU kernels' astype(q.dtype) of the
// window (decode_layer.py:323,334): cp.async copies bytes and cannot
// round, so those tiles go through registers (stage_chunk). An fp32 q over
// a bf16 cache runs the fp32 pass on the raw bf16 bytes, copied by 8-byte
// cp.async and widened to fp32 (exact) as the products read them: the same
// tiles, skips, arithmetic and combine, so dense == paged holds bit for bit
// within each mixed pair too, and a mixed form gives the uniform form's
// bits on the converted cache.
#pragma once

#include <type_traits>

#include "common.cuh"

#define DA_KT 32        // keys per split block
#define DA_THREADS 256  // 8 warps
#define DA_HMAX 8       // query heads per KV head (Gemma-2B: 8)
#define DA_DMAX 256
#define DA_LD (DA_DMAX + 8)  // bf16 row stride of the K / V tiles: conflict-free fragment loads
#define DA_PLD (DA_KT + 8)   // bf16 row stride of p
#define DA_MERGE 8           // combine: split s is added by warp s % DA_MERGE
#define DA_F32_CS 2              // the fp32 split pass: CTAs a cluster, one share of D each
#define DA_F32_DH (DA_DMAX / DA_F32_CS)  // a rank's columns at most
#define DA_F32_LD (DA_F32_DH + 4)   // fp32 row stride of a rank's K / V tile: 16-byte rows,
                                    // conflict-free float4 reads of eight rows
#define DA_F32_BLD (DA_F32_DH + 4)  // bf16 row stride of a rank's tile of a bf16 cache: 8-byte
                                    // rows, conflict-free 8-byte reads of sixteen rows

// Contiguous per-row cache: key j of query row b at c * stride_b + j * D,
// where c = b, or with kShared c = b / rpc (rpc query rows share a cache
// row: the s positions of a speculative verify block; a decode step keeps
// the division out of its address arithmetic); visible where valid[b, j]
// (a (B, W) mask of query rows).
template <bool kShared, class E = bf16>
struct DenseKV {
  using elem = E;
  const E* k;
  const E* v;
  const uint8_t* valid;
  long long stride_b;
  int D, W, rpc;
  __device__ __forceinline__ size_t row(int b, int, int j) const {
    return (size_t)(kShared ? b / rpc : b) * stride_b + (size_t)j * D;
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
template <class E = bf16>
struct PagedKV {
  using elem = E;
  const E* k;
  const E* v;
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
template <class E = bf16>
struct SegKV {
  using elem = E;
  const E* k;
  const E* v;
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

// One 16-byte chunk of a bf16 K / V tile row in shared memory (8 values)
// from cache elements of type E at src; with on false nothing is read and
// the chunk is zeros. Where E is bf16 it is one 16-byte cp.async (in flight
// until the caller's wait); an fp32 cache is read into registers and
// rounded to bf16 to nearest even as it is stored (torch's
// .to(torch.bfloat16), JAX's astype).
template <class E>
__device__ __forceinline__ void stage_chunk(bf16* dst, const E* src, bool on) {
  if constexpr (sizeof(E) == 2) {
    cp_async_16(dst, src, on);
  } else {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (on) {
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      r = make_uint4(pack_f32_bf16x2(a.x, a.y), pack_f32_bf16x2(a.z, a.w),
                     pack_f32_bf16x2(b.x, b.y), pack_f32_bf16x2(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(dst) = r;
  }
}

// grid (nsplit, B * Hkv); G query heads per KV head, q (B, Hkv * G, D).
// A floor of 2 blocks per SM keeps ptxas from squeezing registers for more
// blocks than the grids of decode ever place on an SM.
template <class KV>
__global__ void __launch_bounds__(DA_THREADS, 2)
    attn_split(const bf16* __restrict__ q, KV kv, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_o, int G, int Hkv, int D,
               int W, int nsplit, float scale) {
  __shared__ __align__(16) bf16 ks[DA_KT][DA_LD];
  __shared__ __align__(16) bf16 vs[DA_KT][DA_LD];
  __shared__ __align__(16) bf16 ps[16][DA_PLD];  // p: heads as rows, 8 .. 15 zero
  __shared__ float red[2][DA_HMAX][DA_KT];       // the two depth halves of q.k^T
  __shared__ uint8_t ok[DA_KT];
  const int bh = blockIdx.y, split = blockIdx.x;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const int k0 = split * DA_KT;
  const int nk = min(DA_KT, W - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t part = (size_t)bh * nsplit + split;
  if (kv.skip(b, k0, nk)) {  // no visible key in this tile: the combine's identity
    if (tid < G) {
      part_m[part * G + tid] = PG_NEG_INF;
      part_l[part * G + tid] = 0.f;
    }
    for (int i = tid; i < G * D; i += DA_THREADS) part_o[part * G * D + i] = 0.f;
    return;
  }
  const int nchunk = D / 8;
  const int dp = (D + 15) & ~15;  // q.k^T depth, zero padded to the k16 step
  const int pchunk = dp / 8;

  // K, then V: one 16-byte chunk per 8 columns of a visible key (a
  // cp.async, or from an fp32 cache rounded in registers), zeros for the
  // other keys and for the columns D .. dp - 1
  using E = typename KV::elem;
  for (int half = 0; half < 2; ++half) {
    const E* src = half ? kv.v : kv.k;
    bf16(*dst)[DA_LD] = half ? vs : ks;
#pragma unroll 4
    for (int i = tid; i < DA_KT * pchunk; i += DA_THREADS) {
      const int j = i / pchunk, c = i - j * pchunk;
      const bool on = c < nchunk && j < nk && kv.visible(b, k0 + j);
      const E* from = on ? src + kv.row(b, hk, k0 + j) + c * 8 : src;
      stage_chunk<E>(&dst[j][c * 8], from, on);
    }
    cp_async_commit();
  }
  if (tid < DA_KT) ok[tid] = tid < nk && kv.visible(b, k0 + tid);

  // this warp's q.k^T share: keys nt * 8 .. + 7, k16 steps [kb, ke); the A
  // fragment's rows g are the query heads (rows g + 8 are zero)
  const int nt = warp & 3, dh = warp >> 2;
  const int ksteps = dp / 16, khalf = (ksteps + 1) / 2;
  const int kb = dh * khalf, ke = min(ksteps, kb + khalf);
  const bf16* qh = q + ((size_t)b * Hkv * G + (size_t)hk * G + g) * D;
  uint32_t qa[DA_DMAX / 32][2];
#pragma unroll
  for (int kk = 0; kk < DA_DMAX / 32; ++kk) {
    const int c = (kb + kk) * 16 + 2 * t;
    const bool on = kb + kk < ke && g < G;
    qa[kk][0] = on && c < D ? ld_bf16x2(qh + c) : 0u;
    qa[kk][1] = on && c + 8 < D ? ld_bf16x2(qh + c + 8) : 0u;
  }
  cp_async_wait<1>();  // K has landed (V may not have)
  __syncthreads();
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < DA_DMAX / 32; ++kk) {
    if (kb + kk < ke) {
      const bf16* kp = &ks[nt * 8 + g][(kb + kk) * 16 + 2 * t];
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      const uint32_t bb[2] = {ld_bf16x2(kp), ld_bf16x2(kp + 8)};
      mma_bf16_16816(sc, a, bb);
    }
  }
  red[dh][g][nt * 8 + 2 * t] = sc[0];
  red[dh][g][nt * 8 + 2 * t + 1] = sc[1];
  __syncthreads();

  // per-head max and sum over this tile's visible keys: warp h, lane = key
  {
    const int h = warp;
    const bool on = h < G && ok[lane];
    const float s = (red[0][h][lane] + red[1][h][lane]) * scale;
    float m = on ? s : PG_NEG_INF;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float p = on ? __expf(s - m) : 0.f;
    ps[h][lane] = f2bf(p);
    ps[h + 8][lane] = f2bf(0.f);
    float l = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0 && h < G) {
      part_m[part * G + h] = m;
      part_l[part * G + h] = l;
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // unnormalized bf16(p) . V: warp w owns output columns 32 w .. + 31
  const int n0 = warp * 32;
  if (n0 < D) {
    const int lr = lane & 7, lm = lane >> 3;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DA_KT / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, &ps[(lm & 1) * 8 + lr][kk * 16 + (lm >> 1) * 8]);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        if (n0 + pr * 16 < D) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, &vs[kk * 16 + (lm & 1) * 8 + lr][n0 + pr * 16 + (lm >> 1) * 8]);
          mma_bf16_16816(acc[2 * pr], a, bv);
          mma_bf16_16816(acc[2 * pr + 1], a, bv + 2);
        }
      }
    }
    if (g < G) {
      float* po = part_o + (part * G + g) * D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + i * 8 + 2 * t;
        if (col < D) *reinterpret_cast<float2*>(po + col) = make_float2(acc[i][0], acc[i][1]);
      }
    }
  }
}

// grid (ceil(D / 32), G, B * Hkv), 8 warps: merges the nsplit partials of
// one query head into 32 columns of out (B, Hkv * G, D). (Templated on the
// address policy only so that each source instantiates a kernel of its
// own.)
template <class KV, class T = bf16>
__global__ void __launch_bounds__(DA_MERGE * 32)
    attn_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                 const float* __restrict__ part_o, T* __restrict__ out, int G, int D,
                 int nsplit) {
  __shared__ float wmax[DA_MERGE];
  __shared__ float wden[DA_MERGE];
  __shared__ float wnum[DA_MERGE][32];
  const int bh = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * 32 + lane;
  const size_t base = (size_t)bh * nsplit;
  // the largest split max (a max is the same in any order)
  float mx = PG_NEG_INF;
  for (int s = threadIdx.x; s < nsplit; s += DA_MERGE * 32)
    mx = fmaxf(mx, part_m[(base + s) * G + h]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < DA_MERGE; ++i) mx = fmaxf(mx, wmax[i]);
  // warp w adds the splits w, w + 8, ... in ascending order, loading four
  // of them ahead of the adds (a column past D reads column D - 1 and is
  // not stored)
  float den = 0.f, num = 0.f;
  const int dc = min(d, D - 1);
  int s = warp;
  for (; s + 3 * DA_MERGE < nsplit; s += 4 * DA_MERGE) {
    float mv[4], lv[4], ov[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t i = (base + s + u * DA_MERGE) * G + h;
      mv[u] = part_m[i];
      lv[u] = part_l[i];
      ov[u] = part_o[i * D + dc];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float wgt = __expf(mv[u] - mx);
      den += wgt * lv[u];
      num += wgt * ov[u];
    }
  }
  for (; s < nsplit; s += DA_MERGE) {
    const size_t i = (base + s) * G + h;
    const float wgt = __expf(part_m[i] - mx);
    den += wgt * part_l[i];
    num += wgt * part_o[i * D + dc];
  }
  wnum[warp][lane] = num;
  if (lane == 0) wden[warp] = den;
  __syncthreads();
  if (warp == 0 && d < D) {
    float dt = 0.f, nt = 0.f;
#pragma unroll
    for (int w = 0; w < DA_MERGE; ++w) {
      dt += wden[w];
      nt += wnum[w][lane];
    }
    out[((size_t)bh * G + h) * D + d] = from_f32<T>(nt * (dt > 0.f ? 1.f / dt : 0.f));
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
  attn_combine<KV><<<dim3((D + 31) / 32, G, B * Hkv), DA_MERGE * 32, 0, st>>>(
      part_m, part_l, part_o, out, G, D, nsplit);
  return (int)cudaGetLastError();
}

// The fp32 split pass (header): grid (DA_F32_CS * nsplit, B * Hkv) in
// clusters of DA_F32_CS along x, DA_THREADS threads, static shared memory.
// Rank r of a split's cluster stages and multiplies columns [r D / 2,
// (r + 1) D / 2) of the tile. KV's policy addresses fp32 rows, or bf16 rows
// (a mixed form: the raw bytes staged, widened as read).
struct __align__(16) SplitF32Smem {
  float k[DA_KT][DA_F32_LD];  // the rank's columns of K (a bf16 cache: bf16, DA_F32_BLD a row)
  float v[DA_KT][DA_F32_LD];  // and of V
  float q[DA_HMAX][DA_F32_DH];
  float p[DA_KT][DA_HMAX];  // key-major: a thread's four heads in one 16-byte read; heads >= G zero
  float s[DA_HMAX][DA_KT];  // the rank's partial scores, read by the other rank
  size_t row[DA_KT];        // each visible key's row in the cache
  uint8_t ok[DA_KT];
};

// Chunk c (4 columns) of row j of a rank's tile: an fp32 cache's 16 bytes,
// or a bf16 cache's 8 raw bytes, by cp.async (zeros where on is false).
template <class E>
__device__ __forceinline__ void f32_stage4(float (*tile)[DA_F32_LD], int j, int c, const E* src,
                                           bool on) {
  if constexpr (sizeof(E) == 4)
    cp_async_16(&tile[j][4 * c], src, on);
  else
    cp_async_8(reinterpret_cast<bf16*>(tile) + j * DA_F32_BLD + 4 * c, src, on);
}

// Chunk c of row j of a rank's tile, in fp32 (a bf16 tile widened: exact).
template <class E>
__device__ __forceinline__ float4 f32_load4(const float (*tile)[DA_F32_LD], int j, int c) {
  if constexpr (sizeof(E) == 4) {
    return *reinterpret_cast<const float4*>(&tile[j][4 * c]);
  } else {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(reinterpret_cast<const bf16*>(tile) + j * DA_F32_BLD + 4 * c);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

// Element (j, col) of a rank's tile, in fp32.
template <class E>
__device__ __forceinline__ float f32_load1(const float (*tile)[DA_F32_LD], int j, int col) {
  if constexpr (sizeof(E) == 4)
    return tile[j][col];
  else
    return bf2f(reinterpret_cast<const bf16*>(tile)[j * DA_F32_BLD + col]);
}

template <class KV>
__global__ void __launch_bounds__(DA_THREADS, 4)
    attn_split_f32(const float* __restrict__ q, KV kv, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_o, int G, int Hkv, int D,
                   int W, int nsplit, float scale) {
  __shared__ SplitF32Smem sm;
  const int rank = cluster_rank();
  const int bh = blockIdx.y, split = blockIdx.x / DA_F32_CS;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const int k0 = split * DA_KT;
  const int nk = min(DA_KT, W - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t part = (size_t)bh * nsplit + split;
  const int dh = D / DA_F32_CS, d0 = rank * dh;  // the rank's columns [d0, d0 + dh)
  if (kv.skip(b, k0, nk)) {  // no visible key in this tile (both ranks): the combine's identity
    if (rank == 0 && tid < G) {
      part_m[part * G + tid] = PG_NEG_INF;
      part_l[part * G + tid] = 0.f;
    }
    for (int i = tid; i < G * dh; i += DA_THREADS)
      part_o[(part * G + i / dh) * D + d0 + i % dh] = 0.f;
    return;
  }
  const int nchunk = dh / 4;  // 4-column chunks of the rank's share of a row (D % 8 == 0)

  // each key's visibility and row first (one round trip to the mask or
  // the page table), then the rank's columns of K and of V: one chunk per
  // 4 columns of a visible key, zeros for the other keys, with no load
  // between the copies
  using E = typename KV::elem;
  if (tid < DA_KT) {
    const bool on = tid < nk && kv.visible(b, k0 + tid);
    sm.ok[tid] = on;
    sm.row[tid] = on ? kv.row(b, hk, k0 + tid) : 0;
  }
  __syncthreads();
  for (int half = 0; half < 2; ++half) {
    const E* src = half ? kv.v : kv.k;
    float(*dst)[DA_F32_LD] = half ? sm.v : sm.k;
#pragma unroll 4
    for (int i = tid; i < DA_KT * nchunk; i += DA_THREADS) {
      const int j = i / nchunk, c = i - j * nchunk;
      const bool on = sm.ok[j];
      f32_stage4<E>(dst, j, c, on ? src + sm.row[j] + d0 + c * 4 : src, on);
    }
    cp_async_commit();
  }
  const float* qh = q + (size_t)bh * G * D + d0;
  for (int i = tid; i < G * dh; i += DA_THREADS) {
    const int h = i / dh;
    sm.q[h][i - h * dh] = qh[(size_t)h * D + i - h * dh];
  }
  cp_async_wait<1>();  // K has landed (V may not have)
  __syncthreads();

  // the partial score of head h = warp and key = lane over the rank's
  // columns: four sums (a chunk's columns 0 .. 3) over the chunks in order,
  // added (0 + 1) + (2 + 3)
  {
    const int h = warp;
    float s = 0.f;
    if (h < G) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int c = 0; c < nchunk; ++c) {
        const float4 qv = *reinterpret_cast<const float4*>(&sm.q[h][4 * c]);
        const float4 kk = f32_load4<E>(sm.k, lane, c);
        a.x = fmaf(qv.x, kk.x, a.x);
        a.y = fmaf(qv.y, kk.y, a.y);
        a.z = fmaf(qv.z, kk.z, a.z);
        a.w = fmaf(qv.w, kk.w, a.w);
      }
      s = __fadd_rn(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w));
    }
    sm.s[h][lane] = s;
  }
  cluster_sync_all();  // both ranks' partial scores are visible

  // the score, rank 0's columns first (both ranks get the same bits); the
  // per-head max and sum over this tile's visible keys
  {
    const int h = warp;
    const bool on = h < G && sm.ok[lane];
    const float s =
        __fadd_rn(ld_cluster_f32(&sm.s[h][lane], 0), ld_cluster_f32(&sm.s[h][lane], 1)) * scale;
    float m = on ? s : PG_NEG_INF;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float p = on ? __expf(s - m) : 0.f;
    sm.p[lane][h] = p;
    float l = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (rank == 0 && lane == 0 && h < G) {
      part_m[part * G + h] = m;
      part_l[part * G + h] = l;
    }
  }
  cluster_arrive();    // this rank has read the other's scores
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // unnormalized p . V over the rank's columns: thread (column tid %
  // DA_F32_DH, heads 4 (tid / DA_F32_DH) .. + 3), the tile's keys in order
  {
    const int col = tid % DA_F32_DH, h0 = 4 * (tid / DA_F32_DH);
    if (col < dh && h0 < G) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int j = 0; j < DA_KT; ++j) {
        const float vv = f32_load1<E>(sm.v, j, col);
        const float4 p4 = *reinterpret_cast<const float4*>(&sm.p[j][h0]);
        acc[0] = fmaf(p4.x, vv, acc[0]);
        acc[1] = fmaf(p4.y, vv, acc[1]);
        acc[2] = fmaf(p4.z, vv, acc[2]);
        acc[3] = fmaf(p4.w, vv, acc[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (h0 + i < G) part_o[(part * G + h0 + i) * D + d0 + col] = acc[i];
    }
  }
  cluster_wait();  // the other rank has read this one's scores
}

// Launches the fp32 split pass and the combine (fp32 out) on ``st``;
// returns cudaGetLastError().
template <class KV>
inline int attn_launch_f32(const float* q, const KV& kv, float* part_m, float* part_l,
                           float* part_o, float* out, int B, int G, int Hkv, int D, int W,
                           int nsplit, float scale, cudaStream_t st) {
  const int err = cluster_launch(attn_split_f32<KV>, dim3(DA_F32_CS * nsplit, B * Hkv),
                                 DA_THREADS, DA_F32_CS, 0, st, q, kv, part_m, part_l, part_o, G,
                                 Hkv, D, W, nsplit, scale);
  if (err != 0) return err;
  attn_combine<KV, float><<<dim3((D + 31) / 32, G, B * Hkv), DA_MERGE * 32, 0, st>>>(
      part_m, part_l, part_o, out, G, D, nsplit);
  return (int)cudaGetLastError();
}
