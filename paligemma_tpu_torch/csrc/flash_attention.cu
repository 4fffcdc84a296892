// Prefix-LM flash attention, forward (FlashAttention-2) on the tensor cores.
//
// Replaces paligemma_tpu/kernels/flash_attention.py:_flash_kernel (via
// _flash_forward / flash_attention). Key j is visible to query i of batch b
// iff  j < kv_len[b]  and  (j < prefix_len[b]  or  j <= i + q_offset).
// Query heads that share a KV head are folded into the rows of one block
// (row = g * Sq + i), as the TPU kernel does, so a block reads each K/V tile
// once per KV head. Per row, with fp32 scores s = scale * q.k:
//
//   m = running max of s,  p = exp(s - m)  (fp32),  l = sum of p  (fp32)
//   out = (sum_j bf16(p_j) v_j) / l,        lse = m + log l   (fp32)
//
// p is rounded to bf16 as the A operand of p.V, where the TPU kernel rounds
// it; l sums the fp32 p. Online softmax with NEG_INF = -1e30; a masked key
// gets p = 0 by a select, so a row with no visible key writes exact zeros
// to out and (with a non-null ``lse``) to lse (B, Hq, Sq), which the
// backward (csrc/flash_attention_bwd.cu) reads.
//
// Design. A block owns 64 folded rows of one (batch, KV head), four
// 16-row groups. 64-key K and V tiles stream through a cp.async ring in the
// order K_0, V_0, K_1, V_1, ... and every warp of the block reads each
// staged tile: S = Q K^T lands in mma.sync.m16n8k16 C fragments (K's B
// fragments by ldmatrix), the online softmax runs on them in registers (in
// log2 units: one multiply-add and one ex2 per score; O is rescaled only
// when a row max grew), and the C fragments of bf16(p) are the A fragments
// of O += P V (V's B fragments by ldmatrix.trans), with no trip through
// shared memory. The ring has NS slots, and a load is issued NS - 1 loads
// ahead.
// Q stays in shared memory and is re-read by ldmatrix each k16 step.
// * D <= 80 (SigLIP's 72, and 64): one warp per row group (4 warps), four
//   ring slots (the next tile's K and V load while this one computes),
//   registers held to 128 a thread so that 4 blocks (16 warps) share an
//   SM: Q's A fragments kept in registers instead cost that occupancy or
//   spills (measured at the 896 px tower, PERF.md).
// * 80 < D <= 256 (Gemma's 256), depth 256: a warp's 16 x 256 fp32 O
//   accumulator already takes 128 registers a thread, and the ring has two
//   slots (FA2's schedule: V_j loads during S_j, K_{j+1} during P_j V_j;
//   four 64 x 256 tiles would take 135 KB). Two warps share each row
//   group, one per 32-key half of every tile (8 warps), and add their
//   (m, l, O) once at the end in a fixed order: twice the warps to hide
//   the latency of each ldmatrix and mma, and twice the threads issuing
//   each tile's copies.
// The depth is D rounded up to DP in {64, 80, 256}: cp.async
// zero-fills the columns past D, the keys past kv_len and the rows past
// the tensor, so a masked key's 0 weight never meets a stale value.
//
// Hidden work is skipped: a block's sweep ends at min(kv_len, max(prefix_len,
// the largest position among its rows + 1)) (a block that straddles two
// heads holds position Sq - 1), a warp computes only the tiles its own rows
// see, and a tile that every row of the warp sees skips the mask. A row's
// arithmetic depends on its own data, DP and the fixed tiling only, never
// on the other rows of the grid: a row gives the same bits in any batch,
// which dense == paged serving and TP at world size 1 == one card rest on.
//
// Rows per block (measured on an H100, PERF.md): 64-row blocks beat smaller
// ones that give every SM a block (34 blocks of 64 rows beat 133 of 16 at
// the LM prefill): each block copies every K/V tile its rows see, so
// smaller blocks multiply the L2 traffic and leave fewer threads to issue
// it.
//
// What bounds it (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): at the LM prefill
// (B1 S266 Hq8 Hkv1 D256, 0.58 GFLOP, 2.4 MB) the bytes, 0.7 us; at the
// training shape (B2 S512, prefix 268, kv_len 512 / 400) the bytes, 9.4 MB
// in 2.8 us, about the 2.7 us of the visible pairs' 2.7 GFLOP; at the 896
// px tower (B1 S4096 H16 D72, depth 80) the operations, 77 GFLOP, 78 us.
// Measured on an H100 (PERF.md): 22 us, 33 us and 0.51 ms. What holds it
// above the bounds: instruction issue. With one 16-row m-tile per warp
// every K / V fragment feeds two mma.sync, and the softmax, the fragment
// loads and the copies cost several instructions per mma; wgmma and TMA
// are later work.
//
// The fp32 form (flash_fwd_f32_kernel, pg_flash_attention_fwd_fp32;
// --dtype float32): the same function, mask, sweep bound and lse with fp32
// q, k, v and out, p not rounded (the TPU kernel's rounding of p to v's
// dtype is the identity at fp32). Both products run on the tensor cores in
// 3xTF32 (tf32.cuh: mma.sync.m16n8k8, each fp32 operand split into a tf32
// big and small part, a k8 step's three products summed from zero and added
// to the fp32 sum, since the tensor core's own fp32 sum truncates). A block
// of four warps owns BM folded rows of one (batch, KV head); K and V tiles
// stream through shared memory as fp32 (rows of DP + 4 floats: both
// fragment reads free of bank conflicts), K_{j+1} loading during P_j V_j and
// V_{j+1} during S_{j+1}. Warp (wr, wd) owns MT 16-row tiles and a slice of
// DS = DP / WD of the depth:
// * Q's A fragments are split once, when Q lands: into registers (MT 1, 2 x
//   4 DS / 8 of them) or into big / small planes in shared memory (MT 2);
// * S over the slice: each K fragment (ldmatrix) is split once for the
//   warp's MT row tiles; with WD > 1 the slices' partial scores meet in
//   shared memory and every warp of the row group adds them in slice order,
//   so all hold the same bits;
// * the online softmax in log2 units on the C fragments; p's C fragment is
//   P V's A fragment with the k8 step's index t standing for key 2t and t +
//   4 for key 2t + 1, so V's B fragments are the 32-bit words of keys 2t and
//   2t + 1 (rows 2t apart: free of conflicts), split once for the MT tiles;
// * O += P V for the slice's DS columns (MT DS / 2 fp32 accumulators).
// The shape by DP (D rounded up): 64 and 72 (SigLIP) one warp a 32-row
// group (MT 2), 128 rows a block, 32-key tiles; 128 two warps a 16-row
// group, 32 rows; 256 (Gemma) four warps on 16 rows, 16-key tiles, three
// blocks an SM, and a cluster of two CTAs on each block's rows, rank r
// taking the key tiles r, r + 2, ... and rank 0 adding rank 1's (m, l, O)
// through distributed shared memory: the LM prefill's 2128 folded rows give
// 266 CTAs where 64-row blocks gave 34. The split is fixed by DP and the
// tiles by absolute key, and a tile a row does not see adds exact zeros,
// so a row's bits depend on its own data and the tiling only, not on the
// batch it is in. B12's fp32 form (pg_vision_attention_fp32) is this kernel
// with no lengths: every key visible, as in the vision tower.
// What bounds it: the products at 3xTF32 (495 / 3 = 165 TFLOP/s): 0.58
// GFLOP at the LM prefill (3.5 us), 2.7 GFLOP at the training shape (16
// us), 77 GFLOP at the 896 px tower (0.47 ms). Measured on an H100 (PERF.md
// row 1f, tools/fwd_fp32_times.py): 47 us, 163 us and 1.70 ms, against one
// fp32 SDPA's 56, 191 and 2760 us: 7 %, 10 % and 28 % of the bound. The LM
// prefill waits on latency (two CTAs of four warps an SM) and on the L2
// (each 16-row block reads all 266 keys' K and V); mma.sync's issue and
// the splits (four instructions a split element) bound the rest. Measured
// and dropped, with one row tile a warp: 16-key tiles at three blocks an SM
// for DP 72 (2.52 ms against 2.27; two row tiles a warp then gave 1.70), no
// cluster at DP 256 (63 us against 47).
#include "tf32.cuh"

#define FA_BK 64  // keys per K / V tile
#define FA_WR 4   // 16-row groups per block

// The kernel's shape at depth DP: a block has NW = FA_WR * WK warps; warp
// (wr, wk) owns rows 16 wr .. 16 wr + 15 of the block's 64 and keys
// KW wk .. KW wk + KW - 1 of every 64-key tile.
template <int DP>
struct FwdCfg {
  static constexpr int LD = DP + 8;             // bf16 row stride: conflict-free ldmatrix
  static constexpr int WK = DP <= 80 ? 1 : 2;   // warps that share a row group's keys
  static constexpr int KW = FA_BK / WK;         // keys of a tile per warp
  static constexpr int NW = FA_WR * WK;
  static constexpr int NS = DP <= 80 ? 4 : 2;   // ring slots
  // blocks per SM that the registers must allow (<= 128 registers a thread
  // at 4), and the copies in a rolled loop to fit them
  static constexpr int MIN_BLOCKS = DP <= 80 ? 4 : 1;
  static constexpr bool ROLLED = DP <= 80;
  static constexpr int BYTES = (16 * FA_WR + NS * FA_BK) * LD * (int)sizeof(bf16);
};

// 2^x (ex2.approx, as __expf uses): exp(s - m) is computed as
// 2^(s log2(e) - m log2(e)) with the scale folded into one multiply-add.
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Folded rows row0 .. row0+n-1 of q (B, Sq, Hq, D) into a tile of stride
// DP + 8, columns [0, DP): one 16-byte cp.async per chunk, zeros past
// `rows` and past D.
template <int DP, int NT>
__device__ __forceinline__ void fa_load_rows(bf16* dst, const bf16* __restrict__ q, int n, int b,
                                             int kvh, int row0, int rows, int Sq, int Hq,
                                             int group, int D) {
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < n * CH; idx += NT) {
    const int r = idx / CH, c = idx - r * CH, row = row0 + r;
    const bool ok = row < rows && c * 8 < D;
    const bf16* p = q;
    if (ok) {
      const int g = row / Sq, i = row - g * Sq;
      p = q + (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + g) * D + c * 8;
    }
    cp_async_16(dst + r * (DP + 8) + c * 8, p, ok);
  }
}

// Keys k0 .. k0+FA_BK-1 of a (B, Skv, Hkv, D) tensor, as fa_load_rows:
// zeros at and past klen and past D. Thread (r0, c) copies chunk c of rows
// r0, r0 + RP, ...: one compare and two pointer steps per chunk.
template <int DP, int NT, bool ROLLED>
__device__ __forceinline__ void fa_load_keys(bf16* dst, const bf16* __restrict__ src, int k0,
                                             int b, int kvh, int klen, int Skv, int Hkv, int D) {
  constexpr int CH = DP / 8, RP = NT / CH;  // 16-byte chunks of a row, rows per pass
  const int c = threadIdx.x % CH, r0 = threadIdx.x / CH;
  if (r0 >= RP) return;
  const size_t step = (size_t)RP * Hkv * D;
  const bf16* p = src + (((size_t)b * Skv + k0 + r0) * Hkv + kvh) * D + c * 8;
  bf16* d = dst + r0 * (DP + 8) + c * 8;
  const bool cok = c * 8 < D;
  const int left = klen - k0 - r0;  // rows r0 + RP i with RP i < left hold keys
  auto copy = [&](int i) {
    if (r0 + RP * i < FA_BK) {
      const bool ok = cok && RP * i < left;
      cp_async_16(d, ok ? p : src, ok);
    }
    p += step;
    d += RP * (DP + 8);
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = 0; i < (FA_BK + RP - 1) / RP; ++i) copy(i);
  } else {
#pragma unroll
    for (int i = 0; i < (FA_BK + RP - 1) / RP; ++i) copy(i);
  }
}

// Positions (i + q_offset) of the valid folded rows among row0 .. row0+n-1:
// (smallest, largest), or (0, -1) when none is valid. Rows that straddle a
// head boundary hold positions 0 and Sq - 1.
__device__ __forceinline__ int2 fa_positions(int row0, int n, int rows, int Sq, int q_offset) {
  const int last = min(row0 + n, rows) - 1;
  if (last < row0) return make_int2(0, -1);
  const int g0 = row0 / Sq, g1 = last / Sq;
  if (g0 != g1) return make_int2(q_offset, Sq - 1 + q_offset);
  return make_int2(row0 - g0 * Sq + q_offset, last - g1 * Sq + q_offset);
}

// One past the last key that a row with positions `pos` sees.
__device__ __forceinline__ int fa_key_end(int2 pos, int plen, int klen) {
  return pos.y < 0 ? 0 : min(klen, max(plen, pos.y + 1));
}

template <int DP>
__global__ void __launch_bounds__(FwdCfg<DP>::NW * 32, FwdCfg<DP>::MIN_BLOCKS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ prefix_len,
                     const int* __restrict__ kv_len, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int D,
                     float scale, int q_offset) {
  using Cfg = FwdCfg<DP>;
  constexpr int LD = Cfg::LD, NS = Cfg::NS, NT = Cfg::NW * 32, KW = Cfg::KW;
  constexpr int KD = DP / 16, ND = DP / 8;  // k16 steps over D, n8 tiles over D
  // the key groups' hand-off (m, l and O of every lane) fits in the ring
  static_assert((Cfg::WK - 1) * FA_WR * 32 * (ND * 4 + 4) * 4 <= NS * FA_BK * LD * 2, "hand-off");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + 16 * FA_WR * LD;  // slot s at ring + s FA_BK LD

  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * 16 * FA_WR;
  const int group = Hq / Hkv, rows = group * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % FA_WR, wk = warp / FA_WR;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int plen = prefix_len[b], klen = min(kv_len[b], Skv);
  const int n_tiles =
      (fa_key_end(fa_positions(row0, 16 * FA_WR, rows, Sq, q_offset), plen, klen) + FA_BK - 1) /
      FA_BK;
  const int wrow0 = row0 + wr * 16;
  const int2 wpos = fa_positions(wrow0, 16, rows, Sq, q_offset);
  const int kend = fa_key_end(wpos, plen, klen);  // this warp's rows see no key past it
  const float c2 = scale * 1.4426950408889634f;  // scores to log2 units

  // load n of the sweep (K_{n/2} or V_{n/2}) into slot n % NS; every thread
  // commits a group per load, an empty one past the last
  auto issue = [&](int n) {
    if (n < 2 * n_tiles)
      fa_load_keys<DP, NT, Cfg::ROLLED>(ring + (n % NS) * FA_BK * LD, (n & 1) ? v : k,
                                        (n >> 1) * FA_BK, b, kvh, klen, Skv, Hkv, D);
    cp_async_commit();
  };
  // wait for load n, then start load n + NS - 1 into the slot load n - 1
  // used (every warp is past it after the barrier); returns load n's tile
  auto take = [&](int n) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    issue(n + NS - 1);
    return ring + (n % NS) * FA_BK * LD;
  };

  fa_load_rows<DP, NT>(qs, q, 16 * FA_WR, b, kvh, row0, rows, Sq, Hq, group, D);
  cp_async_commit();
#pragma unroll
  for (int n = 0; n < NS - 1; ++n) issue(n);

  const int a_off = (wr * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;  // A of Q

  // rows g and g + 8 of the warp: position, running max (log2 units),
  // this thread's share of the running sum, and the output columns
  // 8 nt + 2t, + 1
  int pos[2];
  float m[2] = {PG_NEG_INF, PG_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = (wrow0 + g + 8 * h) % Sq + q_offset;
  float o[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FA_BK + wk * KW;  // this warp's keys: k0 .. k0 + KW - 1
    const bool live = k0 < kend;         // warp-uniform
    uint32_t pa[KW / 16][4];             // bf16(p): the A fragments of P V

    const bf16* ks = take(2 * j) + wk * KW * LD;
    if (live) {
      // S = Q K^T for the warp's 16 rows and KW keys
      float s[KW / 8][4];
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < KW / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (np * 16 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8);
          mma_bf16_16816(s[2 * np], a, bk);
          mma_bf16_16816(s[2 * np + 1], a, bk + 2);
        }
      }

      // mask: element e of tile nt is row g + 8 (e >> 1) against key
      // k0 + 8 nt + 2t + (e & 1); bit 4 nt + e of `seen` records it
      const bool full = k0 + KW <= klen && (k0 + KW <= plen || k0 + KW - 1 <= wpos.x);
      uint32_t seen = 0xffffffffu;
      float mx[2] = {PG_NEG_INF, PG_NEG_INF};
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full) {
            const int key = k0 + nt * 8 + 2 * t + (e & 1);
            if (!(key < klen && (key < plen || key <= pos[e >> 1]))) {
              s[nt][e] = PG_NEG_INF;
              seen &= ~(1u << (4 * nt + e));
            }
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      // the new row max (log2 units) over the quad that shares each row;
      // O and l are rescaled only when a max grew somewhere in the warp
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * c2);
        alpha[h] = fa_exp2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nt = 0; nt < ND; ++nt) {
          o[nt][0] *= alpha[0];
          o[nt][1] *= alpha[0];
          o[nt][2] *= alpha[1];
          o[nt][3] *= alpha[1];
        }
      }
      // p = 2^(s c2 - m) in fp32 (summed into l), then bf16: score tiles 2kk
      // and 2kk + 1 are the A fragment of keys 16 kk .. + 15
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (seen >> (4 * nt + e)) & 1u ? fa_exp2(fmaf(s[nt][e], c2, -m[e >> 1])) : 0.f;
          l[e >> 1] += p[e];
        }
        pa[nt >> 1][(nt & 1) * 2] = pack_f32_bf16x2(p[0], p[1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32_bf16x2(p[2], p[3]);
      }
    }

    const bf16* vs = take(2 * j + 1) + wk * KW * LD;
    if (live) {
      // O += P V, with V[key][d] as B[k = key][n = d]
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
#pragma unroll
        for (int pr = 0; pr < DP / 16; ++pr) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vs + (kk * 16 + (lm & 1) * 8 + lr) * LD + pr * 16 + (lm >> 1) * 8);
          mma_bf16_16816(o[2 * pr], pa[kk], bv);
          mma_bf16_16816(o[2 * pr + 1], pa[kk], bv + 2);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // the row sums over the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (Cfg::WK > 1) {
    // key groups 1 .. WK - 1 hand m, l and O to group 0 through the ring
    // (each value to the lane that holds the same element), which adds
    // them in group order: the same bits on every call
    constexpr int PER = ND * 4 + 4;  // floats per lane
    __syncthreads();                 // every warp is done with the ring
    float* hand = reinterpret_cast<float*>(ring) + lane;
    if (wk > 0) {
      float* dst = hand + ((wk - 1) * FA_WR + wr) * PER * 32;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dst[h * 32] = m[h];
        dst[(2 + h) * 32] = l[h];
      }
#pragma unroll
      for (int nt = 0; nt < ND; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 + nt * 4 + e) * 32] = o[nt][e];
    }
    __syncthreads();
    if (wk > 0) return;
    float mx[2] = {m[0], m[1]}, f[2];
#pragma unroll
    for (int w = 1; w < Cfg::WK; ++w)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(mx[h], hand[((w - 1) * FA_WR + wr) * PER * 32 + h * 32]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f[h] = fa_exp2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= f[h];
    }
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= f[e >> 1];
#pragma unroll
    for (int w = 1; w < Cfg::WK; ++w) {
      const float* src = hand + ((w - 1) * FA_WR + wr) * PER * 32;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f[h] = fa_exp2(src[h * 32] - mx[h]);
        l[h] += src[(2 + h) * 32] * f[h];
      }
#pragma unroll
      for (int nt = 0; nt < ND; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] += src[(4 + nt * 4 + e) * 32] * f[e >> 1];
    }
  }

  // out = O / l and lse = m ln 2 + log l (0 for a row with no visible key)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + g + 8 * h;
    if (row >= rows) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    const int gi = row / Sq, i = row - gi * Sq;
    bf16* dst = out + (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + gi) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
      if (nt * 8 < D)
        *reinterpret_cast<uint32_t*>(dst + nt * 8) =
            pack_f32_bf16x2(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
    }
    // (B, Hq, Sq) row of head kvh * group + gi is folded row `row` of (b, kvh)
    if (lse != nullptr && t == 0)
      lse[((size_t)b * Hkv + kvh) * rows + row] =
          l[h] > 0.f ? m[h] * 0.6931471805599453f + logf(l[h]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The fp32 forward (header): 3xTF32 on mma.sync.m16n8k8 tiles (tf32.cuh).
// ---------------------------------------------------------------------------
#define FA32_NT 128  // threads: four warps
#define FA32_XLD 40  // row stride of the partial-score hand-over (8 mod 32)

// The block's shape at depth DP (D rounded up to 64, 72, 128 or 256): warp
// (wr, wd) owns MT 16-row tiles of row group wr (RG groups: BM = 16 MT RG
// folded rows a block) over a DS = DP / WD slice of the depth (KS = DS / 8
// k8 steps of S and n8 tiles of O). Q's fragments are split once: into
// registers at MT 1, into big / small planes in shared memory at MT 2 (two
// row tiles' would not fit the registers). BN keys a K / V tile; CS CTAs
// of a cluster share a block's rows, rank r taking the key tiles r, r + CS,
// ...; MIN_BLOCKS CTAs an SM.
template <int DP>
struct F32Cfg {
  static constexpr int WD = DP <= 72 ? 1 : DP / 64;
  static constexpr int MT = DP <= 72 ? 2 : 1;
  static constexpr int RG = 4 / WD;
  static constexpr int BM = 16 * MT * RG;
  static constexpr int DS = DP / WD;
  static constexpr int KS = DS / 8;
  static constexpr int BN = DP == 256 ? 16 : 32;
  static constexpr int CS = DP == 256 ? 2 : 1;
  static constexpr int MIN_BLOCKS = DP == 256 ? 3 : 2;
  static constexpr bool QREG = MT == 1;
  static constexpr int LD = DP + 4;  // row stride, floats: 4 mod 8, both fragment reads free
  static constexpr int XCH = WD > 1 ? WD * BM * FA32_XLD : 0;  // the hand-over, floats
  static constexpr int BYTES =
      (((QREG ? 1 : 2) * BM + 2 * BN) * LD + XCH) * (int)sizeof(float);
  static_assert(DS % 8 == 0 && WD * RG == FA32_NT / 32 && BN % 16 == 0, "shape");
  static_assert(WD == 1 || MT == 1, "the depth slices hand over one row tile's scores");
  // the cluster's hand-over (m, l and O of every thread) fits in the K / V tiles
  static_assert(CS == 1 || (4 + 4 * KS) * MT * FA32_NT <= 2 * BN * LD, "hand-over");
};

// n rows of a (B, S, H, D) fp32 tensor into a tile of stride LD, 16-byte
// cp.async chunks, zeros where ok(r) is false and past D. addr(r) is the
// element offset of row r.
template <int DP, class Ok, class Addr>
__device__ __forceinline__ void fa32_load(float* dst, const float* __restrict__ src, int n, int D,
                                          Ok ok, Addr addr) {
  constexpr int CH = DP / 4;
  for (int idx = threadIdx.x; idx < n * CH; idx += FA32_NT) {
    const int r = idx / CH, c = idx - r * CH;
    const bool on = c * 4 < D && ok(r);
    cp_async_16(dst + r * F32Cfg<DP>::LD + c * 4, on ? src + addr(r) + c * 4 : src, on);
  }
}

template <int DP>
__global__ void __launch_bounds__(FA32_NT, F32Cfg<DP>::MIN_BLOCKS)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ prefix_len,
                         const int* __restrict__ kv_len, float* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int D,
                         float scale, int q_offset) {
  using C = F32Cfg<DP>;
  constexpr int LD = C::LD, KS = C::KS, WD = C::WD, MT = C::MT, BN = C::BN, NB = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);       // [BM][LD] (MT 2: big, then small)
  float* ks = qs + (C::QREG ? 1 : 2) * C::BM * LD;  // [BN][LD]
  float* vs = ks + BN * LD;                         // [BN][LD]
  float* xch = vs + BN * LD;                        // [WD][BM][FA32_XLD] partial scores

  const int cs = C::CS, kr = cs > 1 ? cluster_rank() : 0;  // this rank's tiles: kr, kr + cs, ..
  const int b = blockIdx.z, kvh = blockIdx.y, row0 = (blockIdx.x / cs) * C::BM;
  const int group = Hq / Hkv, rows = group * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WD, wd = warp % WD, d0 = wd * C::DS;  // rows of group wr, depth d0 ..
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  // no lengths (pg_vision_attention_fp32): every key is visible
  const int plen = prefix_len ? prefix_len[b] : Skv;
  const int klen = kv_len ? min(kv_len[b], Skv) : Skv;
  const int n_tiles =
      (fa_key_end(fa_positions(row0, C::BM, rows, Sq, q_offset), plen, klen) + BN - 1) / BN;
  const int wrow0 = row0 + wr * 16 * MT;
  const int2 wpos = fa_positions(wrow0, 16 * MT, rows, Sq, q_offset);
  const int kend = fa_key_end(wpos, plen, klen);  // this warp's rows see no key past it
  const float c2 = scale * 1.4426950408889634f;  // scores to log2 units

  auto q_ok = [&](int rr) { return row0 + rr < rows; };
  auto q_addr = [&](int rr) {
    const int fr = row0 + rr, gi = fr / Sq, i = fr - gi * Sq;
    return (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + gi) * D;
  };
  // the tile of keys k0 .. k0 + BN - 1 of k or v: zeros at and past klen
  auto load_keys = [&](float* dst, const float* src, int k0) {
    fa32_load<DP>(dst, src, BN, D, [&](int j) { return k0 + j < klen; },
                  [&](int j) { return (((size_t)b * Skv + k0 + j) * Hkv + kvh) * D; });
  };

  // copy groups: (Q, K_kr), V_kr; each tile then commits the rank's next K
  // (once K_j is read) and V (once V_j is)
  if (kr < n_tiles) {
    fa32_load<DP>(qs, q, C::BM, D, q_ok, q_addr);
    load_keys(ks, k, kr * BN);
  }
  cp_async_commit();
  if (kr < n_tiles) load_keys(vs, v, kr * BN);
  cp_async_commit();

  // rows g and g + 8 of row tile mt: position, running max (log2 units),
  // this thread's share of the running sum, and O's columns d0 + 8 nd + 2t, + 1
  int pos[MT][2];
  float m[MT][2], l[MT][2], o[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pos[mt][h] = (wrow0 + 16 * mt + g + 8 * h) % Sq + q_offset;
      m[mt][h] = PG_NEG_INF;
      l[mt][h] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) o[mt][nd][0] = o[mt][nd][1] = o[mt][nd][2] = o[mt][nd][3] = 0.f;
  // MT 1: Q's A fragments over the slice, big and small, in registers
  uint32_t qb[C::QREG ? KS : 1][4], qm[C::QREG ? KS : 1][4];
  // A fragment rows lr + 8 (lm & 1), columns 4 (lm >> 1) of the warp's first row tile
  const int qa = (wr * 16 * MT + lr + 8 * (lm & 1)) * LD + d0 + 4 * (lm >> 1);

  for (int j = kr; j < n_tiles; j += cs) {
    const int k0 = j * BN;
    const bool live = k0 < kend;  // warp-uniform
    cp_async_wait<1>();           // K_j (and Q) have landed
    __syncthreads();
    if (j == kr) {  // Q, split once
      if constexpr (C::QREG) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t r[4];
          ldsm_x4_f32(r, qs + qa + 8 * kk);
          split_tf32<4>(r, qb[kk], qm[kk]);
        }
      } else {  // into the big plane (in place) and the small one
        for (int idx = threadIdx.x; idx < C::BM * DP; idx += FA32_NT) {
          const int r = idx / DP, c = idx - r * DP;
          uint32_t bg, sm;
          split_tf32(qs[r * LD + c], bg, sm);
          qs[r * LD + c] = __uint_as_float(bg);
          qs[(C::BM + r) * LD + c] = __uint_as_float(sm);
        }
        __syncthreads();
      }
    }
    // S = Q K^T over the warp's slice: K's B fragments (key lr of n8 tile
    // 2 np + (lm >> 1), column 4 (lm & 1) of the k8 step) by ldmatrix, split
    // once for the warp's row tiles
    float s[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
    if (live) {
      const float* kb = ks + (8 * (lm >> 1) + lr) * LD + d0 + 4 * (lm & 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[MT][4], am[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (C::QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) ab[mt][i] = qb[kk][i], am[mt][i] = qm[kk][i];
          } else {
            ldsm_x4_f32(ab[mt], qs + qa + 16 * mt * LD + 8 * kk);
            ldsm_x4_f32(am[mt], qs + C::BM * LD + qa + 16 * mt * LD + 8 * kk);
          }
        }
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          uint32_t r[4], bb[4], bs[4];
          ldsm_x4_f32(r, kb + 16 * np * LD + 8 * kk);
          split_tf32<4>(r, bb, bs);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_3xtf32(s[mt][2 * np], ab[mt], am[mt], bb, bs);
            mma_3xtf32(s[mt][2 * np + 1], ab[mt], am[mt], bb + 2, bs + 2);
          }
        }
      }
    }
    // the depth slices' partial scores through shared memory, summed by
    // every warp of the row group in slice order (the same bits in each)
    const int xat = (wr * 16 + g) * FA32_XLD + 2 * t;
    if constexpr (WD > 1) {
      if (live) {
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(xch + wd * C::BM * FA32_XLD + xat + 8 * h * FA32_XLD +
                                       8 * nt) = make_float2(s[0][nt][2 * h], s[0][nt][2 * h + 1]);
      }
    }
    __syncthreads();  // every warp is done with K_j; the partial scores are visible
    if (j + cs < n_tiles) load_keys(ks, k, k0 + cs * BN);
    cp_async_commit();

    uint32_t pb[MT][NB][4], pm[MT][NB][4];  // P's A fragments (keys 8 kk ..): big, small
    if (live) {
      if constexpr (WD > 1) {
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int w = 0; w < WD; ++w) {
              const float2 p = *reinterpret_cast<const float2*>(
                  xch + w * C::BM * FA32_XLD + xat + 8 * h * FA32_XLD + 8 * nt);
              acc.x += p.x;
              acc.y += p.y;
            }
            s[0][nt][2 * h] = acc.x;
            s[0][nt][2 * h + 1] = acc.y;
          }
      }
      // mask (element e of tile nt: row g + 8 (e >> 1) of the row tile, key
      // k0 + 8 nt + 2t + (e & 1)), the new row max over the quad sharing the row
      const bool full = k0 + BN <= klen && (k0 + BN <= plen || k0 + BN - 1 <= wpos.x);
      uint32_t seen[MT];
      float alpha[MT][2];
      bool grew = false;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        seen[mt] = 0xffffffffu;
        float mx[2] = {PG_NEG_INF, PG_NEG_INF};
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!full) {
              const int key = k0 + 8 * nt + 2 * t + (e & 1);
              if (!(key < klen && (key < plen || key <= pos[mt][e >> 1]))) {
                seen[mt] &= ~(1u << (4 * nt + e));
                continue;
              }
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][nt][e] * c2);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[mt][h], mx[h]);
          alpha[mt][h] = fa_exp2(m[mt][h] - m_new);
          m[mt][h] = m_new;
          l[mt][h] *= alpha[mt][h];
          grew |= alpha[mt][h] != 1.f;
        }
      }
      if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nd = 0; nd < KS; ++nd) {
            o[mt][nd][0] *= alpha[mt][0];
            o[mt][nd][1] *= alpha[mt][0];
            o[mt][nd][2] *= alpha[mt][1];
            o[mt][nd][3] *= alpha[mt][1];
          }
      }
      // p = 2^(s c2 - m) (0 for a masked key), summed into l; score tile kk
      // is the A fragment of keys 8 kk .. + 7 with the step's depth index t
      // standing for key 2t and t + 4 for key 2t + 1 (V's B fragments below
      // read the same keys): a[0..3] = p of (g, 2t), (g + 8, 2t), (g, 2t + 1),
      // (g + 8, 2t + 1)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = (seen[mt] >> (4 * nt + e)) & 1u
                       ? fa_exp2(fmaf(s[mt][nt][e], c2, -m[mt][e >> 1]))
                       : 0.f;
            l[mt][e >> 1] += p[e];
          }
          split_tf32(p[0], pb[mt][nt][0], pm[mt][nt][0]);
          split_tf32(p[2], pb[mt][nt][1], pm[mt][nt][1]);
          split_tf32(p[1], pb[mt][nt][2], pm[mt][nt][2]);
          split_tf32(p[3], pb[mt][nt][3], pm[mt][nt][3]);
        }
    }

    cp_async_wait<1>();  // V_j has landed
    __syncthreads();
    if (live) {
      // O += P V over the slice: b[0] = V[8 kk + 2t][col], b[1] = V[8 kk + 2t + 1][col]
      // at col = d0 + 8 nd + g (rows 2t apart: free of bank conflicts), split
      // once for the warp's row tiles
      const float* vb = vs + (2 * t) * LD + d0 + g;
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        if (k0 + 8 * kk >= kend) break;
#pragma unroll
        for (int nd = 0; nd < KS; ++nd) {
          uint32_t bb[2], bs[2];
          split_tf32(vb[8 * kk * LD + 8 * nd], bb[0], bs[0]);
          split_tf32(vb[(8 * kk + 1) * LD + 8 * nd], bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(o[mt][nd], pb[mt][kk], pm[mt][kk], bb, bs);
        }
      }
    }
    __syncthreads();  // every warp is done with V_j (and the hand-over)
    if (j + cs < n_tiles) load_keys(vs, v, k0 + cs * BN);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
    }

  // the cluster's (m, l, O): each rank's through its shared memory (each
  // value to the thread that holds the same element), combined by rank 0
  // in rank order
  if constexpr (C::CS > 1) {
    constexpr int PER = 4 + 4 * KS;  // floats a row tile and thread
    float* mine = ks + threadIdx.x;
    __syncthreads();  // every warp is done with the tiles
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float* at = mine + mt * PER * FA32_NT;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        at[h * FA32_NT] = m[mt][h];
        at[(2 + h) * FA32_NT] = l[mt][h];
      }
#pragma unroll
      for (int nd = 0; nd < KS; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) at[(4 + 4 * nd + e) * FA32_NT] = o[mt][nd][e];
    }
    cluster_sync_all();
    if (kr == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* at = mine + mt * PER * FA32_NT;
        float mx[2] = {m[mt][0], m[mt][1]}, f[2];
        for (int r = 1; r < cs; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], ld_cluster_f32(at + h * FA32_NT, r));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          f[h] = fa_exp2(m[mt][h] - mx[h]);
          m[mt][h] = mx[h];
          l[mt][h] *= f[h];
        }
#pragma unroll
        for (int nd = 0; nd < KS; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][nd][e] *= f[e >> 1];
        for (int r = 1; r < cs; ++r) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            f[h] = fa_exp2(ld_cluster_f32(at + h * FA32_NT, r) - mx[h]);
            l[mt][h] += ld_cluster_f32(at + (2 + h) * FA32_NT, r) * f[h];
          }
#pragma unroll
          for (int nd = 0; nd < KS; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[mt][nd][e] += ld_cluster_f32(at + (4 + 4 * nd + e) * FA32_NT, r) * f[e >> 1];
        }
      }
    }
    cluster_sync_all();  // rank 0 has read every rank's values
    if (kr != 0) return;
  }

  // out = O / l and lse = m ln 2 + log l (0 for a row with no visible key)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow0 + 16 * mt + g + 8 * h;
      if (row >= rows) continue;
      const float inv = l[mt][h] > 0.f ? 1.f / l[mt][h] : 0.f;
      const int gi = row / Sq, i = row - gi * Sq;
      float* dst =
          out + (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + gi) * D + d0 + 2 * t;
#pragma unroll
      for (int nd = 0; nd < KS; ++nd) {
        if (d0 + 8 * nd < D)
          *reinterpret_cast<float2*>(dst + 8 * nd) =
              make_float2(o[mt][nd][2 * h] * inv, o[mt][nd][2 * h + 1] * inv);
      }
      if (lse != nullptr && wd == 0 && t == 0)
        lse[((size_t)b * Hkv + kvh) * rows + row] =
            l[mt][h] > 0.f ? m[mt][h] * 0.6931471805599453f + logf(l[mt][h]) : 0.f;
    }
}

template <int DP>
static int launch_fwd_f32(const void* q, const void* k, const void* v, const void* prefix_len,
                          const void* kv_len, void* out, void* lse, int B, int Sq, int Skv,
                          int Hq, int Hkv, int D, float scale, int q_offset, cudaStream_t st) {
  constexpr int bytes = F32Cfg<DP>::BYTES;
  // dynamic shared memory above 48 KB, allowed once per process
  static const int attr = (int)cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != 0) return attr;
  const int rows = (Hq / Hkv) * Sq, cs = F32Cfg<DP>::CS;
  dim3 grid((rows + F32Cfg<DP>::BM - 1) / F32Cfg<DP>::BM * cs, Hkv, B);
  return cluster_launch(flash_fwd_f32_kernel<DP>, grid, FA32_NT, cs, bytes, st, (const float*)q,
                        (const float*)k, (const float*)v, (const int*)prefix_len,
                        (const int*)kv_len, (float*)out, (float*)lse, Sq, Skv, Hq, Hkv, D, scale,
                        q_offset);
}

template <int DP>
static int launch_fwd(const void* q, const void* k, const void* v, const void* prefix_len,
                      const void* kv_len, void* out, void* lse, int B, int Sq, int Skv, int Hq,
                      int Hkv, int D, float scale, int q_offset, cudaStream_t st) {
  constexpr int bytes = FwdCfg<DP>::BYTES;
  // dynamic shared memory above 48 KB, allowed once per process
  static const int attr = (int)cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != 0) return attr;
  const int rows = (Hq / Hkv) * Sq;
  dim3 grid((rows + 16 * FA_WR - 1) / (16 * FA_WR), Hkv, B);
  flash_fwd_kernel<DP><<<grid, FwdCfg<DP>::NW * 32, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)prefix_len,
      (const int*)kv_len, (bf16*)out, (float*)lse, Sq, Skv, Hq, Hkv, D, scale, q_offset);
  return (int)cudaGetLastError();
}

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) bf16, contiguous, 16-byte
// aligned, D % 8 == 0 and D <= 256 (the wrapper checks these).
PG_EXPORT int pg_flash_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* prefix_len, const void* kv_len, void* out,
                                     void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                     float scale, int q_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_fwd<64>(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D, scale,
                          q_offset, st);
  if (D <= 80)
    return launch_fwd<80>(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D, scale,
                          q_offset, st);
  return launch_fwd<256>(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D, scale,
                         q_offset, st);
}

// The fp32 form at depth D rounded up to 64, 72, 128 or 256 (F32Cfg).
static int launch_fwd_f32_at(const void* q, const void* k, const void* v, const void* prefix_len,
                             const void* kv_len, void* out, void* lse, int B, int Sq, int Skv,
                             int Hq, int Hkv, int D, float scale, int q_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_fwd_f32<64>(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D,
                              scale, q_offset, st);
  if (D <= 72)
    return launch_fwd_f32<72>(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D,
                              scale, q_offset, st);
  if (D <= 128)
    return launch_fwd_f32<128>(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D,
                               scale, q_offset, st);
  return launch_fwd_f32<256>(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D,
                             scale, q_offset, st);
}

// The fp32 form: q, k, v and out fp32 (16-byte aligned, D % 8 == 0, D <=
// 256), the rest as pg_flash_attention_fwd.
PG_EXPORT int pg_flash_attention_fwd_fp32(const void* q, const void* k, const void* v,
                                          const void* prefix_len, const void* kv_len, void* out,
                                          void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                                          int D, float scale, int q_offset, void* stream) {
  return launch_fwd_f32_at(q, k, v, prefix_len, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, D, scale,
                           q_offset, stream);
}

// B12's fp32 form (kernels/ablation/vision_attention.py on fp32 tensors):
// o = softmax(scale q k^T) v over all S keys of each head, i.e. this fp32
// forward with every key visible (no lengths: prefix = kv_len = S), q_offset
// 0, Hq = Hkv = H and no lse. q, k, v, out (B, S, H, D) fp32, contiguous,
// 16-byte aligned, D % 8 == 0 and D <= 256.
PG_EXPORT int pg_vision_attention_fp32(const void* q, const void* k, const void* v, void* out,
                                       int B, int S, int H, int D, float scale, void* stream) {
  return launch_fwd_f32_at(q, k, v, nullptr, nullptr, out, nullptr, B, S, S, H, H, D, scale, 0,
                           stream);
}
