// Prefix-LM flash attention, backward (FlashAttention-2) on the tensor cores.
//
// Replaces paligemma_tpu/kernels/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (via _flash_backward, under the custom VJP _flash). Same
// mask as the forward (csrc/flash_attention.cu): key j is visible to query i
// of batch b iff  j < kv_len[b]  and  (j < prefix_len[b]  or  j <= i + q_offset).
// Query heads sharing a KV head are folded into rows (row = g * Sq + i), as
// in the forward and the TPU kernels. Inputs: q, k, v, dO (bf16), the
// forward's lse and delta = rowsum(dO * O) (fp32, (B, Hq, Sq), i.e.
// (B, Hkv, rows)). Per visible (row, key) pair:
//
//   p  = exp(scale * q.k - lse)          ds = p * (dO.v - delta)      (fp32)
//   dq = scale * sum_j bf16(ds) k_j      dk = scale * sum_i bf16(ds) q_i
//   dv = sum_i bf16(p) dO_i                                 (fp32 sums)
//
// p and ds are rounded to bf16 before their products, where the TPU kernels
// round them; dq, dk and dv are rounded to bf16 once, at the end. A masked
// pair, a padded row and a row with no visible key get p = ds = 0 by a
// select (never by exp(-inf)), so they contribute exactly 0.
//
// What bounds it: at the training shape (B = 2, S = 512, Hq = 8, Hkv = 1,
// D = 256, prefix 268, kv_len 512 / 400) the visible (head, row, key)
// triples number 2.62 M. dq does 6 D flops per triple (4.0 GFLOP: 4.1 us at
// 989 TFLOP/s, about the time of its 13.7 MB at 3.35 TB/s), dk/dv 8 D (5.4
// GFLOP, 5.4 us), so the tensor cores bound both. All five products (S, dP,
// dQ, dK, dV) run on mma.sync.m16n8k16 (bf16 in, fp32 accumulators), their
// operands staged in shared memory by cp.async and read by ldmatrix
// (common.cuh).
//
// * flash_bwd_dq_kernel: a block of 8 warps owns 64 folded rows of one
//   (batch, KV head): 128 blocks at the training shape, one wave on 132
//   SMs. Its Q and dO tiles stay in shared memory; 64-key K / V tiles stream
//   through a two-stage cp.async ring up to the last key any of its rows
//   sees. Warp (wg, wr) owns rows 16 wr .. + 15 and keys 32 wg .. + 31 of each
//   tile: S = Q K^T and dP = dO V^T land in C fragments, p and ds are
//   computed in registers, and the C fragments of bf16(ds) are the A
//   fragments of dQ += dS K (no trip through shared memory), with K read by
//   ldmatrix.trans. dQ's 16 x D fp32 accumulator is D / 2 registers a
//   thread; at the end warp group 1 hands its accumulators to group 0
//   through shared memory, which adds them (the key split puts 8 warps on
//   each SM where 64 rows of 4 warps would leave 4).
// * flash_bwd_dkv_kernel: a block of 8 warps owns 64 keys of one (batch,
//   KV head) and one range of 64-row tiles (a split). K and V stay
//   resident; the tiles of Q, dO, lse and delta stream through the ring,
//   skipping tiles that see none of the block's keys. Warp (kg, h) computes
//   S^T = K Q^T and dP^T = V dO^T for keys 16 kg .. + 15 against rows
//   32 h .. + 31 of the tile, stores bf16 P^T and dS^T in shared memory,
//   and after a barrier accumulates dV += P^T dO and dK += dS^T Q for keys
//   16 kg .. + 15 and half h of D's columns: the two fp32 accumulators cost
//   D / 2 registers a thread, as in dq. Each split writes fp32 partials
//   (B, Hkv, Skv, D) to device memory; flash_bwd_dkv_sum adds them in split
//   order (the same bits on every call, no atomics), scales dk and rounds
//   both to bf16. The wrapper takes the fewest splits that give every SM
//   one block (8 at the training shape: 128 blocks, 8 x 2.1 MB of partials).
//
// Every head_dim that is a multiple of 8 up to 256 runs: the depth of S and
// dP is D rounded up to 16 with zero columns (SigLIP's 72 -> 80), and the
// n8 tiles over D need no padding. The kernels are compiled for D <= 128 and
// D <= 256 (the accumulators' size). Tile rows are padded by 16 bytes, so
// ldmatrix is free of bank conflicts. Shared memory is dynamic: 198 KB (dq)
// and 217 KB (dk/dv) at D <= 256, one block per SM. wgmma and TMA (FA3's
// warp-specialised backward) are later work.
//
// The fp32 forms (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel; the
// Trainer on fp32 parameters): the same function, mask, sweep bounds and
// fixed-order split sum with fp32 q, k, v, dO, dq, dk and dv, and p and ds
// not rounded (the TPU kernels' casts to the input dtype are the identity at
// fp32). Every product runs on the tensor cores in 3xTF32
// (mma.sync.m16n8k8 tf32 with fp32 accumulators; tf32.cuh, shared with the
// fp32 forward): each fp32 operand x is
// split in registers as big = tf32(x) and small = tf32(x - big), both
// rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away), and a k8 step
// sums small.big, big.small and big.big in that order (CUTLASS's "fast
// fp32" scheme; the dropped small.small term is below 2^-22 of each
// product) on the tensor core from zero, then adds that to the running
// fp32 sum (the tensor core's own sum truncates; carried over the depth its
// error grows with the sum). Operands are fp32
// tiles in shared memory (Bwd32: a row stride of 8 mod 32 floats with
// 16-byte chunks swapped on rows with bit 2 set, so that the A-pattern
// reads by ldmatrix and the B reads along keys or rows are both free of
// bank conflicts; zeros past D, past kv_len and past the rows); p comes
// from exp2 in log2 units.
// * dq: a cluster of cs CTAs of 16 warps owns 64 folded rows (cs the most of 1,
//   2 and 4 that keeps the CTAs in one wave: 1 at the training shape, 2 at a TP
//   rank's Hq4; 8 warps and 32 rows where even so they would fill at most half
//   the SMs), each CTA a cs-th of the key tiles its rows see; ranks 1 .. cs - 1
//   hand their dQ to rank 0 through distributed shared memory, which adds them
//   in rank order. Q and dO stay in shared memory, one 32-key K tile and one V
//   tile stream (V_{j+1} loads during S_j and dQ += dS K_j, K_{j+1} during
//   dP_{j+1}). Warp (wr, wk, dh) computes dP = dO V^T and S = Q K^T for rows 16
//   wr .. + 15 and keys 16 wk .. + 15 of each tile over half dh of the depth;
//   the two halves trade sums through shared memory, each forms dS of one n8
//   tile of keys into shared memory; then warp (wr, cq) accumulates dQ += dS K
//   for its rows and the n8 tiles cq, cq + 4, .. of D (32 fp32 accumulators a
//   thread at DP 256, within 512 threads' 128 registers). 225 KB of shared
//   memory at DP 256 (146 KB at 32 rows).
// * dk/dv: a block owns 32 keys and one row split; K and V stay resident,
//   32-row tiles of Q, dO, lse and delta stream through a two-stage ring,
//   tiles that see none of the block's keys skipped. Warp (kg, rg, dh)
//   computes S^T = K Q^T and dP^T = V dO^T for keys 16 kg .. and rows 16 rg
//   .. over half dh of the depth; the two halves trade sums through shared
//   memory, each adds them for one n8 tile of rows, forms p and ds and
//   stores P^T and dS^T; then warp (kg, cq) accumulates dV += P^T dO and
//   dK += dS^T Q for keys 16 kg .. and the n8 tiles cq, cq + 4, .. of D
//   (8 fp32 accumulators a thread per n8 tile: 64 at DP 256). The
//   split partials are summed by flash_bwd_dkv_sum<float>.
// What bounds them: at the training shape the operations at 3xTF32
// (three tf32 products per fp32 product: 495 / 3 = 165 TFLOP/s; dq 4.0
// GFLOP, 24 us; dk/dv 5.4 GFLOP, 33 us). Splitting the operands in
// registers costs four instructions per 32-bit element beside the mma
// instructions, and mma.sync reaches only part of Hopper's tensor-core
// rate (wgmma is later work).
#include "tf32.cuh"

#define BW_M 64            // folded rows of a dq block; rows of a streamed dk/dv tile
#define BW_N 64            // keys of a streamed K / V tile of the dq block; of a dk/dv block
#define BW_NQ 32           // keys of a dq warp's half of the K / V tile
#define BW_PLD (BW_M + 8)  // bf16 row stride of the P^T / dS^T tiles

template <int DMAX>
struct BwdSmem {
  static constexpr int LD = DMAX + 8;  // bf16 row stride of the Q / dO / K / V tiles
  // dq: Q, dO, then two stages of (K, V); the ring then holds the dQ hand-off
  static constexpr int DQ_BYTES = (2 * BW_M + 4 * BW_N) * LD * (int)sizeof(bf16);
  static_assert(BW_M * DMAX * sizeof(float) <= 4 * BW_N * LD * sizeof(bf16), "dQ hand-off");
  // dk/dv: K, V, two stages of (Q, dO), P^T, dS^T, two stages of (lse, delta)
  static constexpr int DKV_BYTES = (2 * BW_N + 4 * BW_M) * LD * (int)sizeof(bf16) +
                                   2 * BW_N * BW_PLD * (int)sizeof(bf16) +
                                   4 * BW_M * (int)sizeof(float);
};

// Folded rows row0 .. row0+n-1 of a (B, Sq, Hq, D) tensor into a tile of
// stride DMAX + 8, columns [0, DP): one 16-byte cp.async per chunk, zeros
// past `rows` and past D.
template <int DMAX, int NT>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* __restrict__ src, int n, int b,
                                        int kvh, int row0, int rows, int Sq, int Hq, int group,
                                        int D, int DP) {
  constexpr int CH = DMAX / 8;
  for (int idx = threadIdx.x; idx < n * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    if (c * 8 >= DP) continue;
    const bool ok = row < rows && c * 8 < D;
    const bf16* p = src;
    if (ok) {
      const int g = row / Sq, i = row - g * Sq;
      p = src + (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + g) * D + c * 8;
    }
    cp_async_16(dst + r * (DMAX + 8) + c * 8, p, ok);
  }
}

// Keys k0 .. k0+n-1 of a (B, Skv, Hkv, D) tensor, as cp_rows: zeros at and
// past klen (so a masked key's 0 weight never meets a stale value) and past D.
template <int DMAX, int NT>
__device__ __forceinline__ void cp_keys(bf16* dst, const bf16* __restrict__ src, int n, int b,
                                        int kvh, int k0, int klen, int Skv, int Hkv, int D,
                                        int DP) {
  constexpr int CH = DMAX / 8;
  for (int idx = threadIdx.x; idx < n * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, key = k0 + r;
    if (c * 8 >= DP) continue;
    const bool ok = key < klen && c * 8 < D;
    const bf16* p = ok ? src + (((size_t)b * Skv + key) * Hkv + kvh) * D + c * 8 : src;
    cp_async_16(dst + r * (DMAX + 8) + c * 8, p, ok);
  }
}

// One past the last key any folded row of the n-row tile at row0 sees.
__device__ __forceinline__ int tile_key_end(int row0, int n, int rows, int Sq, int q_offset,
                                            int plen, int klen) {
  const int last = min(row0 + n, rows) - 1;
  if (last < row0) return 0;
  const int max_i = (row0 / Sq == last / Sq) ? last - (last / Sq) * Sq : Sq - 1;
  return min(klen, max(plen, max_i + q_offset + 1));
}

template <int DMAX>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ prefix_len, const int* __restrict__ kv_len,
                        bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
                        float scale, int q_offset) {
  constexpr int LD = BwdSmem<DMAX>::LD, NT = DMAX / 8;  // NT: n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BW_M * LD;
  bf16* kvs = dos + BW_M * LD;  // stage s: K at kvs + 2 s BW_N LD, V after it

  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * BW_M;
  const int group = Hq / Hkv, rows = group * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3, wg = warp >> 2;  // rows 16 wr .., keys 32 wg .. of each tile
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int DP = (D + 15) & ~15;
  const int plen = prefix_len[b], klen = min(kv_len[b], Skv);
  const int kend = tile_key_end(row0, BW_M, rows, Sq, q_offset, plen, klen);
  const int n_kt = (kend + BW_N - 1) / BW_N;

  if (n_kt > 0) {
    cp_rows<DMAX, 256>(qs, q, BW_M, b, kvh, row0, rows, Sq, Hq, group, D, DP);
    cp_rows<DMAX, 256>(dos, dout, BW_M, b, kvh, row0, rows, Sq, Hq, group, D, DP);
    cp_keys<DMAX, 256>(kvs, k, BW_N, b, kvh, 0, klen, Skv, Hkv, D, DP);
    cp_keys<DMAX, 256>(kvs + BW_N * LD, v, BW_N, b, kvh, 0, klen, Skv, Hkv, D, DP);
    cp_async_commit();
  }

  // this thread's rows of the warp's 16: g and g + 8
  bool rok[2];
  int pos[2];
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wr * 16 + g + 8 * h;
    const size_t stat = ((size_t)b * Hkv + kvh) * rows + row;
    rok[h] = row < rows;
    pos[h] = row % Sq + q_offset;
    lse_r[h] = rok[h] ? lse[stat] : 0.f;
    dl_r[h] = rok[h] ? delta[stat] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int a_off = (wr * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;  // A of Q, dO
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is visible to all; tile kt - 1's stage is no longer read
    if (kt + 1 < n_kt) {
      bf16* nxt = kvs + ((kt + 1) & 1) * 2 * BW_N * LD;
      const int k1 = (kt + 1) * BW_N;
      cp_keys<DMAX, 256>(nxt, k, BW_N, b, kvh, k1, klen, Skv, Hkv, D, DP);
      cp_keys<DMAX, 256>(nxt + BW_N * LD, v, BW_N, b, kvh, k1, klen, Skv, Hkv, D, DP);
      cp_async_commit();
    }
    const int k0 = kt * BW_N + wg * BW_NQ;
    if (k0 >= kend) continue;  // warp-uniform: this warp's keys are past every row's last
    const bf16* ks = kvs + (kt & 1) * 2 * BW_N * LD + wg * BW_NQ * LD;
    const bf16* vs = ks + BW_N * LD;

    // S and dP of the warp's 16 rows against the tile's 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < DP) {
        uint32_t a_q[4], a_o[4];
        ldsm_x4(a_q, qs + a_off + kk * 16);
        ldsm_x4(a_o, dos + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = (np * 16 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8;
          uint32_t b_k[4], b_v[4];
          ldsm_x4(b_k, ks + off);
          ldsm_x4(b_v, vs + off);
          mma_bf16_16816(s[2 * np], a_q, b_k);
          mma_bf16_16816(s[2 * np + 1], a_q, b_k + 2);
          mma_bf16_16816(dp[2 * np], a_o, b_v);
          mma_bf16_16816(dp[2 * np + 1], a_o, b_v + 2);
        }
      }
    }

    // p and ds of rows g, g + 8 against keys k0 + 8 nt + 2t (+ 1); the C
    // fragments of key tiles 2 kk and 2 kk + 1 are the A fragment of keys
    // 16 kk .. + 15
    uint32_t a_ds[2][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = rok[h] && key < klen && (key < plen || key <= pos[h]);
        ds[e] = ok ? __expf(s[nt][e] * scale - lse_r[h]) * (dp[nt][e] - dl_r[h]) : 0.f;
      }
      a_ds[nt >> 1][(nt & 1) * 2] = pack_f32_bf16x2(ds[0], ds[1]);
      a_ds[nt >> 1][(nt & 1) * 2 + 1] = pack_f32_bf16x2(ds[2], ds[3]);
    }

    // dQ += dS K, with K[key][d] as B[k = key][n = d]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int pr = 0; pr < DMAX / 16; ++pr) {
        if (pr * 16 < DP) {
          uint32_t b_k[4];
          ldsm_x4_trans(b_k, ks + (kk * 16 + (lm & 1) * 8 + lr) * LD + pr * 16 + (lm >> 1) * 8);
          mma_bf16_16816(acc[2 * pr], a_ds[kk], b_k);
          mma_bf16_16816(acc[2 * pr + 1], a_ds[kk], b_k + 2);
        }
      }
    }
  }

  // warp group 1's dQ to group 0 through the ring (each value to the lane
  // that holds the same element), then group 0 adds it and stores
  __syncthreads();  // every warp is done with the ring
  float* hand = reinterpret_cast<float*>(kvs) + wr * NT * 4 * 32 + lane;
  if (wg == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hand[(nt * 4 + e) * 32] = acc[nt][e];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += hand[(nt * 4 + e) * 32];

  // dq of rows g and g + 8: columns 8 nt + 2t, + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    const int row = row0 + wr * 16 + g + 8 * h, gi = row / Sq, i = row - gi * Sq;
    bf16* dst = dq + (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + gi) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * 8 < D)
        *reinterpret_cast<uint32_t*>(dst + nt * 8) =
            pack_f32_bf16x2(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ prefix_len, const int* __restrict__ kv_len,
                         float* __restrict__ part_dk, float* __restrict__ part_dv, int Sq,
                         int Skv, int Hq, int Hkv, int D, float scale, int q_offset,
                         int tiles_per_split) {
  constexpr int LD = BwdSmem<DMAX>::LD, NH = DMAX / 16;  // NH: n8 tiles of half of D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BW_N * LD;
  bf16* qd = vs + BW_N * LD;       // stage s: Q at qd + 2 s BW_M LD, dO after it
  bf16* pts = qd + 4 * BW_M * LD;  // P^T (BW_N keys x BW_M rows)
  bf16* dsts = pts + BW_N * BW_PLD;  // dS^T
  float* stats = reinterpret_cast<float*>(dsts + BW_N * BW_PLD);  // stage s: lse, then delta

  const int nkt = (Skv + BW_N - 1) / BW_N;
  const int kt = blockIdx.x % nkt, split = blockIdx.x / nkt;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = kt * BW_N;
  const int group = Hq / Hkv, rows = group * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int kg = warp & 3, hh = warp >> 2;
  const int DP = (D + 15) & ~15;
  const int plen = prefix_len[b], klen = min(kv_len[b], Skv);
  const int t_end = min((rows + BW_M - 1) / BW_M, (split + 1) * tiles_per_split);
  const size_t stat0 = ((size_t)b * Hkv + kvh) * rows;

  // the first row tile at or after tt that sees a key of this block (t_end: none)
  auto next_tile = [&](int tt) {
    while (tt < t_end && tile_key_end(tt * BW_M, BW_M, rows, Sq, q_offset, plen, klen) <= k0)
      ++tt;
    return tt;
  };
  auto load_tile = [&](int tt, int st) {
    bf16* qst = qd + st * 2 * BW_M * LD;
    cp_rows<DMAX, 256>(qst, q, BW_M, b, kvh, tt * BW_M, rows, Sq, Hq, group, D, DP);
    cp_rows<DMAX, 256>(qst + BW_M * LD, dout, BW_M, b, kvh, tt * BW_M, rows, Sq, Hq, group, D,
                       DP);
    if (threadIdx.x < 2 * BW_M) {  // lse by threads 0-63, delta by 64-127
      const int row = tt * BW_M + (threadIdx.x & (BW_M - 1));
      const float* src = threadIdx.x < BW_M ? lse : delta;
      cp_async_4(stats + st * 2 * BW_M + threadIdx.x, row < rows ? src + stat0 + row : src,
                 row < rows);
    }
  };

  float acc_dv[NH][4], acc_dk[NH][4];
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[nt][e] = acc_dk[nt][e] = 0.f;

  int tt = k0 < klen ? next_tile(split * tiles_per_split) : t_end;
  if (tt < t_end) {
    cp_keys<DMAX, 256>(ks, k, BW_N, b, kvh, k0, klen, Skv, Hkv, D, DP);
    cp_keys<DMAX, 256>(vs, v, BW_N, b, kvh, k0, klen, Skv, Hkv, D, DP);
    load_tile(tt, 0);
    cp_async_commit();
  }
  const int a_off = (kg * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;  // A of K, V
  const int pa_off = (kg * 16 + (lm & 1) * 8 + lr) * BW_PLD + (lm >> 1) * 8;  // A of P^T, dS^T
  for (int it = 0; tt < t_end; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile tt is visible to all; the previous tile's stage, P^T and dS^T are free
    const int tn = next_tile(tt + 1);
    if (tn < t_end) {
      load_tile(tn, st ^ 1);
      cp_async_commit();
    }
    const bf16* qst = qd + st * 2 * BW_M * LD;
    const bf16* dost = qst + BW_M * LD;
    const float* lse_s = stats + st * 2 * BW_M;
    const int row0 = tt * BW_M;

    // S^T and dP^T of keys 16 kg .. + 15 against rows 32 hh .. + 31
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < DP) {
        uint32_t a_k[4], a_v[4];
        ldsm_x4(a_k, ks + a_off + kk * 16);
        ldsm_x4(a_v, vs + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = (hh * 32 + np * 16 + (lm >> 1) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8;
          uint32_t b_q[4], b_o[4];
          ldsm_x4(b_q, qst + off);
          ldsm_x4(b_o, dost + off);
          mma_bf16_16816(s[2 * np], a_k, b_q);
          mma_bf16_16816(s[2 * np + 1], a_k, b_q + 2);
          mma_bf16_16816(dp[2 * np], a_v, b_o);
          mma_bf16_16816(dp[2 * np + 1], a_v, b_o + 2);
        }
      }
    }

    // bf16 P^T and dS^T into shared memory: element e of tile nt is key
    // 16 kg + g + 8 (e >> 1) against row 32 hh + 8 nt + 2t + (e & 1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = hh * 32 + nt * 8 + 2 * t + c, row = row0 + r;
        const bool rok = row < rows;
        const int pos = row % Sq + q_offset;
        const float l = lse_s[r], dl = lse_s[BW_M + r];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = k0 + kg * 16 + g + 8 * h, e = 2 * h + c;
          const bool ok = rok && key < klen && (key < plen || key <= pos);
          p[e] = ok ? __expf(s[nt][e] * scale - l) : 0.f;
          ds[e] = ok ? p[e] * (dp[nt][e] - dl) : 0.f;
        }
      }
      const int at = (kg * 16 + g) * BW_PLD + hh * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(pts + at) = pack_f32_bf16x2(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(pts + at + 8 * BW_PLD) = pack_f32_bf16x2(p[2], p[3]);
      *reinterpret_cast<uint32_t*>(dsts + at) = pack_f32_bf16x2(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(dsts + at + 8 * BW_PLD) = pack_f32_bf16x2(ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's 64 rows, for the columns
    // of half hh of D (dO[row][d] and Q[row][d] as B[k = row][n = d])
#pragma unroll
    for (int kk = 0; kk < BW_M / 16; ++kk) {
      uint32_t a_p[4], a_s[4];
      ldsm_x4(a_p, pts + pa_off + kk * 16);
      ldsm_x4(a_s, dsts + pa_off + kk * 16);
#pragma unroll
      for (int pr = 0; pr < NH / 2; ++pr) {
        const int c0 = hh * (DMAX / 2) + pr * 16;
        if (c0 < DP) {
          const int off = (kk * 16 + (lm & 1) * 8 + lr) * LD + c0 + (lm >> 1) * 8;
          uint32_t b_o[4], b_q[4];
          ldsm_x4_trans(b_o, dost + off);
          ldsm_x4_trans(b_q, qst + off);
          mma_bf16_16816(acc_dv[2 * pr], a_p, b_o);
          mma_bf16_16816(acc_dv[2 * pr + 1], a_p, b_o + 2);
          mma_bf16_16816(acc_dk[2 * pr], a_s, b_q);
          mma_bf16_16816(acc_dk[2 * pr + 1], a_s, b_q + 2);
        }
      }
    }
    tt = tn;
  }

  // fp32 partials of keys k0 + 16 kg + g (+ 8), columns hh D / 2 + 8 nt + 2t
  const size_t total = (size_t)gridDim.z * Hkv * Skv * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kg * 16 + g + 8 * h;
    if (key >= Skv) continue;
    const size_t off = split * total + (((size_t)b * Hkv + kvh) * Skv + key) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NH; ++nt) {
      const int col = hh * (DMAX / 2) + nt * 8;
      if (col < D) {
        *reinterpret_cast<float2*>(part_dk + off + col) =
            make_float2(acc_dk[nt][2 * h], acc_dk[nt][2 * h + 1]);
        *reinterpret_cast<float2*>(part_dv + off + col) =
            make_float2(acc_dv[nt][2 * h], acc_dv[nt][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 forms (header): 3xTF32 products on mma.sync.m16n8k8 tiles.
// ---------------------------------------------------------------------------
#define BW32_M 64    // folded rows of a dq block (32 where 64-row blocks leave half the SMs idle)
#define BW32_N 32    // keys of a dq block's K / V tile; keys of a dk/dv block
#define BW32_R 32    // rows of a dk/dv block's streamed Q / dO tile
#define BW32_NT 256  // threads of a dk/dv block
#define BW32_PS 40   // row stride of the dk/dv block's S^T / dP^T hand-over (8 mod 32)
#define BW32_PL 36   // row stride of P^T / dS^T, of dq's S / dP hand-over and dS (4 mod 32)

// Tiles of fp32 rows of DP (D rounded up to 64, 80, 128 or 256) columns at a
// row stride LD = 8 (mod 32) floats, column c of row r stored at c ^ (r & 4)
// (16-byte chunks trade places on rows with bit 2 set). Both fragment reads
// are then free of bank conflicts: rows g = 0..7 at columns t = 0..3 (A, and
// B along the depth: ldmatrix), and rows t = 0..3 at columns g = 0..7 (B
// along keys or rows: one 32-bit load a lane).
template <int DP>
struct Bwd32 {
  static constexpr int LD = ((DP + 31) & ~31) + 8;
  // dq: Q, dO (M rows each), one K and one V tile (32 keys each), the
  // S / dP hand-over and dS (M rows x 32 keys each)
  template <int M>
  static constexpr int dq_bytes() {
    return ((2 * M + 2 * BW32_N) * LD + 3 * M * BW32_PL) * (int)sizeof(float);
  }
  // dk/dv: K, V (32 keys each), two stages of (Q, dO) of 32 rows, the
  // S^T / dP^T hand-over, P^T and dS^T, two stages of (lse, delta)
  static constexpr int DKV_BYTES =
      ((2 * BW32_N + 4 * BW32_R) * LD + 2 * BW32_N * BW32_PS + 2 * BW32_N * BW32_PL +
       4 * BW32_R) * (int)sizeof(float);
  static_assert(DKV_BYTES <= 232448, "shared memory of one block");
};

__device__ __forceinline__ int bw32_at(int r, int c, int ld) { return r * ld + (c ^ (r & 4)); }

// 2^x (ex2.approx): p = exp(s scale - lse) is 2^(s c2 - lse log2 e), the
// forward's (csrc/flash_attention.cu fa_exp2) arithmetic.
__device__ __forceinline__ float bw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c[nt] (16 rows x 8, nt = 0, 1) += A . B^T over the depth's k8 steps
// kk0 .. kk1 - 1: A's rows and B's rows from the tiles a and b, the lane's
// ldmatrix row addresses a_row / b_row (its column within a k8 step a_col /
// b_col: 0 or 4).
template <int LD, int UNROLL>
__device__ __forceinline__ void rows_by_rows_3xtf32(float (*c)[4], const float* a,
                                                    const float* b, int a_row, int a_col,
                                                    int b_row, int b_col, int kk0, int kk1) {
#pragma unroll UNROLL
  for (int kk = kk0; kk < kk1; ++kk) {
    uint32_t ar[4], br[4], ab[4], as[4], bb[4], bs[4];
    ldsm_x4_f32(ar, a + bw32_at(a_row, 8 * kk + a_col, LD));
    ldsm_x4_f32(br, b + bw32_at(b_row, 8 * kk + b_col, LD));
    split_tf32<4>(ar, ab, as);
    split_tf32<4>(br, bb, bs);
    mma_3xtf32(c[0], ab, as, bb, bs);
    mma_3xtf32(c[1], ab, as, bb + 2, bs + 2);
  }
}

// n rows of an fp32 tensor into a tile (Bwd32's layout), 16-byte cp.async
// chunks, zeros where ok(r) is false and past D; addr(r) is the element
// offset of row r.
template <int DP, class Ok, class Addr>
__device__ __forceinline__ void bw32_load(float* dst, const float* __restrict__ src, int n, int D,
                                          Ok ok, Addr addr) {
  constexpr int CH = DP / 4;
  for (int idx = threadIdx.x; idx < n * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const bool on = c * 4 < D && ok(r);
    cp_async_16(dst + bw32_at(r, 4 * c, Bwd32<DP>::LD), on ? src + addr(r) + c * 4 : src, on);
  }
}

// A block of M folded rows: 8 M / 16 warps (M / 16 row groups).
template <int DP, int M>
__global__ void __launch_bounds__(8 * M, 1)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ prefix_len, const int* __restrict__ kv_len,
                            float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
                            float scale, int q_offset) {
  // NT: n8 tiles over D (NQ of them a warp), KH: k8 steps of half the depth
  constexpr int LD = Bwd32<DP>::LD, NT = DP / 8, NQ = (NT + 3) / 4, KH = DP / 16, RG = M / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [M][LD]
  float* dos = qs + M * LD;                    // [M][LD]
  float* ks = dos + M * LD;                    // [BW32_N][LD]
  float* vs = ks + BW32_N * LD;                // [BW32_N][LD]
  float* hand = vs + BW32_N * LD;              // S, then dP, of the other depth half [M][BW32_PL]
  float* dss = hand + 2 * M * BW32_PL;         // dS [M][BW32_PL]

  // a cluster of cs CTAs shares a block of rows, rank kr taking the kr-th
  // cs-th of its key tiles
  const int cs = cluster_size(), kr = cluster_rank();
  const int b = blockIdx.z, kvh = blockIdx.y, row0 = (blockIdx.x / cs) * M;
  const int group = Hq / Hkv, rows = group * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // S / dP: rows 16 wr .., keys 16 wk .. of each tile, depth half dh;
  // dQ: rows 16 wr .., the n8 tiles cq, cq + 4, ... of D
  const int wr = warp % RG, wk = (warp / RG) & 1, dh = warp / (2 * RG), cq = warp / RG;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int plen = prefix_len[b], klen = min(kv_len[b], Skv);
  const int kend = tile_key_end(row0, M, rows, Sq, q_offset, plen, klen);
  const int n_tiles = (kend + BW32_N - 1) / BW32_N, per = (n_tiles + cs - 1) / cs;
  const int j0 = min(n_tiles, kr * per), j1 = min(n_tiles, j0 + per);
  const float c2 = scale * 1.4426950408889634f;  // scores to log2 units

  auto row_ok = [&](int rr) { return row0 + rr < rows; };
  auto row_addr = [&](int rr) {
    const int fr = row0 + rr, gi = fr / Sq, i = fr - gi * Sq;
    return (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + gi) * D;
  };
  // the tile of keys k0 .. k0 + BW32_N - 1 of k or v: zeros at and past klen
  auto load_keys = [&](float* dst, const float* src, int k0) {
    bw32_load<DP>(dst, src, BW32_N, D, [&](int j) { return k0 + j < klen; },
                  [&](int j) { return (((size_t)b * Skv + k0 + j) * Hkv + kvh) * D; });
  };

  // copy groups: (Q, dO, V_j0), then K_j0; each tile then commits V_{j+1}
  // (once V_j is read) and K_{j+1} (once K_j is)
  if (j0 < j1) {
    bw32_load<DP>(qs, q, M, D, row_ok, row_addr);
    bw32_load<DP>(dos, dout, M, D, row_ok, row_addr);
    load_keys(vs, v, j0 * BW32_N);
    cp_async_commit();
    load_keys(ks, k, j0 * BW32_N);
    cp_async_commit();
  }

  // this thread's rows of the warp's 16: g and g + 8
  bool rok[2];
  int pos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wr * 16 + g + 8 * h;
    const size_t stat = ((size_t)b * Hkv + kvh) * rows + row;
    rok[h] = row < rows;
    pos[h] = row % Sq + q_offset;
    lse2[h] = rok[h] ? lse[stat] * 1.4426950408889634f : 0.f;
    dl[h] = rok[h] ? delta[stat] : 0.f;
  }

  float acc[NQ][4];  // dQ of rows g, g + 8 and columns 8 (cq + 4 i) + 2t, + 1
#pragma unroll
  for (int i = 0; i < NQ; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // ldmatrix rows: A (Q, dO, dS) row lr + 8 (lm & 1) of the warp's 16 at
  // column 4 (lm >> 1) of a k8 step; B (K, V) key lr of n8 tile lm >> 1 at
  // column 4 (lm & 1)
  const int a_row = wr * 16 + lr + 8 * (lm & 1), a_col = 4 * (lm >> 1);
  const int b_row = wk * 16 + 8 * (lm >> 1) + lr, b_col = 4 * (lm & 1);
  // C element e of n8 tile nt: row 16 wr + g + 8 (e >> 1), key 16 wk + 8 nt + 2t + (e & 1)
  const int at_h = (wr * 16 + g) * BW32_PL + wk * 16 + 2 * t;
  auto tile = [&](const float (*c)[4], int nt, int e) { return nt ? c[1][e] : c[0][e]; };

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * BW32_N, kw = k0 + wk * 16;  // the warp's first key
    const bool busy = kw < kend;  // warp-uniform: keys past every row's last skip
    cp_async_wait<1>();
    __syncthreads();  // V_j (and Q, dO) visible to all
    float dp[2][4] = {}, s[2][4] = {};
    if (busy)
      rows_by_rows_3xtf32<LD, 2>(dp, dos, vs, a_row, a_col, b_row, b_col, dh * KH,
                                 dh * KH + KH);
    cp_async_wait<0>();
    __syncthreads();  // K_j visible to all; V_j no longer read
    if (j + 1 < j1) load_keys(vs, v, k0 + BW32_N);
    cp_async_commit();
    if (busy)
      rows_by_rows_3xtf32<LD, 2>(s, qs, ks, a_row, a_col, b_row, b_col, dh * KH, dh * KH + KH);
    // each warp hands the other depth half its sums of n8 tile 1 - dh and
    // forms dS of tile dh from both halves' sums
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = at_h + 8 * h * BW32_PL + 8 * (1 - dh);
      *reinterpret_cast<float2*>(hand + at) =
          make_float2(tile(s, 1 - dh, 2 * h), tile(s, 1 - dh, 2 * h + 1));
      *reinterpret_cast<float2*>(hand + M * BW32_PL + at) =
          make_float2(tile(dp, 1 - dh, 2 * h), tile(dp, 1 - dh, 2 * h + 1));
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = at_h + 8 * h * BW32_PL + 8 * dh;
      const float2 s1 = *reinterpret_cast<const float2*>(hand + at);
      const float2 d1 = *reinterpret_cast<const float2*>(hand + M * BW32_PL + at);
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kw + 8 * dh + 2 * t + c;
        const bool ok = rok[h] && key < klen && (key < plen || key <= pos[h]);
        // the first half's sum plus the second's (a sum of two: either order)
        const float sv = tile(s, dh, 2 * h + c) + (c ? s1.y : s1.x);
        const float dv = tile(dp, dh, 2 * h + c) + (c ? d1.y : d1.x);
        ds[c] = ok ? bw_exp2(fmaf(sv, c2, -lse2[h])) * (dv - dl[h]) : 0.f;
      }
      *reinterpret_cast<float2*>(dss + at) = make_float2(ds[0], ds[1]);
    }
    __syncthreads();
    // dQ += dS K over the tile's keys in k8 steps, with K[key][d] as
    // B[k = key][n = d]: keys t and t + 4 of the step (rows of the tile
    // without and with bit 2) at column 8 nd + g
#pragma unroll
    for (int kk = 0; kk < BW32_N / 8; ++kk) {
      if (k0 + 8 * kk >= kend) break;
      uint32_t ar[4], ab[4], as[4];
      ldsm_x4_f32(ar, dss + a_row * BW32_PL + 8 * kk + a_col);
      split_tf32<4>(ar, ab, as);
      const float* kr = ks + (8 * kk + t) * LD;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int nd = cq + 4 * i;
        if (nd < NT && nd * 8 < D) {
          uint32_t bb[2], bs[2];
          split_tf32(kr[8 * nd + g], bb[0], bs[0]);
          split_tf32(kr[4 * LD + ((8 * nd + g) ^ 4)], bb[1], bs[1]);
          mma_3xtf32(acc[i], ab, as, bb, bs);
        }
      }
    }
    __syncthreads();  // K_j, the hand-over and dS no longer read
    if (j + 1 < j1) load_keys(ks, k, k0 + BW32_N);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the block

  // the cluster's sum: each rank's dQ through its shared memory (each value
  // to the thread that holds the same element), added by rank 0 in rank order
  if (cs > 1) {
    float* mine = qs + threadIdx.x;
    __syncthreads();  // every warp is done with the tiles
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(i * 4 + e) * blockDim.x] = acc[i][e];
    cluster_sync_all();
    if (kr == 0) {
      for (int r = 1; r < cs; ++r)
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][e] += ld_cluster_f32(mine + (i * 4 + e) * blockDim.x, r);
    }
    cluster_sync_all();  // rank 0 has read every rank's sums
    if (kr != 0) return;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    float* dst = dq + row_addr(wr * 16 + g + 8 * h) + 2 * t;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int nd = cq + 4 * i;
      if (nd < NT && nd * 8 < D)
        *reinterpret_cast<float2*>(dst + 8 * nd) =
            make_float2(acc[i][2 * h] * scale, acc[i][2 * h + 1] * scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(BW32_NT, 1)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int* __restrict__ prefix_len, const int* __restrict__ kv_len,
                             float* __restrict__ part_dk, float* __restrict__ part_dv, int Sq,
                             int Skv, int Hq, int Hkv, int D, float scale, int q_offset,
                             int tiles_per_split) {
  // NT: n8 tiles over D (NQ of them a warp), KH: k8 steps of half the depth
  constexpr int LD = Bwd32<DP>::LD, NT = DP / 8, NQ = (NT + 3) / 4, KH = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [BW32_N][LD]
  float* vs = ks + BW32_N * LD;                // [BW32_N][LD]
  float* qd = vs + BW32_N * LD;                // stage s: Q at qd + 2 s BW32_R LD, dO after it
  float* hand = qd + 4 * BW32_R * LD;          // S^T, dP^T of the depth's second half
  float* pts = hand + 2 * BW32_N * BW32_PS;    // P^T, then dS^T [BW32_N][BW32_PL]
  float* stats = pts + 2 * BW32_N * BW32_PL;   // stage s: lse, then delta

  const int nkt = (Skv + BW32_N - 1) / BW32_N;
  const int kt = blockIdx.x % nkt, split = blockIdx.x / nkt;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = kt * BW32_N;
  const int group = Hq / Hkv, rows = group * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  // S^T / dP^T: keys 16 kg .., rows 16 rg .. of the tile, depth half dh;
  // dV / dK: keys 16 kg .., n8 tiles cq, cq + 4, ... of D
  const int kg = warp & 1, rg = (warp >> 1) & 1, dh = warp >> 2, cq = warp >> 1;
  const int plen = prefix_len[b], klen = min(kv_len[b], Skv);
  const int t_end = min((rows + BW32_R - 1) / BW32_R, (split + 1) * tiles_per_split);
  const size_t stat0 = ((size_t)b * Hkv + kvh) * rows;
  const float c2 = scale * 1.4426950408889634f;

  // the first row tile at or after tt that sees a key of this block (t_end: none)
  auto next_tile = [&](int tt) {
    while (tt < t_end && tile_key_end(tt * BW32_R, BW32_R, rows, Sq, q_offset, plen, klen) <= k0)
      ++tt;
    return tt;
  };
  auto load_tile = [&](int tt, int st) {
    float* qst = qd + st * 2 * BW32_R * LD;
    const int row0 = tt * BW32_R;
    auto ok = [&](int rr) { return row0 + rr < rows; };
    auto addr = [&](int rr) {
      const int fr = row0 + rr, gi = fr / Sq, i = fr - gi * Sq;
      return (((size_t)b * Sq + i) * Hq + (size_t)kvh * group + gi) * D;
    };
    bw32_load<DP>(qst, q, BW32_R, D, ok, addr);
    bw32_load<DP>(qst + BW32_R * LD, dout, BW32_R, D, ok, addr);
    if (threadIdx.x < 2 * BW32_R) {  // lse by threads 0-31, delta by 32-63
      const int row = row0 + (threadIdx.x & (BW32_R - 1));
      const float* src = threadIdx.x < BW32_R ? lse : delta;
      cp_async_4(stats + st * 2 * BW32_R + threadIdx.x, row < rows ? src + stat0 + row : src,
                 row < rows);
    }
  };

  float acc_dk[NQ][4], acc_dv[NQ][4];  // keys 16 kg + g (+ 8), columns 8 (cq + 4 i) + 2t, + 1
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;

  int tt = k0 < klen ? next_tile(split * tiles_per_split) : t_end;
  if (tt < t_end) {
    auto key_ok = [&](int j) { return k0 + j < klen; };
    auto key_addr = [&](int j) { return (((size_t)b * Skv + k0 + j) * Hkv + kvh) * D; };
    bw32_load<DP>(ks, k, BW32_N, D, key_ok, key_addr);
    bw32_load<DP>(vs, v, BW32_N, D, key_ok, key_addr);
    load_tile(tt, 0);
    cp_async_commit();
  }
  // ldmatrix rows: A (K, V) key lr + 8 (lm & 1) of the warp's 16 at column
  // 4 (lm >> 1); B (Q, dO) row lr of n8 tile lm >> 1 at column 4 (lm & 1);
  // A of P^T / dS^T as A of K
  const int a_row = kg * 16 + lr + 8 * (lm & 1), a_col = 4 * (lm >> 1);
  const int b_row = rg * 16 + 8 * (lm >> 1) + lr, b_col = 4 * (lm & 1);
  for (int it = 0; tt < t_end; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile tt is visible to all; the previous tile's stage is free
    const int tn = next_tile(tt + 1);
    if (tn < t_end) {
      load_tile(tn, st ^ 1);
      cp_async_commit();
    }
    const float* qst = qd + st * 2 * BW32_R * LD;
    const float* dost = qst + BW32_R * LD;
    const float* lse_s = stats + st * 2 * BW32_R;
    const int row0 = tt * BW32_R;

    // S^T = K Q^T and dP^T = V dO^T over the warp's half of the depth
    float s[2][4] = {}, dp[2][4] = {};
    rows_by_rows_3xtf32<LD, 4>(s, ks, qst, a_row, a_col, b_row, b_col, dh * KH, dh * KH + KH);
    rows_by_rows_3xtf32<LD, 4>(dp, vs, dost, a_row, a_col, b_row, b_col, dh * KH, dh * KH + KH);
    // element e of n8 tile nt: key 16 kg + g + 8 (e >> 1), row 16 rg + 8 nt +
    // 2t + (e & 1). Each warp hands the other half its sums of n8 tile 1 - dh
    // and forms p and ds of tile dh from both halves' sums
    const int at_h = (kg * 16 + g) * BW32_PS + rg * 16 + 2 * t;
    auto tile = [&](const float (*c)[4], int nt, int e) { return nt ? c[1][e] : c[0][e]; };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = at_h + 8 * h * BW32_PS + 8 * (1 - dh);
      *reinterpret_cast<float2*>(hand + at) =
          make_float2(tile(s, 1 - dh, 2 * h), tile(s, 1 - dh, 2 * h + 1));
      *reinterpret_cast<float2*>(hand + BW32_N * BW32_PS + at) =
          make_float2(tile(dp, 1 - dh, 2 * h), tile(dp, 1 - dh, 2 * h + 1));
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = at_h + 8 * h * BW32_PS + 8 * dh;
      const float2 s1 = *reinterpret_cast<const float2*>(hand + at);
      const float2 d1 = *reinterpret_cast<const float2*>(hand + BW32_N * BW32_PS + at);
      const int key = k0 + kg * 16 + g + 8 * h;
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int rr = rg * 16 + dh * 8 + 2 * t + c, row = row0 + rr;
        const bool ok = row < rows && key < klen && (key < plen || key <= row % Sq + q_offset);
        // the first half's sum plus the second's (a sum of two: either order)
        const float sv = tile(s, dh, 2 * h + c) + (c ? s1.y : s1.x);
        const float dv = tile(dp, dh, 2 * h + c) + (c ? d1.y : d1.x);
        p[c] = ok ? bw_exp2(fmaf(sv, c2, -lse_s[rr] * 1.4426950408889634f)) : 0.f;
        ds[c] = ok ? p[c] * (dv - lse_s[BW32_R + rr]) : 0.f;
      }
      const int pt = (kg * 16 + g + 8 * h) * BW32_PL + rg * 16 + dh * 8 + 2 * t;
      *reinterpret_cast<float2*>(pts + pt) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(pts + BW32_N * BW32_PL + pt) = make_float2(ds[0], ds[1]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's rows in k8 steps (dO[row][d]
    // and Q[row][d] as B[k = row][n = d]: rows t and t + 4 of the step at column
    // 8 nd + g)
#pragma unroll
    for (int kk = 0; kk < BW32_R / 8; ++kk) {
      uint32_t ar[4], pb[4], ps[4], sb[4], ss[4];
      ldsm_x4_f32(ar, pts + a_row * BW32_PL + 8 * kk + a_col);
      split_tf32<4>(ar, pb, ps);
      ldsm_x4_f32(ar, pts + BW32_N * BW32_PL + a_row * BW32_PL + 8 * kk + a_col);
      split_tf32<4>(ar, sb, ss);
      const float* orow = dost + (8 * kk + t) * LD;
      const float* qrow = qst + (8 * kk + t) * LD;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int nd = cq + 4 * i;
        if (nd < NT && nd * 8 < D) {
          const int c0 = 8 * nd + g, c1 = 4 * LD + ((8 * nd + g) ^ 4);
          uint32_t bb[2], bs[2];
          split_tf32(orow[c0], bb[0], bs[0]);
          split_tf32(orow[c1], bb[1], bs[1]);
          mma_3xtf32(acc_dv[i], pb, ps, bb, bs);
          split_tf32(qrow[c0], bb[0], bs[0]);
          split_tf32(qrow[c1], bb[1], bs[1]);
          mma_3xtf32(acc_dk[i], sb, ss, bb, bs);
        }
      }
    }
    tt = tn;
  }

  // fp32 partials of keys k0 + 16 kg + g (+ 8), columns 8 nd + 2t, + 1 (dk unscaled)
  const size_t total = (size_t)gridDim.z * Hkv * Skv * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kg * 16 + g + 8 * h;
    if (key >= Skv) continue;
    const size_t off = split * total + (((size_t)b * Hkv + kvh) * Skv + key) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int nd = cq + 4 * i;
      if (nd < NT && nd * 8 < D) {
        *reinterpret_cast<float2*>(part_dk + off + 8 * nd) =
            make_float2(acc_dk[i][2 * h], acc_dk[i][2 * h + 1]);
        *reinterpret_cast<float2*>(part_dv + off + 8 * nd) =
            make_float2(acc_dv[i][2 * h], acc_dv[i][2 * h + 1]);
      }
    }
  }
}

// Four consecutive outputs (4-element aligned): bf16 rounded to nearest
// even, or fp32 as they are.
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_f32_bf16x2(a, b), pack_f32_bf16x2(c, d));
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// dk = scale * sum of the dk partials, dv = sum of the dv partials, in split
// order; partials are (nsplit, B, Hkv, Skv, D), outputs (B, Skv, Hkv, D) in
// T (bf16 for the bf16 kernel, fp32 for its fp32 form). Each thread adds 4
// consecutive columns (D % 8 == 0).
template <class T>
__global__ void flash_bwd_dkv_sum(const float* __restrict__ part_dk,
                                  const float* __restrict__ part_dv, T* __restrict__ dk,
                                  T* __restrict__ dv, int nsplit, int B, int Skv, int Hkv, int D,
                                  float scale) {
  const size_t total = (size_t)B * Hkv * Skv * D;
  const size_t idx = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (idx >= total) return;
  const int d = idx % D;
  size_t rest = idx / D;
  const int key = rest % Skv;
  rest /= Skv;
  const int kvh = rest % Hkv, b = rest / Hkv;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < nsplit; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(part_dk + s * total + idx);
    const float4 c = *reinterpret_cast<const float4*>(part_dv + s * total + idx);
    sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
    sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
  }
  const size_t out = (((size_t)b * Skv + key) * Hkv + kvh) * D + d;
  store4(dk + out, sk.x * scale, sk.y * scale, sk.z * scale, sk.w * scale);
  store4(dv + out, sv.x, sv.y, sv.z, sv.w);
}

// The sum pass on ``st``; returns cudaGetLastError().
template <class T>
static int launch_dkv_sum(const void* part_dk, const void* part_dv, void* dk, void* dv,
                          int nsplit, int B, int Skv, int Hkv, int D, float scale,
                          cudaStream_t st) {
  const size_t quads = (size_t)B * Hkv * Skv * D / 4;
  const int threads = 256;
  flash_bwd_dkv_sum<T><<<(unsigned)((quads + threads - 1) / threads), threads, 0, st>>>(
      (const float*)part_dk, (const float*)part_dv, (T*)dk, (T*)dv, nsplit, B, Skv, Hkv, D,
      scale);
  return (int)cudaGetLastError();
}

// The kernel's dynamic shared memory above 48 KB, allowed once per process.
template <typename Kernel>
static int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DMAX>
static int launch_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* prefix_len,
                     const void* kv_len, void* dq, int B, int Sq, int Skv, int Hq, int Hkv,
                     int D, float scale, int q_offset, cudaStream_t st) {
  constexpr int bytes = BwdSmem<DMAX>::DQ_BYTES;
  static const int attr = allow_smem(flash_bwd_dq_kernel<DMAX>, bytes);
  if (attr != 0) return attr;
  const int rows = (Hq / Hkv) * Sq;
  dim3 grid((rows + BW_M - 1) / BW_M, Hkv, B);
  flash_bwd_dq_kernel<DMAX><<<grid, 256, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)prefix_len, (const int*)kv_len, (bf16*)dq, Sq, Skv, Hq,
      Hkv, D, scale, q_offset);
  return (int)cudaGetLastError();
}

template <int DMAX>
static int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* prefix_len,
                      const void* kv_len, void* part_dk, void* part_dv, int B, int Sq, int Skv,
                      int Hq, int Hkv, int D, int nsplit, float scale, int q_offset,
                      cudaStream_t st) {
  constexpr int bytes = BwdSmem<DMAX>::DKV_BYTES;
  static const int attr = allow_smem(flash_bwd_dkv_kernel<DMAX>, bytes);
  if (attr != 0) return attr;
  const int n_tiles = ((Hq / Hkv) * Sq + BW_M - 1) / BW_M;
  const int tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  dim3 grid(((Skv + BW_N - 1) / BW_N) * nsplit, Hkv, B);
  flash_bwd_dkv_kernel<DMAX><<<grid, 256, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)prefix_len, (const int*)kv_len, (float*)part_dk,
      (float*)part_dv, Sq, Skv, Hq, Hkv, D, scale, q_offset, tiles_per_split);
  return (int)cudaGetLastError();
}

// q, dout: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) bf16, contiguous, 16-byte
// aligned, D % 8 == 0 and D <= 256 (the wrapper checks these).
PG_EXPORT int pg_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* prefix_len, const void* kv_len, void* dq,
                                        int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                        float scale, int q_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq, Skv, Hq,
                          Hkv, D, scale, q_offset, st);
  return launch_dq<256>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq, Skv, Hq, Hkv,
                        D, scale, q_offset, st);
}

PG_EXPORT int pg_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* prefix_len, const void* kv_len,
                                         void* part_dk, void* part_dv, void* dk, void* dv, int B,
                                         int Sq, int Skv, int Hq, int Hkv, int D, int nsplit,
                                         float scale, int q_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      D <= 128 ? launch_dkv<128>(q, k, v, dout, lse, delta, prefix_len, kv_len, part_dk,
                                 part_dv, B, Sq, Skv, Hq, Hkv, D, nsplit, scale, q_offset, st)
               : launch_dkv<256>(q, k, v, dout, lse, delta, prefix_len, kv_len, part_dk,
                                 part_dv, B, Sq, Skv, Hq, Hkv, D, nsplit, scale, q_offset, st);
  if (err != 0) return err;
  return launch_dkv_sum<bf16>(part_dk, part_dv, dk, dv, nsplit, B, Skv, Hkv, D, scale, st);
}

template <int DP, int M>
static int launch_dq_f32_rows(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* prefix_len,
                              const void* kv_len, void* dq, int B, int Sq, int Skv, int Hq,
                              int Hkv, int D, float scale, int q_offset, int cs,
                              cudaStream_t st) {
  constexpr int bytes = Bwd32<DP>::template dq_bytes<M>();
  static_assert(bytes <= 232448, "shared memory of one block");
  static const int attr = allow_smem(flash_bwd_dq_f32_kernel<DP, M>, bytes);
  if (attr != 0) return attr;
  const int rows = (Hq / Hkv) * Sq;
  dim3 grid(((rows + M - 1) / M) * cs, Hkv, B);
  return cluster_launch(flash_bwd_dq_f32_kernel<DP, M>, grid, 8 * M, cs, bytes, st,
                        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
                        (const float*)lse, (const float*)delta, (const int*)prefix_len,
                        (const int*)kv_len, (float*)dq, Sq, Skv, Hq, Hkv, D, scale, q_offset);
}

// The CTAs of a cluster that splits a dq block's key tiles: the most of 1,
// 2 and 4 that keep the 64-row blocks' CTAs in one wave.
static int dq_cluster(long blocks64, int sms) {
  int cs = 1;
  while (cs < 4 && blocks64 * cs * 2 <= sms) cs *= 2;
  return cs;
}

// 64-row blocks in clusters of dq_cluster CTAs, or 32-row ones where those
// would still fill at most half the SMs.
template <int DP>
static int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* prefix_len,
                         const void* kv_len, void* dq, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, float scale, int q_offset, cudaStream_t st) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long blocks64 = (long)(((Hq / Hkv) * Sq + BW32_M - 1) / BW32_M) * Hkv * B;
  const int cs = dq_cluster(blocks64, sms);
  if (2 * blocks64 * cs <= sms)
    return launch_dq_f32_rows<DP, 32>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq,
                                      Skv, Hq, Hkv, D, scale, q_offset, cs, st);
  return launch_dq_f32_rows<DP, BW32_M>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B,
                                        Sq, Skv, Hq, Hkv, D, scale, q_offset, cs, st);
}

template <int DP>
static int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const void* prefix_len,
                          const void* kv_len, void* part_dk, void* part_dv, int B, int Sq,
                          int Skv, int Hq, int Hkv, int D, int nsplit, float scale, int q_offset,
                          cudaStream_t st) {
  constexpr int bytes = Bwd32<DP>::DKV_BYTES;
  static const int attr = allow_smem(flash_bwd_dkv_f32_kernel<DP>, bytes);
  if (attr != 0) return attr;
  const int n_tiles = ((Hq / Hkv) * Sq + BW32_R - 1) / BW32_R;
  const int tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  dim3 grid(((Skv + BW32_N - 1) / BW32_N) * nsplit, Hkv, B);
  flash_bwd_dkv_f32_kernel<DP><<<grid, BW32_NT, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (const int*)prefix_len, (const int*)kv_len, (float*)part_dk,
      (float*)part_dv, Sq, Skv, Hq, Hkv, D, scale, q_offset, tiles_per_split);
  return (int)cudaGetLastError();
}

// The fp32 forms: q, k, v, dout and dq (dk, dv) fp32, the rest as
// pg_flash_attention_bwd_dq (_dkv); nsplit row splits of 32-row tiles.
PG_EXPORT int pg_flash_attention_bwd_dq_fp32(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, const void* prefix_len,
                                             const void* kv_len, void* dq, int B, int Sq,
                                             int Skv, int Hq, int Hkv, int D, float scale,
                                             int q_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_dq_f32<64>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq, Skv, Hq,
                             Hkv, D, scale, q_offset, st);
  if (D <= 80)
    return launch_dq_f32<80>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq, Skv, Hq,
                             Hkv, D, scale, q_offset, st);
  if (D <= 128)
    return launch_dq_f32<128>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq, Skv,
                              Hq, Hkv, D, scale, q_offset, st);
  return launch_dq_f32<256>(q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq, Skv, Hq,
                            Hkv, D, scale, q_offset, st);
}

PG_EXPORT int pg_flash_attention_bwd_dkv_fp32(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, const void* prefix_len,
                                              const void* kv_len, void* part_dk, void* part_dv,
                                              void* dk, void* dv, int B, int Sq, int Skv, int Hq,
                                              int Hkv, int D, int nsplit, float scale,
                                              int q_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (D <= 64)
    err = launch_dkv_f32<64>(q, k, v, dout, lse, delta, prefix_len, kv_len, part_dk, part_dv, B,
                             Sq, Skv, Hq, Hkv, D, nsplit, scale, q_offset, st);
  else if (D <= 80)
    err = launch_dkv_f32<80>(q, k, v, dout, lse, delta, prefix_len, kv_len, part_dk, part_dv, B,
                             Sq, Skv, Hq, Hkv, D, nsplit, scale, q_offset, st);
  else if (D <= 128)
    err = launch_dkv_f32<128>(q, k, v, dout, lse, delta, prefix_len, kv_len, part_dk, part_dv,
                              B, Sq, Skv, Hq, Hkv, D, nsplit, scale, q_offset, st);
  else
    err = launch_dkv_f32<256>(q, k, v, dout, lse, delta, prefix_len, kv_len, part_dk, part_dv,
                              B, Sq, Skv, Hq, Hkv, D, nsplit, scale, q_offset, st);
  if (err != 0) return err;
  return launch_dkv_sum<float>(part_dk, part_dv, dk, dv, nsplit, B, Skv, Hkv, D, scale, st);
}
