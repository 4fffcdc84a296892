// Weight-only quantized matmul on Hopper's warpgroup tensor cores (wgmma),
// its tiles brought in by TMA. Shared by int8_matmul.cu (int8 weights
// stored (K, N) or N-major (N, K)) and int4_matmul.cu (int4 weights
// nibble-packed as "K-halves", (K/2, N)):
//
//   out(M, N) = cast_bf16((x(M, K) . dequant_bf16(w)) fp32 * s(N))
//
// bf16 holds every int8 (-127..127) and int4 (-8..7) value exactly, so a
// bf16 product with fp32 accumulators computes the TPU kernels' function;
// the per-column scale is applied once, after the whole K sweep, as they do.
//
// What bounds it: at prefill and training rows (M in the hundreds to
// thousands) the products, 2 M K N flops (0.23 ms at M = 1024 for
// Gemma-2B's four projections of one layer on an H100); at decode rows the
// weight bytes. The design:
// - The product is taken transposed, out^T = W^T . x^T: the weights are
//   wgmma's A operand, converted to bf16 in registers, and x is B, read
//   from shared memory. A CTA owns 128 weight columns (output columns) by
//   XN rows of x (16, 64, 128, 136 or 256: the wgmma's N; 136 takes the 266
//   rows of a 224 px prompt in two tiles): two consumer warpgroups of 64
//   weight columns each and a producer warp. A stage costs nearly the same
//   whatever XN (its conversion and waits, not its products, set the
//   pace), so the 256-row tile is the fastest where M fills it; its 128
//   accumulators a thread need more registers than the 168 ptxas gives a
//   CTA of 288 or 384 threads, so there the producer is a whole warpgroup
//   that hands its registers to the consumers (setmaxnreg 56 / 224).
// - The producer (one thread) keeps TMA loads in flight into a ring of ST
//   stages, each a 64-deep x tile (XN x 64 bf16, 128-byte swizzle; int4: a
//   second one at column K/2 + k0) and the raw weight tile: int8 (K, N) and
//   int4, 64 stored rows x 128 columns (128-byte swizzle); int8 (N, K), 128
//   rows of 64 K values (64-byte swizzle). A stage completes on a full
//   mbarrier and is handed back on an empty one (one arrival per consumer
//   warp) once the products that read its x tile are done.
// - The consumers convert their A fragments straight from the raw tile
//   (wq_load: ldmatrix.trans on byte pairs, or 4-byte loads) with the
//   integer tricks of gemv_tile.cuh (int8: the byte under the exponent of
//   2^23, one subtraction; int4: the nibble under bf16's 128, one bf16x2
//   FMA), no cvt per element; nothing is written back to shared memory and
//   the two warpgroups never wait for each other. The work goes in units of
//   4 steps of 16 (a stage; int4: a stage's low nibbles against x at k, then
//   its high ones against x at k + K/2, into the same accumulators): unit
//   u + 1's fragments are converted while unit u's products run (two
//   register sets, wgmma.wait_group 1; converting unit u + 1 while units u -
//   1 and u both run, from a third set, gave wrong sums on an H100).
// - Measured against the other form (the converted tile written back to
//   shared memory as wgmma's B, x as A; PERF.md): that one was 13-19 %
//   slower at 266 and 1024 rows. Each wgmma reads its shared-memory operands
//   again, and at full rate the register-A form's reads of x (1/32 byte a
//   MAC) plus the TMA writes already take most of an SM's 128 bytes a cycle.
// - Without a K split (cluster 1) the CTAs are persistent: CTA b takes the
//   tiles b, b + grid, ... (rows of x fastest, so CTAs side by side share a
//   weight block in L2), and the producer runs on into the next tile while
//   the consumers scale, cast and store the last one from registers.
// - Split-K (a cluster of 2-8 CTAs, one tile each) where the output tiles
//   alone would leave SMs idle (kernels/ablation/_wq_gemm.py plans it): the
//   ranks take consecutive K ranges and write their fp32 sums to their own
//   shared memory; after a cluster barrier each rank adds every rank's sums
//   for its share of the tile through distributed shared memory, in rank
//   order, scales, casts and stores. No fp32 partials in device memory, no
//   atomics: a second call gives the same bits.
// - Rows of x past M read as zeros (TMA) and are not stored.
//
// A fragment of thread (g, t) of warp w: rows 16w + g and 16w + g + 8, k
// pairs {2t, 2t+1} and {2t+8, 2t+9} of a 16-deep step.
// - int8 (K, N) and int4: ldmatrix.trans on byte pairs (two columns as one
//   16-bit element) reads 8 K rows of 16 columns per matrix and hands thread
//   (g, t) the column pair (2g, 2g + 1) at K rows 2t and 2t + 1: bytes (k
//   2t: n 2g, 2g+1; k 2t+1: n 2g, 2g+1). So fragment row g is column 2g and
//   row g + 8 column 2g + 1 (the epilogue maps them back), and a fragment
//   word is two bytes of one ldmatrix word.
// - int8 (N, K): fragment row g is weight row g; its pairs are the bytes
//   2t, 2t+1 and 2t+8, 2t+9 of a 16-byte chunk: two 4-byte loads a row and
//   step (both pairs of a quad's two threads in one word).
#pragma once

#include "gemv_tile.cuh"  // clusters, cluster_launch, the int8 / int4 conversions
#include "hopper.cuh"
#include "tensor_map.cuh"

enum WqLayout { WQ_KN = 0, WQ_NK = 1, WQ_INT4 = 2 };

#define WQ_BK 64            // stored K rows per stage
#define WQ_COLS 128         // output columns (weight columns) of a tile
#define WQ_SMEM_MAX 232448  // dynamic shared memory a block may use (227 KB)

template <int LAYOUT, int XN>
struct WqCfg {
  static constexpr int HALVES = LAYOUT == WQ_INT4 ? 2 : 1;
  static constexpr int CONSUMERS = 256;
  // the producer: one warp, or (XN 256) a warpgroup that hands its
  // registers to the consumers (setmaxnreg: 128 accumulators a thread)
  static constexpr bool WIDE = XN == 256;
  static constexpr int THREADS = CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int X_BYTES = XN * WQ_BK * 2;  // one x tile, 128-byte rows
  static constexpr int RAW_BYTES = WQ_COLS * WQ_BK;
  static constexpr int STAGE_BYTES = HALVES * X_BYTES + RAW_BYTES;
  static constexpr int ST = XN == 16 ? 8 : (WIDE && HALVES == 2 ? 3 : 4);  // ring stages
  static constexpr int RING = ST * STAGE_BYTES;
  static constexpr int LDS = WQ_COLS + 8;    // floats a row of the split-K sums
  static constexpr int SUMS = XN * LDS * 4;  // the sums reuse the ring
  static constexpr int BODY = ((RING > SUMS ? RING : SUMS) + 1023) / 1024 * 1024;
  // 1024 bytes of alignment slack, the ring (then the sums), the barriers
  static constexpr int BYTES = 1024 + BODY + 256;
  static constexpr int MIN_BLOCKS = XN == 16 ? 2 : 1;  // CTAs an SM (_wq_gemm.py)
  static_assert(BYTES * MIN_BLOCKS <= WQ_SMEM_MAX, "shared memory");
  static_assert(X_BYTES % 1024 == 0 && RAW_BYTES % 1024 == 0, "tiles 1024-byte aligned");
};

template <int XN>
__device__ __forceinline__ void wq_mma(float* acc, const uint32_t* a, uint64_t db) {
  if constexpr (XN == 16) wgmma_rs_n16(acc, a, db);
  else if constexpr (XN == 64) wgmma_rs_n64<0>(acc, a, db);
  else if constexpr (XN == 128) wgmma_rs_n128<0>(acc, a, db);
  else if constexpr (XN == 136) wgmma_rs_n136(acc, a, db);
  else wgmma_rs_n256(acc, a, db);
}

// Two int8 weights (bytes I and J of the word w ^ 0x80808080) as a bf16 pair.
template <int I, int J>
__device__ __forceinline__ uint32_t wq_s8_pair(uint32_t wx, uint32_t magic) {
  return pack_int_bf16x2(s8_at<I>(wx, magic), s8_at<J>(wx, magic));
}

// The same with the bytes picked by prmt selectors in registers (s8_at's
// 0x7440 | byte).
__device__ __forceinline__ uint32_t wq_s8_pair_sel(uint32_t wx, uint32_t magic, uint32_t s0,
                                                   uint32_t s1) {
  return pack_int_bf16x2(__uint_as_float(__byte_perm(wx, magic, s0)) - 8388736.f,
                         __uint_as_float(__byte_perm(wx, magic, s1)) - 8388736.f);
}

// The A fragments of one unit (4 steps of 16 of a stage; int4: unit 0 of a
// stage its low nibbles, unit 1 its high ones) for warp w of warpgroup wg,
// from the stage's raw tile. int4 reads the tile at unit 0 and keeps the
// ldmatrix words in `held` for unit 1.
template <int LAYOUT>
__device__ __forceinline__ void wq_load(uint32_t (*a)[4], uint32_t (&held)[2][4],
                                        const uint8_t* raw, int half, int wg, int w, int lane,
                                        uint32_t magic) {
  if constexpr (LAYOUT == WQ_NK) {
    const int g = lane >> 2, t = lane & 3;
    const uint32_t s0 = 0x7440u | (2 * (t & 1)), s1 = s0 + 1;  // the pair's bytes in its word
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const int r = wg * 64 + 16 * w + g + 8 * h;
      const uint8_t* row = raw + r * WQ_BK + 4 * (t >> 1);
      const int sw = (r >> 1) & 3;  // the 64-byte swizzle
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint8_t* c = row + ((st ^ sw) << 4);
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(c) ^ 0x80808080u;
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(c + 8) ^ 0x80808080u;
        a[st][h] = wq_s8_pair_sel(lo, magic, s0, s1);
        a[st][2 + h] = wq_s8_pair_sel(hi, magic, s0, s1);
      }
    }
  } else {
    const int c = wg * 4 + w;  // the warp's 16 columns: one 16-byte chunk of a row
    if (LAYOUT == WQ_KN || half == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)  // steps 2j, 2j + 1: K rows 32j + lane, 128-byte swizzle
        ldsm_x4_trans(held[j], reinterpret_cast<const bf16*>(raw + (32 * j + lane) * 128 +
                                                             ((c ^ (lane & 7)) << 4)));
    }
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const uint32_t r0 = held[st >> 1][2 * (st & 1)];  // k 0-7 of the step
      const uint32_t r1 = held[st >> 1][2 * (st & 1) + 1];  // k 8-15
      if constexpr (LAYOUT == WQ_KN) {
        const uint32_t x0 = r0 ^ 0x80808080u, x1 = r1 ^ 0x80808080u;
        a[st][0] = wq_s8_pair<0, 2>(x0, magic);
        a[st][1] = wq_s8_pair<1, 3>(x0, magic);
        a[st][2] = wq_s8_pair<0, 2>(x1, magic);
        a[st][3] = wq_s8_pair<1, 3>(x1, magic);
      } else if (half == 0) {  // shift 0 / 8: low nibbles of rows g / g + 8
        a[st][0] = s4_pair<0>(r0);
        a[st][1] = s4_pair<8>(r0);
        a[st][2] = s4_pair<0>(r1);
        a[st][3] = s4_pair<8>(r1);
      } else {  // 4 / 12: high nibbles
        a[st][0] = s4_pair<4>(r0);
        a[st][1] = s4_pair<12>(r0);
        a[st][2] = s4_pair<4>(r1);
        a[st][3] = s4_pair<12>(r1);
      }
    }
  }
}

// A float4 of another rank's shared memory.
__device__ __forceinline__ float4 ld_cluster_f32x4(const float* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_addr(p)), "r"((uint32_t)rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The split-K epilogue: rank `rank` of `cs` adds every rank's sums (XN x
// WQ_COLS fp32 in shared memory, LDS floats a row; rank order) for its
// share of the tile's rows of x below M, scales, casts and stores. A thread
// keeps 4 columns (their scales loaded once) and loads every rank's values
// before it adds them. Between two cluster barriers.
template <int XN, int LDS, int THREADS>
__device__ __forceinline__ void wq_cluster_epilogue(const float* sums,
                                                    const float* __restrict__ s,
                                                    bf16* __restrict__ out, int M, int N, int m0,
                                                    int n0, int rank, int cs) {
  constexpr int C4 = WQ_COLS / 4;
  static_assert(THREADS % C4 == 0, "a thread's columns stay the same");
  const int total = min(XN, M - m0) * C4;
  const int per = (total + cs - 1) / cs;
  const int lo = rank * per, hi = min(total, lo + per);
  const int c = ((lo + (int)threadIdx.x) % C4) * 4, n = n0 + c;
  if (n >= N) return;
  const float4 sc = make_float4(s[n], s[n + 1], s[n + 2], s[n + 3]);
  for (int e = lo + (int)threadIdx.x; e < hi; e += THREADS) {
    const float* p = &sums[(e / C4) * LDS + c];
    float4 a[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < cs) a[q] = ld_cluster_f32x4(p, q);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < cs) {
        v.x += a[q].x;
        v.y += a[q].y;
        v.z += a[q].z;
        v.w += a[q].w;
      }
    }
    *reinterpret_cast<uint2*>(out + (size_t)(m0 + e / C4) * N + n) =
        make_uint2(pack_f32_bf16x2(v.x * sc.x, v.y * sc.y),
                   pack_f32_bf16x2(v.z * sc.z, v.w * sc.w));
  }
}

// x map: (K, M) bf16, box 64 x XN, 128-byte swizzle. w map: int8 (K, N) and
// int4: (N, Ks) bytes, box 128 x 64, 128-byte swizzle; int8 (N, K): (K, N)
// bytes, box 64 x 128, 64-byte swizzle. kst: stages of each rank but the
// last. Cluster 1: a 1-D grid of persistent CTAs over every tile; else a
// grid of (column tiles x cluster, row tiles), one tile a cluster.
template <int LAYOUT, int XN>
__global__ void __launch_bounds__(WqCfg<LAYOUT, XN>::THREADS, WqCfg<LAYOUT, XN>::MIN_BLOCKS)
    wq_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ s,
                    bf16* __restrict__ out, int M, int K, int N, int kst) {
  using C = WqCfg<LAYOUT, XN>;
  constexpr int ST = C::ST, NACC = XN / 2;
  extern __shared__ uint8_t wq_smem[];
  uint8_t* base = wq_smem + ((1024u - (smem_addr(wq_smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BODY);
  uint64_t* empty = full + ST;
  float* sums = reinterpret_cast<float*>(base);

  const int rank = cluster_rank(), cs = cluster_size();
  const int stages = (LAYOUT == WQ_INT4 ? K / 2 : K) / WQ_BK;
  const int sbeg = rank * kst;
  const int nst = min(stages, sbeg + kst) - sbeg;  // >= 1: the plan leaves no rank empty
  const int row_tiles = (M + XN - 1) / XN;
  const int tiles = cs > 1 ? 1 : (N + WQ_COLS - 1) / WQ_COLS * row_tiles;
  const int first = cs > 1 ? 0 : (int)blockIdx.x, stride = cs > 1 ? 1 : (int)gridDim.x;
  // a tile's first output column and row of x
  auto tile_n0 = [&](int tile) {
    return (cs > 1 ? (int)blockIdx.x / cs : tile / row_tiles) * WQ_COLS;
  };
  auto tile_m0 = [&](int tile) { return (cs > 1 ? (int)blockIdx.y : tile % row_tiles) * XN; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto xtile = [&](int st, int hf) { return base + st * C::STAGE_BYTES + hf * C::X_BYTES; };
  auto rawtile = [&](int st) { return base + st * C::STAGE_BYTES + C::HALVES * C::X_BYTES; };

  if (warp >= 8) {  // the producer: one thread issues every copy, tile after tile
    if constexpr (C::WIDE) setmaxnreg_dec<56>();
    if (warp == 8 && lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;  // stages issued so far
      for (int tile = first; tile < tiles; tile += stride) {
        const int n0 = tile_n0(tile), m0 = tile_m0(tile);
        for (int i = 0; i < nst; ++i, ++it) {
          const int st = it % ST, k0 = (sbeg + i) * WQ_BK;
          if (it >= ST) mbar_wait(empty + st, ((it / ST) - 1) & 1);
          mbar_expect_tx(full + st, C::STAGE_BYTES);
          tma_load_2d(xtile(st, 0), &xmap, full + st, k0, m0);
          if constexpr (LAYOUT == WQ_INT4)
            tma_load_2d(xtile(st, 1), &xmap, full + st, K / 2 + k0, m0);
          if constexpr (LAYOUT == WQ_NK)
            tma_load_2d(rawtile(st), &wmap, full + st, k0, n0);
          else
            tma_load_2d(rawtile(st), &wmap, full + st, n0, k0);
        }
      }
    }
    __syncwarp();
  } else {
    if constexpr (C::WIDE) setmaxnreg_inc<224>();
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int c0 = wg * 64 + 16 * w;  // the warp's first column of the tile
    const uint32_t magic = gt_magic();
    float acc[NACC];
    uint32_t f0[4][4], f1[4][4];  // two units' fragments
    uint32_t held[2][4];          // int4: a stage's ldmatrix words
    int it0 = 0;  // stages of the ring consumed before this tile
    const int units = nst * C::HALVES;
    auto load = [&](int u, uint32_t(*f)[4]) {
      const int gs = it0 + u / C::HALVES;
      if (u % C::HALVES == 0) mbar_wait(full + gs % ST, (gs / ST) & 1);
      wq_load<LAYOUT>(f, held, rawtile(gs % ST), u % C::HALVES, wg, w, lane, magic);
    };
    // unit u's products on `cur`; then, once unit u - 1's are done (`nxt`
    // free; a stage whose last unit that was goes back to the producer),
    // unit u + 1's fragments into `nxt` while unit u's products run
    auto step = [&](int u, uint32_t(*cur)[4], uint32_t(*nxt)[4]) {
      const int gs = it0 + u / C::HALVES;
      reg_fence<16>(&cur[0][0]);
      reg_fence<NACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wq_mma<XN>(acc, cur[kk], wgmma_desc128(xtile(gs % ST, u % C::HALVES) + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence<NACC>(acc);
      reg_fence<16>(&nxt[0][0]);
      if (u > 0 && u % C::HALVES == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (gs - 1) % ST);
      }
      if (u + 1 < units) load(u + 1, nxt);
    };

    for (int tile = first; tile < tiles; tile += stride, it0 += nst) {
      const int n0 = tile_n0(tile), m0 = tile_m0(tile);
      // this thread's two columns (fragment rows g, g + 8): int8 (K, N) and
      // int4 2g, 2g + 1; int8 (N, K) g, g + 8
      const int na = n0 + c0 + (LAYOUT == WQ_NK ? g : 2 * g);
      const int nb = na + (LAYOUT == WQ_NK ? 8 : 1);
      const float sa = cs == 1 && na < N ? s[na] : 0.f, sb = cs == 1 && nb < N ? s[nb] : 0.f;
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      load(0, f0);
      for (int u = 0; u < units; u += 2) {
        step(u, f0, f1);
        if (u + 1 < units) step(u + 1, f1, f0);
      }
      wgmma_wait<0>();
      reg_fence<NACC>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (it0 + nst - 1) % ST);
      // acc[4j + e]: fragment row 16w + g (+ 8 for e >= 2), x row 8j + 2t + (e & 1)
      if (cs == 1) {  // scale, cast and store from registers
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j) {
          const int m = m0 + 8 * j + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (m + e >= M) continue;
            bf16* o = out + (size_t)(m + e) * N;
            if constexpr (LAYOUT == WQ_NK) {
              if (na < N) o[na] = f2bf(acc[4 * j + e] * sa);
              if (nb < N) o[nb] = f2bf(acc[4 * j + 2 + e] * sb);
            } else if (na < N) {
              *reinterpret_cast<uint32_t*>(o + na) =
                  pack_f32_bf16x2(acc[4 * j + e] * sa, acc[4 * j + 2 + e] * sb);
            }
          }
        }
      } else {  // the sums as [x row][column], for the cluster's epilogue
        named_bar_sync(1, C::CONSUMERS);  // every product has read the ring
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j) {
          const int m = 8 * j + 2 * t;
          if constexpr (LAYOUT == WQ_NK) {
            sums[m * C::LDS + c0 + g] = acc[4 * j];
            sums[(m + 1) * C::LDS + c0 + g] = acc[4 * j + 1];
            sums[m * C::LDS + c0 + g + 8] = acc[4 * j + 2];
            sums[(m + 1) * C::LDS + c0 + g + 8] = acc[4 * j + 3];
          } else {
            *reinterpret_cast<float2*>(&sums[m * C::LDS + c0 + 2 * g]) =
                make_float2(acc[4 * j], acc[4 * j + 2]);
            *reinterpret_cast<float2*>(&sums[(m + 1) * C::LDS + c0 + 2 * g]) =
                make_float2(acc[4 * j + 1], acc[4 * j + 3]);
          }
        }
      }
    }
  }

  if (cs > 1) {
    cluster_sync_all();
    wq_cluster_epilogue<XN, C::LDS, C::THREADS>(sums, s, out, M, N, tile_m0(0), tile_n0(0), rank,
                                                cs);
    cluster_sync_all();  // every rank has read this CTA's sums
  }
}

// ---------------------------------------------------------------------------
// Host side: the two tensor maps (built per call) and the launch.
// ---------------------------------------------------------------------------
template <int LAYOUT, int XN>
static int wq_launch_tile(const void* x, const void* w, const float* s, bf16* out, int M, int K,
                          int N, int cluster, int kst, int ctas, cudaStream_t st) {
  using C = WqCfg<LAYOUT, XN>;
  CUtensorMap xmap, wmap;
  int err = tma_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, WQ_BK,
                       XN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  if (LAYOUT == WQ_NK)
    err = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, K, WQ_BK, WQ_COLS,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  else
    err = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, LAYOUT == WQ_INT4 ? K / 2 : K, N,
                     WQ_COLS, WQ_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = wq_wgmma_kernel<LAYOUT, XN>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = cluster > 1 ? dim3((N + WQ_COLS - 1) / WQ_COLS * cluster, (M + XN - 1) / XN, 1)
                                : dim3(ctas, 1, 1);
  return cluster_launch(kernel, grid, C::THREADS, cluster, C::BYTES, st, xmap, wmap, s, out, M, K,
                        N, kst);
}

// x (M, K) bf16, w: the layout's int8 bytes, out (M, N) bf16, all three
// 16-byte aligned, s (N,) fp32; stored K rows a multiple of 64, N of 16.
// rows: 64, 128 or 136 rows of x a tile (16: N-major weights at M <= 16);
// cluster: the K split; kst: stages of each rank but the last; ctas: the
// persistent grid of cluster 1 (kernels/ablation/_wq_gemm.py plans all four).
template <int LAYOUT>
inline int wq_launch(const void* x, const void* w, const void* s, void* out, int M, int K, int N,
                     int rows, int cluster, int kst, int ctas, cudaStream_t st) {
  const int ks = LAYOUT == WQ_INT4 ? K / 2 : K;
  if (M < 1 || ks % WQ_BK || N % 16 || cluster < 1 || cluster > 8 || kst < 1 || ctas < 1 ||
      (cluster - 1) * kst >= ks / WQ_BK || cluster * kst < ks / WQ_BK ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 || (uintptr_t)s % 4)
    return (int)cudaErrorInvalidValue;
  const float* sp = (const float*)s;
  bf16* op = (bf16*)out;
  if (rows == 256)
    return wq_launch_tile<LAYOUT, 256>(x, w, sp, op, M, K, N, cluster, kst, ctas, st);
  if (rows == 136)
    return wq_launch_tile<LAYOUT, 136>(x, w, sp, op, M, K, N, cluster, kst, ctas, st);
  if (rows == 128)
    return wq_launch_tile<LAYOUT, 128>(x, w, sp, op, M, K, N, cluster, kst, ctas, st);
  if (rows == 64) return wq_launch_tile<LAYOUT, 64>(x, w, sp, op, M, K, N, cluster, kst, ctas, st);
  if constexpr (LAYOUT == WQ_NK) {
    if (rows == 16 && M <= 16)
      return wq_launch_tile<LAYOUT, 16>(x, w, sp, op, M, K, N, cluster, kst, ctas, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The most clusters of `cluster` CTAs of the tile (LAYOUT, rows) the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
template <int LAYOUT, int XN>
static int wq_max_clusters_tile(int cluster, int* out) {
  using C = WqCfg<LAYOUT, XN>;
  auto kernel = wq_wgmma_kernel<LAYOUT, XN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64, 1, 1);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}

template <int LAYOUT>
inline int wq_max_clusters(int rows, int cluster, int* out) {
  if (rows == 256) return wq_max_clusters_tile<LAYOUT, 256>(cluster, out);
  if (rows == 136) return wq_max_clusters_tile<LAYOUT, 136>(cluster, out);
  if (rows == 128) return wq_max_clusters_tile<LAYOUT, 128>(cluster, out);
  if (rows == 64) return wq_max_clusters_tile<LAYOUT, 64>(cluster, out);
  if constexpr (LAYOUT == WQ_NK) {
    if (rows == 16) return wq_max_clusters_tile<LAYOUT, 16>(cluster, out);
  }
  return (int)cudaErrorInvalidValue;
}
