// int8 weight-only GEMV for single-token decode, with fused epilogues.
//
// Replaces the weight streams of the TPU kernel
// paligemma_tpu/kernels/decode_layer.py:_kernel_all (the int8 qkv, o-proj,
// gate/up and down dots with their per-channel scales) and serves the int8
// LM-head logits of paligemma_tpu/models/gemma.py:lm_head on the logits path.
//
//   out(B, N) = cast_bf16((x(B, K) . w8(K, N)) fp32 * s(N))      mode 0
//   out       = cast_bf16(residual + cast_bf16(...))              mode 1
//   out(B, I) = cast_bf16(gelu_tanh(g_j) * u_j), N = 2I,          mode 2
//               g_j = column j, u_j = column I + j (fused gateup)
//   out(B, N) = (x . w8) fp32 * s, written as fp32                mode 3
//   q, K / V rows = rope_kv(cast_bf16(...)), N = (H + 2) D        mode 4
//
// With a norm (pg_int8_gemv_fused, modes 0-2 and 4) x is replaced by its
// Gemma RMSNorm y = bf16((x * r) * (1 + w)) in the tile's prologue
// (gemv_tile.cuh, gt_norm_stage), as the TPU kernel normalizes in the
// kernel that streams the weights (decode_layer.py:_kernel_all, rmsnorm of
// x by in_norm_ref before the qkv dot and of h by post_norm_ref before the
// gate/up dot).
//
// Mode 4 is the qkv projection with the TPU kernel's RoPE and the fresh
// K/V rows (decode_layer.py:_kernel_all, the half-split rotation of q and
// k; decode_layer_paged.py:_kernel_paged, whose caller writes the fresh row
// into its page slot) in its epilogue: column j of head h (j < D/2) pairs
// with column j + D/2 of the same head. A tile covers 64 pairs, as GeGLU's
// covers 64 gate | up pairs: quads g < 4 read the pairs' first columns
// (h D + j0 + 16 g), quads g >= 4 their partners (D/2 % 16 == 0, so a
// quad's 16 columns lie in one head's half), and each cluster rank takes
// whole pairs. A column's sum order is the plan's of (K, N), as in mode 0,
// so the cast values have mode 0's bits. The epilogue rotates q and k in
// fp32 on the bf16 values (v is copied), writes q (B, H, D), and writes
// k and v into row pos[b] of their cache (dense: row b S + pos; paged: slot
// table[b, pos / ps] ps + pos % ps of the layer's pool, page 0 the
// garbage page) and into k_new / v_new.
//
// One launch per GEMV: the product runs on the tensor cores over the
// shared tile of gemv_tile.cuh, K is split over the CTAs of a thread-block
// cluster and reduced through distributed shared memory, and the epilogue
// of the mode runs in the same kernel. kernels/gemv_plan.py fixes the
// split: the cluster size and each CTA's K range, from (K, N) alone.
//
// The LoRA expand (pg_int8_gemv_lora, modes 0-2) of the TPU kernel's
// in-kernel multi-LoRA (paligemma_tpu/kernels/decode_layer.py _kernel_all
// with lora=True) runs in the same epilogue: after the cluster reduction the
// rank that owns column j adds each row's adapter delta d(b, j) = sum_g
// z(b, zoff(j) + g) * B(g, j) in fp32 (g in order), with z (B, nz) the
// masked adapter basis of kernels/lora (csrc/lora.cu) and B (G, N) the
// alpha-folded adapter rows, fp32 or bf16, each element rounded to bf16 as
// the TPU kernel casts its operands. It is added where the TPU kernel adds
// it:
//   mode 0 (qkv):     out = cast(cast(acc * s) + cast(d))
//   mode 1 (o, down): out = cast(cast(residual + cast(acc * s)) + cast(d))
//   mode 2 (gate/up): g = acc_g * s_g + d_g, u = acc_u * s_u + d_u in fp32,
//                     before the GeGLU
// A column reads only its own target's G rows of z: zoff(j) = G times the
// number of target boundaries seg1 <= seg2 at or below j (q | k | v for
// qkv, gate | up for gateup, one target for o and down). At its start the
// CTA copies its rank's columns of B and the tile's rows of z (LE_GC
// adapter rows of each) into shared memory with cp.async that skip L1, so
// the copies are in flight during the weight stream and each B element is
// read once per 8 rows of x; the deltas go to the shared memory the warps'
// sums used. With a zero delta a column has the bits of the fused epilogue.
//
// Mode 3, the fp32 partial, serves the tensor-parallel decode: it replaces
// the o-proj partial of paligemma_tpu/kernels/decode_layer_tp.py:_attn_kernel
// and the down-proj partial of paligemma_tpu/kernels/decode_mlp.py:_kernel
// under out_dtype=float32. Each rank's partial leaves here uncast; the ranks'
// sum is cast once after the all-reduce, so on one rank the result has the
// bits of mode 1's cast-then-add.
//
// Mode 3 with the LoRA expand (pg_int8_gemv_lora) is a tensor-parallel
// rank's o or down partial under a multi-LoRA bank, the function the JAX
// package leaves to XLA under GSPMD (paligemma_tpu/runtime/serving.py, the
// mesh's multi-LoRA tick): out is (B, 2N) fp32, [acc * s | d], the base
// partial beside the delta partial d = z_r . B of the rank's masked basis
// z_r (kernels/lora at the rank's K rows). Both halves are summed across
// ranks in one all-reduce and the caller adds them as mode 1 does:
// h = cast(cast(h + cast(sum base)) + cast(sum d)), so on one rank the
// result has the bits of mode 1 with the expand.
//
// The fp32 form (T = float, pg_int8_gemv_fp32; --dtype float32) takes every
// mode, the expand included: the tile's sums are gemv_tile_sums_f32's, z is
// fp32 (csrc/lora.cu's fp32 form), an fp32 B is read as it is, the delta is
// the same in-order fp32 sum over g, and every cast above is the identity
// (mode 0: acc * s + d; mode 1: (residual + acc * s) + d). Mode 3 keeps the
// plan and the rank-order cluster sum, so it has mode 0's bits at fp32 too,
// and one rank's [base | delta] added as (h + base) + delta has mode 1's.
// The expand's staging grows by z's fp32 rows (3 KB) beside the tile's
// static 36 KB; the fp32 prologue stages nothing, so the two never meet.
//
// Mode 4 over a KV cache of the other dtype (the engines' cache_dtype; C,
// the cache type, beside T: pg_int8_gemv_rope_kv_cache_fp32 with bf16 x,
// pg_int8_gemv_fp32_rope_kv_cache_bf16 with fp32 x): q and the rotation
// are T's as above; the K / V rows and k_new / v_new take C, each value
// cast to T first and then converted, as the TPU kernel returns
// k_new.astype(cache dtype) of the activation-dtype row
// (decode_layer.py:307-308): a bf16 row widened to fp32 (exact), an fp32
// row rounded to bf16 (nearest even, as torch's .to(torch.bfloat16)).
//
// What bounds it: at decode batches each weight byte is used B times, far
// below the ~295 flop/byte where the card turns compute-bound, so it is
// bound by reading w8 from device memory (110 MB per layer of Gemma-2B:
// 32.9 us at 3.35 TB/s; a rank-8 bank of 3 fp32 adapters adds B's 4.9 MB).
// The design keeps three 16-row steps of 16-byte
// weight loads in flight per warp and the plan puts ~16 warps on every SM
// (the rate follows the resident warps, not the depth of the pipeline),
// spends ~3 instructions per weight byte (the conversion; the products are
// 8 mma.sync per 2 KB), reads each weight byte once per 8 rows of x, and
// writes no partials to device memory.
#pragma once

#include <type_traits>

#include "gemv_tile.cuh"

#define LE_GC 32  // adapter rows of B staged at a time

struct LoraExpand {
  const void* z;   // (B, nz) masked adapter basis, in the activation type
  const void* lb;  // (G, N) adapter rows, fp32 (lb_f32) or bf16
  int lb_f32, G, nz, seg1, seg2;

  // the target of weight column col: its block of z
  __device__ __forceinline__ int target(int col) const { return (col >= seg1) + (col >= seg2); }
};

// The expand's operands of LE_GC adapter rows, in dynamic shared memory:
// B's rows for the rank's columns in B's dtype (ldb bytes a row, 16-byte
// aligned), then the tile's rows of z (z_bytes each: the activation type,
// LE_GC per target).
__host__ __device__ __forceinline__ int lora_ldb(int ncols, int b_f32) {
  return (ncols * (b_f32 ? 4 : 2) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int lora_stage_bytes(int ldb, int z_bytes) {
  return LE_GC * ldb + GT_BT * 3 * LE_GC * z_bytes;
}

// The weight columns of a rank's share of a tile's epilogue: cc < width
// is output column col0 + cc and, with GeGLU, cc >= width the up column
// up0 + cc - width; with RoPE (half > 0) col0 is the share's first pair,
// cc < width the pair col0 + cc's first column and cc >= width the pair
// col0 + cc - width's second (D/2 = half columns on).
struct EpiCols {
  int col0, up0, width, half, hd;

  // pair p's first column: j = p % half of head p / half
  __device__ __forceinline__ int pair_col(int p) const { return (p / half) * hd + p % half; }

  __device__ __forceinline__ int col(int cc) const {
    if (half > 0) return cc < width ? pair_col(col0 + cc) : pair_col(col0 + cc - width) + half;
    return cc < width ? col0 + cc : up0 + cc - width;
  }
};

// Start copying rows g0 .. g0 + LE_GC of the expand's operands: 16-byte
// cp.async that skip L1 (where the GEMV's x lives) wherever the rank's
// column ranges are 16-byte aligned (every plan at Gemma-2B's shapes; with
// RoPE each 16-byte piece's pairs lie in one head's half), else 4-byte ones
// (fp32) or plain loads (bf16). One commit group; columns past N read as
// zeros. T: z's type (the activation type).
template <class T>
__device__ __forceinline__ void lora_prefetch(uint8_t* st, int ldb, const LoraExpand& lora,
                                              int g0, int b0, int nb, const EpiCols& cols,
                                              int nt, int N) {
  const int width = cols.width;
  const int gn = min(LE_GC, lora.G - g0), ncols = nt * width, nz_t = lora.nz / lora.G;
  const int esize = lora.lb_f32 ? 4 : 2, per16 = 16 / esize;  // elements per 16 bytes
  const uint8_t* lb = (const uint8_t*)lora.lb;
  const bool aligned =
      (uintptr_t)lb % 16 == 0 && N % per16 == 0 && cols.col0 % per16 == 0 &&
      width % per16 == 0 &&
      (cols.half > 0 ? cols.half % per16 == 0 : (nt == 1 || cols.up0 % per16 == 0));
  if (aligned) {
    const int chunks = ncols / per16;  // 16-byte pieces of a row
    for (int i = threadIdx.x; i < gn * chunks; i += blockDim.x) {
      const int g = i / chunks, cc = (i % chunks) * per16;
      const int col = cols.col(cc);
      cp_async_16(st + g * ldb + cc * esize,
                  lb + ((size_t)(g0 + g) * N + min(col, N - per16)) * esize, col < N);
    }
  } else {
    for (int i = threadIdx.x; i < gn * ncols; i += blockDim.x) {
      const int g = i / ncols, cc = i % ncols;
      const int col = cols.col(cc);
      const size_t at = (size_t)(g0 + g) * N + min(col, N - 1);
      if (lora.lb_f32)
        cp_async_4(st + g * ldb + cc * 4, (const float*)lora.lb + at, col < N);
      else
        reinterpret_cast<bf16*>(st + g * ldb)[cc] =
            col < N ? ((const bf16*)lora.lb)[at] : __float2bfloat16(0.f);
    }
  }
  T* zs = reinterpret_cast<T*>(st + LE_GC * ldb);
  constexpr int ZV = 16 / sizeof(T);  // z elements in 16 bytes
  const int zchunks = gn / ZV;        // G % 8 == 0: 16-byte pieces of each target's block
  for (int i = threadIdx.x; i < nb * nz_t * zchunks; i += blockDim.x) {
    const int r = i / (nz_t * zchunks), t = (i / zchunks) % nz_t, c = (i % zchunks) * ZV;
    cp_async_16(&zs[(r * 3 + t) * LE_GC + c],
                (const T*)lora.z + (size_t)(b0 + r) * lora.nz + t * lora.G + g0 + c, true);
  }
  cp_async_commit();
}

// Column cc's deltas of rows r0, r0 + rstep, ... (ROWS of them at most)
// over the staged adapter rows g < gn, added in g order to ds (first: from
// 0): B is read, and cast to the activation type T as the TPU kernel casts
// its operands (bf16: fp32 B rounded; fp32: as it is), once for those rows.
template <int ROWS, class T>
__device__ __forceinline__ void lora_column(float* ds, const uint8_t* st, const T* zt,
                                            int ldb, int cc, int r0, int rstep, int nb, int gn,
                                            bool first, bool b_f32) {
  float d[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i * rstep;
    d[i] = first || r >= nb ? 0.f : ds[r * GT_COLS + cc];
  }
#pragma unroll 4
  for (int g = 0; g < gn; ++g) {
    const uint8_t* row = st + g * ldb;
    const float bv = b_f32 ? to_f32(from_f32<T>(reinterpret_cast<const float*>(row)[cc]))
                           : bf2f(reinterpret_cast<const bf16*>(row)[cc]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = r0 + i * rstep;
      if (r < nb) d[i] = fmaf(to_f32(zt[r * 3 * LE_GC + g]), bv, d[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i * rstep;
    if (r < nb) ds[r * GT_COLS + cc] = d[i];
  }
}

// The adapter deltas of this rank's columns, into ds[r][cc] (GT_COLS per
// row, cc as in EpiCols), each summed over g in order: a thread takes a
// column and every rstep-th row of the tile (rstep: the CTA's threads per
// column). The first LE_GC rows were prefetched at the kernel's start;
// later ones are copied here. Uses sm.red (free after the cluster barrier
// that follows the tile's sums); ends with a CTA barrier.
template <class T>
__device__ __forceinline__ const float* lora_deltas(GemvSmem& sm, uint8_t* st, int ldb,
                                                    const LoraExpand& lora, int b0, int nb,
                                                    const EpiCols& cols, int nt, int N) {
  float* ds = &sm.red[0][0][0];  // [GT_BT][GT_COLS]
  const T* zs = reinterpret_cast<const T*>(st + LE_GC * ldb);
  const int ncols = nt * cols.width;
  const int rstep = ncols > 0 ? max(1, (int)blockDim.x / ncols) : 0;
  const int rows = rstep > 0 ? (GT_BT + rstep - 1) / rstep : 0;  // per thread
  for (int g0 = 0; g0 < lora.G; g0 += LE_GC) {
    const int gn = min(LE_GC, lora.G - g0);
    if (g0 > 0) {
      __syncthreads();  // the previous rows are no longer read
      lora_prefetch<T>(st, ldb, lora, g0, b0, nb, cols, nt, N);
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int item = threadIdx.x; item < ncols * rstep; item += blockDim.x) {
      const int cc = item % ncols, r0 = item / ncols;
      const int col = cols.col(cc);
      const T* zt = zs + (col < N ? lora.target(col) : 0) * LE_GC;
      const bool f32 = lora.lb_f32;
      if (rows == 1)
        lora_column<1>(ds, st, zt, ldb, cc, r0, rstep, nb, gn, g0 == 0, f32);
      else if (rows == 2)
        lora_column<2>(ds, st, zt, ldb, cc, r0, rstep, nb, gn, g0 == 0, f32);
      else if (rows <= 4)
        lora_column<4>(ds, st, zt, ldb, cc, r0, rstep, nb, gn, g0 == 0, f32);
      else
        lora_column<GT_BT>(ds, st, zt, ldb, cc, r0, rstep, nb, gn, g0 == 0, f32);
    }
  }
  __syncthreads();
  return ds;
}

// The operands of mode 4's epilogue: RoPE on q and k in the activation
// type T, the fresh K/V rows in the cache type C (T, or the other dtype).
template <class T, class C = T>
struct RopeKVT {
  const T* cos;      // (B, D)
  const T* sin;      // (B, D)
  const int* pos;    // (B,) the token's position
  C* kdst;           // dense: (B, rows, D) layer cache; paged: (n_pages, rows, D) pool
  C* vdst;
  C* knew;           // (B, D)
  C* vnew;
  const int* table;  // (B, tstride) page table; null: dense rows
  int H, D, rows, tstride;  // rows: S (dense) or the page size
};
using RopeKV = RopeKVT<bf16>;

// Pair (col, col + D/2) of row b (j = col % D < D/2 of head col / D):
// its cos and sin, loaded before the pair's cluster sums so that the loads
// overlap them.
struct RopeIn {
  float c1, c2, s1, s2;
};

template <class T, class C>
__device__ __forceinline__ RopeIn rope_load(const RopeKVT<T, C>& rp, int b, int col) {
  const int half = rp.D / 2;
  const size_t cb = (size_t)b * rp.D + col % rp.D;
  return RopeIn{to_f32(rp.cos[cb]), to_f32(rp.cos[cb + half]), to_f32(rp.sin[cb]),
                to_f32(rp.sin[cb + half])};
}

// A value of the activation type T in the cache type C: itself, or
// converted (bf16 -> fp32 exact, fp32 -> bf16 to nearest even).
template <class C, class T>
__device__ __forceinline__ C to_cache(T v) {
  if constexpr (std::is_same<C, T>::value)
    return v;
  else
    return from_f32<C>(to_f32(v));
}

// The pair, cast (v1, v2): rotate (q and k heads), then write q, or k / v
// into the cache row of position pos (dense row b * rows + pos, or the
// slot of the page table) and into k_new / v_new, in the cache type. The
// rotation is the plain version's: o1 = x1 c1 - x2 s1, o2 = x2 c2 + x1 s2
// in fp32, each product rounded, the result cast to T.
template <class T, class C>
__device__ __forceinline__ void rope_write(const RopeKVT<T, C>& rp, T* q, int b, int col, T v1,
                                           T v2, const RopeIn& cs, int pos) {
  const int half = rp.D / 2, h = col / rp.D, j = col % rp.D;
  float o1 = to_f32(v1), o2 = to_f32(v2);
  if (h <= rp.H) {
    const float x1 = o1, x2 = o2;
    o1 = __fadd_rn(__fmul_rn(x1, cs.c1), -__fmul_rn(x2, cs.s1));
    o2 = __fadd_rn(__fmul_rn(x2, cs.c2), __fmul_rn(x1, cs.s2));
  }
  if (h < rp.H) {
    T* qo = q + ((size_t)b * rp.H + h) * rp.D + j;
    qo[0] = from_f32<T>(o1);
    qo[half] = from_f32<T>(o2);
    return;
  }
  size_t row;
  if (rp.table != nullptr) {
    const int page = rp.table[(size_t)b * rp.tstride + pos / rp.rows];
    row = (size_t)page * rp.rows + pos % rp.rows;
  } else {
    row = (size_t)b * rp.rows + pos;
  }
  const bool kh = h == rp.H;
  C* dst = (kh ? rp.kdst : rp.vdst) + row * rp.D + j;
  C* fresh = (kh ? rp.knew : rp.vnew) + (size_t)b * rp.D + j;
  dst[0] = fresh[0] = to_cache<C>(from_f32<T>(o1));
  dst[half] = fresh[half] = to_cache<C>(from_f32<T>(o2));
}

// v + cast(d): a cast value plus its column's cast LoRA delta, cast (at
// T = float every cast is the identity: v + d)
template <class T>
__device__ __forceinline__ T add_delta(T v, float d) {
  return from_f32<T>(to_f32(v) + to_f32(from_f32<T>(d)));
}

// T: the activation type of x, residual, out (not mode 3), the norm
// weight, cos / sin and the LoRA basis z: bf16, or fp32
// (gemv_tile_sums_f32, every cast the identity). C: the type of mode 4's
// cache rows (T, or the other dtype).
template <class T, bool FAST, bool LORA, bool NORM, class C = T>
__global__ void __launch_bounds__(32 * GT_MAX_WARPS, 2)
    int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ s, const T* __restrict__ residual,
                     void* __restrict__ out, int B, int K, int N, int mode, int k_per_cta,
                     int x8, LoraExpand lora, typename GtNorm<T>::type norm,
                     RopeKVT<T, C> rope) {
  __shared__ GemvSmem sm;
  extern __shared__ __align__(16) uint8_t lora_smem[];  // LORA: lora_stage_bytes(ldb, sizeof(T))
  const int rank = cluster_rank(), cs = cluster_size();
  const int tile = blockIdx.x / cs;
  const int b0 = blockIdx.z * GT_BT;
  const int nb = min(GT_BT, B - b0);
  const int kbeg = rank * k_per_cta;
  const int kend = min(K, kbeg + k_per_cta);
  // tile-local column c is weight column tile * 128 + c, or with GeGLU
  // gate column tile * 64 + c (c < 64) and up column I + tile * 64 + c - 64,
  // or with RoPE pair tile * 64 + c's first column (c < 64) and its second
  const bool pairs = mode == 2 || mode == 4;
  const int inter = N / 2, half = rope.D / 2;
  const int g = (threadIdx.x & 31) >> 2;
  const int tile_out = pairs ? GT_COLS / 2 : GT_COLS;  // output columns (pairs) per tile
  int qcol = tile * GT_COLS + 16 * g;
  if (mode == 2) qcol = (g < 4 ? 0 : inter) + tile * tile_out + 16 * (g & 3);
  if (mode == 4) {
    const int p = tile * tile_out + 16 * (g & 3);
    qcol = p < inter ? (p / half) * rope.D + p % half + (g < 4 ? 0 : half) : N;
  }
  // rank r applies the epilogue to its share of the tile's output columns
  const int n_out = pairs ? inter : N;
  const int per = (tile_out + cs - 1) / cs;
  const int c_lo = rank * per;
  const int width = min(tile_out, c_lo + per) - c_lo;
  const EpiCols cols{tile * tile_out + c_lo, inter + tile * tile_out + c_lo, width,
                     mode == 4 ? half : 0, rope.D};
  const int nt = pairs ? 2 : 1, ldb = lora_ldb(per * nt, lora.lb_f32);
  if constexpr (LORA)  // in flight during the weight stream
    lora_prefetch<T>(lora_smem, ldb, lora, 0, b0, nb, cols, nt, N);
  if constexpr (sizeof(T) == 4)  // x8: x16 for fp32 (gemv_tile_sums_f32)
    gemv_tile_sums_f32<FAST, NORM>(sm, x, w, K, N, b0, nb, qcol, kbeg, kend, x8 != 0, norm);
  else
    gemv_tile_sums<FAST, GT_INT8, NORM>(sm, x, w, K, N, b0, nb, qcol, kbeg, kend, x8 != 0, norm,
                                        k_per_cta + GT_NORM_PAD);
  cluster_sync_all();
  const float* ds = nullptr;
  if constexpr (LORA) ds = lora_deltas<T>(sm, lora_smem, ldb, lora, b0, nb, cols, nt, N);
  // each item's global operands (scales, residual, cos / sin, pos) are
  // loaded before its cluster sums, so that the two latencies overlap
  for (int idx = threadIdx.x; idx < nb * width; idx += blockDim.x) {
    const int r = idx / width, c = c_lo + idx % width;
    const int j = tile * tile_out + c;
    if (j >= n_out) continue;
    const size_t o = (size_t)(b0 + r) * n_out + j;
    if (mode == 4) {
      const int col = cols.pair_col(j);
      const float s1 = s[col], s2 = s[col + half];
      const RopeIn cs_in = rope_load(rope, b0 + r, col);
      const int pos = col / rope.D >= rope.H ? rope.pos[b0 + r] : 0;
      const float2 acc = gt_cluster_sum2(sm, r, c, c + GT_COLS / 2, cs);
      T v1 = from_f32<T>(acc.x * s1), v2 = from_f32<T>(acc.y * s2);
      if constexpr (LORA) {  // as mode 0 adds it, after the cast
        v1 = add_delta<T>(v1, ds[r * GT_COLS + idx % width]);
        v2 = add_delta<T>(v2, ds[r * GT_COLS + width + idx % width]);
      }
      rope_write<T, C>(rope, (T*)out, b0 + r, col, v1, v2, cs_in, pos);
    } else if (mode == 2) {
      // the products rounded before the GeGLU (no FMA contraction), as
      // the TPU kernel rounds them before it adds the LoRA delta
      const float sg = s[j], su = s[inter + j];
      const float2 acc = gt_cluster_sum2(sm, r, c, c + GT_COLS / 2, cs);
      float gate = __fmul_rn(acc.x, sg);
      float up = __fmul_rn(acc.y, su);
      if constexpr (LORA) {
        gate += ds[r * GT_COLS + idx % width];
        up += ds[r * GT_COLS + width + idx % width];
      }
      ((T*)out)[o] = from_f32<T>(gelu_tanh_f(gate) * up);
    } else if (mode == 3) {
      const float sj = s[j];
      if constexpr (LORA) {  // [base | delta], each (B, N)
        const size_t o2 = (size_t)(b0 + r) * 2 * N + j;
        ((float*)out)[o2] = gt_cluster_sum(sm, r, c, cs) * sj;
        ((float*)out)[o2 + N] = ds[r * GT_COLS + idx % width];
      } else {
        ((float*)out)[o] = gt_cluster_sum(sm, r, c, cs) * sj;
      }
    } else {
      const float sj = s[j];
      const float res = mode == 1 ? to_f32(residual[o]) : 0.f;
      T v = from_f32<T>(gt_cluster_sum(sm, r, c, cs) * sj);
      if (mode == 1) v = from_f32<T>(res + to_f32(v));
      if constexpr (LORA) v = add_delta<T>(v, ds[r * GT_COLS + idx % width]);
      ((T*)out)[o] = v;
    }
  }
  cluster_sync_all();  // every rank has read this CTA's sums
}

template <bool LORA, bool NORM, class T = bf16, class C = T>
static int launch_gemv(const void* x, const void* w8, const void* s, const void* residual,
                       void* out, int B, int K, int N, int mode, int cluster, int warps,
                       int k_per_cta, LoraExpand lora, typename GtNorm<T>::type norm,
                       RopeKVT<T, C> rope, void* stream) {
  const bool pairs = mode == 2 || mode == 4;
  const int tiles = pairs ? (N / 2 + GT_COLS / 2 - 1) / (GT_COLS / 2) : (N + GT_COLS - 1) / GT_COLS;
  const dim3 grid(tiles * cluster, 1, (B + GT_BT - 1) / GT_BT);
  const bool fast = N % (pairs ? 32 : 16) == 0 && (uintptr_t)w8 % 16 == 0;
  // 4 elements of x in one load: 8 bytes (bf16), 16 (fp32)
  const int x8 = K % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0;
  auto kernel = &int8_gemv_kernel<T, false, LORA, NORM, C>;
  if (fast) kernel = &int8_gemv_kernel<T, true, LORA, NORM, C>;
  if (warps != 4 && warps != GT_MAX_WARPS) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    // the fp32 prologue reads x and w 16 bytes at a time
    if (NORM && (!x8 || (uintptr_t)norm.w % 16)) return (int)cudaErrorInvalidValue;
  } else {
    // the staged y of the CTA's K range fits the warps' sum buffer
    if (NORM && (K % 8 || (size_t)GT_BT * (k_per_cta + GT_NORM_PAD) * 2 > sizeof(GemvSmem::red)))
      return (int)cudaErrorInvalidValue;
  }
  int smem = 0;
  if constexpr (LORA) {
    // the rank's columns of B, as the kernel sizes them; with the static
    // GemvSmem it may pass the 48 KB default
    const int nt = pairs ? 2 : 1, tile_out = GT_COLS / nt;
    smem = lora_stage_bytes(lora_ldb((tile_out + cluster - 1) / cluster * nt, lora.lb_f32),
                            sizeof(T));
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return cluster_launch(kernel, grid, 32 * warps, cluster, smem, (cudaStream_t)stream,
                        (const T*)x, (const int8_t*)w8, (const float*)s, (const T*)residual, out,
                        B, K, N, mode, k_per_cta, x8, lora, norm, rope);
}

// The mixed forms' entry (pg_int8_gemv_rope_kv_cache_fp32,
// pg_int8_gemv_fp32_rope_kv_cache_bf16): mode 4 with the norm prologue (nw
// not null), and the LoRA expand where z is not null, over a cache of type
// C beside activations of type T. The arguments are pg_int8_gemv_fused's:
// x, residual, out (q), cos, sin, nw and z in T; k_dst, v_dst, k_new and
// v_new in C.
template <class T, class C>
static int launch_rope_kv(const void* x, const void* w8, const void* s, const void* residual,
                          void* out, int B, int K, int N, int mode, int cluster, int warps,
                          int k_per_cta, const void* z, const void* lb, int lb_f32, int G, int nz,
                          int seg1, int seg2, const void* nw, float eps, const void* cos,
                          const void* sin, const void* pos, void* k_dst, void* v_dst,
                          void* k_new, void* v_new, const void* table, int H, int D, int rows,
                          int tstride, void* stream) {
  if (mode != 4 || nw == nullptr || D <= 0 || (D / 2) % 16 || N != (H + 2) * D)
    return (int)cudaErrorInvalidValue;
  if (z != nullptr && (G <= 0 || G % 8 || nz % G || nz / G > 3)) return (int)cudaErrorInvalidValue;
  const LoraExpand lora{z, lb, lb_f32, G, nz, seg1, seg2};
  const typename GtNorm<T>::type norm{(const T*)nw, eps};
  const RopeKVT<T, C> rope{(const T*)cos, (const T*)sin, (const int*)pos, (C*)k_dst, (C*)v_dst,
                           (C*)k_new, (C*)v_new, (const int*)table, H, D, rows, tstride};
  return z != nullptr
             ? launch_gemv<true, true, T, C>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                             warps, k_per_cta, lora, norm, rope, stream)
             : launch_gemv<false, true, T, C>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                              warps, k_per_cta, lora, norm, rope, stream);
}
