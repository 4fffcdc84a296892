// The int8 weight-only GEMV tile on the tensor cores, shared by
// int8_gemv.cuh and decode_head.cu so that the LM head's logits come out
// bit-identical from both kernels (the greedy token of the logits path and
// of the fused argmax path must agree). kernels/gemv_plan.py is the host
// side: it fixes the cluster size and each CTA's K range.
//
// The product is out^T = W^T . x^T on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate): A is 16 weight columns x 16 k, the int8 weights converted to
// bf16 in registers (exact: |q| <= 127 fits bf16's 8-bit significand); B is
// x^T, 16 k x 8 rows of x (one n8 tile holds a batch of up to 8).
//
// Layout. w8 stays (K, N) with N contiguous. A warp covers 128 columns:
// lane (g, t) = (lane / 4, lane % 4) loads 16 bytes (columns 16g .. 16g+15
// of the tile) from each of the rows 4t .. 4t+3 of a 16-row step, so a
// warp reads 128 contiguous bytes of each row (GeGLU: 64 of the gate and
// 64 of the paired up columns). The A fragment wants, for mma row g, k
// pairs {2t, 2t+1} and {2t+8, 2t+9}: inside each step the logical k {2t,
// 2t+1, 2t+8, 2t+9} is relabelled to the physical rows 4t .. 4t+3, and x's
// B fragment (row g of x, k 4t .. 4t+3: one 8-byte load) takes the same
// relabelling, so the sum over k is unchanged. The mma rows are paired with
// the columns the lane loaded: in m-tile m (0..7), mma row g is column
// 16g + 2m and row g + 8 is column 16g + 2m + 1; prmt (__byte_perm) picks
// each byte out of the four row words, so the transpose costs nothing
// beyond the conversion. The accumulators come out as (column 16g + 2m +
// {0, 1}, x row 2t + {0, 1}).
//
// The conversion: (byte ^ 0x80) placed under the exponent of 2^23 is the
// float 2^23 + q + 128; one subtraction gives q exactly, and the upper half
// of that float is q in bf16 (one prmt per pair).
//
// The weight format is a template parameter. GT_INT8 is the above. GT_INT4
// (kernels/ablation/quant4, "K-halves"): the (K/2, N) stored rows hold
// q[k, n] in the low nibble of row k and q[k + K/2, n] in its high nibble,
// both signed. The tile walks the stored rows exactly as int8 rows (the
// same loads, the plan of (K/2, N)); each step feeds two products into the
// same accumulators, the low nibbles against x at k and then the high ones
// against x at k + K/2 (two 8-byte x loads). A prmt pairs two rows' bytes
// of two columns in one word; a nibble pair masked out of it ((v & 0xF) ^ 8
// = q + 8) under bf16's 128 (0x4300) is the bf16 pair 136 + q, and one
// bf16x2 subtraction of 136 gives q exactly: ~1.5 instructions a weight
// (int8: ~2.75).
//
// Split-K: the CTA's W warps (4 or 8) take its 16-row steps in turn (warp
// w: steps w, w + W, ...), each with GT_STAGES steps of loads in flight in
// registers (128 registers a thread: 16 warps fit on an SM); their sums go
// to shared memory and are added in warp order. The CTAs of a cluster take
// consecutive K ranges; after a cluster barrier each rank reads every
// rank's sums for its share of the columns through distributed shared
// memory, adds them in rank order and applies the epilogue. So a sum's
// order is fixed by the plan: no atomics, and a second call gives the same
// bits.
//
// The RMSNorm prologue (NORM; the input and post-attention norms of the
// TPU kernel paligemma_tpu/kernels/decode_layer.py:_kernel_all, which
// normalizes in the kernel that streams the weights): the tile multiplies
// y = bf16((x * r) * (1 + w)), r = rsqrt(mean(x^2) + eps), instead of x.
// Every kernel that reads a normalized row (the GEMV of each plan and the
// LoRA shrink, csrc/lora.cu) must compute y with the same bits, so r must
// not depend on a plan: one warp sums the squares of the whole row in an
// order fixed by K alone (gt_row_rsqrt; the row, 4 KB at K = 2048, is read
// from L2 by every CTA). The CTA first issues its first GT_STAGES steps of
// weight loads, so that HBM streams while r is computed; then its warps
// write y for the CTA's K range into shared memory (the warps' sum buffer,
// free until the K loop ends), and the loop reads x's fragments from there.
//
// fp32 x (--dtype float32; gemv_tile_sums_f32). The weights stay the bf16
// A operand (exact). Each fp32 element of x is split into three bf16 terms,
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each
// difference exact in fp32, so x == hi + mid + lo barring underflow), and
// every step runs the three terms as B operands against the same converted
// weight fragments, into the same fp32 accumulators: a product of two 8-bit
// significands is exact in fp32, so the sum differs from fp32 x . W only in
// the order of its additions. The weight bytes, the plan, the warps' steps
// and the order in which warps and ranks are added are the bf16 tile's, so
// at fp32 too an element's sum depends on (K, N) alone. The cost is three
// mma.sync per A fragment instead of one. The norm prologue at fp32 makes
// y = (x * r) * (1 + w) in fp32, unrounded, at each step (x from L1 / L2
// as it streams; r of every row and w of the CTA's K rows staged in shared
// memory once per CTA, before the loop), and splits y.
#pragma once

#include "common.cuh"

#define GT_MAX_WARPS 8  // warps per CTA: 4 or 8 (kernels/gemv_plan.py)
#define GT_COLS 128     // weight columns of a tile
#define GT_BT 8
#define GT_STAGES 3  // 16-row steps of loads in flight per warp

enum GtFormat { GT_INT8 = 0, GT_INT4 = 1 };  // the weight format of a stored row

#define GT_NORM_PAD 8  // bf16 between two staged rows of y: 4 banks, 2-way reads at most

struct __align__(16) GemvSmem {
  float red[GT_MAX_WARPS][GT_BT][GT_COLS];  // each warp's sums (NORM: y before the K loop)
  float sum[GT_BT][GT_COLS];                // the CTA's sums, read by the cluster
};

// The norm's operands: y = bf16((x * r) * (1 + w)), r = rsqrt(mean(x^2) + eps).
struct NormIn {
  const bf16* w;  // (K,) bf16, 16-byte aligned
  float eps;
};

// 16 weight bytes, streamed: read once, so they are not kept in L1.
__device__ __forceinline__ uint4 ldg_stream16(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ldg_16(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ldg_8(const bf16* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// 0x4B000000 (2^23 as a float) in a register the compiler cannot see
// through: prmt then takes its selector as the immediate, instead of
// holding four selectors in registers.
__device__ __forceinline__ uint32_t gt_magic() {
  uint32_t m;
  asm volatile("mov.b32 %0, 0x4B000000;\n" : "=r"(m));
  return m;
}

// Byte i of the word w ^ 0x80808080 as a float: exactly the int8 value.
template <int I>
__device__ __forceinline__ float s8_at(uint32_t wx, uint32_t magic) {
  return __uint_as_float(__byte_perm(wx, magic, 0x7440 | I)) - 8388736.f;
}

// Two small integral floats as bf16x2 (lo in the low half): their upper
// halves, exact.
__device__ __forceinline__ uint32_t pack_int_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// One 16-row step: rows 4t .. 4t+3 of the lane's 16 columns (wv[r], r the
// row) against NT B fragments of x row g at k 4t .. 4t+3 (b[i]: bf16 x, or
// fp32 x's three bf16 terms), each A fragment against b[0], b[1], ... in
// order, into the 8 m-tiles' accumulators.
template <int NT>
__device__ __forceinline__ void gt_mma_terms(float (&acc)[8][4], const uint4 (&wv)[4],
                                             const uint32_t (&b)[NT][2], uint32_t magic) {
  uint32_t wx[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    wx[r][0] = wv[r].x ^ 0x80808080u;
    wx[r][1] = wv[r].y ^ 0x80808080u;
    wx[r][2] = wv[r].z ^ 0x80808080u;
    wx[r][3] = wv[r].w ^ 0x80808080u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // the m-tiles 2j (bytes 0, 1) and 2j + 1 (bytes 2, 3)
    uint32_t a[4];
    a[0] = pack_int_bf16x2(s8_at<0>(wx[0][j], magic), s8_at<0>(wx[1][j], magic));
    a[1] = pack_int_bf16x2(s8_at<1>(wx[0][j], magic), s8_at<1>(wx[1][j], magic));
    a[2] = pack_int_bf16x2(s8_at<0>(wx[2][j], magic), s8_at<0>(wx[3][j], magic));
    a[3] = pack_int_bf16x2(s8_at<1>(wx[2][j], magic), s8_at<1>(wx[3][j], magic));
#pragma unroll
    for (int i = 0; i < NT; ++i) mma_bf16_16816(acc[2 * j], a, b[i]);
    a[0] = pack_int_bf16x2(s8_at<2>(wx[0][j], magic), s8_at<2>(wx[1][j], magic));
    a[1] = pack_int_bf16x2(s8_at<3>(wx[0][j], magic), s8_at<3>(wx[1][j], magic));
    a[2] = pack_int_bf16x2(s8_at<2>(wx[2][j], magic), s8_at<2>(wx[3][j], magic));
    a[3] = pack_int_bf16x2(s8_at<3>(wx[2][j], magic), s8_at<3>(wx[3][j], magic));
#pragma unroll
    for (int i = 0; i < NT; ++i) mma_bf16_16816(acc[2 * j + 1], a, b[i]);
  }
}

// The step with bf16 x (xv: 4 elements, as gt_load_x packs them).
__device__ __forceinline__ void gt_mma_step(float (&acc)[8][4], const uint4 (&wv)[4], uint2 xv,
                                            uint32_t magic) {
  const uint32_t b[1][2] = {{xv.x, xv.y}};
  gt_mma_terms<1>(acc, wv, b, magic);
}

// x's 4 elements of a step from xp, of which the first nrow exist (the
// rest read as zeros; x8: one 8-byte load).
__device__ __forceinline__ void gt_load_x(uint2& xv, const bf16* __restrict__ xp, bool xrow,
                                          int nrow, bool x8) {
  uint32_t lo = 0u, hi = 0u;
  if (xrow) {
    if (x8 && nrow == 4) {
      const uint2 v = ldg_8(xp);
      lo = v.x;
      hi = v.y;
    } else {
      uint32_t e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = j < nrow ? (uint32_t)__bfloat16_as_ushort(xp[j]) : 0u;
      lo = e[0] | (e[1] << 16);
      hi = e[2] | (e[3] << 16);
    }
  }
  xv = make_uint2(lo, hi);
}

// The loads of one step for a lane: its 4 weight rows from p (the first
// row's 16 columns; rows n1 bytes apart), of which the first nrow exist,
// and x's 4 elements from xp (its first nrow). Rows past kend and columns
// past N read as zeros (FAST: N % 16 == 0 and a 16-byte aligned w8, one
// 16-byte load per row; else byte loads), as do x's elements past kend
// (x8: K % 4 == 0 and x 8-byte aligned).
template <bool FAST>
__device__ __forceinline__ void gt_load_w(uint4 (&wv)[4], const int8_t* __restrict__ p, size_t n1,
                                          int ncol, int nrow) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    if (r < nrow && ncol > 0) {
      if (FAST) {
        const uint4 v = ldg_stream16(p + r * n1);
        wd[0] = v.x, wd[1] = v.y, wd[2] = v.z, wd[3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (c < ncol) wd[c >> 2] |= (uint32_t)(uint8_t)__ldg(p + r * n1 + c) << (8 * (c & 3));
      }
    }
    wv[r] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

template <bool FAST>
__device__ __forceinline__ void gt_load(uint4 (&wv)[4], uint2& xv, const int8_t* __restrict__ p,
                                        size_t n1, int ncol, const bf16* __restrict__ xp,
                                        bool xrow, int nrow, bool x8) {
  gt_load_w<FAST>(wv, p, n1, ncol, nrow);
  gt_load_x(xv, xp, xrow, nrow, x8);
}

// x's 4 elements of a step from the staged y (shared memory, zeros past
// the CTA's K range).
__device__ __forceinline__ uint2 gt_load_xs(const bf16* xs, bool xrow) {
  return xrow ? *reinterpret_cast<const uint2*>(xs) : make_uint2(0u, 0u);
}

// ---------------------------------------------------------------------------
// The RMSNorm prologue.
// ---------------------------------------------------------------------------
// rsqrt(mean(x^2) + eps) of the row xr of K elements (K % 8 == 0, 16-byte
// aligned), computed by one warp: lane l sums the squares of the 8-element
// chunks l, l + 32, l + 64, ... in order (four loads in flight), then a
// butterfly of shuffles adds the lanes (each addition commutative, so
// every lane ends with the same sum). The order depends on K alone.
__device__ __forceinline__ float gt_row_rsqrt(const bf16* __restrict__ xr, int K, float eps) {
  const int lane = threadIdx.x & 31, chunks = K >> 3;
  float acc = 0.f;
  for (int c0 = lane; c0 < chunks; c0 += 4 * 32) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = c0 + 32 * i < chunks ? ldg_16(xr + 8 * (c0 + 32 * i)) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[8];
      bf16x8_to_float(v[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(f[j], f[j], acc);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  return rsqrtf(__fadd_rn(__fdiv_rn(acc, (float)K), eps));
}

// y of 8 elements: bf16((x * r) * (1 + w)), each product rounded (no FMA),
// in the order of the plain version (ops/norms.rms_norm).
__device__ __forceinline__ uint4 gt_norm8(uint4 xv, uint4 wv, float r) {
  float xf[8], wf[8];
  bf16x8_to_float(xv, xf);
  bf16x8_to_float(wv, wf);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack_f32_bf16x2(__fmul_rn(__fmul_rn(xf[2 * i], r), __fadd_rn(1.f, wf[2 * i])),
                           __fmul_rn(__fmul_rn(xf[2 * i + 1], r), __fadd_rn(1.f, wf[2 * i + 1])));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// y of x rows b0 .. b0+nb-1 at K rows [kbeg, kend) into ys (ld bf16 a row:
// the plan's k_per_cta + GT_NORM_PAD; zeros from kend to kbeg + ld -
// GT_NORM_PAD). Warp w takes rows w, w + warps, ...: its row's r, then its
// row's y (x from L1, the row just read). Ends with a CTA barrier.
__device__ __forceinline__ void gt_norm_stage(bf16* ys, int ld, const bf16* __restrict__ x,
                                              NormIn norm, int K, int b0, int nb, int kbeg,
                                              int kend) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int chunks = (ld - GT_NORM_PAD) >> 3;
  for (int r = warp; r < nb; r += warps) {
    const bf16* xr = x + (size_t)(b0 + r) * K;
    const float rs = gt_row_rsqrt(xr, K, norm.eps);
    for (int c = lane; c < chunks; c += 32) {
      const int k = kbeg + 8 * c;
      uint4 y = make_uint4(0u, 0u, 0u, 0u);
      if (k < kend) y = gt_norm8(ldg_16(xr + k), ldg_16(norm.w + k), rs);
      *reinterpret_cast<uint4*>(ys + (size_t)r * ld + 8 * c) = y;
    }
  }
  __syncthreads();
}

// The nibbles of v at bits 0-3 and 16-19 (SHIFT moves them there) as the
// bf16 pair q (low half) and q' (high half).
template <int SHIFT>
__device__ __forceinline__ uint32_t s4_pair(uint32_t v) {
  const uint32_t biased = ((v >> SHIFT) & 0x000F000Fu) ^ 0x43084308u;  // 136 + q
  uint32_t q;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(q)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // * 1 - 136
  return q;
}

// One int4 step: stored rows 4t .. 4t+3 of the lane's 16 columns (wv[r]),
// x row g at k 4t .. 4t+3 of the low half (xl) and of the high half (xh).
// A pair word holds rows (r, r + 1) of two columns: bytes (row r col c,
// row r col c + 1, row r + 1 col c, row r + 1 col c + 1).
__device__ __forceinline__ void gt_mma_step_int4(float (&acc)[8][4], const uint4 (&wv)[4],
                                                 uint2 xl, uint2 xh) {
  const uint32_t bl[2] = {xl.x, xl.y}, bh[2] = {xh.x, xh.y};
  const uint32_t w[4][4] = {{wv[0].x, wv[0].y, wv[0].z, wv[0].w},
                            {wv[1].x, wv[1].y, wv[1].z, wv[1].w},
                            {wv[2].x, wv[2].y, wv[2].z, wv[2].w},
                            {wv[3].x, wv[3].y, wv[3].z, wv[3].w}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // the m-tiles 2j (bytes 0, 1) and 2j + 1 (bytes 2, 3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t sel = h ? 0x7632u : 0x5410u;
      const uint32_t p01 = __byte_perm(w[0][j], w[1][j], sel);
      const uint32_t p23 = __byte_perm(w[2][j], w[3][j], sel);
      uint32_t a[4];
      a[0] = s4_pair<0>(p01);
      a[1] = s4_pair<8>(p01);
      a[2] = s4_pair<0>(p23);
      a[3] = s4_pair<8>(p23);
      mma_bf16_16816(acc[2 * j + h], a, bl);
      a[0] = s4_pair<4>(p01);
      a[1] = s4_pair<12>(p01);
      a[2] = s4_pair<4>(p23);
      a[3] = s4_pair<12>(p23);
      mma_bf16_16816(acc[2 * j + h], a, bh);
    }
  }
}

// The CTA's sums over the stored rows [kbeg, kend) of x rows b0 ..
// b0+nb-1 and the tile's 128 columns: quad g of every warp reads the 16
// weight columns from qcol (its own, so a tile may be two column ranges, as
// GeGLU's gate | up; qcol >= N: none). x is (B, K); with GT_INT4 stored row
// k carries x's columns k and K/2 + k. With NORM the tile multiplies the
// normalized rows (gt_norm_stage; ld: the plan's k_per_cta + GT_NORM_PAD).
// On return sm.sum[r][c] holds them (r < nb), in a fixed order: each
// warp's steps in turn, then the warps in order.
template <bool FAST, int FMT = GT_INT8, bool NORM = false>
__device__ __forceinline__ void gemv_tile_sums(GemvSmem& sm, const bf16* __restrict__ x,
                                               const int8_t* __restrict__ w, int K, int N, int b0,
                                               int nb, int qcol, int kbeg, int kend, bool x8,
                                               NormIn norm = NormIn{}, int ld = 0) {
  static_assert(!(NORM && FMT == GT_INT4), "the norm prologue reads int8 rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = kend > kbeg ? (kend - kbeg + 15) >> 4 : 0;
  const int mine = steps > warp ? (steps - warp + warps - 1) / warps : 0;
  const int ncol = N - qcol;
  const bool xrow = g < nb;
  const int row0 = kbeg + 16 * warp + 4 * t;  // the lane's first row of step 0
  const int stride = 16 * warps;              // rows between a warp's steps
  const size_t n1 = (size_t)N;
  // the lane's weights and x at row0; a step moves them stride rows on
  const int8_t* wp = w + (size_t)row0 * n1 + qcol;
  const bf16* xp = x + (size_t)(b0 + (xrow ? g : 0)) * K + row0;
  const size_t wstep = (size_t)stride * n1;
  const uint32_t magic = gt_magic();

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  uint4 wb[GT_STAGES][4];
  uint2 xb[GT_STAGES];
  uint2 xh[FMT == GT_INT4 ? GT_STAGES : 1];  // int4: x at the high half's k
  const int xhalf = K / 2;
  // NORM: the lane's x fragments come from the staged y (row g, the CTA's
  // K range) in sm.red
  bf16* ys = reinterpret_cast<bf16*>(&sm.red[0][0][0]);
  const bf16* xsp = ys + (size_t)(xrow ? g : 0) * ld + (row0 - kbeg);
  if constexpr (NORM) {
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s)  // the weights stream while y is made
      if (s < mine)
        gt_load_w<FAST>(wb[s], wp + s * wstep, n1, ncol, min(4, kend - row0 - s * stride));
    gt_norm_stage(ys, ld, x, norm, K, b0, nb, kbeg, kend);
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s)
      if (s < mine) xb[s] = gt_load_xs(xsp + s * stride, xrow);
  } else {
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s)
      if (s < mine) {
        const int nrow = min(4, kend - row0 - s * stride);
        gt_load<FAST>(wb[s], xb[s], wp + s * wstep, n1, ncol, xp + s * stride, xrow, nrow, x8);
        if constexpr (FMT == GT_INT4) gt_load_x(xh[s], xp + xhalf + s * stride, xrow, nrow, x8);
      }
  }
  for (int i0 = 0; i0 < mine; i0 += GT_STAGES) {
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s) {
      const int i = i0 + s;
      if (i < mine) {
        if constexpr (FMT == GT_INT4)
          gt_mma_step_int4(acc, wb[s], xb[s], xh[s]);
        else
          gt_mma_step(acc, wb[s], xb[s], magic);
        const int next = i + GT_STAGES;
        if (next < mine) {
          const int nrow = min(4, kend - row0 - next * stride);
          if constexpr (NORM) {
            gt_load_w<FAST>(wb[s], wp + next * wstep, n1, ncol, nrow);
            xb[s] = gt_load_xs(xsp + next * stride, xrow);
          } else {
            gt_load<FAST>(wb[s], xb[s], wp + next * wstep, n1, ncol, xp + next * stride, xrow,
                          nrow, x8);
          }
          if constexpr (FMT == GT_INT4)
            gt_load_x(xh[s], xp + xhalf + next * stride, xrow, nrow, x8);
        }
      }
    }
  }
  if constexpr (NORM) __syncthreads();  // every warp has read y before sm.red takes the sums
  // acc[m] = (column 16g + 2m, row 2t), (16g + 2m, 2t + 1), (16g + 2m + 1, 2t),
  // (16g + 2m + 1, 2t + 1)
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    *reinterpret_cast<float2*>(&sm.red[warp][2 * t][16 * g + 2 * m]) =
        make_float2(acc[m][0], acc[m][2]);
    *reinterpret_cast<float2*>(&sm.red[warp][2 * t + 1][16 * g + 2 * m]) =
        make_float2(acc[m][1], acc[m][3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nb * GT_COLS; e += blockDim.x) {
    const int r = e / GT_COLS, c = e % GT_COLS;
    float v = 0.f;
    for (int i = 0; i < warps; ++i) v += sm.red[i][r][c];
    sm.sum[r][c] = v;
  }
}

// ---------------------------------------------------------------------------
// fp32 x: the three-term split (header).
// ---------------------------------------------------------------------------
// The norm's operands at fp32: y = (x * r) * (1 + w), r = rsqrt(mean(x^2) + eps).
struct NormInF {
  const float* w;  // (K,) fp32, 16-byte aligned
  float eps;
};

__device__ __forceinline__ float4 ldg_f4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// x's 4 fp32 elements of a step from xp, of which the first nrow exist
// (the rest read as zeros; x16: one 16-byte load).
__device__ __forceinline__ float4 gt_load_xf(const float* __restrict__ xp, bool xrow, int nrow,
                                             bool x16) {
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  if (xrow) {
    if (x16 && nrow == 4) return ldg_f4(xp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nrow) e[j] = __ldg(xp + j);
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

// The three bf16 terms of 4 fp32 values as B fragments: b[i] holds term i
// (hi, mid, lo) of elements (0, 1) in b[i][0] and (2, 3) in b[i][1], the
// lower index in the low half, as gt_load_x packs bf16 x.
__device__ __forceinline__ void gt_split3(float4 v, uint32_t (&b)[3][2]) {
  float e[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const bf16 t = __float2bfloat16_rn(e[j]);
      h[i][j] = (uint32_t)__bfloat16_as_ushort(t);
      e[j] = __fsub_rn(e[j], __bfloat162float(t));  // exact
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b[i][0] = h[i][0] | (h[i][1] << 16);
    b[i][1] = h[i][2] | (h[i][3] << 16);
  }
}

// The step with fp32 x: the same A fragments, each against the three
// terms of x in order hi, mid, lo.
__device__ __forceinline__ void gt_mma_step3(float (&acc)[8][4], const uint4 (&wv)[4], float4 xv,
                                             uint32_t magic) {
  uint32_t b[3][2];
  gt_split3(xv, b);
  gt_mma_terms<3>(acc, wv, b, magic);
}

// rsqrt(mean(x^2) + eps) of the fp32 row xr of K elements (K % 4 == 0,
// 16-byte aligned), by one warp: lane l sums the squares of the 4-element
// chunks l, l + 32, ... in order, then the butterfly adds the lanes. The
// order depends on K alone.
__device__ __forceinline__ float gt_row_rsqrt_f32(const float* __restrict__ xr, int K,
                                                  float eps) {
  const int lane = threadIdx.x & 31, chunks = K >> 2;
  float acc = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const float4 v = ldg_f4(xr + 4 * c);
    acc = fmaf(v.x, v.x, acc);
    acc = fmaf(v.y, v.y, acc);
    acc = fmaf(v.z, v.z, acc);
    acc = fmaf(v.w, v.w, acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  return rsqrtf(__fadd_rn(__fdiv_rn(acc, (float)K), eps));
}

// y of 4 fp32 elements: (x * r) * (1 + w), each product rounded (no FMA),
// in the order of the plain version (ops/norms.rms_norm), not rounded to
// bf16.
__device__ __forceinline__ float4 gt_norm4(float4 x, float4 w, float r) {
  return make_float4(__fmul_rn(__fmul_rn(x.x, r), __fadd_rn(1.f, w.x)),
                     __fmul_rn(__fmul_rn(x.y, r), __fadd_rn(1.f, w.y)),
                     __fmul_rn(__fmul_rn(x.z, r), __fadd_rn(1.f, w.z)),
                     __fmul_rn(__fmul_rn(x.w, r), __fadd_rn(1.f, w.w)));
}

// The norm operands of activation type T, and the row's rsqrt(mean(x^2) +
// eps) by one warp in each type's order (the GEMV and the LoRA shrink of a
// row read the same r).
template <class T>
struct GtNorm;
template <>
struct GtNorm<bf16> {
  using type = NormIn;
};
template <>
struct GtNorm<float> {
  using type = NormInF;
};
__device__ __forceinline__ float gt_row_rsqrt_t(const bf16* xr, int K, float eps) {
  return gt_row_rsqrt(xr, K, eps);
}
__device__ __forceinline__ float gt_row_rsqrt_t(const float* xr, int K, float eps) {
  return gt_row_rsqrt_f32(xr, K, eps);
}

// gemv_tile_sums with fp32 x (B, K) (int8 weights): the same steps, loads
// and sum order, each step's x split into three bf16 terms (header). With
// NORM the tile multiplies y = (x * r) * (1 + w): r of rows b0 .. b0+nb-1
// first (warp w takes rows w, w + warps, ...; the weights stream
// meanwhile) and w of rows kbeg .. kbeg + 16 steps - 1 in sm.red (so that
// no register holds it through the loop; a K range too long for sm.red
// reads w from L1 / L2 at each step), then each step makes y from its x and
// w. x16: K % 4 == 0 and x 16-byte aligned (NORM needs it, and w 16-byte
// aligned).
template <bool FAST, bool NORM = false>
__device__ __forceinline__ void gemv_tile_sums_f32(GemvSmem& sm, const float* __restrict__ x,
                                                   const int8_t* __restrict__ w, int K, int N,
                                                   int b0, int nb, int qcol, int kbeg, int kend,
                                                   bool x16, NormInF norm = NormInF{}) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = kend > kbeg ? (kend - kbeg + 15) >> 4 : 0;
  const int mine = steps > warp ? (steps - warp + warps - 1) / warps : 0;
  const int ncol = N - qcol;
  const bool xrow = g < nb;
  const int row0 = kbeg + 16 * warp + 4 * t;  // the lane's first row of step 0
  const int stride = 16 * warps;              // rows between a warp's steps
  const size_t n1 = (size_t)N;
  const int8_t* wp = w + (size_t)row0 * n1 + qcol;
  const float* xp = x + (size_t)(b0 + (xrow ? g : 0)) * K + row0;
  // NORM: the norm weight of the CTA's K rows, staged in sm.red before the
  // loop (zeros past kend) where it fits, read at the lane's rows each step
  const bool wsm = NORM && (size_t)16 * steps * sizeof(float) <= sizeof(sm.red);
  const float* nws = reinterpret_cast<const float*>(&sm.red[0][0][0]) + (row0 - kbeg);
  const size_t wstep = (size_t)stride * n1;
  const uint32_t magic = gt_magic();

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  uint4 wb[GT_STAGES][4];
  float4 xb[GT_STAGES];
  float r = 0.f;
  if constexpr (NORM) {
    __shared__ float rs[GT_BT];
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s)  // the weights stream while r is computed
      if (s < mine)
        gt_load_w<FAST>(wb[s], wp + s * wstep, n1, ncol, min(4, kend - row0 - s * stride));
    for (int rr = warp; rr < nb; rr += warps) {
      const float v = gt_row_rsqrt_f32(x + (size_t)(b0 + rr) * K, K, norm.eps);
      if (lane == 0) rs[rr] = v;
    }
    float* ws = reinterpret_cast<float*>(&sm.red[0][0][0]);
    for (int k = 4 * threadIdx.x; wsm && k < 16 * steps; k += 4 * blockDim.x)
      *reinterpret_cast<float4*>(ws + k) =
          kbeg + k < kend ? ldg_f4(norm.w + kbeg + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    r = rs[xrow ? g : 0];
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s)
      if (s < mine)
        xb[s] = gt_load_xf(xp + s * stride, xrow, min(4, kend - row0 - s * stride), x16);
  } else {
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s)
      if (s < mine) {
        const int nrow = min(4, kend - row0 - s * stride);
        gt_load_w<FAST>(wb[s], wp + s * wstep, n1, ncol, nrow);
        xb[s] = gt_load_xf(xp + s * stride, xrow, nrow, x16);
      }
  }
  for (int i0 = 0; i0 < mine; i0 += GT_STAGES) {
#pragma unroll
    for (int s = 0; s < GT_STAGES; ++s) {
      const int i = i0 + s;
      if (i < mine) {
        if constexpr (NORM) {
          const float4 nw =
              wsm ? *reinterpret_cast<const float4*>(nws + i * stride)
                  : gt_load_xf(norm.w + row0 + i * stride, true,
                               min(4, kend - row0 - i * stride), x16);
          gt_mma_step3(acc, wb[s], gt_norm4(xb[s], nw, r), magic);
        } else
          gt_mma_step3(acc, wb[s], xb[s], magic);
        const int next = i + GT_STAGES;
        if (next < mine) {
          const int nrow = min(4, kend - row0 - next * stride);
          gt_load_w<FAST>(wb[s], wp + next * wstep, n1, ncol, nrow);
          xb[s] = gt_load_xf(xp + next * stride, xrow, nrow, x16);
        }
      }
    }
  }
  if constexpr (NORM) __syncthreads();  // every warp has read w before sm.red takes the sums
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    *reinterpret_cast<float2*>(&sm.red[warp][2 * t][16 * g + 2 * m]) =
        make_float2(acc[m][0], acc[m][2]);
    *reinterpret_cast<float2*>(&sm.red[warp][2 * t + 1][16 * g + 2 * m]) =
        make_float2(acc[m][1], acc[m][3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nb * GT_COLS; e += blockDim.x) {
    const int rr = e / GT_COLS, c = e % GT_COLS;
    float v = 0.f;
    for (int i = 0; i < warps; ++i) v += sm.red[i][rr][c];
    sm.sum[rr][c] = v;
  }
}

// The cluster's sum of element (r, c): every rank's, in rank order.
__device__ __forceinline__ float gt_cluster_sum(const GemvSmem& sm, int r, int c, int cs) {
  float v = 0.f;
  for (int q = 0; q < cs; ++q) v += ld_cluster_f32(&sm.sum[r][c], q);
  return v;
}

// The cluster's sums of elements (r, c) and (r, c2), each in rank order,
// their loads interleaved (two chains in flight: a pair's two columns).
__device__ __forceinline__ float2 gt_cluster_sum2(const GemvSmem& sm, int r, int c, int c2,
                                                  int cs) {
  float v = 0.f, v2 = 0.f;
  for (int q = 0; q < cs; ++q) {
    const float a = ld_cluster_f32(&sm.sum[r][c], q), b = ld_cluster_f32(&sm.sum[r][c2], q);
    v += a;
    v2 += b;
  }
  return make_float2(v, v2);
}

// The GEMV tile's launch: CTAs of `warps` warps (4 or 8).
template <typename... KArgs, typename... Args>
inline int gt_launch(void (*kernel)(KArgs...), dim3 grid, int cs, int warps, cudaStream_t st,
                     Args... args) {
  if (warps != 4 && warps != GT_MAX_WARPS) return (int)cudaErrorInvalidValue;
  return cluster_launch(kernel, grid, 32 * warps, cs, 0, st, args...);
}
