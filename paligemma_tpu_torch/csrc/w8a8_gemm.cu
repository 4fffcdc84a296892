// W8A8 prefill matmul on Hopper's int8 tensor cores: int8 activations,
// each row quantized on the fly, times the int8 weights of the serving
// tree, with exact int32 sums. Two kernels, one launch each:
//
//   K1 w8a8_quant_rows: per row of x (M, K) bf16 or fp32, a_s = max(amax
//      |x|, 1e-8) / 127 and x8 = clip(rint(x / a_s), -127, 127) (IEEE
//      division, round half to even: the plain version's bits and JAX's);
//   K2 w8a8_gemm: out = cast(((float) int32(x8 . w8)) * a_s[row] * s[col])
//      (the multiplications in that order) in bf16 or fp32, or the int32
//      sums themselves for a tensor-parallel rank, which sums them across
//      ranks first.
//
// The fp32 forms (--dtype float32) change only the load and store types:
// K1 reads fp32 rows (16 bytes = 4 elements a load, 5 bytes an element
// moved against bf16's 3), K2 writes fp32 (the cast is the identity). The
// codes, a_s and the int32 sums are the same function of the values.
//
// They replace no Pallas kernel: the JAX package computes W8A8 in XLA
// (paligemma_tpu/kernels/quant.py _xla_w8a8_matmul). Because every int32
// sum is exact in any order, K2's output equals its plain version's bit for
// bit whatever its tiling and K split, and so does K1's.
//
// What bounds K2: at 266 rows (one 224 px prompt) the weight bytes, one
// layer's four projections 110 MB in 33 us at 3.35 TB/s against 29 us of
// int8 products at 1,979 TOPS; at 2560 rows (a serving wave) the products.
// K1 is one read of x and one write of x8: bytes.
//
// K2's design (csrc/wq_wgmma.cuh's shape, on int8 operands):
// - int8 tensor-core operands are K-major on both sides. x8 (M, K) is;
//   the serving tree's w8 (K, N) is not, and the decode chain reads that
//   layout, so no (N, K) copy is kept. The product is taken transposed,
//   out^T = W^T . x8^T: W^T is wgmma's A operand in registers, gathered
//   from the raw (K, N) tile, and x8 is B, read from shared memory.
// - A CTA owns 128 weight columns (two consumer warpgroups of 64) by a row
//   tile of x sized to M: 16, 32, 64, 128 or 256 rows in one chunk, or 272
//   in two (144 + 128: wgmma's s8 N runs in steps of 16, and 266 rows in one
//   tile beat three 128-row tiles, which put 31 % of the products on zero
//   rows and gathered every weight fragment three times). Each weight
//   fragment is gathered once a stage and applied to every chunk (one
//   wgmma m64nNk32 each). Tiles above 128 rows keep 128-136 int32
//   accumulators a thread: the producer is a warpgroup that hands its
//   registers to the consumers (setmaxnreg 56 / 224).
// - The producer (one thread) keeps TMA loads in flight into a ring of
//   W8_ST stages; a stage is 128 K values: the x8 chunks (128-byte rows)
//   and the raw weight tile (128 K rows x 128 columns), all in the 128-byte
//   swizzle.
// - A fragment of thread (g, t) of warp w holds two weight columns of the
//   warp's 16 (c0 + 2g as row g, c0 + 2g + 1 as row g + 8) at the K values
//   4t..4t+3 and 16+4t..16+4t+3 of a 32-deep step: one ldmatrix.trans on
//   byte pairs and four byte permutations a step (w8_load). A stage's
//   fragments are gathered while the previous stage's products run (two
//   register sets, wgmma.wait_group 1).
// - Where the tiles alone would leave SMs idle (the narrow projections at
//   prefill rows: qkv, o and down at 266 rows give 16-20 tiles), the K
//   stages are split over a cluster of 2-8 CTAs, one tile a cluster
//   (kernels/w8a8.py plans it); each rank writes its int32 sums to its
//   shared memory and, after a cluster barrier, adds every rank's sums for
//   its share of the tile through distributed shared memory, in rank
//   order, then scales, casts and stores. Otherwise persistent CTAs take
//   the tiles in turn (CTAs side by side share a weight block in L2) and
//   scale, cast and store from registers.
// - Rows of x past M, K past K and columns past N read as zeros (TMA) and
//   are not stored.
// Measured on an H100 (PERF.md, the W8A8 table; tools/w8a8_times.py): one
// layer's four projections 0.103 ms at 266 rows, 40 % of the bytes bound
// (0.041; the parent design 0.194-0.199 in the same call), 0.666 ms at 2560
// rows, 43 % of the operations' (0.285; parent 0.885-0.889). At 266 rows
// qkv and o take 12 us each, mostly a tile's fixed cost (pipeline fill,
// cluster barriers, epilogue); gateup's 256 tiles take two rounds of the
// 132 CTAs, and each stage's shared-memory traffic (the x chunks read by
// both warpgroups' wgmma, the TMA writes, the fragment gathers) about
// matches its products.
#include "hopper.cuh"
#include "tensor_map.cuh"

#define W8_BK 128                      // K values per stage: one 128-byte row of each tile
#define W8_COLS 128                    // weight (output) columns of a tile
#define W8_ST 4                        // ring stages
#define W8_RAW_BYTES (W8_BK * W8_COLS)  // the raw weight tile of a stage
#define W8_LDS (W8_COLS + 8)           // ints a row of a split rank's sums (8 mod 32)
#define W8_CONSUMERS 256
#define W8_QUANT_THREADS 256

// A tile of W8_COLS weight columns by XA + XB rows of x: one chunk of XA
// rows, or two (XB > 0), both read through one tensor map of XA-row boxes.
template <int XA, int XB>
struct W8Cfg {
  static constexpr int ROWS = XA + XB;
  static constexpr bool WIDE = ROWS > 128;  // a producer warpgroup (setmaxnreg)
  static constexpr int THREADS = W8_CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int CHUNKS = XB > 0 ? 2 : 1;
  static constexpr int X_BYTES = XA * W8_BK;  // one chunk's x8 tile
  static constexpr int STAGE = CHUNKS * X_BYTES + W8_RAW_BYTES;
  static constexpr int RING = W8_ST * STAGE;
  static constexpr int SUMS = ROWS * W8_LDS * 4;  // a split rank's sums reuse the ring
  static constexpr int BODY = ((RING > SUMS ? RING : SUMS) + 1023) / 1024 * 1024;
  // 1024 bytes of alignment slack, the ring (then the sums), the barriers
  static constexpr int BYTES = 1024 + BODY + 256;
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(X_BYTES % 1024 == 0, "tiles 1024-byte aligned");
};

// d (64 x N, s32) += A (registers, s8 fragments) . B (smem, K-major, s8):
// wgmma m64nNk32 at each chunk's N.
template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<16>(uint32_t* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(uint32_t* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(uint32_t* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(uint32_t* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<144>(uint32_t* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, {%72, %73, %74, %75}, %76, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(uint32_t* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// One stage's A fragments (four 32-deep steps) of warp w of warpgroup wg
// from the raw weight tile (K row r at byte 128 r, its 16-byte chunk c at
// chunk c ^ (r % 8)), by ldmatrix.trans on byte pairs (two columns as one
// 16-bit element): matrix i of step kk is K rows 32 kk + 16 (i >> 1) +
// {0, 1, 4, 5, 8, 9, 12, 13} + 2 (i & 1) of the warp's 16 columns, so
// thread (g, t) receives columns 2g, 2g + 1 at K rows 4t, 4t + 1 of the
// half (i even) and 4t + 2, 4t + 3 (i odd); two byte permutations give
// fragment rows g (column 2g) and g + 8 (column 2g + 1) at K values
// 4t .. 4t + 3. (Rows r and r + 8 of a matrix share banks: 2-way.)
__device__ __forceinline__ void w8_load(uint32_t (*a)[4], const uint8_t* raw, int wg, int w,
                                        int lane) {
  const int i = lane >> 3, mr = lane & 7;
  const int r0 = 16 * (i >> 1) + 4 * (mr >> 1) + 2 * (i & 1) + (mr & 1);  // the lane's row
  const uint8_t* p = raw + r0 * 128 + (((wg * 4 + w) ^ (r0 & 7)) << 4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t m[4];
    ldsm_x4_trans(m, reinterpret_cast<const bf16*>(p + kk * 32 * 128));
    a[kk][0] = __byte_perm(m[0], m[1], 0x6420);  // column c0 + 2g: fragment row g
    a[kk][1] = __byte_perm(m[0], m[1], 0x7531);  // c0 + 2g + 1: row g + 8
    a[kk][2] = __byte_perm(m[2], m[3], 0x6420);
    a[kk][3] = __byte_perm(m[2], m[3], 0x7531);
  }
}

enum { W8_OUT_BF16 = 0, W8_OUT_INT32 = 1, W8_OUT_FP32 = 2 };

// Two adjacent outputs (columns n, n + 1 of row m; `at` = m N + n) of the
// int32 sums va, vb: the sums, or ((float) v * a_s[m]) * s[col] in fp32 or
// bf16.
__device__ __forceinline__ void w8_put2(void* out, int out_kind, size_t at, int va, int vb,
                                        float am, float sa, float sb) {
  if (out_kind == W8_OUT_INT32) {
    *reinterpret_cast<int2*>(reinterpret_cast<int*>(out) + at) = make_int2(va, vb);
    return;
  }
  const float oa = __fmul_rn(__fmul_rn(__int2float_rn(va), am), sa);
  const float ob = __fmul_rn(__fmul_rn(__int2float_rn(vb), am), sb);
  if (out_kind == W8_OUT_FP32)
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + at) = make_float2(oa, ob);
  else
    *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + at) = pack_f32_bf16x2(oa, ob);
}

// A chunk's accumulators (acc[4j + e]: column na (e < 2) or na + 1, x row
// m0 + 8j + 2t + (e & 1)) scaled, cast and stored from registers.
template <int NACC>
__device__ __forceinline__ void w8_store(const uint32_t* acc, void* out, int out_kind,
                                         const float* __restrict__ a_s, float sa, float sb,
                                         int M, int N, int m0, int na, int t) {
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m < M)
        w8_put2(out, out_kind, (size_t)m * N + na, (int)acc[4 * j + e], (int)acc[4 * j + 2 + e],
                out_kind == W8_OUT_INT32 ? 0.f : a_s[m], sa, sb);
    }
}

// A chunk's accumulators into this rank's sums ([x row][column], W8_LDS
// ints a row), rows r0 ..
template <int NACC>
__device__ __forceinline__ void w8_keep(const uint32_t* acc, int* sums, int r0, int col, int t) {
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int r = r0 + 8 * j + 2 * t;
    *reinterpret_cast<int2*>(&sums[r * W8_LDS + col]) =
        make_int2((int)acc[4 * j], (int)acc[4 * j + 2]);
    *reinterpret_cast<int2*>(&sums[(r + 1) * W8_LDS + col]) =
        make_int2((int)acc[4 * j + 1], (int)acc[4 * j + 3]);
  }
}

// Four ints of another rank's shared memory.
__device__ __forceinline__ int4 ld_cluster_s32x4(const int* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_addr(p)), "r"((uint32_t)rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The split-K epilogue: rank `rank` of `cs` adds every rank's int32 sums
// (rank order; exact in any) for its share of the tile's rows below M,
// then scales, casts and stores. A thread keeps 4 columns and loads every
// rank's values before it adds them. Between two cluster barriers.
template <int ROWS, int THREADS>
__device__ __forceinline__ void w8_cluster_epilogue(const int* sums, const float* __restrict__ a_s,
                                                    const float* __restrict__ s, void* out,
                                                    int out_kind, int M, int N, int m0, int n0,
                                                    int rank, int cs) {
  constexpr int C4 = W8_COLS / 4;
  static_assert(THREADS % C4 == 0, "a thread's columns stay the same");
  const int total = min(ROWS, M - m0) * C4;
  const int per = (total + cs - 1) / cs;
  const int lo = rank * per, hi = min(total, lo + per);
  const int c = ((lo + (int)threadIdx.x) % C4) * 4, n = n0 + c;
  if (n >= N) return;
  const float4 sc = make_float4(s[n], s[n + 1], s[n + 2], s[n + 3]);
  for (int e = lo + (int)threadIdx.x; e < hi; e += THREADS) {
    const int* p = &sums[(e / C4) * W8_LDS + c];
    int4 a[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < cs) a[q] = ld_cluster_s32x4(p, q);
    int4 v = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < cs) {
        v.x += a[q].x;
        v.y += a[q].y;
        v.z += a[q].z;
        v.w += a[q].w;
      }
    }
    const int m = m0 + e / C4;
    const size_t at = (size_t)m * N + n;
    const float am = out_kind == W8_OUT_INT32 ? 0.f : a_s[m];
    w8_put2(out, out_kind, at, v.x, v.y, am, sc.x, sc.y);
    w8_put2(out, out_kind, at + 2, v.z, v.w, am, sc.z, sc.w);
  }
}

// x8 map: (K, M) bytes, box 128 x XA; w map: (N, K) bytes, box 128 x 128;
// both in the 128-byte swizzle. out: (M, N) of out_kind (W8_OUT_*). kst:
// stages of each rank but the last. Cluster 1: a 1-D grid of persistent
// CTAs over every tile; else a grid of (column tiles x cluster, row tiles),
// one tile a cluster.
template <int XA, int XB>
__global__ void __launch_bounds__(W8Cfg<XA, XB>::THREADS, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a_s,
                     const float* __restrict__ s, void* __restrict__ out, int M, int K, int N,
                     int out_kind, int kst) {
  using C = W8Cfg<XA, XB>;
  constexpr int NA = XA / 2, NB = XB > 0 ? XB / 2 : 4;  // int32 accumulators a thread
  extern __shared__ uint8_t w8_smem[];
  uint8_t* base = w8_smem + ((1024u - (smem_addr(w8_smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BODY);
  uint64_t* empty = full + W8_ST;
  int* sums = reinterpret_cast<int*>(base);

  const int rank = cluster_rank(), cs = cluster_size();
  const int stages = (K + W8_BK - 1) / W8_BK;
  const int sbeg = rank * kst;
  const int nst = min(stages, sbeg + kst) - sbeg;  // >= 1: the plan leaves no rank empty
  const int row_tiles = (M + C::ROWS - 1) / C::ROWS;
  const int tiles = cs > 1 ? 1 : (N + W8_COLS - 1) / W8_COLS * row_tiles;
  const int first = cs > 1 ? 0 : (int)blockIdx.x, stride = cs > 1 ? 1 : (int)gridDim.x;
  // a tile's first output column and row of x (rows of x fastest)
  auto tile_n0 = [&](int tile) {
    return (cs > 1 ? (int)blockIdx.x / cs : tile / row_tiles) * W8_COLS;
  };
  auto tile_m0 = [&](int tile) { return (cs > 1 ? (int)blockIdx.y : tile % row_tiles) * C::ROWS; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < W8_ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto xtile = [&](int st, int ch) { return base + st * C::STAGE + ch * C::X_BYTES; };
  auto rawtile = [&](int st) { return base + st * C::STAGE + C::CHUNKS * C::X_BYTES; };

  if (warp >= 8) {  // the producer: one thread issues every copy, tile after tile
    if constexpr (C::WIDE) setmaxnreg_dec<56>();
    if (warp == 8 && lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;  // stages issued so far
      for (int tile = first; tile < tiles; tile += stride) {
        const int n0 = tile_n0(tile), m0 = tile_m0(tile);
        for (int i = 0; i < nst; ++i, ++it) {
          const int st = it % W8_ST, k0 = (sbeg + i) * W8_BK;
          if (it >= W8_ST) mbar_wait(empty + st, ((it / W8_ST) - 1) & 1);
          mbar_expect_tx(full + st, C::STAGE);
          tma_load_2d(xtile(st, 0), &xmap, full + st, k0, m0);
          if constexpr (XB > 0) tma_load_2d(xtile(st, 1), &xmap, full + st, k0, m0 + XA);
          tma_load_2d(rawtile(st), &wmap, full + st, n0, k0);
        }
      }
    }
    __syncwarp();
  } else {
    if constexpr (C::WIDE) setmaxnreg_inc<224>();
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int c0 = wg * 64 + 16 * w;  // the warp's first column of the tile
    uint32_t acc_a[NA], acc_b[NB];
    uint32_t f0[4][4], f1[4][4];  // two stages' fragments
    int it0 = 0;                  // stages of the ring consumed before this tile
    auto load = [&](int u, uint32_t(*f)[4]) {
      const int gs = it0 + u;
      mbar_wait(full + gs % W8_ST, (gs / W8_ST) & 1);
      w8_load(f, rawtile(gs % W8_ST), wg, w, lane);
    };
    // stage u's products on `cur` (each fragment against every chunk);
    // then, once stage u - 1's are done (its ring slot goes back to the
    // producer), stage u + 1's fragments into `nxt` while stage u's run
    auto step = [&](int u, uint32_t(*cur)[4], uint32_t(*nxt)[4]) {
      const int gs = it0 + u;
      reg_fence<16>(&cur[0][0]);
      reg_fence<NA>(acc_a);
      if constexpr (XB > 0) reg_fence<NB>(acc_b);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_s8<XA>(acc_a, cur[kk], wgmma_desc128(xtile(gs % W8_ST, 0) + kk * 32));
        if constexpr (XB > 0)
          wgmma_s8<XB>(acc_b, cur[kk], wgmma_desc128(xtile(gs % W8_ST, 1) + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence<NA>(acc_a);
      if constexpr (XB > 0) reg_fence<NB>(acc_b);
      reg_fence<16>(&nxt[0][0]);
      if (u > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (gs - 1) % W8_ST);
      }
      if (u + 1 < nst) load(u + 1, nxt);
    };

    for (int tile = first; tile < tiles; tile += stride, it0 += nst) {
      const int n0 = tile_n0(tile), m0 = tile_m0(tile);
      const int na = n0 + c0 + 2 * g;  // this thread's columns na and na + 1 (N % 16 == 0)
#pragma unroll
      for (int i = 0; i < NA; ++i) acc_a[i] = 0u;
#pragma unroll
      for (int i = 0; i < NB; ++i) acc_b[i] = 0u;
      load(0, f0);
      for (int u = 0; u < nst; u += 2) {
        step(u, f0, f1);
        if (u + 1 < nst) step(u + 1, f1, f0);
      }
      wgmma_wait<0>();
      reg_fence<NA>(acc_a);
      if constexpr (XB > 0) reg_fence<NB>(acc_b);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (it0 + nst - 1) % W8_ST);
      if (cs == 1) {  // scale, cast and store from registers
        if (na >= N) continue;
        const float sa = out_kind == W8_OUT_INT32 ? 0.f : s[na];
        const float sb = out_kind == W8_OUT_INT32 ? 0.f : s[na + 1];
        w8_store<NA>(acc_a, out, out_kind, a_s, sa, sb, M, N, m0, na, t);
        if constexpr (XB > 0) w8_store<NB>(acc_b, out, out_kind, a_s, sa, sb, M, N, m0 + XA, na, t);
      } else {  // the sums as [x row][column], for the cluster's epilogue
        named_bar_sync(1, W8_CONSUMERS);  // every product has read the ring
        w8_keep<NA>(acc_a, sums, 0, c0 + 2 * g, t);
        if constexpr (XB > 0) w8_keep<NB>(acc_b, sums, XA, c0 + 2 * g, t);
      }
    }
  }

  if (cs > 1) {
    cluster_sync_all();
    w8_cluster_epilogue<C::ROWS, C::THREADS>(sums, a_s, s, out, out_kind, M, N, tile_m0(0),
                                             tile_n0(0), rank, cs);
    cluster_sync_all();  // every rank has read this CTA's sums
  }
}

// EPV elements of a row of type T from 16 bytes at p, as fp32
__device__ __forceinline__ void w8_row_values(const bf16* p, float (&v)[8]) {
  bf16x8_to_float(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void w8_row_values(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

// One block per row: the row's amax (or amax_in[row] where given: a
// tensor-parallel rank's input shard takes the whole row's), a_s, codes.
// T: x's type; each thread reads 16 bytes (EPV elements) at a time.
template <class T>
__global__ void __launch_bounds__(W8_QUANT_THREADS)
    w8a8_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ amax_in,
                           int8_t* __restrict__ x8, float* __restrict__ a_s, int K) {
  constexpr int EPV = 16 / sizeof(T);
  __shared__ float red[W8_QUANT_THREADS / 32];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + (size_t)row * K;
  float as;
  if (amax_in != nullptr) {
    as = amax_in[row];
  } else {
    float mx = 0.f;
    for (int k = EPV * threadIdx.x; k < K; k += EPV * W8_QUANT_THREADS) {
      float v[EPV];
      w8_row_values(xr + k, v);
#pragma unroll
      for (int i = 0; i < EPV; ++i) mx = fmaxf(mx, fabsf(v[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    mx = red[0];
#pragma unroll
    for (int i = 1; i < W8_QUANT_THREADS / 32; ++i) mx = fmaxf(mx, red[i]);
    as = mx;
  }
  as = __fdiv_rn(fmaxf(as, 1e-8f), 127.f);
  if (threadIdx.x == 0) a_s[row] = as;
  for (int k = EPV * threadIdx.x; k < K; k += EPV * W8_QUANT_THREADS) {
    float v[EPV];
    w8_row_values(xr + k, v);
    uint32_t q[EPV / 4] = {};
#pragma unroll
    for (int i = 0; i < EPV; ++i) {
      const int c = min(127, max(-127, __float2int_rn(__fdiv_rn(v[i], as))));
      q[i >> 2] |= ((uint32_t)c & 0xFFu) << (8 * (i & 3));
    }
    if constexpr (EPV == 8)
      *reinterpret_cast<uint2*>(x8 + (size_t)row * K + k) = make_uint2(q[0], q[1]);
    else
      *reinterpret_cast<uint32_t*>(x8 + (size_t)row * K + k) = q[0];
  }
}

template <class T>
static int quant_rows(const void* x, const void* amax, void* x8, void* a_s, int M, int K,
                      void* stream) {
  if (M < 1 || K < 8 || K % 8 || ((uintptr_t)x | (uintptr_t)x8) % 16)
    return (int)cudaErrorInvalidValue;
  w8a8_quant_rows_kernel<T><<<M, W8_QUANT_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)amax, (int8_t*)x8, (float*)a_s, K);
  return (int)cudaGetLastError();
}

// x (M, K) bf16 (16-byte aligned, K % 8 == 0), amax (M,) fp32 or NULL, x8
// (M, K) int8 and a_s (M,) fp32 out.
PG_EXPORT int pg_w8a8_quant_rows(const void* x, const void* amax, void* x8, void* a_s, int M,
                                 int K, void* stream) {
  return quant_rows<bf16>(x, amax, x8, a_s, M, K, stream);
}

// The fp32 form: x (M, K) fp32, the rest as pg_w8a8_quant_rows.
PG_EXPORT int pg_w8a8_quant_rows_fp32(const void* x, const void* amax, void* x8, void* a_s,
                                      int M, int K, void* stream) {
  return quant_rows<float>(x, amax, x8, a_s, M, K, stream);
}

template <int XA, int XB>
static int w8_launch(const void* x8, const void* w8, const float* a_s, const float* s, void* out,
                     int M, int K, int N, int out_kind, int cluster, int kst, int ctas,
                     cudaStream_t st) {
  using C = W8Cfg<XA, XB>;
  CUtensorMap xmap, wmap;
  int err = tma_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x8, K, M, K, W8_BK, XA,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, N, K, N, W8_COLS, W8_BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = w8a8_gemm_kernel<XA, XB>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = cluster > 1 ? dim3((N + W8_COLS - 1) / W8_COLS * cluster,
                                       (M + C::ROWS - 1) / C::ROWS, 1)
                                : dim3(ctas, 1, 1);
  return cluster_launch(kernel, grid, C::THREADS, cluster, C::BYTES, st, xmap, wmap, a_s, s, out,
                        M, K, N, out_kind, kst);
}

// x8 (M, K) int8, w8 (K, N) int8, a_s (M,) fp32, s (N,) fp32, out (M, N)
// bf16, int32 sums or fp32 (out_kind 0, 1, 2: W8_OUT_*); x8, w8 and out
// 16-byte aligned, K and N multiples of 16. rows: the row tile (16, 32, 64,
// 128, 256, or 272 as 144 + 128); cluster: the K split (1-8 CTAs); kst:
// stages of 128 K values of each rank but the last; ctas: the persistent
// grid of cluster 1 (at most one CTA an SM). kernels/w8a8.py plans all four.
PG_EXPORT int pg_w8a8_gemm(const void* x8, const void* w8, const void* a_s, const void* s,
                           void* out, int M, int K, int N, int out_kind, int rows, int cluster,
                           int kst, int ctas, void* stream) {
  const int stages = (K + W8_BK - 1) / W8_BK;
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16 || ctas < 1 || out_kind < W8_OUT_BF16 ||
      out_kind > W8_OUT_FP32 || cluster < 1 || cluster > 8 || kst < 1 ||
      (cluster - 1) * kst >= stages || cluster * kst < stages ||
      ((uintptr_t)x8 | (uintptr_t)w8 | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const float* as = (const float*)a_s;
  const float* sp = (const float*)s;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 16: return w8_launch<16, 0>(x8, w8, as, sp, out, M, K, N, out_kind, cluster, kst, ctas, st);
    case 32: return w8_launch<32, 0>(x8, w8, as, sp, out, M, K, N, out_kind, cluster, kst, ctas, st);
    case 64: return w8_launch<64, 0>(x8, w8, as, sp, out, M, K, N, out_kind, cluster, kst, ctas, st);
    case 128:
      return w8_launch<128, 0>(x8, w8, as, sp, out, M, K, N, out_kind, cluster, kst, ctas, st);
    case 256:
      return w8_launch<256, 0>(x8, w8, as, sp, out, M, K, N, out_kind, cluster, kst, ctas, st);
    case 272:
      return w8_launch<144, 128>(x8, w8, as, sp, out, M, K, N, out_kind, cluster, kst, ctas, st);
  }
  return (int)cudaErrorInvalidValue;
}
