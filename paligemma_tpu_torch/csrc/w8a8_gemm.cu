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
// bit, and so does K1's.
//
// What bounds K2: at prefill rows (266 for one 224 px prompt, 2560 for a
// serving wave) the int8 products, 2 M K N operations at 1,979 TOPS; the
// weight bytes (K N) only at the fewest rows. K1 is one read of x and one
// write of x8: bytes.
//
// K2's design, from csrc/wq_wgmma.cuh (which states it in full), in its
// simplest form:
// - int8 tensor-core operands are K-major on both sides. x8 (M, K) is;
//   the serving tree's w8 (K, N) is not, and the decode chain reads that
//   layout, so no (N, K) copy is kept. The product is taken transposed,
//   out^T = W^T . x8^T: W^T is wgmma's A operand in registers, gathered
//   from the raw (K, N) tile, and x8 is B, read from shared memory.
// - A CTA owns 128 weight columns by 128 rows of x (m64n128k32, two
//   consumer warpgroups of 64 columns each) and a producer warp whose one
//   thread keeps TMA loads in flight into a ring of W8_ST stages; a stage
//   is 128 K values: the x8 tile (128 rows x 128 bytes) and the raw weight
//   tile (128 K rows x 128 columns), both in the 128-byte swizzle.
// - A fragment of thread (g, t) of warp w holds two weight columns of the
//   warp's 16 (c0 + 2g as row g, c0 + 2g + 1 as row g + 8) at the K values
//   4t..4t+3 and 16+4t..16+4t+3 of a 32-deep step: four 2-byte loads (a
//   column pair at one K row) and two byte permutations per register pair.
//   A stage's fragments are gathered while the previous stage's products
//   run (two register sets, wgmma.wait_group 1).
// - Persistent CTAs take the tiles in turn, rows of x fastest (CTAs side
//   by side share a weight block in L2). No K split.
// - Rows of x past M, K past K and columns past N read as zeros (TMA) and
//   are not stored.
#include "hopper.cuh"
#include "tensor_map.cuh"

#define W8_BK 128       // K values per stage: one 128-byte row of each tile
#define W8_COLS 128     // weight (output) columns of a tile
#define W8_ROWS 128     // rows of x of a tile (the wgmma's N)
#define W8_ST 4         // ring stages
#define W8_X_BYTES (W8_ROWS * W8_BK)
#define W8_RAW_BYTES (W8_BK * W8_COLS)
#define W8_STAGE (W8_X_BYTES + W8_RAW_BYTES)
#define W8_BODY (W8_ST * W8_STAGE)
#define W8_SMEM (1024 + W8_BODY + 256)  // alignment slack, the ring, the barriers
#define W8_CONSUMERS 256
#define W8_THREADS (W8_CONSUMERS + 32)
#define W8_NACC (W8_ROWS / 2)  // int32 accumulators a thread
#define W8_QUANT_THREADS 256

// d (64 x 128, s32) += A (registers, s8 fragments) . B (smem, K-major, s8)
__device__ __forceinline__ void wgmma_s8_n128(uint32_t* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One stage's A fragments (four 32-deep steps) of warp w of warpgroup wg
// from the raw weight tile (K row r at byte 128 r, its 16-byte chunk c at
// chunk c ^ (r % 8)).
__device__ __forceinline__ void w8_load(uint32_t (*a)[4], const uint8_t* raw, int wg, int w,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int c = wg * 4 + w;  // the warp's 16 columns: one 16-byte chunk of a row
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // K values 4t.. and 16 + 4t.. of the step
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * kk + 16 * h + 4 * t + i;
        p[i] = *reinterpret_cast<const uint16_t*>(raw + r * 128 + ((c ^ (r & 7)) << 4) + 2 * g);
      }
      const uint32_t p01 = p[0] | (p[1] << 16), p23 = p[2] | (p[3] << 16);
      a[kk][2 * h] = __byte_perm(p01, p23, 0x6420);      // column c0 + 2g: fragment row g
      a[kk][2 * h + 1] = __byte_perm(p01, p23, 0x7531);  // c0 + 2g + 1: row g + 8
    }
  }
}

// x8 map: (K, M) bytes, box 128 x 128; w map: (N, K) bytes, box 128 x 128;
// both in the 128-byte swizzle. out: (M, N) of out_kind (W8_OUT_*).
enum { W8_OUT_BF16 = 0, W8_OUT_INT32 = 1, W8_OUT_FP32 = 2 };
__global__ void __launch_bounds__(W8_THREADS, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a_s,
                     const float* __restrict__ s, void* __restrict__ out, int M, int K, int N,
                     int out_kind) {
  extern __shared__ uint8_t w8_smem[];
  uint8_t* base = w8_smem + ((1024u - (smem_addr(w8_smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + W8_BODY);
  uint64_t* empty = full + W8_ST;

  const int nst = (K + W8_BK - 1) / W8_BK;
  const int row_tiles = (M + W8_ROWS - 1) / W8_ROWS;
  const int tiles = (N + W8_COLS - 1) / W8_COLS * row_tiles;
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

  auto xtile = [&](int st) { return base + st * W8_STAGE; };
  auto rawtile = [&](int st) { return base + st * W8_STAGE + W8_X_BYTES; };

  if (warp >= 8) {  // the producer: one thread issues every copy, tile after tile
    if (warp == 8 && lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;  // stages issued so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile / row_tiles * W8_COLS, m0 = tile % row_tiles * W8_ROWS;
        for (int i = 0; i < nst; ++i, ++it) {
          const int st = it % W8_ST, k0 = i * W8_BK;
          if (it >= W8_ST) mbar_wait(empty + st, ((it / W8_ST) - 1) & 1);
          mbar_expect_tx(full + st, W8_STAGE);
          tma_load_2d(xtile(st), &xmap, full + st, k0, m0);
          tma_load_2d(rawtile(st), &wmap, full + st, n0, k0);
        }
      }
    }
    __syncwarp();
    return;
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int c0 = wg * 64 + 16 * w;  // the warp's first column of the tile
  uint32_t acc[W8_NACC];
  uint32_t f0[4][4], f1[4][4];  // two stages' fragments
  int it0 = 0;                  // stages of the ring consumed before this tile
  auto load = [&](int u, uint32_t(*f)[4]) {
    const int gs = it0 + u;
    mbar_wait(full + gs % W8_ST, (gs / W8_ST) & 1);
    w8_load(f, rawtile(gs % W8_ST), wg, w, lane);
  };
  // stage u's products on `cur`; then, once stage u - 1's are done (its
  // ring slot goes back to the producer), stage u + 1's fragments into
  // `nxt` while stage u's products run
  auto step = [&](int u, uint32_t(*cur)[4], uint32_t(*nxt)[4]) {
    const int gs = it0 + u;
    reg_fence<16>(&cur[0][0]);
    reg_fence<W8_NACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8_n128(acc, cur[kk], wgmma_desc128(xtile(gs % W8_ST) + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence<W8_NACC>(acc);
    reg_fence<16>(&nxt[0][0]);
    if (u > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (gs - 1) % W8_ST);
    }
    if (u + 1 < nst) load(u + 1, nxt);
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, it0 += nst) {
    const int n0 = tile / row_tiles * W8_COLS, m0 = tile % row_tiles * W8_ROWS;
    const int na = n0 + c0 + 2 * g;  // this thread's columns na and na + 1 (N % 16 == 0)
#pragma unroll
    for (int i = 0; i < W8_NACC; ++i) acc[i] = 0u;
    load(0, f0);
    for (int u = 0; u < nst; u += 2) {
      step(u, f0, f1);
      if (u + 1 < nst) step(u + 1, f1, f0);
    }
    wgmma_wait<0>();
    reg_fence<W8_NACC>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (it0 + nst - 1) % W8_ST);
    if (na >= N) continue;
    const float sa = s[na], sb = s[na + 1];
    // acc[4j + e]: column na (e < 2) or na + 1 (e >= 2), row m0 + 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < W8_NACC / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= M) continue;
        const int va = (int)acc[4 * j + e], vb = (int)acc[4 * j + 2 + e];
        if (out_kind == W8_OUT_INT32) {
          *reinterpret_cast<int2*>(reinterpret_cast<int*>(out) + (size_t)m * N + na) =
              make_int2(va, vb);
          continue;
        }
        const float am = a_s[m];
        const float oa = __fmul_rn(__fmul_rn(__int2float_rn(va), am), sa);
        const float ob = __fmul_rn(__fmul_rn(__int2float_rn(vb), am), sb);
        if (out_kind == W8_OUT_FP32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + (size_t)m * N + na) =
              make_float2(oa, ob);
        else
          *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + (size_t)m * N + na) =
              pack_f32_bf16x2(oa, ob);
      }
    }
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

// x8 (M, K) int8, w8 (K, N) int8, a_s (M,) fp32, s (N,) fp32, out (M, N)
// bf16, int32 sums or fp32 (out_kind 0, 1, 2: W8_OUT_*); x8, w8 and out
// 16-byte aligned, K and N multiples of 16; ctas: the persistent grid (at
// most one CTA an SM).
PG_EXPORT int pg_w8a8_gemm(const void* x8, const void* w8, const void* a_s, const void* s,
                           void* out, int M, int K, int N, int out_kind, int ctas,
                           void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16 || ctas < 1 || out_kind < W8_OUT_BF16 ||
      out_kind > W8_OUT_FP32 ||
      ((uintptr_t)x8 | (uintptr_t)w8 | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  int err = tma_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x8, K, M, K, W8_BK, W8_ROWS,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, N, K, N, W8_COLS, W8_BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      w8a8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W8_SMEM);
  if (e != cudaSuccess) return (int)e;
  w8a8_gemm_kernel<<<ctas, W8_THREADS, W8_SMEM, (cudaStream_t)stream>>>(
      xmap, wmap, (const float*)a_s, (const float*)s, out, M, K, N, out_kind);
  return (int)cudaGetLastError();
}
