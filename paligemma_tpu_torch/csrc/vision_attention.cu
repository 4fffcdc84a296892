// Multi-head attention for the SigLIP vision tower on Hopper's warpgroup
// tensor cores (wgmma), its tiles brought in by TMA.
//
// Replaces paligemma_tpu/kernels/ablation/vision_attention.py:_kernel
// (non-causal, unmasked MHA over all S patches, a block of heads per grid
// step). Per (batch, head) it computes what the TPU kernel computes,
//
//   s = q k^T * scale  (fp32),  p = exp(s - rowmax(s)),  l = rowsum(p)
//   out = (bf16(p) . v) / l      (fp32 accumulators)
//
// with an online softmax instead of the TPU kernel's one-shot one (which
// needs a row's S scores at once and bounds S by shared memory here): a
// running max m and sum l per row, O rescaled by 2^(m_old - m_new) only
// when a row's max grew, p rounded to bf16 against the running max. So the
// result differs from the one-shot softmax by bf16 rounding only.
//
// What bounds it: at So400m's shapes (H 16, D 72) the work is 4 S^2 D H
// flops per call, 77 GFLOP at S = 4096 against 19 MB of q/k/v/out, so the
// tensor cores bound it from S = 1024 up (0.078 ms at S = 4096 on an H100)
// and memory at S = 256. The design:
// - A block owns 64 * NWG query rows of one (batch, head): NWG consumer
//   warpgroups of 64 rows each, and one producer warp. blockIdx.x is the
//   row tile, so consecutive blocks share a head and find its K/V in L2.
// - The producer warp loads the block's Q once, then the head's K and V in
//   128-key tiles, by TMA into a ring of ST stages, with a full barrier for
//   K and one for V per stage (q.k^T starts before V has landed) and an
//   empty barrier that the consumers' warps arrive on when a stage is read.
// - q.k^T is wgmma.m64n128k16 with Q and K from shared memory, over the
//   depth rounded up to 16 (five k-steps at D = 72). p.v is wgmma.m64nDPk16
//   with p from registers (the scores' accumulator rounded to bf16 is the
//   A operand) and V from shared memory read MN-major (DP = 80 at D = 72).
// - Depth is stored as 16-column atoms in TMA's 32-byte swizzle
//   (hopper.cuh); the tensor map's innermost extent is D, so TMA fills the
//   columns D .. DP - 1 with zeros and no padded copy of q, k or v exists.
// - The softmax runs in log2 units: one FFMA and one ex2 per score.
// - No atomics: a second call on the same inputs gives the same bits.
// - No setmaxnreg: at one block of 288 threads per SM (NWG = 2) or two of
//   160 (NWG = 1) every thread may already hold more registers than a
//   consumer needs (ptxas.log), so giving the producer's back buys nothing.
// At D = 72 the exponentials cost nearly as much as the products (one ex2
// per 4 D = 288 flops; an H100's special-function units run at 1/250 of
// its bf16 tensor rate). On an H100 none of these beat this design at
// S = 4096 (PERF.md): depth 96 or 128 in a 64- or 128-byte swizzle,
// tile j's q.k^T issued with tile j - 1's p.v, the two warpgroups taking
// turns through named barriers, K/V multicast to a 2-CTA cluster.
#include "hopper.cuh"
#include "tensor_map.cuh"

#define VA_BN 128           // keys per K / V tile
#define VA_SMEM_MAX 232448  // dynamic shared memory a block may use (227 KB)

// NA 16-column depth atoms (DP = 16 NA: 64, 80 or 128), NWG consumer
// warpgroups of 64 query rows.
template <int NA, int NWG>
struct VaCfg {
  static constexpr int DP = 16 * NA;
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = VA_BN * DP * 2;  // one K (or V) tile
  static constexpr int FIT = (VA_SMEM_MAX - 2048 - Q_BYTES) / (2 * KV_BYTES);
  // ring stages: two for the 64-row blocks (two blocks per SM), else as
  // many as fit, at most four
  static constexpr int ST = NWG == 1 ? 2 : (FIT < 4 ? FIT : 4);
  // 1024 bytes of alignment slack, the tiles, then the barriers
  static constexpr int BYTES = 1024 + Q_BYTES + 2 * ST * KV_BYTES + 1024;
};

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DP == 80) wgmma_rs_n80(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ float va_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int NA, int NWG>
__global__ void __launch_bounds__(VaCfg<NA, NWG>::THREADS, NWG == 1 ? 2 : 1)
    vision_attn_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, int S,
                       int H, int D, float scale_log2) {
  using C = VaCfg<NA, NWG>;
  constexpr int DP = C::DP, BM = C::BM, ST = C::ST;
  extern __shared__ uint8_t va_smem[];
  uint8_t* base = va_smem + ((1024u - (smem_addr(va_smem) & 1023u)) & 1023u);
  uint8_t* kbase = base + C::Q_BYTES;
  uint8_t* vbase = kbase + ST * C::KV_BYTES;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vbase + ST * C::KV_BYTES);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int row0 = b * S;  // this batch's first row of the (B * S) row axis
  const int nkt = S / VA_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_k + i, 1);
      mbar_init(full_v + i, 1);
      mbar_init(empty + i, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a) tma_load_3d(base + a * BM * 32, &qmap, full_q, a * 16, h, row0 + q0);
      for (int j = 0; j < nkt; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(empty + st, ((j / ST) - 1) & 1);
        uint8_t* kt = kbase + st * C::KV_BYTES;
        uint8_t* vt = vbase + st * C::KV_BYTES;
        mbar_expect_tx(full_k + st, C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_3d(kt + a * VA_BN * 32, &kmap, full_k + st, a * 16, h, row0 + j * VA_BN);
        mbar_expect_tx(full_v + st, C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_3d(vt + a * VA_BN * 32, &vmap, full_v + st, a * 16, h, row0 + j * VA_BN);
      }
    }
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg .. + 63; this thread's rows are
  // 16 w + g and 16 w + g + 8 of them
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {PG_NEG_INF, PG_NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};                // this thread's share of the running sum

  mbar_wait(full_q, 0);
  for (int j = 0; j < nkt; ++j) {
    const int st = j % ST;
    const uint32_t ph = (j / ST) & 1;
    const uint8_t* kt = kbase + st * C::KV_BYTES;
    const uint8_t* vt = vbase + st * C::KV_BYTES;

    // s = q k^T: 64 rows x 128 keys, fp32
    float s[VA_BN / 2];
#pragma unroll
    for (int i = 0; i < VA_BN / 2; ++i) s[i] = 0.f;
    mbar_wait(full_k + st, ph);
    reg_fence<VA_BN / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NA; ++kk)
      wgmma_ss_n128(s, wgmma_desc(base + kk * BM * 32 + wg * 64 * 32, 16, 256),
                    wgmma_desc(kt + kk * VA_BN * 32, 16, 256), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<VA_BN / 2>(s);

    // the new row max over the quad that shares each row; O and l are
    // rescaled only when a max grew somewhere in the warp
    float mx[2] = {PG_NEG_INF, PG_NEG_INF};
#pragma unroll
    for (int n = 0; n < VA_BN / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = va_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }
    // p = 2^(s scale log2(e) - m) in fp32 (summed into l), then bf16:
    // score columns 16 kk .. + 15 are the A operand of k-step kk
    uint32_t pa[VA_BN / 16][4];
#pragma unroll
    for (int n = 0; n < VA_BN / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = va_exp2(fmaf(s[4 * n + e], scale_log2, -m[e >> 1]));
        l[e >> 1] += p[e];
      }
      pa[n >> 1][(n & 1) * 2] = pack_f32_bf16x2(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_f32_bf16x2(p[2], p[3]);
    }

    // O += p v: V[key][d] read MN-major, keys 16 kk .. + 15 per k-step
    mbar_wait(full_v + st, ph);
    reg_fence<DP / 2>(o);
    reg_fence<VA_BN / 4>(&pa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < VA_BN / 16; ++kk)
      wgmma_pv<DP>(o, pa[kk], wgmma_desc(vt + kk * 16 * 32, VA_BN * 32, 256));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<DP / 2>(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);  // this warp has read the stage
  }

  // the row sums over the quad, then normalize and store (B, S, H, D) bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const int ra = row0 + q0 + wg * 64 + w * 16 + g;
  bf16* oa = out + ((size_t)ra * H + h) * D;
  bf16* ob = out + ((size_t)(ra + 8) * H + h) * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    if (n * 8 < D) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(oa + col) = pack_f32_bf16x2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(ob + col) =
          pack_f32_bf16x2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps, built per call from the pointers
// (tensor_map.cuh).
// ---------------------------------------------------------------------------
// (B, S, H, D) bf16 as a 3-D map (D, H, B * S) whose box is 16 columns of
// one head by `rows` positions, written in the 32-byte swizzle; columns at
// or past D read as zeros. Returns a cudaError_t.
static int va_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)B * (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2};
  const cuuint32_t box[3] = {16, 1, (cuuint32_t)rows};
  return tma_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box,
                 CU_TENSOR_MAP_SWIZZLE_32B);
}

static int va_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, int B, int S,
                   int H, int D, int rows) {
  int err = va_map(&maps[0], q, B, S, H, D, rows);
  if (!err) err = va_map(&maps[1], k, B, S, H, D, VA_BN);
  if (!err) err = va_map(&maps[2], v, B, S, H, D, VA_BN);
  return err;
}

template <int NA, int NWG>
static int va_launch(const CUtensorMap* maps, bf16* out, int B, int S, int H, int D, float scale,
                     cudaStream_t st) {
  using C = VaCfg<NA, NWG>;
  cudaError_t err = cudaFuncSetAttribute(vision_attn_kernel<NA, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  vision_attn_kernel<NA, NWG><<<dim3(S / C::BM, H, B), C::THREADS, C::BYTES, st>>>(
      maps[0], maps[1], maps[2], out, S, H, D, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// q, k, v, out: (B, S, H, D) bf16, contiguous, 16-byte aligned; S % 128 ==
// 0, D % 8 == 0, D <= 128; rows: 64 or 128 query rows per block (the
// wrapper checks these). D <= 64 runs at depth 64, D <= 80 at 80, else 128.
PG_EXPORT int pg_vision_attention(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int H, int D, int rows, float scale, void* stream) {
  CUtensorMap maps[3];
  int err = va_maps(maps, q, k, v, B, S, H, D, rows);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* op = (bf16*)out;
  const bool two = rows == 128;
  if (D <= 64) return two ? va_launch<4, 2>(maps, op, B, S, H, D, scale, st)
                          : va_launch<4, 1>(maps, op, B, S, H, D, scale, st);
  if (D <= 80) return two ? va_launch<5, 2>(maps, op, B, S, H, D, scale, st)
                          : va_launch<5, 1>(maps, op, B, S, H, D, scale, st);
  return two ? va_launch<8, 2>(maps, op, B, S, H, D, scale, st)
             : va_launch<8, 1>(maps, op, B, S, H, D, scale, st);
}

// Builds the three tensor maps of a call `iters` times and launches
// nothing: the host cost of the maps, for measurement.
PG_EXPORT int pg_vision_attention_maps(const void* q, const void* k, const void* v, int B, int S,
                                       int H, int D, int rows, int iters) {
  CUtensorMap maps[3];
  for (int i = 0; i < iters; ++i) {
    const int err = va_maps(maps, q, k, v, B, S, H, D, rows);
    if (err) return err;
  }
  return 0;
}
