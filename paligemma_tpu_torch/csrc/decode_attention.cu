// Single-token MQA attention over one layer's KV-cache window.
//
// Replaces the attention piece of paligemma_tpu/kernels/decode_layer.py:
// _kernel_all (per-row MQA over cache slots [0, W) with a (B, W) validity
// mask; fp32 softmax). The fresh token's K/V is already in the cache (the
// rope_kv_write kernel wrote it), so no arithmetic merge is needed here.
//
//   out[b, h*D:(h+1)*D] = sum_j p[b,h,j] v[b,j],  p = softmax over valid j
//                          of scale * q[b,h] . k[b,j];  no valid j -> 0
//
// What bounds it: reading the K and V window (2 * W * D * 2 bytes per row
// and layer; 2 MB at W=2048, D=256); the flops are ~Hq per byte. All Hq query
// heads share the one KV head, so each block reads a K/V tile once for all
// heads. The window is split over blocks of DA_KT = 32 keys (split-K), so a
// single row puts W/32 blocks on the card; each block stages its K/V tile in
// shared memory with independent 16-byte loads (a first version that walked
// 256 keys per block with one dependent load per key took 68 us per call at
// W=512 on an H100 80GB HBM3 at 700 W),
// writes an unnormalized (max, sum, output) triple, and a combine pass
// merges the splits with the usual rescaling.
#include "common.cuh"

#define DA_KT 32        // keys per split block
#define DA_THREADS 256  // 8 warps
#define DA_HMAX 8       // query heads per KV head (Gemma-2B: 8)
#define DA_DMAX 256

__global__ void __launch_bounds__(DA_THREADS)
    decode_attention_split(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                           const bf16* __restrict__ vc, const uint8_t* __restrict__ valid,
                           float* __restrict__ part_m, float* __restrict__ part_l,
                           float* __restrict__ part_o, int H, int D, int W, long long stride_b,
                           int nsplit, float scale) {
  __shared__ float qs[DA_HMAX][DA_DMAX];
  __shared__ __align__(16) bf16 ks[DA_KT][DA_DMAX];
  __shared__ __align__(16) bf16 vs[DA_KT][DA_DMAX];
  __shared__ float sc[DA_HMAX][DA_KT];
  __shared__ uint8_t ok[DA_KT];
  const int b = blockIdx.y, split = blockIdx.x;
  const int k0 = split * DA_KT;
  const int nk = min(DA_KT, W - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nchunk = D / 8;
  for (int i = tid; i < DA_HMAX * DA_DMAX; i += DA_THREADS) {
    const int h = i / DA_DMAX, d = i - h * DA_DMAX;
    qs[h][d] = (h < H && d < D) ? bf2f(q[((size_t)b * H + h) * D + d]) : 0.f;
  }
  if (tid < nk) ok[tid] = valid[(size_t)b * W + k0 + tid];
  // stage the K/V tile with independent 16-byte loads (all in flight at once)
  const bf16* kb = kc + (size_t)b * stride_b + (size_t)k0 * D;
  const bf16* vb = vc + (size_t)b * stride_b + (size_t)k0 * D;
  for (int i = tid; i < nk * nchunk; i += DA_THREADS) {
    const int j = i / nchunk, c = i - j * nchunk;
    *reinterpret_cast<uint4*>(&ks[j][c * 8]) =
        *reinterpret_cast<const uint4*>(kb + (size_t)j * D + c * 8);
    *reinterpret_cast<uint4*>(&vs[j][c * 8]) =
        *reinterpret_cast<const uint4*>(vb + (size_t)j * D + c * 8);
  }
  __syncthreads();

  // scores: warp w takes keys w, w+8, ...; lane covers d = lane*8 .. +8
  const bool lane_on = lane < nchunk;
  for (int j = warp; j < nk; j += DA_THREADS / 32) {
    float kv[8];
    if (lane_on) bf16x8_to_float(*reinterpret_cast<const uint4*>(&ks[j][lane * 8]), kv);
    float dots[DA_HMAX];
#pragma unroll
    for (int h = 0; h < DA_HMAX; ++h) {
      float acc = 0.f;
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(qs[h][lane * 8 + e], kv[e], acc);
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

  // per-head max and sum over this split's valid keys: warp h, lane = key
  if (warp < H) {
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
      part_m[((size_t)b * nsplit + split) * H + warp] = m;
      part_l[((size_t)b * nsplit + split) * H + warp] = l;
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
    for (int h = 0; h < H; ++h)
      part_o[(((size_t)b * nsplit + split) * H + h) * D + d] = acc[h];
  }
}

__global__ void decode_attention_combine(const float* __restrict__ part_m,
                                         const float* __restrict__ part_l,
                                         const float* __restrict__ part_o,
                                         bf16* __restrict__ out, int H, int D, int nsplit) {
  const int b = blockIdx.y, h = blockIdx.x;
  float mx = PG_NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[((size_t)b * nsplit + s) * H + h]);
  float den = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t i = ((size_t)b * nsplit + s) * H + h;
    den += __expf(part_m[i] - mx) * part_l[i];
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = ((size_t)b * nsplit + s) * H + h;
      num += __expf(part_m[i] - mx) * part_o[i * D + d];
    }
    out[((size_t)b * H + h) * D + d] = f2bf(num * inv);
  }
}

PG_EXPORT int pg_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                  const void* valid, void* part_m, void* part_l, void* part_o,
                                  void* out, int B, int H, int D, int W, int stride_b,
                                  int nsplit, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  decode_attention_split<<<dim3(nsplit, B), DA_THREADS, 0, st>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache, (const uint8_t*)valid,
      (float*)part_m, (float*)part_l, (float*)part_o, H, D, W, (long long)stride_b, nsplit,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_combine<<<dim3(H, B), 256, 0, st>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_o, (bf16*)out, H, D,
      nsplit);
  return (int)cudaGetLastError();
}
