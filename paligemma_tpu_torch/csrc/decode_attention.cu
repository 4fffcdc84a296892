// Single-token MQA attention over one layer's KV-cache window.
//
// Replaces the attention piece of paligemma_tpu/kernels/decode_layer.py:
// _kernel_all (per-row MQA over cache slots [0, W) with a (B, W) validity
// mask; fp32 softmax). The fresh token's K/V is already in the cache (the
// qkv GEMV's RoPE epilogue wrote it), so no arithmetic merge is needed here.
//
//   out[b, h*D:(h+1)*D] = sum_j p[b,h,j] v[c,j],  p = softmax over valid j
//                          of scale * q[b,h] . k[c,j];  no valid j -> 0
//
// where c = b / rows_per_cache: a speculative verify (models/paligemma
// decode_verify on the kernel path) scores the s positions of a block as s
// query rows of one cache row, each with its own row of the mask; a decode
// step passes 1.
//
// What bounds it: reading the K and V window (2 * W * D * 2 bytes per row
// and layer; 2 MB at W=2048, D=256); the flops are ~Hq per byte. All Hq
// query heads share the one KV head, so each block reads a K/V tile once
// for all heads, and scores it with tensor-core products whose live rows
// are the heads. The window is split over blocks of DA_KT = 32 keys
// (split-K), so a single row puts W/32 blocks on the card; each block
// stages its K and V tiles as two groups of cp.async copies, writes an
// unnormalized (max, sum, output) triple, and a combine pass of one block
// per 32 output columns and head merges the splits in a fixed order. The
// two passes live in attention_split.cuh, shared with the paged kernel
// (paged_attention.cu) and the length-aware one (seg_attention.cu). (A
// first version that walked 256 keys per block with one dependent load per
// key took 68 us per call at W=512; the template's first version, scalar
// FMAs and a combine of one block per head, 17.3 us at W=2048: both on an
// H100 80GB HBM3 at 700 W.)
//
// pg_decode_attention_fp32 is the fp32 form (--dtype float32): fp32 q,
// cache and out, the template's fp32 split pass (attention_split.cuh) on
// the same tiles and combine. The mixed forms take a cache of the other
// dtype (the engines' cache_dtype): pg_decode_attention_cache_fp32 (bf16 q
// and out, an fp32 cache rounded to bf16 as each tile is staged, then the
// bf16 pass) and pg_decode_attention_fp32_cache_bf16 (fp32 q and out, a
// bf16 cache widened to fp32, then the fp32 pass).
#include "attention_split.cuh"

// q and out in the activation type T, the caches in E: the bf16 pass at
// T = bf16, the fp32 pass at T = float.
template <bool kShared, class T, class E>
static int launch(const void* q, const void* k_cache, const void* v_cache, const void* valid,
                  void* part_m, void* part_l, void* part_o, void* out, int B, int H, int D,
                  int W, int stride_b, int rows_per_cache, int nsplit, float scale,
                  void* stream) {
  DenseKV<kShared, E> kv{(const E*)k_cache, (const E*)v_cache, (const uint8_t*)valid,
                         (long long)stride_b, D, W, rows_per_cache};
  if constexpr (sizeof(T) == 4)
    return attn_launch_f32((const float*)q, kv, (float*)part_m, (float*)part_l, (float*)part_o,
                           (float*)out, B, H, /*Hkv=*/1, D, W, nsplit, scale,
                           (cudaStream_t)stream);
  else
    return attn_launch((const bf16*)q, kv, (float*)part_m, (float*)part_l, (float*)part_o,
                       (bf16*)out, B, H, /*Hkv=*/1, D, W, nsplit, scale, (cudaStream_t)stream);
}

template <class T, class E>
static int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* valid,
                    void* part_m, void* part_l, void* part_o, void* out, int B, int H, int D,
                    int W, int stride_b, int rows_per_cache, int nsplit, float scale,
                    void* stream) {
  return (rows_per_cache == 1 ? launch<false, T, E> : launch<true, T, E>)(
      q, k_cache, v_cache, valid, part_m, part_l, part_o, out, B, H, D, W, stride_b,
      rows_per_cache, nsplit, scale, stream);
}

PG_EXPORT int pg_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                  const void* valid, void* part_m, void* part_l, void* part_o,
                                  void* out, int B, int H, int D, int W, int stride_b,
                                  int rows_per_cache, int nsplit, float scale, void* stream) {
  return dispatch<bf16, bf16>(q, k_cache, v_cache, valid, part_m, part_l, part_o, out, B, H, D,
                              W, stride_b, rows_per_cache, nsplit, scale, stream);
}

// As pg_decode_attention with fp32 q (B, H, D), caches and out (B, H * D).
PG_EXPORT int pg_decode_attention_fp32(const void* q, const void* k_cache, const void* v_cache,
                                       const void* valid, void* part_m, void* part_l,
                                       void* part_o, void* out, int B, int H, int D, int W,
                                       int stride_b, int rows_per_cache, int nsplit, float scale,
                                       void* stream) {
  return dispatch<float, float>(q, k_cache, v_cache, valid, part_m, part_l, part_o, out, B, H,
                                D, W, stride_b, rows_per_cache, nsplit, scale, stream);
}

// As pg_decode_attention (bf16 q and out) over fp32 caches.
PG_EXPORT int pg_decode_attention_cache_fp32(const void* q, const void* k_cache,
                                             const void* v_cache, const void* valid,
                                             void* part_m, void* part_l, void* part_o, void* out,
                                             int B, int H, int D, int W, int stride_b,
                                             int rows_per_cache, int nsplit, float scale,
                                             void* stream) {
  return dispatch<bf16, float>(q, k_cache, v_cache, valid, part_m, part_l, part_o, out, B, H,
                               D, W, stride_b, rows_per_cache, nsplit, scale, stream);
}

// As pg_decode_attention_fp32 (fp32 q and out) over bf16 caches.
PG_EXPORT int pg_decode_attention_fp32_cache_bf16(const void* q, const void* k_cache,
                                                  const void* v_cache, const void* valid,
                                                  void* part_m, void* part_l, void* part_o,
                                                  void* out, int B, int H, int D, int W,
                                                  int stride_b, int rows_per_cache, int nsplit,
                                                  float scale, void* stream) {
  return dispatch<float, bf16>(q, k_cache, v_cache, valid, part_m, part_l, part_o, out, B, H,
                               D, W, stride_b, rows_per_cache, nsplit, scale, stream);
}
