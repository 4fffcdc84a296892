// Paged single-token GQA attention: one query token per row over the row's
// logical pages [0, kv_len), read through a page table from a page pool.
//
// Replaces paligemma_tpu/kernels/paged_attention.py: _kernel (one page per
// grid step), _kernel_multi (8 pages per step, hand-gathered), _kernel_batched
// (all rows per step) and _kernel_runs (one DMA per physically consecutive
// page run). The four compute one function and differ only in how they order
// the TPU's DMAs; on Hopper one kernel serves all four names.
//
//   out[b, h] = sum_{j < kv_len[b]} p[b,h,j] v[b,j],
//   p = softmax_j(scale * q[b,h] . k[b,j]),  kv_len[b] == 0 -> 0
//   k[b,j] = pool[layer, table[b, j / ps], j % ps, h / G]
//
// What bounds it: reading the row's K and V pages (2 * kv_len * D * 2 bytes
// per row, KV head and layer). The design is decode_attention.cu's: split-K
// over 32-key tiles, each tile staged in shared memory by cp.async (the page
// lookup is per key, so any page size works and a fragmented table costs no
// more than a contiguous one; a key past kv_len is never looked up), the G
// query heads of a KV head scored against one staged tile on the tensor
// cores, and a fixed-order combine pass. Tiles past kv_len are skipped
// without a load, so reads follow the live tokens and not the table's
// width. Both kernels are the same template (attention_split.cuh): on the
// same keys they return the same bits.
//
// pg_paged_attention_fp32 is the fp32 form (--dtype float32): an fp32 pool,
// q and out through the template's fp32 split pass, so dense == paged at
// fp32 too. The mixed forms take a pool of the other dtype, as
// decode_attention.cu's do: pg_paged_attention_cache_fp32 (bf16 q and out,
// an fp32 pool rounded to bf16 as staged) and
// pg_paged_attention_fp32_cache_bf16 (fp32 q and out, a bf16 pool widened).
#include "attention_split.cuh"

// q and out in the activation type T, the pool in E (see decode_attention.cu).
template <class T, class E>
static int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
                  const void* kv_len, void* part_m, void* part_l, void* part_o, void* out, int B,
                  int Hq, int Hkv, int D, int W, int page_size, int table_stride,
                  long long layer_off, int nsplit, float scale, void* stream) {
  PagedKV<E> kv{(const E*)k_pool, (const E*)v_pool, (const int*)table, (const int*)kv_len,
                layer_off, page_size, table_stride, Hkv, D};
  if constexpr (sizeof(T) == 4)
    return attn_launch_f32((const float*)q, kv, (float*)part_m, (float*)part_l, (float*)part_o,
                           (float*)out, B, Hq / Hkv, Hkv, D, W, nsplit, scale,
                           (cudaStream_t)stream);
  else
    return attn_launch((const bf16*)q, kv, (float*)part_m, (float*)part_l, (float*)part_o,
                       (bf16*)out, B, Hq / Hkv, Hkv, D, W, nsplit, scale, (cudaStream_t)stream);
}

PG_EXPORT int pg_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                 const void* table, const void* kv_len, void* part_m,
                                 void* part_l, void* part_o, void* out, int B, int Hq, int Hkv,
                                 int D, int W, int page_size, int table_stride,
                                 long long layer_off, int nsplit, float scale, void* stream) {
  return launch<bf16, bf16>(q, k_pool, v_pool, table, kv_len, part_m, part_l, part_o, out, B, Hq,
                            Hkv, D, W, page_size, table_stride, layer_off, nsplit, scale, stream);
}

// As pg_paged_attention with fp32 q (B, Hq, D), pool and out (B, Hq, D).
PG_EXPORT int pg_paged_attention_fp32(const void* q, const void* k_pool, const void* v_pool,
                                      const void* table, const void* kv_len, void* part_m,
                                      void* part_l, void* part_o, void* out, int B, int Hq,
                                      int Hkv, int D, int W, int page_size, int table_stride,
                                      long long layer_off, int nsplit, float scale,
                                      void* stream) {
  return launch<float, float>(q, k_pool, v_pool, table, kv_len, part_m, part_l, part_o, out, B,
                              Hq, Hkv, D, W, page_size, table_stride, layer_off, nsplit, scale,
                              stream);
}

// As pg_paged_attention (bf16 q and out) over an fp32 pool.
PG_EXPORT int pg_paged_attention_cache_fp32(const void* q, const void* k_pool,
                                            const void* v_pool, const void* table,
                                            const void* kv_len, void* part_m, void* part_l,
                                            void* part_o, void* out, int B, int Hq, int Hkv,
                                            int D, int W, int page_size, int table_stride,
                                            long long layer_off, int nsplit, float scale,
                                            void* stream) {
  return launch<bf16, float>(q, k_pool, v_pool, table, kv_len, part_m, part_l, part_o, out, B,
                             Hq, Hkv, D, W, page_size, table_stride, layer_off, nsplit, scale,
                             stream);
}

// As pg_paged_attention_fp32 (fp32 q and out) over a bf16 pool.
PG_EXPORT int pg_paged_attention_fp32_cache_bf16(const void* q, const void* k_pool,
                                                 const void* v_pool, const void* table,
                                                 const void* kv_len, void* part_m, void* part_l,
                                                 void* part_o, void* out, int B, int Hq, int Hkv,
                                                 int D, int W, int page_size, int table_stride,
                                                 long long layer_off, int nsplit, float scale,
                                                 void* stream) {
  return launch<float, bf16>(q, k_pool, v_pool, table, kv_len, part_m, part_l, part_o, out, B,
                             Hq, Hkv, D, W, page_size, table_stride, layer_off, nsplit, scale,
                             stream);
}
