// Length-aware single-token GQA over a dense (B, S, Hkv, D) KV cache, with
// the visible keys given by three scalars per row.
//
// Replaces paligemma_tpu/kernels/ablation/decode_attention.py:_kernel
// (one query token per row, key blocks past the row's last needed block
// skipped, online softmax in fp32):
//
//   out[b, h] = sum_j p[b,h,j] v[b,j,h/G],  p = softmax over visible j of
//               scale * q[b,h] . k[b,j,h/G];  no visible j -> 0
//   visible(j) = j < seg0[b]  or  seg1[b] <= j < kv_len[b]
//
// What bounds it: reading the visible keys and values (2 * D * 2 bytes per
// key and KV head: 2.1 MB at kv_len 2048, D 256, one KV head); the flops
// are G per byte. The design is the split/combine of attention_split.cuh
// with the SegKV address policy: 32-key tiles staged by cp.async, only
// their visible keys read, the G query heads of a KV head scored against
// one staged tile on the tensor cores, a tile with no visible key (wholly
// past kv_len, or wholly inside the pad hole [seg0, seg1)) skipped without
// a load, and a fixed-order combine. A page table cannot express the hole,
// so this is a policy of its own rather than the paged kernel over an
// identity table. fp32 q and cache (pg_seg_attention_fp32) take the fp32
// split pass over the same policy (SegKV<float>): fp32 tiles, scores and
// p.v in order on the CUDA cores, p not rounded, the same skipped tiles.
#include "attention_split.cuh"

PG_EXPORT int pg_seg_attention(const void* q, const void* k_cache, const void* v_cache,
                               const void* seg0, const void* seg1, const void* kv_len,
                               void* part_m, void* part_l, void* part_o, void* out, int B,
                               int Hq, int Hkv, int D, int S, int nsplit, float scale,
                               void* stream) {
  SegKV<bf16> kv{(const bf16*)k_cache, (const bf16*)v_cache, (const int*)seg0,
                 (const int*)seg1, (const int*)kv_len, S, Hkv, D};
  return attn_launch((const bf16*)q, kv, (float*)part_m, (float*)part_l, (float*)part_o,
                     (bf16*)out, B, Hq / Hkv, Hkv, D, S, nsplit, scale, (cudaStream_t)stream);
}

// The fp32 form: q (B, Hq, D), the caches and out fp32, the rest as
// pg_seg_attention; attention_split.cuh's fp32 split pass over SegKV<float>
// and the combine writing fp32.
PG_EXPORT int pg_seg_attention_fp32(const void* q, const void* k_cache, const void* v_cache,
                                    const void* seg0, const void* seg1, const void* kv_len,
                                    void* part_m, void* part_l, void* part_o, void* out, int B,
                                    int Hq, int Hkv, int D, int S, int nsplit, float scale,
                                    void* stream) {
  SegKV<float> kv{(const float*)k_cache, (const float*)v_cache, (const int*)seg0,
                  (const int*)seg1, (const int*)kv_len, S, Hkv, D};
  return attn_launch_f32((const float*)q, kv, (float*)part_m, (float*)part_l, (float*)part_o,
                         (float*)out, B, Hq / Hkv, Hkv, D, S, nsplit, scale,
                         (cudaStream_t)stream);
}
