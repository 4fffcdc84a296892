// The int8 GEMV's fp32 entry point (--dtype float32; the kernel and its
// design: int8_gemv.cuh, the tile's fp32 form: gemv_tile.cuh
// gemv_tile_sums_f32).
#include "int8_gemv.cuh"

// The fp32 form (--dtype float32) of every mode: 0-2 and 4 with the norm
// prologue where nw is not null (nw (K,) fp32, K % 4 == 0, x and nw 16-byte
// aligned), mode 3 (the fp32 partial, no norm), and the LoRA expand where z
// is not null (z (B, nz) fp32, 16-byte aligned; lb, G, nz, seg1, seg2 as
// pg_int8_gemv_lora; mode 3 writes out (B, 2N), [base | delta]). x,
// residual, out, cos, sin, k_dst, v_dst, k_new and v_new are fp32; the rest
// as pg_int8_gemv_fused.
PG_EXPORT int pg_int8_gemv_fp32(const void* x, const void* w8, const void* s,
                                const void* residual, void* out, int B, int K, int N, int mode,
                                int cluster, int warps, int k_per_cta, const void* z,
                                const void* lb, int lb_f32, int G, int nz, int seg1, int seg2,
                                const void* nw, float eps, const void* cos, const void* sin,
                                const void* pos, void* k_dst, void* v_dst, void* k_new,
                                void* v_new, const void* table, int H, int D, int rows,
                                int tstride, void* stream) {
  if (mode < 0 || mode > 4 || (mode == 3 && nw != nullptr)) return (int)cudaErrorInvalidValue;
  if (z != nullptr && (G <= 0 || G % 8 || nz % G || nz / G > 3)) return (int)cudaErrorInvalidValue;
  if (mode == 4 && (D <= 0 || (D / 2) % 16 || N != (H + 2) * D)) return (int)cudaErrorInvalidValue;
  const LoraExpand lora{z, lb, lb_f32, G, nz, seg1, seg2};
  const NormInF norm{(const float*)nw, eps};
  const RopeKVT<float> rope{(const float*)cos, (const float*)sin, (const int*)pos,
                            (float*)k_dst, (float*)v_dst, (float*)k_new, (float*)v_new,
                            (const int*)table, H, D, rows, tstride};
  const bool with_norm = nw != nullptr;
  if (z != nullptr)
    return with_norm
               ? launch_gemv<true, true, float>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                                warps, k_per_cta, lora, norm, rope, stream)
               : launch_gemv<true, false, float>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                                 warps, k_per_cta, lora, norm, rope, stream);
  return with_norm
             ? launch_gemv<false, true, float>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                               warps, k_per_cta, lora, norm, rope, stream)
             : launch_gemv<false, false, float>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                                warps, k_per_cta, lora, norm, rope, stream);
}

// Mode 4 of fp32 x with the norm prologue (and the LoRA expand where z is
// not null) over a bf16 cache (a mixed cache dtype): the arguments of
// pg_int8_gemv_fp32, k_dst, v_dst, k_new and v_new bf16, each fp32 row
// rounded to bf16 to nearest even (int8_gemv.cuh).
PG_EXPORT int pg_int8_gemv_fp32_rope_kv_cache_bf16(
    const void* x, const void* w8, const void* s, const void* residual, void* out, int B, int K,
    int N, int mode, int cluster, int warps, int k_per_cta, const void* z, const void* lb,
    int lb_f32, int G, int nz, int seg1, int seg2, const void* nw, float eps, const void* cos,
    const void* sin, const void* pos, void* k_dst, void* v_dst, void* k_new, void* v_new,
    const void* table, int H, int D, int rows, int tstride, void* stream) {
  return launch_rope_kv<float, bf16>(x, w8, s, residual, out, B, K, N, mode, cluster, warps,
                                     k_per_cta, z, lb, lb_f32, G, nz, seg1, seg2, nw, eps, cos,
                                     sin, pos, k_dst, v_dst, k_new, v_new, table, H, D, rows,
                                     tstride, stream);
}
