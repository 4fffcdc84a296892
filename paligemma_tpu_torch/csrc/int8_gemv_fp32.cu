// The int8 GEMV's fp32 entry point (--dtype float32; the kernel and its
// design: int8_gemv.cuh, the tile's fp32 form: gemv_tile.cuh
// gemv_tile_sums_f32).
#include "int8_gemv.cuh"

// The fp32 form (--dtype float32): modes 0-2 and 4, no LoRA expand, with
// the norm prologue where nw is not null (nw (K,) fp32, K % 4 == 0, x and
// nw 16-byte aligned). x, residual, out, cos, sin, k_dst, v_dst, k_new and
// v_new are fp32; the rest as pg_int8_gemv_fused.
PG_EXPORT int pg_int8_gemv_fp32(const void* x, const void* w8, const void* s,
                                const void* residual, void* out, int B, int K, int N, int mode,
                                int cluster, int warps, int k_per_cta, const void* nw, float eps,
                                const void* cos, const void* sin, const void* pos, void* k_dst,
                                void* v_dst, void* k_new, void* v_new, const void* table, int H,
                                int D, int rows, int tstride, void* stream) {
  if (mode < 0 || mode == 3 || mode > 4) return (int)cudaErrorInvalidValue;
  if (mode == 4 && (D <= 0 || (D / 2) % 16 || N != (H + 2) * D)) return (int)cudaErrorInvalidValue;
  const NormInF norm{(const float*)nw, eps};
  const RopeKVT<float> rope{(const float*)cos, (const float*)sin, (const int*)pos,
                            (float*)k_dst, (float*)v_dst, (float*)k_new, (float*)v_new,
                            (const int*)table, H, D, rows, tstride};
  if (nw != nullptr)
    return launch_gemv<false, true, float>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                           warps, k_per_cta, LoraExpand{}, norm, rope, stream);
  return launch_gemv<false, false, float>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                          warps, k_per_cta, LoraExpand{}, norm, rope, stream);
}
