// The int8 GEMV's bf16 entry points (the kernel and its design:
// int8_gemv.cuh; the fp32 form's entry point: int8_gemv_fp32.cu, a source of
// its own so that nvcc compiles the two sets of instantiations in parallel).
#include "int8_gemv.cuh"

// x (B, K) bf16, w8 (K, N) int8, s (N,) fp32, residual (B, N) bf16 (mode
// 1), out (B, N) or (B, N / 2) (mode 2); cluster, warps and k_per_cta from
// kernels/gemv_plan.py.
PG_EXPORT int pg_int8_gemv(const void* x, const void* w8, const void* s, const void* residual,
                           void* out, int B, int K, int N, int mode, int cluster, int warps,
                           int k_per_cta, void* stream) {
  if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  return launch_gemv<false, false>(x, w8, s, residual, out, B, K, N, mode, cluster, warps,
                                   k_per_cta, LoraExpand{}, NormIn{}, RopeKV{}, stream);
}

// Modes 0-3 with the LoRA expand: z (B, nz) bf16, lb (G, N) fp32 or bf16,
// column boundaries seg1 <= seg2 (N where there is none), nz = G x the
// targets; mode 3 writes out (B, 2N) fp32, [base | delta].
PG_EXPORT int pg_int8_gemv_lora(const void* x, const void* w8, const void* s,
                                const void* residual, void* out, int B, int K, int N, int mode,
                                int cluster, int warps, int k_per_cta, const void* z,
                                const void* lb, int lb_f32, int G, int nz, int seg1, int seg2,
                                void* stream) {
  if (mode < 0 || mode > 3 || G <= 0 || G % 8 || nz % G || nz / G > 3)
    return (int)cudaErrorInvalidValue;
  return launch_gemv<true, false>(x, w8, s, residual, out, B, K, N, mode, cluster, warps,
                                  k_per_cta, LoraExpand{z, lb, lb_f32, G, nz, seg1, seg2},
                                  NormIn{}, RopeKV{}, stream);
}

// Modes 0-2 and 4 with the norm prologue where nw is not null (nw (K,)
// bf16, 16-byte aligned, K % 8 == 0, the staged rows within GemvSmem::red)
// and the LoRA expand where z is not null (as pg_int8_gemv_lora). Mode 4
// (RoPE + KV write): out is q (B, H, D); N = (H + 2) D with D / 2 % 16 ==
// 0; cos, sin (B, D) bf16, pos (B,) int32, k_dst / v_dst the layer's cache
// (B, rows, D) or, with a table (B, tstride) int32, its pool (n_pages,
// rows, D), k_new / v_new (B, D), all bf16.
PG_EXPORT int pg_int8_gemv_fused(const void* x, const void* w8, const void* s,
                                 const void* residual, void* out, int B, int K, int N, int mode,
                                 int cluster, int warps, int k_per_cta, const void* z,
                                 const void* lb, int lb_f32, int G, int nz, int seg1, int seg2,
                                 const void* nw, float eps, const void* cos, const void* sin,
                                 const void* pos, void* k_dst, void* v_dst, void* k_new,
                                 void* v_new, const void* table, int H, int D, int rows,
                                 int tstride, void* stream) {
  if (mode < 0 || mode == 3 || mode > 4) return (int)cudaErrorInvalidValue;
  if (z != nullptr && (G <= 0 || G % 8 || nz % G || nz / G > 3)) return (int)cudaErrorInvalidValue;
  if (mode == 4 && (D <= 0 || (D / 2) % 16 || N != (H + 2) * D)) return (int)cudaErrorInvalidValue;
  const LoraExpand lora{z, lb, lb_f32, G, nz, seg1, seg2};
  const NormIn norm{(const bf16*)nw, eps};
  const RopeKV rope{(const bf16*)cos, (const bf16*)sin, (const int*)pos, (bf16*)k_dst,
                    (bf16*)v_dst, (bf16*)k_new, (bf16*)v_new, (const int*)table,
                    H, D, rows, tstride};
  const bool with_norm = nw != nullptr;
  if (z != nullptr)
    return with_norm ? launch_gemv<true, true>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                               warps, k_per_cta, lora, norm, rope, stream)
                     : launch_gemv<true, false>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                                warps, k_per_cta, lora, norm, rope, stream);
  return with_norm ? launch_gemv<false, true>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                              warps, k_per_cta, lora, norm, rope, stream)
                   : launch_gemv<false, false>(x, w8, s, residual, out, B, K, N, mode, cluster,
                                               warps, k_per_cta, lora, norm, rope, stream);
}

// Mode 4 with the norm prologue (and the LoRA expand where z is not null)
// over an fp32 cache beside bf16 x (a mixed cache dtype): the arguments of
// pg_int8_gemv_fused, k_dst, v_dst, k_new and v_new fp32, each row cast to
// bf16 and widened (int8_gemv.cuh).
PG_EXPORT int pg_int8_gemv_rope_kv_cache_fp32(
    const void* x, const void* w8, const void* s, const void* residual, void* out, int B, int K,
    int N, int mode, int cluster, int warps, int k_per_cta, const void* z, const void* lb,
    int lb_f32, int G, int nz, int seg1, int seg2, const void* nw, float eps, const void* cos,
    const void* sin, const void* pos, void* k_dst, void* v_dst, void* k_new, void* v_new,
    const void* table, int H, int D, int rows, int tstride, void* stream) {
  return launch_rope_kv<bf16, float>(x, w8, s, residual, out, B, K, N, mode, cluster, warps,
                                     k_per_cta, z, lb, lb_f32, G, nz, seg1, seg2, nw, eps, cos,
                                     sin, pos, k_dst, v_dst, k_new, v_new, table, H, D, rows,
                                     tstride, stream);
}
