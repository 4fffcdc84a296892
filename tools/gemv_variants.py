"""Builds of the GEMV tile (``csrc/gemv_tile.cuh``: the int8 GEMV and B9's
int4 form, the norm prologue), its plan and the LoRA shrink with one change
each, timed by tools/gemv_times.py:

    python3 tools/gemv_variants.py [--what gemv,int4,lora,norm] [NAME ...]   # default: all

A variant is a copy of ``paligemma_tpu_torch`` under
``build/gemv_variants/NAME/`` with the text replacements of ``VARIANTS[NAME]``
applied (each must match exactly once, so a variant that no longer fits the
source fails instead of timing the default). The copy builds its own kernels
when tools/gemv_times.py runs on it, in a process of its own; then the
``-Xptxas -v`` lines of its GEMV kernels are printed. The product code has
no knob for any of this.
"""

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "paligemma_tpu_torch"
TILE = "csrc/gemv_tile.cuh"
_INT4 = "csrc/int4_matmul.cu"
_GEMV = "csrc/int8_gemv.cuh"

# the loads alone: every loaded word kept alive by a cheap sum, no mma
_LOADS_ONLY = """        acc[0][0] += __uint_as_float((wb[s][0].x ^ wb[s][1].y ^ wb[s][2].z ^ wb[s][3].w ^
                                      wb[s][0].w ^ wb[s][1].z ^ wb[s][2].y ^ wb[s][3].x ^
                                      xb[s].x) & 0x3fffffffu);
"""
# the int4 step's loads alone: the two x fragments and the weight words kept
# alive by a cheap sum, no conversion and no mma
_INT4_LOADS_ONLY = """          acc[0][0] += __uint_as_float((wb[s][0].x ^ wb[s][1].y ^ wb[s][2].z ^ wb[s][3].w ^
                                        wb[s][0].w ^ wb[s][1].z ^ wb[s][2].y ^ wb[s][3].x ^
                                        xb[s].x ^ xh[s].y) & 0x3fffffffu);
"""
# the arithmetic with no weight loads (both formats): each row word a constant
_NO_WEIGHT_LOADS = (TILE, "const uint4 v = ldg_stream16(p + r * n1);",
                    "const uint32_t c = 0x01010101u * (uint32_t)(nrow + r);\n"
                    "        const uint4 v = make_uint4(c, c, c, c);")

VARIANTS = {
    "default": [],
    "stages2": [(TILE, "#define GT_STAGES 3", "#define GT_STAGES 2")],
    "stages4": [(TILE, "#define GT_STAGES 3", "#define GT_STAGES 4")],
    "loads": [(TILE, "          gt_mma_step(acc, wb[s], xb[s], magic);\n", _LOADS_ONLY)],
    "int4_loads": [(TILE, "          gt_mma_step_int4(acc, wb[s], xb[s], xh[s]);\n",
                    _INT4_LOADS_ONLY)],
    "math_x": [_NO_WEIGHT_LOADS],
    "math": [_NO_WEIGHT_LOADS,
             (TILE, "  uint32_t lo = 0u, hi = 0u;\n  if (xrow) {",
              "  uint32_t lo = (uint32_t)nrow, hi = 0u;\n  if (false) {")],
    "warps4": [("kernels/gemv_plan.py", "WARP_CHOICES = (4, 8)", "WARP_CHOICES = (4,)")],
    # B9's tile with one CTA an SM allowed (up to 255 registers), with 3 or 4
    # steps of loads in flight (time with --what int4)
    "int4_lb1": [(_INT4, "__launch_bounds__(32 * GT_MAX_WARPS, 2)\n    int4_gemv_kernel",
                  "__launch_bounds__(32 * GT_MAX_WARPS, 1)\n    int4_gemv_kernel")],
    "int4_lb1_stages4": [(_INT4, "__launch_bounds__(32 * GT_MAX_WARPS, 2)\n    int4_gemv_kernel",
                          "__launch_bounds__(32 * GT_MAX_WARPS, 1)\n    int4_gemv_kernel"),
                         (TILE, "#define GT_STAGES 3", "#define GT_STAGES 4")],
    # the LoRA shrink (time with --what lora): ranks of 512 K rows at least
    # (clusters of 4 at K 2048), or CTAs of 512 threads everywhere
    "shrink_rows512": [("kernels/lora.py", "MIN_ROWS_PER_RANK = 256", "MIN_ROWS_PER_RANK = 512")],
    "shrink_t512": [("kernels/lora.py", "SMALL_RANK = 256", "SMALL_RANK = 0")],
    # ranks of 1024 or 2048 K rows at least: clusters of 2 or 1 CTA at K 2048
    "shrink_rows1024": [("kernels/lora.py", "MIN_ROWS_PER_RANK = 256",
                         "MIN_ROWS_PER_RANK = 1024")],
    "shrink_rows2048": [("kernels/lora.py", "MIN_ROWS_PER_RANK = 256",
                         "MIN_ROWS_PER_RANK = 2048")],
    # the LoRA expand in the GEMV (time with --what lora): the most shared
    # memory an SM can carve out, or the deltas not computed (what the rest
    # of the LoRA path costs; wrong outputs)
    "expand_carveout": [(_GEMV, "    if (err != cudaSuccess) return (int)err;\n  }",
                         "    if (err != cudaSuccess) return (int)err;\n"
                         "    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,"
                         " 100);\n  }")],
    "expand_nodelta": [(_GEMV, "item < ncols * rstep; item += blockDim.x", "item < 0; item += 1")],
    "target2x": [("kernels/gemv_plan.py", "TARGET_WARPS = 16 * 132", "TARGET_WARPS = 32 * 132")],
}
# the norm prologue's r from chunk sums of squares exchanged through the
# cluster's distributed shared memory (each CTA squares only its own K
# range; one more cluster barrier) instead of every CTA's pass over the
# whole row; the shrink likewise (time with --what norm)
_NORM_DSMEM_STAGE = """__device__ __forceinline__ float gt_sq8(uint4 v) {
  float f[8];
  bf16x8_to_float(v, f);
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) a = fmaf(f[j], f[j], a);
  return a;
}

__device__ __forceinline__ float gt_cluster_rsqrt(const float* sq_row, int K, int k_per_cta,
                                                  float eps) {
  const int lane = threadIdx.x & 31, chunks = K >> 3, per = k_per_cta >> 3;
  float acc = 0.f;
  for (int c0 = lane; c0 < chunks; c0 += 8 * 32) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + 32 * i;
      v[i] = c < chunks ? ld_cluster_f32(sq_row + c % per, c / per) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, v[i]);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  return rsqrtf(__fadd_rn(__fdiv_rn(acc, (float)K), eps));
}

__device__ __forceinline__ void gt_norm_stage(GemvSmem& sm, bf16* ys, int ld,
                                              const bf16* __restrict__ x, NormIn norm, int K,
                                              int b0, int nb, int kbeg, int kend) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int k_per_cta = ld - GT_NORM_PAD, chunks = k_per_cta >> 3;
  const int tpc = max(1, (int)blockDim.x / chunks);
  const int c = threadIdx.x / tpc, sub = threadIdx.x % tpc;
  const int k = kbeg + 8 * c;
  const bool in = c < chunks && k < kend;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 wv = in ? ldg_16(norm.w + k) : zero;
  uint4 xv[GT_BT];
#pragma unroll
  for (int i = 0; i < GT_BT; ++i) {
    const int r = sub + i * tpc;
    xv[i] = in && r < nb ? ldg_16(x + (size_t)(b0 + r) * K + k) : zero;
  }
#pragma unroll
  for (int i = 0; i < GT_BT; ++i) {
    const int r = sub + i * tpc;
    if (c < chunks && r < nb) sm.sq[r][c] = gt_sq8(xv[i]);
  }
  cluster_sync_all();
  for (int r = warp; r < nb; r += warps) {
    const float rs = gt_cluster_rsqrt(&sm.sq[r][0], K, k_per_cta, norm.eps);
    if (lane == 0) sm.rnorm[r] = rs;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < GT_BT; ++i) {
    const int r = sub + i * tpc;
    if (c < chunks && r < nb)
      *reinterpret_cast<uint4*>(ys + (size_t)r * ld + 8 * c) =
          in ? gt_norm8(xv[i], wv, sm.rnorm[r]) : zero;
  }
  __syncthreads();
}
"""
_NORM_DSMEM_SHRINK = """    if constexpr (NORM) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const int r = tid / n8, k8 = (tid % n8) * 8;
      const bool item = tid < GT_BT * n8, live = item && r < nb;
      const uint4 xv = live ? ldg_16(x + (size_t)(b0 + r) * K + c0 + k8) : zero;
      const uint4 nw = item ? ldg_16(norm.w + c0 + k8) : zero;
      if (live) sm.sq[r][k8 / 8] = gt_sq8(xv);
      cluster_sync_all();
      for (int rr = warp; rr < nb; rr += THREADS / 32) {
        const float rs = gt_cluster_rsqrt(&sm.sq[rr][0], K, k_per_cta, norm.eps);
        if (lane == 0) sm.rnorm[rr] = rs;
      }
      __syncthreads();
      if (item)
        *reinterpret_cast<uint4*>(&sm.xs[r][k8]) = live ? gt_norm8(xv, nw, sm.rnorm[r]) : zero;
    } else {
      for (int i = tid; i < GT_BT * n8; i += THREADS) {
        const int r = i / n8, k8 = (i % n8) * 8;
        cp_async_16(&sm.xs[r][k8], x + (size_t)(b0 + min(r, nb - 1)) * K + c0 + k8, r < nb);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();"""
_LORA = "csrc/lora.cu"
VARIANTS["norm_dsmem"] = [
    (TILE, "  float sum[GT_BT][GT_COLS];                // the CTA's sums, read by the cluster\n",
     "  float sum[GT_BT][GT_COLS];\n  float sq[GT_BT][128];\n  float rnorm[GT_BT];\n"),
    (TILE, "__device__ __forceinline__ void gt_norm_stage(", _NORM_DSMEM_STAGE
     + "__device__ __forceinline__ void gt_norm_stage_whole_row("),
    (TILE, "    gt_norm_stage(ys, ld, x, norm, K, b0, nb, kbeg, kend);",
     "    gt_norm_stage(sm, ys, ld, x, norm, K, b0, nb, kbeg, kend);"),
    (_LORA, "  float rnorm[GT_BT];", "  float sq[GT_BT][LS_MAX_THREADS / 8];\n  float rnorm[GT_BT];"),
    (_LORA, "      const float rs = gt_row_rsqrt(x + (size_t)(b0 + r) * K, K, norm.eps);",
     "      const float rs = 0.f;"),
    (_LORA, """    for (int i = tid; i < GT_BT * n8; i += THREADS) {  // rows past B read as zeros
      const int r = i / n8, k8 = (i % n8) * 8;
      const bf16* src = x + (size_t)(b0 + min(r, nb - 1)) * K + c0 + k8;
      if constexpr (NORM)
        *reinterpret_cast<uint4*>(&sm.xs[r][k8]) =
            r < nb ? gt_norm8(ldg_16(src), ldg_16(norm.w + c0 + k8), sm.rnorm[r])
                   : make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async_16(&sm.xs[r][k8], src, r < nb);
    }
    if constexpr (!NORM) {
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();""", _NORM_DSMEM_SHRINK),
]
# B9 / B11 above 16 rows (csrc/wq_wgmma.cuh; time with --what int8, (K, N)
# rows): the fragments without the int8 conversion (raw words, wrong
# sums), or the loads and conversion without the products
_WQ = "csrc/wq_wgmma.cuh"
VARIANTS["wq_noconvert"] = [(_WQ, """        a[st][0] = wq_s8_pair<0, 2>(x0, magic);
        a[st][1] = wq_s8_pair<1, 3>(x0, magic);
        a[st][2] = wq_s8_pair<0, 2>(x1, magic);
        a[st][3] = wq_s8_pair<1, 3>(x1, magic);""", """        a[st][0] = x0;
        a[st][1] = x0 >> 8;
        a[st][2] = x1;
        a[st][3] = x1 >> 8;""")]
_WQ_MMA = "        wq_mma<XN>(acc, cur[kk], wgmma_desc128(xtile(gs % ST, u % C::HALVES) + kk * 32));"
VARIANTS["wq_nomma"] = [(_WQ, _WQ_MMA, """        acc[kk] += __uint_as_float(
            (cur[kk][0] ^ cur[kk][1] ^ cur[kk][2] ^ cur[kk][3]) & 0x3fffffffu);""")]
KERNELS = ("int8_gemv_kernel", "head_argmax_kernel", "int4_gemv_kernel", "wq_wgmma_kernel")


def make_copy(name: str) -> str:
    """build/gemv_variants/NAME/ holding the patched package; returns it."""
    top = os.path.join(ROOT, "build", "gemv_variants", name)
    shutil.rmtree(top, ignore_errors=True)
    pkg = os.path.join(top, PKG)
    shutil.copytree(os.path.join(ROOT, PKG), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    for rel, old, new in VARIANTS[name]:
        path = os.path.join(pkg, rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} matches {text.count(old)} times in {rel}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return top


def main() -> int:
    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_lines

    args = sys.argv[1:]
    what = []
    if args[:1] == ["--what"]:
        what, args = ["--what", args[1]], args[2:]
    names = args or list(VARIANTS)
    rc = 0
    for name in names:
        top = make_copy(name)
        res = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "gemv_times.py"),
                              *what], cwd=top)
        rc |= res.returncode
        print(f"variant [{name}]: gemv_times rc {res.returncode}", flush=True)
        for log in pathlib.Path(top, "build", PKG).glob("*/ptxas.log"):
            ptxas_lines(log, KERNELS)
    return rc


if __name__ == "__main__":
    sys.exit(main())
