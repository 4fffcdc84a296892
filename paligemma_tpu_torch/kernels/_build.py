"""Build and load the CUDA kernels of ``paligemma_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared library
with a plain C interface, which is loaded with ``ctypes``. The build runs on
first use (so ``python3 chip_smoke.py`` alone builds everything) and lands
in ``build/paligemma_tpu_torch/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one is reused within a checkout.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0. Pointers and
the stream are passed as ``ctypes.c_void_p`` (an int would cut a pointer to
32 bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "paligemma_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types (every entry returns int cudaError_t)
SIGNATURES = {
    # q, k, v, prefix_len, kv_len, out, lse (or NULL), B, Sq, Skv, Hq, Hkv,
    # D, scale, q_offset, stream
    "pg_flash_attention_fwd": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
    # the same with fp32 q, k, v and out
    "pg_flash_attention_fwd_fp32": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, dout, lse, delta, prefix_len, kv_len, dq, B, Sq, Skv, Hq, Hkv,
    # D, scale, q_offset, stream
    "pg_flash_attention_bwd_dq": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, dout, lse, delta, prefix_len, kv_len, part_dk, part_dv, dk,
    # dv, B, Sq, Skv, Hq, Hkv, D, nsplit, scale, q_offset, stream
    "pg_flash_attention_bwd_dkv": [_P] * 12 + [_I] * 7 + [_F, _I, _P],
    # the same two with fp32 q, k, v, dout, dq, dk and dv
    "pg_flash_attention_bwd_dq_fp32": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
    "pg_flash_attention_bwd_dkv_fp32": [_P] * 12 + [_I] * 7 + [_F, _I, _P],
    # x, w8, s, residual, out, B, K, N, mode, cluster, warps, k_per_cta,
    # stream
    "pg_int8_gemv": [_P] * 5 + [_I] * 7 + [_P],
    # x, w8, s, residual, out, B, K, N, mode, cluster, warps, k_per_cta, z,
    # lb, lb_f32, G, nz, seg1, seg2, stream
    "pg_int8_gemv_lora": [_P] * 5 + [_I] * 7 + [_P] * 2 + [_I] * 5 + [_P],
    # the same with the norm (nw, eps) and mode 4's RoPE + KV write (cos,
    # sin, pos, k_dst, v_dst, k_new, v_new, table, H, D, rows, tstride)
    "pg_int8_gemv_fused": ([_P] * 5 + [_I] * 7 + [_P] * 2 + [_I] * 5 + [_P, _F] + [_P] * 8
                           + [_I] * 4 + [_P]),
    # fp32 x (every mode, the LoRA expand too): pg_int8_gemv_fused's arguments
    "pg_int8_gemv_fp32": ([_P] * 5 + [_I] * 7 + [_P] * 2 + [_I] * 5 + [_P, _F] + [_P] * 8
                          + [_I] * 4 + [_P]),
    # mode 4 over a cache of the other dtype (bf16 x over fp32 rows, fp32 x
    # over bf16 rows): pg_int8_gemv_fused's arguments
    "pg_int8_gemv_rope_kv_cache_fp32": ([_P] * 5 + [_I] * 7 + [_P] * 2 + [_I] * 5 + [_P, _F]
                                        + [_P] * 8 + [_I] * 4 + [_P]),
    "pg_int8_gemv_fp32_rope_kv_cache_bf16": ([_P] * 5 + [_I] * 7 + [_P] * 2 + [_I] * 5
                                             + [_P, _F] + [_P] * 8 + [_I] * 4 + [_P]),
    # x, a, a_f32, ids, z, B, K, NG, G, rank, cluster, k_per_cta, threads, nw,
    # eps, stream
    "pg_lora_shrink": [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _F, _P],
    # the same with fp32 x, z and nw
    "pg_lora_shrink_fp32": [_P, _P, _I, _P, _P] + [_I] * 8 + [_P, _F, _P],
    # q, k_cache, v_cache, valid, part_m, part_l, part_o, out, B, H, D, W,
    # stride_b, rows_per_cache, nsplit, scale, stream
    "pg_decode_attention": [_P] * 8 + [_I] * 7 + [_F, _P],
    "pg_decode_attention_fp32": [_P] * 8 + [_I] * 7 + [_F, _P],
    # bf16 q over fp32 caches, fp32 q over bf16 caches
    "pg_decode_attention_cache_fp32": [_P] * 8 + [_I] * 7 + [_F, _P],
    "pg_decode_attention_fp32_cache_bf16": [_P] * 8 + [_I] * 7 + [_F, _P],
    # q, k_pool, v_pool, table, kv_len, part_m, part_l, part_o, out, B, Hq,
    # Hkv, D, W, page_size, table_stride, layer_off, nsplit, scale, stream
    "pg_paged_attention": [_P] * 9 + [_I] * 7 + [_L, _I, _F, _P],
    "pg_paged_attention_fp32": [_P] * 9 + [_I] * 7 + [_L, _I, _F, _P],
    "pg_paged_attention_cache_fp32": [_P] * 9 + [_I] * 7 + [_L, _I, _F, _P],
    "pg_paged_attention_fp32_cache_bf16": [_P] * 9 + [_I] * 7 + [_L, _I, _F, _P],
    # y, w8, s, ws, ids, maxv, B, K, N, n_valid, cluster, warps, k_per_cta,
    # stream
    "pg_head_argmax": [_P] * 6 + [_I] * 7 + [_P],
    "pg_head_argmax_fp32": [_P] * 6 + [_I] * 7 + [_P],
    # q, k, v, out, B, S, H, D, rows, scale, stream
    "pg_vision_attention": [_P] * 4 + [_I] * 5 + [_F, _P],
    # q, k, v, B, S, H, D, rows, iters (the tensor maps only, no launch)
    "pg_vision_attention_maps": [_P] * 3 + [_I] * 6,
    # fp32 q, k, v, out, B, S, H, D, scale, stream (the fp32 flash forward)
    "pg_vision_attention_fp32": [_P] * 4 + [_I] * 4 + [_F, _P],
    # q, k_cache, v_cache, seg0, seg1, kv_len, part_m, part_l, part_o, out, B,
    # Hq, Hkv, D, S, nsplit, scale, stream
    "pg_seg_attention": [_P] * 10 + [_I] * 6 + [_F, _P],
    "pg_seg_attention_fp32": [_P] * 10 + [_I] * 6 + [_F, _P],
    # x, w8, s, out, M, K, N, nmajor, rows, cluster, kst, ctas, stream
    "pg_int8_matmul": [_P] * 4 + [_I] * 8 + [_P],
    # x, w4p, s, out, M, K, N, rows, cluster, kst, ctas, stream
    "pg_int4_matmul": [_P] * 4 + [_I] * 7 + [_P],
    # x, w4p, s, out, M, K, N, cluster, warps, k_per_cta, stream
    "pg_int4_gemv": [_P] * 4 + [_I] * 6 + [_P],
    # layout, rows, cluster, out (int *): the wgmma tile's resident clusters
    "pg_wq_max_clusters": [_I] * 3 + [_P],
    # x, amax (or NULL), x8, a_s, M, K, stream
    "pg_w8a8_quant_rows": [_P] * 4 + [_I] * 2 + [_P],
    # the same with fp32 x
    "pg_w8a8_quant_rows_fp32": [_P] * 4 + [_I] * 2 + [_P],
    # x8, w8, a_s, s, out, M, K, N, out_kind (0 bf16, 1 int32, 2 fp32), rows,
    # cluster, k_stages, ctas, stream
    "pg_w8a8_gemm": [_P] * 5 + [_I] * 8 + [_P],
}

_lib = None  # the loaded library; one per process, like the CUDA context


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libpaligemma_kernels.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this source hash is already built: one
    ``nvcc -c`` per source, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cu, _ = sources()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [os.path.join(tmpdir, f.stem + ".o") for f in cu]
        procs = [
            subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(f)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for f, o in zip(cu, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(f.name, p.returncode, log) for f, p, log in zip(cu, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        # link to a temporary name, then rename: a cut build never leaves a
        # half-written library under the final name
        tmp = os.path.join(tmpdir, out.name)
        res = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        (out.parent / "ptxas.log").write_text("".join(logs))
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
