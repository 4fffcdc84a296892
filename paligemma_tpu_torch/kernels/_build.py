"""Build and load the CUDA kernels of ``paligemma_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (every entry returns int cudaError_t)
SIGNATURES = {
    # q, k, v, prefix_len, kv_len, out, B, Sq, Skv, Hq, Hkv, D, scale,
    # q_offset, stream
    "pg_flash_attention_fwd": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    # x, w8, part, B, K, N, k_chunk, stream
    "pg_int8_gemv_partial": [_P] * 3 + [_I] * 4 + [_P],
    # part, nsplit, B, N, s, residual, out, mode, stream
    "pg_int8_gemv_epilogue": [_P, _I, _I, _I, _P, _P, _P, _I, _P],
    # q, k_cache, v_cache, valid, part_m, part_l, part_o, out, B, H, D, W,
    # stride_b, nsplit, scale, stream
    "pg_decode_attention": [_P] * 8 + [_I] * 6 + [_F, _P],
    # y, w8, s, part_max, part_idx, ids, maxv, B, K, N, n_valid, k_chunk,
    # stream
    "pg_head_argmax": [_P] * 7 + [_I] * 5 + [_P],
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
    """Compile ``csrc/*.cu`` unless this source hash is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cu, _ = sources()
    # compile to a temporary name, then rename: a cut build never leaves a
    # half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *map(str, cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    (out.parent / "ptxas.log").write_text(res.stdout + res.stderr)
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
