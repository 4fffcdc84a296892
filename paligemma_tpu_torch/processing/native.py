"""ctypes binding for the native (C++) image preprocessor (port of
paligemma_tpu/processing/native.py).

``native/preprocess.cc`` (the port's own copy of the JAX package's source)
is compiled on first use with the system g++, with the JAX module's flags,
into ``build/paligemma_tpu_torch/native-<hash>/libpreprocess.so`` at the
repository root, keyed by a hash of the source and the flags (as
kernels/_build.py keys the CUDA build): an edited source rebuilds, nothing
is written next to the source. Without a compiler
:func:`native_available` is False and the processor takes the PIL path; a
library that was built and then fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels._build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parent.parent / "native" / "preprocess.cc"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"native-{digest.hexdigest()[:16]}" / "libpreprocess.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        # compile to a temporary name, then rename: a cut or concurrent build
        # never leaves a half-written library under the final name
        with tempfile.TemporaryDirectory(dir=so.parent) as tmpdir:
            tmp = os.path.join(tmpdir, so.name)
            try:
                subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                               check=True, capture_output=True)
            except (OSError, subprocess.CalledProcessError):
                return None
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.preprocess_batch.restype = None
    return lib


def native_available() -> bool:
    """Whether the library is built (building it on the first call)."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
    return _LIB is not None


def preprocess_images_native(
    raw: np.ndarray,  # (B, H, W, 3) uint8 RGB
    image_size: int,
    num_threads: int = 0,
) -> np.ndarray:
    """Resize(bicubic, antialiased) + 1/255 + normalize(0.5) + CHW.

    Returns (B, 3, image_size, image_size) float32. Raises RuntimeError if
    the native library could not be built."""
    if not native_available():
        raise RuntimeError("native preprocessor unavailable (no g++?)")
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.ndim != 4 or raw.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) RGB frames, got {raw.shape}")
    b, h, w, _ = raw.shape
    out = np.empty((b, 3, image_size, image_size), np.float32)
    if num_threads <= 0:
        num_threads = min(b, os.cpu_count() or 1)
    _LIB.preprocess_batch(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        image_size, num_threads,
    )
    return out
