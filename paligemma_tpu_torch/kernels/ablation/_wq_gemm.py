"""Host side of the weight-only quantized matmul kernel
(``csrc/wq_gemm.cuh``, entry points ``pg_int8_matmul`` and
``pg_int4_matmul``): the checks, the K split and the launch."""

from __future__ import annotations

import torch

from .. import _build

BN, BK = 64, 64  # csrc/wq_gemm.cuh WQ_BN, WQ_BK
BM_SMALL, BM_LARGE = 16, 64  # WQ_BM_SMALL (M <= 16), WQ_BM_LARGE
TARGET_BLOCKS = 2 * 132  # two blocks per SM of an H100 before K is split
MAX_GRID_YZ = 65535


def check_operands(name: str, x2: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                   k_rows: int, n: int) -> None:
    """Raise unless the kernel takes these operands: contiguous bf16 x
    (M, K), contiguous int8 weights, fp32 (N,) scales, all on x's device and
    16-byte aligned, ``k_rows`` (the weights' stored K rows) a multiple of
    64 and N a multiple of 16."""
    dev = x2.device
    if x2.dtype != torch.bfloat16 or x2.data_ptr() % 16:
        raise ValueError(f"{name}: x must be bf16 on the card (got {x2.dtype})")
    if w.dtype != torch.int8 or not w.is_contiguous() or w.device != dev or w.data_ptr() % 16:
        raise ValueError(f"{name}: weights must be contiguous 16-byte aligned int8 on x's device")
    if s.shape != (n,) or s.dtype != torch.float32 or s.device != dev:
        raise ValueError(f"{name}: s must be fp32 (N,) = ({n},) on x's device")
    if k_rows % BK or n % 16 or -(-x2.shape[0] // BM_LARGE) > MAX_GRID_YZ:
        raise ValueError(f"{name}: the kernel takes stored K rows {k_rows} a multiple of {BK}, "
                         f"N {n} a multiple of 16, M <= {MAX_GRID_YZ * BM_LARGE}")


def launch(entry: str, x2: torch.Tensor, w: torch.Tensor, s: torch.Tensor, k: int, n: int,
           k_rows: int, *extra: int) -> torch.Tensor:
    """Run ``entry`` on x2 (M, K) and return (M, N) bf16. K is split over
    blocks when the output tiles alone would leave SMs idle; the fp32
    partials are then added in split order and scaled by
    ``pg_wq_split_sum`` (csrc/int8_matmul.cu)."""
    m = x2.shape[0]
    dev = x2.device
    bm = BM_SMALL if m <= BM_SMALL else BM_LARGE
    tiles = -(-n // BN) * -(-m // bm)
    stages = k_rows // BK
    nsplit = max(1, min(stages, -(-TARGET_BLOCKS // tiles)))
    k_chunk = -(-stages // nsplit) * BK
    nsplit = -(-k_rows // k_chunk)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    part = torch.empty((nsplit, m, n), dtype=torch.float32, device=dev) if nsplit > 1 else out
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    err = getattr(lib, entry)(x2.data_ptr(), w.data_ptr(), s.data_ptr(), part.data_ptr(),
                              out.data_ptr(), m, k, n, k_chunk, *extra, stream)
    _build.check(err, entry)
    if nsplit > 1:
        err = lib.pg_wq_split_sum(part.data_ptr(), nsplit, m, n, s.data_ptr(), out.data_ptr(),
                                  stream)
        _build.check(err, f"{entry} epilogue")
    return out
