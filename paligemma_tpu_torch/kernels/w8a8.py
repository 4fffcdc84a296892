"""W8A8 prefill matmul: int8 activations, each row quantized on the fly,
times the int8 weights of the serving tree, with exact int32 sums on the
int8 tensor cores (``csrc/w8a8_gemm.cu``, two kernels).

* :func:`w8a8_quant_rows` (K1): per row of x (M, K),
  ``a_s = max(amax |x|, 1e-8) / 127`` and
  ``x8 = clip(round_half_even(x / a_s), -127, 127)`` (IEEE division), or the
  same with a given amax per row (a tensor-parallel rank whose input is a K
  shard quantizes it with the whole row's amax).
* :func:`w8a8_gemm` (K2): ``cast((float32(x8 . w8) * a_s[row]) * s[col])``
  from the (K, N) int8 weights the decode chain reads (no (N, K) copy), or
  the int32 sums (``out_dtype=torch.int32``) that a tensor-parallel rank
  sums across ranks before :func:`scale_sums`.

Together they compute paligemma_tpu/kernels/quant.py ``_xla_w8a8_matmul``,
which is XLA, not Pallas: they replace no TPU kernel. Every int32 sum is
exact in any order, so each kernel equals its plain version bit for bit.
On a CUDA tensor a wrapper checks its operands and launches its kernel, or
raises; on a CPU tensor it runs the plain version. K1 is bound by bytes (a
read of x, a write of x8), K2 by the int8 products at prefill rows (2 M K N
operations at 1,979 TOPS). The gate that sends a product here is
kernels/quant.matmul_any's.

K2's launch follows :meth:`GemmPlan.make`, a pure function of (M, K, N):
the row tile of x (one of ``ROW_TILES``: 272 rows are two chunks, 144 +
128, each a wgmma on the same weight fragments), and a split of K's stages
over a cluster where the tiles alone would leave SMs idle, costed as
kernels/ablation/_wq_gemm.py costs the weight-only tiles. The int32 sums
are exact, so the plan changes no bit of the output.

fp32 (``--dtype float32``): K1 reads fp32 rows and K2 writes fp32 out, the
kernels' fp32 forms (``pg_w8a8_quant_rows_fp32``, ``out_dtype=torch.float32``
of ``pg_w8a8_gemm``), counted apart on :func:`w8a8_quant_rows_fp32` and
:func:`w8a8_gemm_fp32`; the int32 sums are one kernel whatever x's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import _build
from .ablation._wq_gemm import CLUSTERS_RESIDENT, STAGE_COST

BK = 128  # K values a stage (csrc/w8a8_gemm.cu W8_BK)
COLS = 128  # weight columns of a K2 tile
ROW_TILES = (16, 32, 64, 128, 256, 272)  # rows of x of a K2 tile (272: chunks of 144 and 128)
# the clusters of c CTAs that the card holds at once: one K2 CTA takes an
# SM, as one of csrc/wq_wgmma.cuh's does (measured for that tile)
FITS = CLUSTERS_RESIDENT["wgmma"]


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """K2's launch for (M, K, N): ``rows`` rows of x a tile, K's ``stages``
    (of ``BK``) split over ``cluster`` CTAs, ``k_stages`` a rank but the last
    (rank r sums stages [r k_stages, (r + 1) k_stages)), and ``ctas`` CTAs:
    one tile a cluster where split, else persistent CTAs over the tiles."""
    m: int
    k: int
    n: int
    rows: int
    cluster: int
    k_stages: int
    ctas: int

    @property
    def stages(self) -> int:
        return -(-self.k // BK)

    @property
    def tiles(self) -> int:
        return -(-self.n // COLS) * -(-self.m // self.rows)

    @classmethod
    def make(cls, m: int, k: int, n: int) -> "GemmPlan":
        """The row tile whose busiest CTA takes the fewest stages, each
        costed at its rows plus ``STAGE_COST`` (the larger tile on a tie);
        K split over the most ranks (at least one stage each) whose clusters
        all fit the card at once, where the tiles alone leave SMs idle."""
        if min(m, k, n) < 1:
            raise ValueError(f"GemmPlan: empty matmul (M, K, N) = ({m}, {k}, {n})")
        stages = -(-k // BK)
        best = None
        for rows in ROW_TILES:
            tiles = -(-n // COLS) * -(-m // rows)
            cluster = max(c for c in FITS if c == 1 or (c <= stages and tiles <= FITS[c]))
            per = -(-stages // cluster)
            cluster = -(-stages // per)
            waves, ctas = (-(-tiles // FITS[1]), min(tiles, FITS[1])) if cluster == 1 else (
                1, tiles * cluster)
            option = (waves * per * (rows + STAGE_COST), -rows, cluster, per, ctas)
            best = option if best is None or option < best else best
        _, neg_rows, cluster, per, ctas = best
        return cls(m, k, n, -neg_rows, cluster, per, ctas)


def quant_rows_reference(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: (x8 (M, K) int8, a_s (M,) fp32) of x (M, K)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1)
    amax = amax.float().clamp(min=1e-8)
    # a tensor divisor: torch on CUDA divides by a Python number as a
    # multiplication by its reciprocal, which is not IEEE division
    a_s = amax / torch.full_like(amax, 127.0)
    x8 = torch.round(xf / a_s[:, None]).clamp(-127, 127).to(torch.int8)
    return x8, a_s


def int_sums_reference(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums ``x8 . w8``: an fp64 product, exact while
    127 * 127 * K < 2^53."""
    return (x8.double() @ w8.double()).to(torch.int32)


def scale_sums(acc: torch.Tensor, a_s: torch.Tensor, s: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``cast((float32(acc) * a_s[row]) * s[col])``: K2's epilogue."""
    return ((acc.float() * a_s[:, None]) * s.float()).to(dtype)


def gemm_reference(x8: torch.Tensor, w8: torch.Tensor, a_s: torch.Tensor, s: torch.Tensor,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain K2: (M, N) ``out_dtype``, or the int32 sums."""
    acc = int_sums_reference(x8, w8)
    return acc if out_dtype == torch.int32 else scale_sums(acc, a_s, s, out_dtype)


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def w8a8_quant_rows(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (x8 (M, K) int8, a_s (M,) fp32); ``amax`` (M,) fp32: each
    row's amax, in place of x's own. One launch on the card."""
    if not x.is_cuda:
        return quant_rows_reference(x, amax)
    name = "w8a8_quant_rows"
    fp32 = x.dtype == torch.float32
    _check(x.dim() == 2 and x.dtype in (torch.bfloat16, torch.float32) and x.is_contiguous()
           and x.data_ptr() % 16 == 0, name,
           "x must be contiguous 16-byte aligned bf16 or fp32 (M, K)")
    m, k = x.shape
    _check(m > 0 and k >= 8 and k % 8 == 0, name, f"x takes M >= 1 and K a multiple of 8, "
           f"got {tuple(x.shape)}")
    if amax is not None:
        _check(amax.shape == (m,) and amax.dtype == torch.float32 and amax.is_contiguous()
               and amax.device == x.device, name, f"amax must be contiguous fp32 ({m},) on x's "
               "device")
    x8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
    a_s = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    _build.check((lib.pg_w8a8_quant_rows_fp32 if fp32 else lib.pg_w8a8_quant_rows)(
        x.data_ptr(), None if amax is None else amax.data_ptr(), x8.data_ptr(), a_s.data_ptr(),
        m, k, _build.stream_ptr(x.device)), name)
    (w8a8_quant_rows_fp32 if fp32 else w8a8_quant_rows).launches += 1
    return x8, a_s


w8a8_quant_rows.launches = 0


def w8a8_quant_rows_fp32(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`w8a8_quant_rows` of fp32 x (K1's fp32 form); the count of its
    launches (which :func:`w8a8_quant_rows` makes for fp32 x)."""
    _check(x.dtype == torch.float32, "w8a8_quant_rows_fp32", f"fp32 x, got {x.dtype}")
    return w8a8_quant_rows(x, amax)


w8a8_quant_rows_fp32.launches = 0

_OUT_KIND = {torch.bfloat16: 0, torch.int32: 1, torch.float32: 2}  # csrc/w8a8_gemm.cu W8_OUT_*

def w8a8_gemm(x8: torch.Tensor, w8: torch.Tensor, a_s: torch.Tensor, s: torch.Tensor,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x8 (M, K) int8 . w8 (K, N) int8 with row scales a_s (M,) and column
    scales s (N,): (M, N) ``out_dtype`` (bf16, or fp32: the fp32 form,
    counted on :func:`w8a8_gemm_fp32`), or with ``torch.int32`` the int32
    sums. One launch on the card."""
    if not x8.is_cuda:
        return gemm_reference(x8, w8, a_s, s, out_dtype)
    name = "w8a8_gemm"
    dev = x8.device
    _check(x8.dim() == 2 and x8.dtype == torch.int8 and x8.is_contiguous()
           and x8.data_ptr() % 16 == 0, name, "x8 must be contiguous 16-byte aligned int8 (M, K)")
    m, k = x8.shape
    _check(w8.dim() == 2 and w8.shape[0] == k and w8.dtype == torch.int8 and w8.is_contiguous()
           and w8.device == dev and w8.data_ptr() % 16 == 0, name,
           f"w8 must be contiguous 16-byte aligned int8 ({k}, N) on x8's device, got "
           f"{w8.dtype} {tuple(w8.shape)}")
    n = w8.shape[1]
    _check(m > 0 and k >= 16 and k % 16 == 0 and n >= 16 and n % 16 == 0, name,
           f"the kernel takes K and N multiples of 16 (M {m}, K {k}, N {n})")
    for arg, t, size in (("a_s", a_s, m), ("s", s, n)):
        _check(t.shape == (size,) and t.dtype == torch.float32 and t.is_contiguous()
               and t.device == dev, name, f"{arg} must be contiguous fp32 ({size},) on x8's device")
    _check(out_dtype in _OUT_KIND, name,
           f"out_dtype must be bfloat16, float32 or int32 on the card, got {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    plan = GemmPlan.make(m, k, n)
    lib = _build.library()
    _build.check(lib.pg_w8a8_gemm(
        x8.data_ptr(), w8.data_ptr(), a_s.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n,
        _OUT_KIND[out_dtype], plan.rows, plan.cluster, plan.k_stages, plan.ctas,
        _build.stream_ptr(dev)), name)
    (w8a8_gemm_fp32 if out_dtype == torch.float32 else w8a8_gemm).launches += 1
    return out


w8a8_gemm.launches = 0


def w8a8_gemm_fp32(x8: torch.Tensor, w8: torch.Tensor, a_s: torch.Tensor, s: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`w8a8_gemm` with fp32 out (K2's fp32 form); the count of its
    launches (which :func:`w8a8_gemm` makes for ``out_dtype=torch.float32``)."""
    _check(x8.dtype == torch.int8, "w8a8_gemm_fp32",
           f"x8 must be K1's int8 codes (fp32 x goes to w8a8_quant_rows_fp32), got {x8.dtype}")
    return w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.float32)


w8a8_gemm_fp32.launches = 0


def w8a8_matmul(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ dequant(w8, s)`` with x's rows quantized to int8: K1
    then K2 (on the CPU their plain versions); x's dtype."""
    k = x.shape[-1]
    x8, a_s = w8a8_quant_rows(x.reshape(-1, k).contiguous())
    out = w8a8_gemm(x8, w8, a_s, s, out_dtype=x.dtype)
    return out.reshape(*x.shape[:-1], w8.shape[-1])
