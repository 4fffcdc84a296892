"""The plan and the launch of the weight-only quantized matmuls: B9
(``quant4.int4_matmul``, int4 "K-halves" weights (K/2, N)) and B11
(``quant_pallas.int8_matmul``, int8 weights (K, N); ``int8_matmul_nmajor``,
int8 weights (N, K)).

:meth:`WqPlan.make` is a pure function of (M, K, N, layout) that picks the
route by the rows of x:

* ``gemv`` (int8 (K, N), M <= ``GEMV_ROWS``): the int8 GEMV's tensor-core
  tile in mode 0 (``pg_int8_gemv``, ``csrc/gemv_tile.cuh``), split as
  :class:`~..gemv_plan.GemvPlan` plans (K, N): the same function as the
  decode GEMV on the same bytes;
* ``int4_gemv`` (int4, M <= 16): the GEMV tile's int4 form
  (``pg_int4_gemv``), split as GemvPlan plans the (K/2, N) stored rows;
* ``wgmma16`` (int8 (N, K), M <= 16): ``csrc/wq_wgmma.cuh``'s tile with 16
  rows of x (two CTAs an SM; the other wgmma tiles fill an SM);
* ``wgmma`` (M > 16): ``csrc/wq_wgmma.cuh``'s tile, 128 output columns by
  one of ``ROW_TILES`` rows of x: the one whose busiest CTA takes the
  fewest stages, each costed at its rows plus ``STAGE_COST``.

The wgmma routes split the stored K rows, in stages of ``BK``, over the
CTAs of a cluster only where the output tiles alone would leave SMs idle:
the most ranks whose clusters all fit the card at once
(``CLUSTERS_RESIDENT``), one stage each at least; rank r takes the stored
rows [r * k_per_cta, (r + 1) * k_per_cta), cut at the stored rows. The
ranks' sums are added in rank order through distributed shared memory in
the same launch, so every output's sum order depends on (M, K, N, layout)
only, and a second call gives the same bits. Without a split, ``ctas``
persistent CTAs (one wave at most) take the tiles in turn.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from .. import _build, int8_gemv
from ..gemv_plan import GemvPlan

GEMV_ROWS = 16  # rows of x at most for the decode routes
BK = 64  # stored K rows per stage (csrc/wq_wgmma.cuh WQ_BK)
COLS = 128  # output columns of a wgmma tile
ROW_TILES = (256, 136, 128, 64)  # rows of x of a wgmma tile above GEMV_ROWS (the wgmma's N)
# the clusters of c CTAs of the wgmma tile an H100 holds at once
# (cudaOccupancyMaxActiveClusters, through pg_wq_max_clusters): a
# cluster's CTAs share a GPC, so clusters of CTAs that fill an SM fit badly
CLUSTERS_RESIDENT = {"wgmma": {1: 132, 2: 66, 3: 39, 4: 30, 6: 17, 8: 15},
                     "wgmma16": {1: 264, 2: 132, 3: 79, 4: 62, 6: 39, 8: 30}}
STAGE_COST = 128  # a stage's fixed cost (conversion, waits) in rows of x
N_MULTIPLE = 16  # N a multiple of this (16-byte rows of int8 weights for TMA)
MAX_GRID_X, MAX_GRID_YZ = 2**31 - 1, 65535
LAYOUTS = ("kn", "nk", "int4")  # int8 (K, N), int8 (N, K), int4 (K/2, N)


@dataclasses.dataclass(frozen=True)
class WqPlan:
    m: int
    k: int
    n: int
    layout: str
    route: str  # "gemv", "int4_gemv", "wgmma16" or "wgmma"
    rows: int  # rows of x a tile (the GEMV routes: their batch tile of 8)
    cols: int  # output columns a tile
    cluster: int  # CTAs per cluster: the K splits of one output tile
    k_per_cta: int  # stored K rows of each rank but the last
    warps: int  # warps a CTA (the GEMV routes; the wgmma routes: 0, fixed by rows)
    ctas: int  # CTAs of the grid (the wgmma routes without a K split: persistent)

    @property
    def stored_rows(self) -> int:
        """The weights' stored K rows: K, or K / 2 packed int4 rows."""
        return self.k // 2 if self.layout == "int4" else self.k

    @property
    def tiles(self) -> int:
        """Output tiles: column tiles times row tiles."""
        return -(-self.n // self.cols) * -(-self.m // self.rows)

    @property
    def grid(self) -> Tuple[int, int, int]:
        cols, rows = -(-self.n // self.cols) * self.cluster, -(-self.m // self.rows)
        if self.route.endswith("gemv"):
            return (cols, 1, rows)
        return (self.ctas, 1, 1) if self.cluster == 1 else (cols, rows, 1)

    def k_ranges(self) -> List[Tuple[int, int]]:
        """[lo, hi) of the stored K rows each rank sums, rank by rank."""
        return [(r * self.k_per_cta, min(self.stored_rows, (r + 1) * self.k_per_cta))
                for r in range(self.cluster)]

    @classmethod
    def make(cls, m: int, k: int, n: int, layout: str) -> "WqPlan":
        if layout not in LAYOUTS:
            raise ValueError(f"WqPlan: layout {layout!r} is not one of {LAYOUTS}")
        if min(m, k, n) < 1:
            raise ValueError(f"WqPlan: empty matmul (M, K, N) = ({m}, {k}, {n})")
        stored = k // 2 if layout == "int4" else k
        if m <= GEMV_ROWS and layout != "nk":
            p = GemvPlan.make(stored, n)
            route = "gemv" if layout == "kn" else "int4_gemv"
            rows, cols = 8, 128  # the GEMV tile's batch tile and columns
            ctas = -(-n // cols) * p.cluster * -(-m // rows)
            return cls(m, k, n, layout, route, rows, cols, p.cluster, p.k_per_cta, p.warps, ctas)
        route = "wgmma16" if m <= GEMV_ROWS else "wgmma"
        stages = -(-stored // BK)
        options = [_split(route, m, n, rows, stages)
                   for rows in ((GEMV_ROWS,) if route == "wgmma16" else ROW_TILES)]
        _, neg_rows, cluster, per, ctas = min(options)  # the cheapest, the larger tile on a tie
        return cls(m, k, n, layout, route, -neg_rows, COLS, cluster, per * BK, 0, ctas)


def _split(route: str, m: int, n: int, rows: int, stages: int):
    """(cost, -rows, cluster, stages a rank, CTAs) of tiles of ``rows`` rows
    of x: K split over the largest cluster whose clusters all fit the card at
    once where the tiles alone leave SMs idle, else persistent CTAs over the
    tiles in waves. The cost counts the busiest CTA's stages, each ``rows``
    + ``STAGE_COST``."""
    tiles = -(-n // COLS) * -(-m // rows)
    fits = CLUSTERS_RESIDENT[route]
    cluster = max(c for c in fits if c == 1 or (c <= stages and tiles <= fits[c]))
    per = -(-stages // cluster)
    cluster = -(-stages // per)
    if cluster == 1:
        waves, ctas = -(-tiles // fits[1]), min(tiles, fits[1])
    else:
        waves, ctas = 1, tiles * cluster
    return waves * per * (rows + STAGE_COST), -rows, cluster, per, ctas


def check_operands(name: str, x2: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                   plan: WqPlan) -> None:
    """Raise unless the kernels take these operands: contiguous bf16 x (M,
    K) and int8 weights of the layout's shape, both 16-byte aligned (TMA),
    fp32 (N,) scales, all on x's device, the stored K rows a multiple of
    ``BK``, N a multiple of ``N_MULTIPLE``, and a grid within CUDA's
    limits."""
    dev, k, n = x2.device, plan.k, plan.n
    if x2.dtype != torch.bfloat16 or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous 16-byte aligned bf16 on the card "
                         f"(got {x2.dtype})")
    want = {"kn": (k, n), "nk": (n, k), "int4": (k // 2, n)}[plan.layout]
    if (w.dtype != torch.int8 or tuple(w.shape) != want or not w.is_contiguous()
            or w.device != dev or w.data_ptr() % 16):
        raise ValueError(f"{name}: weights must be contiguous 16-byte aligned int8 {want} on "
                         f"x's device (got {w.dtype} {tuple(w.shape)})")
    if s.shape != (n,) or s.dtype != torch.float32 or s.device != dev:
        raise ValueError(f"{name}: s must be fp32 (N,) = ({n},) on x's device")
    gx, gy, gz = plan.grid
    if plan.stored_rows % BK or n % N_MULTIPLE or gx > MAX_GRID_X or max(gy, gz) > MAX_GRID_YZ:
        raise ValueError(f"{name}: the kernel takes stored K rows {plan.stored_rows} a multiple "
                         f"of {BK}, N {n} a multiple of {N_MULTIPLE}, and M {plan.m} at most "
                         f"{MAX_GRID_YZ} row tiles of {plan.rows}")


def launch(name: str, plan: WqPlan, x2: torch.Tensor, w: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """Check the operands and run ``plan`` on x2 (M, K): one launch, (M, N)
    bf16."""
    check_operands(name, x2, w, s, plan)
    if plan.route == "gemv":
        return int8_gemv._launch(x2, w, s, None, 0)
    dev = x2.device
    out = torch.empty((plan.m, plan.n), dtype=torch.bfloat16, device=dev)
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    ptrs = (x2.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), plan.m, plan.k, plan.n)
    if plan.route == "int4_gemv":
        err = lib.pg_int4_gemv(*ptrs, plan.cluster, plan.warps, plan.k_per_cta, stream)
    elif plan.layout == "int4":
        err = lib.pg_int4_matmul(*ptrs, plan.rows, plan.cluster, plan.k_per_cta // BK,
                                 plan.ctas, stream)
    else:
        err = lib.pg_int8_matmul(*ptrs, int(plan.layout == "nk"), plan.rows, plan.cluster,
                                 plan.k_per_cta // BK, plan.ctas, stream)
    _build.check(err, name)
    return out
