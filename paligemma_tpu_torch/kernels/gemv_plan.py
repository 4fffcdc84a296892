"""The split of one int8 GEMV over the card (``csrc/gemv_tile.cuh``).

``x (B, K) . w8 (K, N)`` runs on thread-block clusters:

* a CTA of ``warps`` warps (4 or 8) covers one tile of ``TILE_N`` weight
  columns (GeGLU: ``TILE_N / 2`` gate and the paired up columns) and
  ``BATCH_TILE`` rows of x (one ``mma.sync`` n8 tile; more rows take more
  tiles on the grid's z axis);
* the ``cluster`` CTAs of one cluster split K: rank r takes rows
  ``[r * k_per_cta, (r + 1) * k_per_cta)``; inside a CTA, warp w takes
  every ``warps``-th 16-row step from step w;
* the warps' sums are added in warp order in shared memory, the ranks' in
  rank order through distributed shared memory, and the epilogue runs in
  the same launch.

The rate follows the warps resident on the SMs (128 registers a thread
allow 16 warps an SM), so the plan splits each column tile's K over enough
warps to put ~16 on every SM: over up to ``MAX_CLUSTER`` CTAs of 4 warps,
then 8 warps a CTA. CTAs stay at most 8 warps, two to an SM: a cluster of 8
CTAs that each fill an SM does not fit 16 times in the H100's GPCs, and
such launches took a second wave (measured). Where the split leaves a warp
without a 16-row step of K, fewer warps.

So every output element is one fixed sum whose order depends on (K, N)
only: not on B, on the batch tile of its row, on the epilogue, or on the
order in which CTAs run. The LM-head argmax (``kernels/decode_head``)
takes the plan of the unpadded vocab, so its logits have the bits of the
logits path's ``int8_gemv``.

Two pieces of the kernel's layout live here as well, so that the CPU tests
can check them:

* the norm prologue stages the CTA's K range of the normalized rows in the
  warps' sum buffer (``NORM_STAGE_BYTES``; the fp32 form stages nothing,
  it makes y as it loads x): :func:`norm_fits`;
* the qkv GEMV's RoPE epilogue (``int8_gemv_rope_kv``) pairs column j of
  a head with column j + D/2 inside one tile: :func:`rope_quad_col` is the
  weight column each quad of a tile reads, :func:`epilogue_share` the
  output columns (pairs) each cluster rank finishes.
"""

from __future__ import annotations

import dataclasses

TILE_N = 128  # weight columns of a tile (csrc/gemv_tile.cuh GT_COLS)
BATCH_TILE = 8  # rows of x per CTA: the n8 of mma.sync.m16n8k16 (GT_BT)
WARP_CHOICES = (4, 8)  # warps per CTA (GT_MAX_WARPS = 8)
STEP_K = 16  # K rows per mma step
MAX_CLUSTER = 8  # the portable cluster size
TARGET_WARPS = 16 * 132  # 16 resident warps on each of the H100's 132 SMs
NORM_PAD = 8  # bf16 between two staged rows of y (GT_NORM_PAD)
NORM_STAGE_BYTES = 8 * BATCH_TILE * TILE_N * 4  # GemvSmem::red: 8 warps' sums


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    k: int
    n: int
    cluster: int  # CTAs per cluster: the K splits of one column tile
    warps: int  # warps per CTA
    k_per_cta: int  # K rows of each rank but the last (a multiple of STEP_K)

    @classmethod
    def make(cls, k: int, n: int) -> "GemvPlan":
        """Split each column tile's K over ~``TARGET_WARPS`` / tiles warps
        (at most one per 16-row step): over a cluster of CTAs of 4 warps,
        then 8 warps a CTA. Depends on (K, N) only."""
        if min(k, n) < 1:
            raise ValueError(f"GemvPlan: empty GEMV (K, N) = ({k}, {n})")
        steps = -(-k // STEP_K)
        per_tile = min(steps, -(-TARGET_WARPS // -(-n // TILE_N)))
        cluster = max(1, min(MAX_CLUSTER, per_tile // WARP_CHOICES[0]))
        warps = max(w for w in WARP_CHOICES if w == WARP_CHOICES[0] or cluster * w <= per_tile)
        per = -(-steps // cluster)
        return cls(k, n, -(-steps // per), warps, per * STEP_K)


def norm_fits(plan: GemvPlan, fp32: bool = False) -> bool:
    """True where the norm prologue's staged rows (a batch tile of the
    CTA's K range, bf16) fit the kernel's buffer, and K is a whole number
    of 8-element chunks (the rows are read 16 bytes at a time). ``fp32``:
    the fp32 form's prologue, which stages nothing and reads x and the
    norm weight 4 elements (16 bytes) at a time."""
    if fp32:
        return plan.k % 4 == 0
    return plan.k % 8 == 0 and BATCH_TILE * (plan.k_per_cta + NORM_PAD) * 2 <= NORM_STAGE_BYTES


def rope_quad_col(tile: int, quad: int, n_heads: int, head_dim: int):
    """The first of the 16 weight columns quad ``quad`` (0-7) of tile
    ``tile`` reads in the RoPE epilogue's GEMV over N = (H + 2) D, or None
    past the last pair. A tile covers ``TILE_N // 2`` pairs (j, j + D/2) of
    one head: quads 0-3 read 16 pairs' first columns, quads 4-7 the same
    pairs' partners (csrc/int8_gemv.cuh, mode 4)."""
    half = head_dim // 2
    p = tile * (TILE_N // 2) + 16 * (quad % 4)
    if p >= (n_heads + 2) * half:
        return None
    return (p // half) * head_dim + p % half + (0 if quad < 4 else half)


def epilogue_share(cluster: int, tile_out: int = TILE_N // 2):
    """[lo, hi) of the tile's output columns (GeGLU and RoPE: pairs) that
    each cluster rank finishes, rank by rank."""
    per = -(-tile_out // cluster)
    return [(r * per, min(tile_out, (r + 1) * per)) for r in range(cluster)]
