"""Single-token MQA attention over a KV-cache window (the attention piece of
paligemma_tpu/kernels/decode_layer.py ``_kernel_all``); the kernel is
``csrc/decode_attention.cu``.

One query token per row, Hq query heads sharing the single KV head, cache
slots ``[0, W)`` of one layer with a (B, W) validity mask, fp32 softmax. The
fresh token's K/V must already be in the cache (kernels/int8_gemv
``int8_gemv_rope_kv`` puts it there) and its slot marked valid.

``rows_per_cache`` = s sends query rows ``[c s, (c + 1) s)`` to cache row c,
each with its own mask row: the s positions of a speculative verify block
(kernels/decode_layer ``layers_decode_fused`` at B s rows), each seeing the cache's
valid slots and the block's keys up to its own. On the same visible keys
the result has the bits of a one-row-per-cache-row call.

fp32 q and an fp32 cache (``--dtype float32``) take the template's fp32
split pass (fp32 tiles, scores and p.v on the CUDA cores, p not rounded; the
same tiles and combine), counted apart on :func:`decode_attention_fp32`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build

KEYS_PER_SPLIT = 32  # csrc/attention_split.cuh DA_KT
MERGE_LANES = 8  # DA_MERGE: the combine's warp that adds split s is s % 8
MAX_HEADS = 8  # DA_HMAX
MAX_BATCH = 65535  # one block row per (batch row, KV head): the grid's y / z limit


@dataclass(frozen=True)
class SplitPlan:
    """How the split-K kernels of ``csrc/attention_split.cuh`` cut one call:
    ``rows`` = B * Hkv rows of ``groups`` query heads each, ``window`` keys,
    ``head_dim`` D. The dense (decode_attention), paged and seg
    (ablation.decode_attention) wrappers all take their plan and scratch
    from here."""

    rows: int
    groups: int
    head_dim: int
    window: int

    @property
    def nsplit(self) -> int:
        return -(-self.window // KEYS_PER_SPLIT)

    @staticmethod
    def tile(split: int) -> tuple[int, int]:
        """Keys [start, start + KEYS_PER_SPLIT) of a split (cut at the
        window's end): fixed by the split index alone."""
        return split * KEYS_PER_SPLIT, (split + 1) * KEYS_PER_SPLIT

    @staticmethod
    def merge_slot(split: int) -> tuple[int, int]:
        """(warp, position): the combine's warp that adds a split, and its
        place in that warp's ascending sum; the warps' sums are then added
        in warp order."""
        return split % MERGE_LANES, split // MERGE_LANES

    def scratch_shapes(self) -> dict:
        """The fp32 partials the split pass writes: a max and a sum per
        split and head, an unnormalized output row per split and head."""
        ml = (self.rows, self.nsplit, self.groups)
        return {"part_m": ml, "part_l": ml, "part_o": ml + (self.head_dim,)}

    def scratch(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        sh = self.scratch_shapes()
        return tuple(torch.empty(sh[n], dtype=torch.float32, device=device)
                     for n in ("part_m", "part_l", "part_o"))


def split_plan(q: torch.Tensor, valid: torch.Tensor) -> SplitPlan:
    """The plan of a dense call: one KV head, the (B, W) mask's window
    (B query rows)."""
    b, h, d = q.shape
    return SplitPlan(rows=b, groups=h, head_dim=d, window=valid.shape[1])


def decode_attention_reference(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B / rows_per_cache, S, D) one layer
    v_cache: torch.Tensor,  # (B / rows_per_cache, S, D)
    valid: torch.Tensor,  # (B, W) bool
    scale: float,
    rows_per_cache: int = 1,
) -> torch.Tensor:
    """Plain version: (B, H*D) in q's dtype; a row with no valid slot gives 0."""
    b, h, d = q.shape
    w = valid.shape[1]
    if rows_per_cache != 1:
        c = torch.arange(b, device=q.device) // rows_per_cache
        k_cache, v_cache = k_cache[:, :w][c], v_cache[:, :w][c]
    s = torch.einsum("bhd,bwd->bhw", q.float(), k_cache[:, :w].float()) * scale
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, torch.ones_like(den))
    out = torch.einsum("bhw,bwd->bhd", p, v_cache[:, :w].float())
    return out.reshape(b, h * d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
    scale: float,
    *,
    rows_per_cache: int = 1,
) -> torch.Tensor:
    """Attention of one token per row over the window; (B, H*D) out.
    ``rows_per_cache``: query rows per cache row (module docstring)."""
    if not q.is_cuda:
        return decode_attention_reference(q, k_cache, v_cache, valid, scale, rows_per_cache)
    b, h, d = q.shape
    s_len = k_cache.shape[1]
    w = valid.shape[1]
    dev = q.device
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous bf16 or fp32 (B, H, D)")
    fp32 = q.dtype == torch.float32
    if rows_per_cache < 1 or b % rows_per_cache:
        raise ValueError(f"decode_attention: B {b} must be a multiple of rows_per_cache "
                         f"{rows_per_cache}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dtype != q.dtype or c.shape != (b // rows_per_cache, s_len, d)
                or not c.is_contiguous() or c.device != dev or c.data_ptr() % 16):
            raise ValueError(f"decode_attention: {name} must be contiguous 16-byte aligned "
                             f"{q.dtype} (B / rows_per_cache, S, D): q's dtype")
    if (valid.dtype != torch.bool or valid.shape != (b, w) or not valid.is_contiguous()
            or valid.device != dev or w > s_len):
        raise ValueError("decode_attention: valid must be contiguous bool (B, W) with W <= S")
    if h > MAX_HEADS or d % 8 or d > 256 or b > MAX_BATCH:
        raise ValueError(f"decode_attention: H {h} <= {MAX_HEADS}, D {d} multiple of 8 <= 256, "
                         f"B {b} <= {MAX_BATCH}")
    plan = split_plan(q, valid)
    part_m, part_l, part_o = plan.scratch(dev)
    out = torch.empty((b, h * d), dtype=q.dtype, device=dev)
    lib = _build.library()
    err = (lib.pg_decode_attention_fp32 if fp32 else lib.pg_decode_attention)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(), out.data_ptr(),
        b, h, d, w, s_len * d, rows_per_cache, plan.nsplit, float(scale),
        _build.stream_ptr(dev),
    )
    _build.check(err, "decode_attention_fp32" if fp32 else "decode_attention")
    (decode_attention_fp32 if fp32 else decode_attention).launches += 1
    return out


decode_attention.launches = 0


def decode_attention_fp32(q, k_cache, v_cache, valid, scale, *, rows_per_cache: int = 1):
    """:func:`decode_attention` of fp32 q and cache on the fp32 split pass;
    the count of its launches (which :func:`decode_attention` makes for
    fp32 q)."""
    if q.dtype != torch.float32:
        raise ValueError(f"decode_attention_fp32: fp32 q, got {q.dtype}")
    return decode_attention(q, k_cache, v_cache, valid, scale, rows_per_cache=rows_per_cache)


decode_attention_fp32.launches = 0
