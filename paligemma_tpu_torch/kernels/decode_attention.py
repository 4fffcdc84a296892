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
same tiles and combine; each tile's columns split over a cluster of
``F32_CLUSTER`` CTAs, :meth:`SplitPlan.f32_columns`), counted apart on
:func:`decode_attention_fp32`.

A cache of the other dtype (the engines' ``cache_dtype``) takes a mixed
form, as the TPU kernel casts the window to q's dtype before its products
(decode_layer.py ``_kernel_all``, ``kwin[...].astype(q_b.dtype)``): bf16 q
over an fp32 cache runs the bf16 pass on the tiles rounded to bf16 as they
are staged (:func:`decode_attention_cache_fp32`), fp32 q over a bf16 cache
the fp32 pass on the tiles widened (:func:`decode_attention_fp32_cache_bf16`),
each counted apart. The plain version casts the window to q's dtype the
same way. The whole cache is never cast.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build

KEYS_PER_SPLIT = 32  # csrc/attention_split.cuh DA_KT
MERGE_LANES = 8  # DA_MERGE: the combine's warp that adds split s is s % 8
MAX_HEADS = 8  # DA_HMAX
F32_CLUSTER = 2  # DA_F32_CS: the fp32 split pass's CTAs a split, one share of D each
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

    def f32_columns(self, rank: int) -> tuple[int, int]:
        """Columns [lo, hi) of D that rank ``rank`` of a split's cluster
        stages and multiplies in the fp32 pass: its partial scores over them
        are added in rank order, and it writes their p.v. Fixed by D alone."""
        share = self.head_dim // F32_CLUSTER
        return rank * share, (rank + 1) * share

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
    """Plain version: (B, H*D) in q's dtype; a row with no valid slot gives 0.
    The window is cast to q's dtype first (the TPU kernel's astype), so an
    fp32 cache under bf16 q is rounded before the fp32 products."""
    b, h, d = q.shape
    w = valid.shape[1]
    k_cache, v_cache = k_cache[:, :w], v_cache[:, :w]
    if rows_per_cache != 1:
        c = torch.arange(b, device=q.device) // rows_per_cache
        k_cache, v_cache = k_cache[c], v_cache[c]
    k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    s = torch.einsum("bhd,bwd->bhw", q.float(), k_cache.float()) * scale
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, torch.ones_like(den))
    out = torch.einsum("bhw,bwd->bhd", p, v_cache.float())
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
    entry, counter = _form(q, k_cache)
    if rows_per_cache < 1 or b % rows_per_cache:
        raise ValueError(f"decode_attention: B {b} must be a multiple of rows_per_cache "
                         f"{rows_per_cache}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dtype != k_cache.dtype or c.shape != (b // rows_per_cache, s_len, d)
                or not c.is_contiguous() or c.device != dev or c.data_ptr() % 16):
            raise ValueError(f"decode_attention: {name} must be contiguous 16-byte aligned "
                             f"{k_cache.dtype} (B / rows_per_cache, S, D), k_cache's dtype")
    if (valid.dtype != torch.bool or valid.shape != (b, w) or not valid.is_contiguous()
            or valid.device != dev or w > s_len):
        raise ValueError("decode_attention: valid must be contiguous bool (B, W) with W <= S")
    if h > MAX_HEADS or d % 8 or d > 256 or b > MAX_BATCH:
        raise ValueError(f"decode_attention: H {h} <= {MAX_HEADS}, D {d} multiple of 8 <= 256, "
                         f"B {b} <= {MAX_BATCH}")
    plan = split_plan(q, valid)
    part_m, part_l, part_o = plan.scratch(dev)
    out = torch.empty((b, h * d), dtype=q.dtype, device=dev)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(), out.data_ptr(),
        b, h, d, w, s_len * d, rows_per_cache, plan.nsplit, float(scale),
        _build.stream_ptr(dev),
    )
    _build.check(err, counter.__name__)
    counter.launches += 1
    return out


decode_attention.launches = 0


def _form(q: torch.Tensor, cache: torch.Tensor):
    """(C entry point, the wrapper that counts its launches) of a (q,
    cache) dtype pair; any other pair raises."""
    form = _FORMS.get((q.dtype, cache.dtype))
    if form is None:
        raise ValueError(f"decode_attention: a {cache.dtype} cache under {q.dtype} q: the "
                         "kernels take bf16 or fp32 for each")
    return form


def check_pair(name: str, q: torch.Tensor, cache: torch.Tensor, want_q, want_cache) -> None:
    if (q.dtype, cache.dtype) != (want_q, want_cache):
        raise ValueError(f"{name}: {want_q} q over a {want_cache} cache, got {q.dtype} over "
                         f"{cache.dtype}")


def decode_attention_fp32(q, k_cache, v_cache, valid, scale, *, rows_per_cache: int = 1):
    """:func:`decode_attention` of fp32 q and cache on the fp32 split pass;
    the count of its launches (which :func:`decode_attention` makes for
    fp32 q over an fp32 cache)."""
    check_pair("decode_attention_fp32", q, k_cache, torch.float32, torch.float32)
    return decode_attention(q, k_cache, v_cache, valid, scale, rows_per_cache=rows_per_cache)


decode_attention_fp32.launches = 0


def decode_attention_cache_fp32(q, k_cache, v_cache, valid, scale, *, rows_per_cache: int = 1):
    """:func:`decode_attention` of bf16 q over an fp32 cache (a mixed form:
    the bf16 pass on the tiles rounded to bf16 as they are staged); the
    count of its launches."""
    check_pair("decode_attention_cache_fp32", q, k_cache, torch.bfloat16, torch.float32)
    return decode_attention(q, k_cache, v_cache, valid, scale, rows_per_cache=rows_per_cache)


decode_attention_cache_fp32.launches = 0


def decode_attention_fp32_cache_bf16(q, k_cache, v_cache, valid, scale, *,
                                     rows_per_cache: int = 1):
    """:func:`decode_attention` of fp32 q over a bf16 cache (a mixed form:
    the fp32 pass on the tiles widened as they are staged); the count of
    its launches."""
    check_pair("decode_attention_fp32_cache_bf16", q, k_cache, torch.float32, torch.bfloat16)
    return decode_attention(q, k_cache, v_cache, valid, scale, rows_per_cache=rows_per_cache)


decode_attention_fp32_cache_bf16.launches = 0

# (q dtype, cache dtype) -> (C entry point, the wrapper that counts its launches)
_FORMS = {(torch.bfloat16, torch.bfloat16): ("pg_decode_attention", decode_attention),
          (torch.float32, torch.float32): ("pg_decode_attention_fp32", decode_attention_fp32),
          (torch.bfloat16, torch.float32): ("pg_decode_attention_cache_fp32",
                                            decode_attention_cache_fp32),
          (torch.float32, torch.bfloat16): ("pg_decode_attention_fp32_cache_bf16",
                                            decode_attention_fp32_cache_bf16)}
