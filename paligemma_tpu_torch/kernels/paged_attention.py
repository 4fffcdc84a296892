"""Paged single-token decode attention (port of
paligemma_tpu/kernels/paged_attention.py); the kernel is
``csrc/paged_attention.cu``.

One query token per row, GQA over the row's logical pages ``[0, kv_len)``,
read through a ``(B, P)`` page table from a page pool
``(n_pages, page_size, Hkv, D)`` or a layer-stacked ``(L, n_pages, ...)``
pool with ``layer_idx`` (the kernel offsets into the stack; no layer is
copied). Rows with ``kv_len == 0`` give zeros; table entries past a row's
last page are never read.

The TPU package has four kernels for this function (one page per grid step,
eight pages per step, all rows per step, and one DMA per physically
consecutive run); they differ only in how the TPU orders its DMAs. The four
names stay, and all launch the one CUDA kernel, which shares its tile and
combine code with kernels/decode_attention: on the same keys the two return
the same bits.

An fp32 pool and q (``--dtype float32``) take the template's fp32 split pass,
as kernels/decode_attention does (dense == paged at fp32 too), counted apart
on :func:`paged_decode_attention_fp32`. A pool of the other dtype takes the
mixed forms of kernels/decode_attention's template, the TPU paged layer's
``k_win.astype(q_b.dtype)`` (decode_layer_paged.py ``_kernel_paged``): bf16
q over an fp32 pool (:func:`paged_decode_attention_cache_fp32`) and fp32 q
over a bf16 pool (:func:`paged_decode_attention_fp32_cache_bf16`), each
counted apart; the plain version casts the gathered pages to q's dtype the
same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .decode_attention import MAX_BATCH, MAX_HEADS, SplitPlan, check_pair


def supported(page_size: int, head_dim: int) -> bool:
    """Page and head sizes the kernel takes (the engine checks this once)."""
    return page_size % 16 == 0 and head_dim % 8 == 0 and head_dim <= 256


def split_plan(q: torch.Tensor, k_pool: torch.Tensor, page_table: torch.Tensor) -> SplitPlan:
    """The plan of a paged call: the table's width in keys is the window."""
    b, hq, d = q.shape
    ps, hkv = k_pool.shape[-3], k_pool.shape[-2]
    return SplitPlan(rows=b * hkv, groups=hq // hkv, head_dim=d, window=page_table.shape[1] * ps)


def _layer_view(k_pool, v_pool, layer_idx):
    want = "(n_pages, ps, Hkv, D)" if layer_idx is None else "(L, n_pages, ps, Hkv, D)"
    if k_pool.dim() != (4 if layer_idx is None else 5):
        raise ValueError(f"paged attention: pool must be {want}, got {tuple(k_pool.shape)}")
    if layer_idx is None:
        return k_pool, v_pool
    return k_pool[int(layer_idx)], v_pool[int(layer_idx)]


def reference_paged_decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_pool: torch.Tensor,  # (n_pages, ps, Hkv, D) or (L, n_pages, ps, Hkv, D)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int
    kv_len: torch.Tensor,  # (B,) int
    scale: Optional[float] = None,
    layer_idx: Optional[int] = None,
) -> torch.Tensor:
    """Plain version: gather the pages into a dense (B, P*ps, Hkv, D) view
    in q's dtype, fp32 scores and softmax over keys ``< kv_len``; (B, Hq, D)
    in q's dtype."""
    kp, vp = _layer_view(k_pool, v_pool, layer_idx)
    b, hq, d = q.shape
    hkv = kp.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    table = page_table.long()
    k = kp[table].reshape(b, -1, hkv, d).to(q.dtype).float()  # (B, P*ps, Hkv, D)
    v = vp[table].reshape(b, -1, hkv, d).to(q.dtype).float()
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(b, hkv, g, d).float(), k) * scale
    visible = torch.arange(k.shape[1], device=q.device)[None] < kv_len.to(q.device).long()[:, None]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, torch.ones_like(den))  # kv_len 0 -> 0
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    kv_len: torch.Tensor,
    scale: Optional[float] = None,
    *,
    layer_idx: Optional[int] = None,
) -> torch.Tensor:
    """Length-aware paged decode attention; (B, Hq, D) out."""
    if not q.is_cuda:
        return reference_paged_decode_attention(q, k_pool, v_pool, page_table, kv_len, scale,
                                                layer_idx)
    b, hq, d = q.shape
    dev = q.device
    if scale is None:
        scale = d**-0.5
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.is_contiguous():
        raise ValueError("paged_decode_attention: q must be contiguous bf16 or fp32 (B, Hq, D)")
    entry, counter = _form(q, k_pool)
    stacked = layer_idx is not None
    if k_pool.dim() != (5 if stacked else 4):
        raise ValueError(f"paged_decode_attention: pool of shape {tuple(k_pool.shape)} "
                         f"with layer_idx={layer_idx}")
    n_pages, ps, hkv = k_pool.shape[-4:-1]
    for name, p in (("k_pool", k_pool), ("v_pool", v_pool)):
        if (p.dtype != k_pool.dtype or p.shape != k_pool.shape or not p.is_contiguous()
                or p.device != dev or p.data_ptr() % 16 or p.shape[-1] != d):
            raise ValueError(f"paged_decode_attention: {name} must be contiguous 16-byte "
                             "aligned with k_pool's dtype and q's head_dim")
    n_p = page_table.shape[1]
    if (page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.stride(1) != 1 or page_table.device != dev):
        raise ValueError("paged_decode_attention: page_table must be (B, P) int32 with unit "
                         "column stride")
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32 or kv_len.device != dev:
        raise ValueError("paged_decode_attention: kv_len must be (B,) int32")
    if hq % hkv or hq // hkv > MAX_HEADS or not supported(ps, d) or b * hkv > MAX_BATCH:
        raise ValueError(f"paged_decode_attention: Hq {hq} a multiple of Hkv {hkv} with at most "
                         f"{MAX_HEADS} per KV head, page_size {ps} a multiple of 16, head_dim "
                         f"{d} a multiple of 8 <= 256, B*Hkv <= {MAX_BATCH}")
    w = n_p * ps
    plan = split_plan(q, k_pool, page_table)
    part_m, part_l, part_o = plan.scratch(dev)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    layer_off = int(layer_idx) * n_pages * ps * hkv * d if stacked else 0
    kv_len = kv_len.contiguous()
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        kv_len.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
        out.data_ptr(), b, hq, hkv, d, w, ps, page_table.stride(0), layer_off, plan.nsplit,
        float(scale), _build.stream_ptr(dev),
    )
    _build.check(err, counter.__name__)
    counter.launches += 1
    return out


paged_decode_attention.launches = 0


def _form(q: torch.Tensor, pool: torch.Tensor):
    """(C entry point, the wrapper that counts its launches) of a (q,
    pool) dtype pair; any other pair raises."""
    form = _FORMS.get((q.dtype, pool.dtype))
    if form is None:
        raise ValueError(f"paged_decode_attention: a {pool.dtype} pool under {q.dtype} q: the "
                         "kernels take bf16 or fp32 for each")
    return form


def paged_decode_attention_fp32(q, k_pool, v_pool, page_table, kv_len, scale=None, *,
                                layer_idx=None):
    """:func:`paged_decode_attention` of fp32 q and pool on the fp32 split
    pass; the count of its launches (which :func:`paged_decode_attention`
    makes for fp32 q over an fp32 pool)."""
    check_pair("paged_decode_attention_fp32", q, k_pool, torch.float32, torch.float32)
    return paged_decode_attention(q, k_pool, v_pool, page_table, kv_len, scale,
                                  layer_idx=layer_idx)


paged_decode_attention_fp32.launches = 0


def paged_decode_attention_cache_fp32(q, k_pool, v_pool, page_table, kv_len, scale=None, *,
                                      layer_idx=None):
    """:func:`paged_decode_attention` of bf16 q over an fp32 pool (a mixed
    form: the bf16 pass on the tiles rounded as staged); the count of its
    launches."""
    check_pair("paged_decode_attention_cache_fp32", q, k_pool, torch.bfloat16, torch.float32)
    return paged_decode_attention(q, k_pool, v_pool, page_table, kv_len, scale,
                                  layer_idx=layer_idx)


paged_decode_attention_cache_fp32.launches = 0


def paged_decode_attention_fp32_cache_bf16(q, k_pool, v_pool, page_table, kv_len, scale=None,
                                           *, layer_idx=None):
    """:func:`paged_decode_attention` of fp32 q over a bf16 pool (a mixed
    form: the fp32 pass on the tiles widened as staged); the count of its
    launches."""
    check_pair("paged_decode_attention_fp32_cache_bf16", q, k_pool, torch.float32, torch.bfloat16)
    return paged_decode_attention(q, k_pool, v_pool, page_table, kv_len, scale,
                                  layer_idx=layer_idx)


paged_decode_attention_fp32_cache_bf16.launches = 0

# (q dtype, cache dtype) -> (C entry point, the wrapper that counts its launches)
_FORMS = {(torch.bfloat16, torch.bfloat16): ("pg_paged_attention", paged_decode_attention),
          (torch.float32, torch.float32): ("pg_paged_attention_fp32",
                                           paged_decode_attention_fp32),
          (torch.bfloat16, torch.float32): ("pg_paged_attention_cache_fp32",
                                            paged_decode_attention_cache_fp32),
          (torch.float32, torch.bfloat16): ("pg_paged_attention_fp32_cache_bf16",
                                            paged_decode_attention_fp32_cache_bf16)}


# The TPU package's other three DMA strategies for the same function are,
# on Hopper, the one kernel above.
paged_decode_attention_multi = paged_decode_attention
paged_decode_attention_batched = paged_decode_attention
paged_decode_attention_runs = paged_decode_attention

# paged_kernel value -> wrapper (models/gemma.forward_paged_decode)
VARIANTS = {
    "one": paged_decode_attention,
    "multi": paged_decode_attention_multi,
    "batched": paged_decode_attention_batched,
    "runs": paged_decode_attention_runs,
}
