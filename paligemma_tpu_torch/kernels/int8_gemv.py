"""int8 weight-only GEMV for decode, with fused epilogues.

The weight streams of the TPU kernel paligemma_tpu/kernels/decode_layer.py
``_kernel_all`` (qkv, o-proj + residual, gate/up + GeGLU, down + residual)
and the int8 LM head of the logits path (models/gemma.lm_head) run through
``int8_gemv``; ``csrc/int8_gemv.cuh`` is the kernel (its entry points in
``int8_gemv.cu`` and ``int8_gemv_fp32.cu``): one launch per GEMV,
the product on the tensor cores, K split over a thread-block cluster as
:class:`~.gemv_plan.GemvPlan` says, the epilogue in the same launch.

    out = cast(x @ w8 (fp32) * s)                      plain
    out = residual + cast(x @ w8 * s)                  residual=...
    out = cast(gelu_tanh(g) * u), [g | u] = x @ w8 * s geglu=True (N = 2I)
    out = x @ w8 (fp32) * s, kept in fp32               int8_gemv_f32

``int8_gemv_f32`` is the fp32-partial epilogue of the tensor-parallel decode
(the o-proj partial of paligemma_tpu/kernels/decode_layer_tp.py
``_attn_kernel`` and the down-proj partial of paligemma_tpu/kernels/
decode_mlp.py ``_kernel``): each rank's partial is summed across ranks in
fp32 and cast once, after the sum. It is a wrapper of its own so that its
launches are counted apart from the bf16 epilogues'. With ``lora=`` it is
:func:`int8_gemv_f32_lora` (K1 of the tensor-parallel multi-LoRA chain):
``[x @ w8 * s | z @ b]`` as one (B, 2N) fp32 partial, the rank's delta
beside its base partial, both summed by one all-reduce and added as the
one-card residual epilogue with the expand adds them (base, then delta,
each cast), so that one rank gives that epilogue's bits
(kernels/decode_layer_tp ``add_partial``).

The GeGLU epilogue works on the fp32 gate and up values, as the TPU kernel
does (its XLA path rounds both to the activation dtype first).

``lora=(z, b, bounds)`` adds each row's LoRA delta in the epilogue (the
expand of the TPU kernel's in-kernel multi-LoRA, decode_layer.py
``_kernel_all`` with ``lora=True``): ``z (B, nz)`` is the row's masked
adapter basis from kernels/lora, ``b (G, N)`` the alpha-folded adapter rows
(fp32 or bf16, cast to the activation dtype), and ``bounds`` the output
columns where the next target's G-wide block of ``z`` starts ((q | k | v):
``(nq, nq + hd)``; (gate | up): ``(I,)``; o and down: ``()``). The delta
is cast and added after the residual (plain and residual modes) or added
in fp32 to the gate and up values before the GeGLU, as the TPU kernel adds
it, by the same launch (``pg_int8_gemv_lora``: each rank adds its columns'
deltas after the cluster's sum).

``norm=(w, eps)`` multiplies the Gemma RMSNorm of x instead of x,
``y = cast((x * rsqrt(mean(x^2) + eps)) * (1 + w))``, computed in the
kernel's prologue (``pg_int8_gemv_fused``) as the TPU kernel normalizes in
the kernel that streams the weights. Its r depends on x's row alone, so
every kernel that reads the row (each GEMV plan and ``lora_shrink`` with the
same ``norm``) multiplies the same bits; on the CPU the plain version runs
ops/norms.rms_norm first, which is the chain the prologue replaces.

``int8_gemv_rope_kv`` is the qkv projection with the TPU kernel's RoPE and
the fresh K/V rows in its epilogue (decode_layer.py ``_kernel_all``;
decode_layer_paged.py ``_kernel_paged``, whose caller writes the fresh row
into its page slot): one launch computes q|k|v, casts it (plus the LoRA
delta, as the plain epilogue adds it), rotates q and k half-split in fp32,
writes q and the K/V rows at ``pos`` (a dense cache row, or a page slot
through ``page_table``) and ``k_new`` / ``v_new``. It is a wrapper of its
own, counted apart. Its plain version is the chain it replaces:
:func:`int8_gemv_reference` then decode_elementwise's
``rope_kv_write_reference`` / ``rope_kv_write_paged_reference``.

fp32 x (``--dtype float32``) takes the tile's fp32 form (``pg_int8_gemv_fp32``:
each fp32 element of x split into three bf16 terms against the same bf16
weight fragments, csrc/gemv_tile.cuh) in every mode, ``int8_gemv_rope_kv``,
the fp32 partial and the LoRA expand included, with the norm prologue;
every operand in the activation dtype is then fp32 (residual, norm weight,
cos / sin, the cache rows, the LoRA basis z and the outputs), every cast
the identity, and an fp32 adapter B is read unrounded. Its launches are
counted apart: :func:`int8_gemv_fp32` (with or without the expand),
:func:`int8_gemv_rope_kv_fp32`, :func:`int8_gemv_f32_fp32` and
:func:`int8_gemv_f32_lora_fp32`. The fp32 partial keeps the tile's plan and
rank-order sums, so it has mode 0's bits at fp32 as at bf16.

``int8_gemv_rope_kv`` over a KV cache of the other dtype (the engines'
``cache_dtype``; the cache rows and ``k_new`` / ``v_new`` in the cache's
dtype, everything else in x's) takes a mixed form of the epilogue: each row
is cast to x's dtype as above and then converted to the cache's, as the TPU
kernel returns ``k_new.astype(cache dtype)`` (decode_layer.py
``_kernel_all``): :func:`int8_gemv_rope_kv_cache_fp32` (bf16 x, the rows
widened exactly) and :func:`int8_gemv_rope_kv_fp32_cache_bf16` (fp32 x, the
rows rounded to bf16 to nearest even, as ``.to(torch.bfloat16)``), each
counted apart.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.activations import gelu_tanh
from ..ops.norms import rms_norm as rms_norm_reference
from . import _build
from .decode_elementwise import rope_kv_write_paged_reference, rope_kv_write_reference
from .gemv_plan import TILE_N, GemvPlan, norm_fits  # noqa: F401  (TILE_N: the head's padding)

LoraExpand = Tuple[torch.Tensor, torch.Tensor, Sequence[int]]  # (z, b, bounds)
Norm = Tuple[torch.Tensor, float]  # (w (K,), eps) of a Gemma RMSNorm


def normed(x: torch.Tensor, norm: Optional[Norm]) -> torch.Tensor:
    """x, or its plain Gemma RMSNorm by ``norm = (w, eps)``."""
    return x if norm is None else rms_norm_reference(x, norm[0], norm[1])


def lora_expand_reference(z: torch.Tensor, b: torch.Tensor, bounds: Sequence[int],
                          dtype: torch.dtype) -> torch.Tensor:
    """(B, N) fp32 LoRA delta: the columns of target t, between its bounds,
    take z's t-th G-wide block times b cast to ``dtype``."""
    g = b.shape[0]
    edges = [0, *bounds, b.shape[1]]
    bq = b.to(dtype).float()
    return torch.cat([z[:, t * g:(t + 1) * g].float() @ bq[:, lo:hi]
                      for t, (lo, hi) in enumerate(zip(edges[:-1], edges[1:]))], dim=-1)


def int8_gemv_reference(
    x: torch.Tensor,  # (B, K)
    w8: torch.Tensor,  # (K, N) int8
    s: torch.Tensor,  # (N,) fp32
    residual: Optional[torch.Tensor] = None,  # (B, N)
    geglu: bool = False,
    out_fp32: bool = False,
    lora: Optional[LoraExpand] = None,
    *,
    norm: Optional[Norm] = None,
) -> torch.Tensor:
    """Plain version of :func:`int8_gemv` (and, with ``out_fp32``, of
    :func:`int8_gemv_f32`)."""
    x = normed(x, norm)
    v = (x.float() @ w8.float()) * s.float()
    delta = None if lora is None else lora_expand_reference(*lora, x.dtype)
    if out_fp32:
        return v if delta is None else torch.cat([v, delta], dim=-1)
    if geglu:
        inter = v.shape[-1] // 2
        g, u = v[:, :inter], v[:, inter:]
        if delta is not None:
            g, u = g + delta[:, :inter], u + delta[:, inter:]
        return (gelu_tanh(g) * u).to(x.dtype)
    out = v.to(x.dtype)
    if residual is not None:
        out = residual + out
    if delta is not None:
        out = out + delta.to(x.dtype)
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_gemv: {msg}")


def _check_lora(lora: LoraExpand, b: int, n: int, dev, dtype) -> Tuple[int, int, int]:
    """Validates the expand operands; returns (G, seg1, seg2)."""
    z, lb, bounds = lora
    g = lb.shape[0] if lb.dim() == 2 else 0
    _check(lb.dim() == 2 and lb.shape[1] == n and lb.is_contiguous() and lb.device == dev
           and lb.dtype in (torch.float32, torch.bfloat16) and g % 8 == 0
           and lb.data_ptr() % 4 == 0,
           f"lora b must be contiguous 4-byte aligned fp32 or bf16 (G, {n}) with G a multiple "
           f"of 8, got {tuple(lb.shape)} {lb.dtype}")
    _check(len(bounds) <= 2 and list(bounds) == sorted(bounds) and all(0 < c < n for c in bounds),
           f"lora bounds {tuple(bounds)} must be at most two sorted columns inside (0, {n})")
    _check(z.dtype == dtype and z.shape == (b, g * (len(bounds) + 1))
           and z.is_contiguous() and z.device == dev and z.data_ptr() % 16 == 0,
           f"lora z must be contiguous 16-byte aligned {dtype} ({b}, "
           f"{g * (len(bounds) + 1)}), x's dtype")
    segs = list(bounds) + [n] * (2 - len(bounds))
    return g, segs[0], segs[1]


def _check_norm(norm: Norm, x: torch.Tensor, plan: GemvPlan) -> None:
    w, _ = norm
    _check(w.dtype == x.dtype and w.shape == (plan.k,) and w.is_contiguous()
           and w.device == x.device and w.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0,
           f"norm weight must be contiguous 16-byte aligned {x.dtype} ({plan.k},) on x's "
           "device, and x 16-byte aligned")
    _check(norm_fits(plan, x.dtype == torch.float32),
           f"the norm prologue takes K % 8 == 0 (fp32: K % 4 == 0) and a K range per CTA "
           f"that fits its buffer (K {plan.k}, N {plan.n}: {plan.k_per_cta} rows a CTA)")


def _launch(x, w8, s, residual, mode: int, lora: Optional[LoraExpand] = None,
            norm: Optional[Norm] = None, rope=None) -> torch.Tensor:
    """One GEMV launch of ``mode`` (0 plain, 1 + residual, 2 GeGLU, 3 fp32
    out, 4 RoPE + KV write with ``rope``: (out q, cos, sin, pos, k_dst,
    v_dst, k_new, v_new, table or None, H, D)); with ``lora`` its epilogue
    adds the expand (mode 3: writes it beside the base partial); with
    ``norm`` its prologue normalizes x (not mode 3)."""
    b, k = x.shape
    n = w8.shape[-1]
    dev = x.device
    fp32 = x.dtype == torch.float32
    _check(b > 0, "x has no rows")
    _check(x.dtype in (torch.bfloat16, torch.float32) and x.is_contiguous(),
           "x must be contiguous bf16 or fp32")
    _check(w8.dtype == torch.int8 and w8.shape == (k, n) and w8.is_contiguous(),
           f"w8 must be contiguous int8 ({k}, N), got {tuple(w8.shape)} {w8.dtype}")
    _check(w8.device == dev and s.device == dev, "all operands on one device")
    _check(n % 4 == 0 and w8.data_ptr() % 4 == 0, "N % 4 == 0 and 4-byte aligned w8")
    _check(s.dtype == torch.float32 and s.shape == (n,) and s.is_contiguous(),
           "s must be contiguous fp32 (N,)")
    if mode == 2:
        _check(n % 2 == 0, "geglu takes an even N")
    if mode == 1:
        _check(residual.dtype == x.dtype and residual.shape == (b, n)
               and residual.is_contiguous() and residual.device == dev,
               f"residual must be contiguous {x.dtype} (B, N), x's dtype")
    g = seg1 = seg2 = 0
    if lora is not None:
        g, seg1, seg2 = _check_lora(lora, b, n, dev, x.dtype)
    plan = GemvPlan.make(k, n)
    if norm is not None:
        _check_norm(norm, x, plan)
    if mode == 4:
        out = rope[0]
    else:  # mode 3 with the expand: [base | delta]
        width = n // 2 if mode == 2 else (2 * n if mode == 3 and lora is not None else n)
        out = torch.empty((b, width), dtype=torch.float32 if mode == 3 else x.dtype, device=dev)
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    args = (x.data_ptr(), w8.data_ptr(), s.data_ptr(),
            residual.data_ptr() if mode == 1 else None, out.data_ptr(), b, k, n, mode,
            plan.cluster, plan.warps, plan.k_per_cta)
    lora_args = (None, None, 0, 0, 0, 0, 0)
    if lora is not None:
        z, lb, _ = lora
        lora_args = (z.data_ptr(), lb.data_ptr(), int(lb.dtype == torch.float32), g, z.shape[1],
                     seg1, seg2)
    rope_args = (None,) * 8 + (0, 0, 0, 0)
    mixed = rope is not None and rope[4].dtype != x.dtype  # a cache of the other dtype
    if rope is not None:
        _, cos, sin, pos, k_dst, v_dst, k_new, v_new, table, h, d = rope
        rope_args = (cos.data_ptr(), sin.data_ptr(), pos.data_ptr(), k_dst.data_ptr(),
                     v_dst.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                     None if table is None else table.data_ptr(), h, d, k_dst.shape[1],
                     0 if table is None else table.stride(0))
    norm_args = (None if norm is None else norm[0].data_ptr(),
                 0.0 if norm is None else float(norm[1]))
    if mixed:
        entry = ("pg_int8_gemv_fp32_rope_kv_cache_bf16" if fp32
                 else "pg_int8_gemv_rope_kv_cache_fp32")
        _build.check(getattr(lib, entry)(*args, *lora_args, *norm_args, *rope_args, stream),
                     entry)
        return out
    if fp32:
        _build.check(lib.pg_int8_gemv_fp32(*args, *lora_args, *norm_args, *rope_args, stream),
                     "int8_gemv fp32")
        return out
    if norm is None and rope is None:
        if lora is None:
            _build.check(lib.pg_int8_gemv(*args, stream), "int8_gemv")
        else:
            _build.check(lib.pg_int8_gemv_lora(*args, *lora_args, stream), "int8_gemv LoRA")
        return out
    _build.check(lib.pg_int8_gemv_fused(*args, *lora_args, *norm_args, *rope_args, stream),
                 "int8_gemv fused")
    return out


def int8_gemv(
    x: torch.Tensor,
    w8: torch.Tensor,
    s: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    geglu: bool = False,
    lora: Optional[LoraExpand] = None,
    *,
    norm: Optional[Norm] = None,
) -> torch.Tensor:
    """``x (B, K)`` times an int8 ``(K, N)`` weight with per-column scales
    (``lora``: plus each row's adapter delta; ``norm``: of x's RMSNorm;
    module docstring)."""
    if not x.is_cuda:
        return int8_gemv_reference(x, w8, s, residual, geglu, lora=lora, norm=norm)
    if x.dtype == torch.float32:
        return int8_gemv_fp32(x, w8, s, residual, geglu, lora, norm=norm)
    _check(not (geglu and residual is not None), "geglu takes no residual")
    out = _launch(x, w8, s, residual, 2 if geglu else (1 if residual is not None else 0), lora,
                  norm)
    int8_gemv.launches += 1
    return out


int8_gemv.launches = 0


def int8_gemv_fp32(
    x: torch.Tensor,
    w8: torch.Tensor,
    s: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    geglu: bool = False,
    lora: Optional[LoraExpand] = None,
    *,
    norm: Optional[Norm] = None,
) -> torch.Tensor:
    """:func:`int8_gemv` of fp32 ``x`` on the tile's fp32 form (module
    docstring): fp32 out, residual, norm weight and LoRA basis z.
    :func:`int8_gemv` sends fp32 x here; its launches are counted here."""
    _check(x.dtype == torch.float32, f"int8_gemv_fp32 takes fp32 x, got {x.dtype}")
    if not x.is_cuda:
        return int8_gemv_reference(x, w8, s, residual, geglu, lora=lora, norm=norm)
    _check(not (geglu and residual is not None), "geglu takes no residual")
    out = _launch(x, w8, s, residual, 2 if geglu else (1 if residual is not None else 0), lora,
                  norm)
    int8_gemv_fp32.launches += 1
    return out


int8_gemv_fp32.launches = 0


def int8_gemv_f32(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor, *,
                  lora: Optional[LoraExpand] = None) -> torch.Tensor:
    """The fp32 partial ``x (B, K) @ w8 * s`` of one tensor-parallel rank:
    (B, N) fp32, no cast and no residual. With ``lora``: (B, 2N), the
    rank's partial adapter delta beside it (:func:`int8_gemv_f32_lora`).
    fp32 x takes the tile's fp32 form, counted on :func:`int8_gemv_f32_fp32`."""
    if lora is not None:
        return int8_gemv_f32_lora(x, w8, s, lora)
    if not x.is_cuda:
        return int8_gemv_reference(x, w8, s, out_fp32=True)
    out = _launch(x, w8, s, None, 3)
    (int8_gemv_f32_fp32 if x.dtype == torch.float32 else int8_gemv_f32).launches += 1
    return out


int8_gemv_f32.launches = 0


def int8_gemv_f32_fp32(x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """:func:`int8_gemv_f32` of fp32 x on the tile's fp32 form (mode 3 of
    ``pg_int8_gemv_fp32``); the count of its launches (which
    :func:`int8_gemv_f32` makes for fp32 x)."""
    _check(x.dtype == torch.float32, f"int8_gemv_f32_fp32 takes fp32 x, got {x.dtype}")
    return int8_gemv_f32(x, *args, **kw)


int8_gemv_f32_fp32.launches = 0


def int8_gemv_f32_lora(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor,
                       lora: LoraExpand) -> torch.Tensor:
    """K1: a tensor-parallel rank's o or down partial under a multi-LoRA
    bank, ``[x @ w8 * s | z @ b]`` (B, 2N) fp32 in one launch (mode 3 with
    the expand; module docstring). ``lora = (z, b, ())``: z (B, G) the
    masked basis of the rank's K rows (kernels/lora), b (G, N) the whole
    alpha-folded adapter rows. The delta half is z @ cast(b) summed in fp32
    over the G rows in order, the one-card expand's sum before its cast."""
    if not x.is_cuda:
        return int8_gemv_reference(x, w8, s, out_fp32=True, lora=lora)
    _check(len(lora[2]) == 0, "the fp32 partial takes one LoRA target (no bounds)")
    out = _launch(x, w8, s, None, 3, lora)
    (int8_gemv_f32_lora_fp32 if x.dtype == torch.float32 else int8_gemv_f32_lora).launches += 1
    return out


int8_gemv_f32_lora.launches = 0


def int8_gemv_f32_lora_fp32(x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """:func:`int8_gemv_f32_lora` (K1) of fp32 x on the tile's fp32 form:
    ``[x @ w8 * s | z @ b]`` with fp32 z and an unrounded fp32 b; the count
    of its launches (which :func:`int8_gemv_f32_lora` makes for fp32 x)."""
    _check(x.dtype == torch.float32, f"int8_gemv_f32_lora_fp32 takes fp32 x, got {x.dtype}")
    return int8_gemv_f32_lora(x, *args, **kw)


int8_gemv_f32_lora_fp32.launches = 0


def int8_gemv_rope_kv_reference(x, w8, s, cos, sin, pos, n_heads, k_dst, v_dst, k_new, v_new, *,
                                norm, page_table=None, lora=None):
    """Plain version of :func:`int8_gemv_rope_kv`: the chain it replaces
    (writes the cache rows or pool slots in place)."""
    qkv = int8_gemv_reference(x, w8, s, lora=lora, norm=norm)
    if page_table is None:
        return rope_kv_write_reference(qkv, cos, sin, pos, n_heads, k_dst, v_dst, k_new, v_new)
    return rope_kv_write_paged_reference(qkv, cos, sin, pos, n_heads, k_dst, v_dst, page_table,
                                         k_new, v_new)


def _check_rope(b, n, n_heads, cos, sin, pos, k_dst, v_dst, k_new, v_new, page_table, dev,
                dtype):
    d = cos.shape[-1]
    cdtype = k_dst.dtype
    _check(d > 0 and (d // 2) % 16 == 0 and d % 2 == 0 and n == (n_heads + 2) * d,
           f"RoPE takes N = (H + 2) * D with D / 2 a multiple of 16, got N {n}, H {n_heads}, "
           f"D {d}")
    _check(cdtype in (torch.bfloat16, torch.float32),
           f"the cache must be bf16 or fp32, got {cdtype}")
    for arg, t, want in (("cos", cos, dtype), ("sin", sin, dtype), ("k_new", k_new, cdtype),
                         ("v_new", v_new, cdtype)):
        _check(t.dtype == want and t.shape == (b, d) and t.is_contiguous()
               and t.device == dev, f"{arg} must be contiguous {want} {(b, d)} on x's device")
    _check(pos.dtype == torch.int32 and pos.shape == (b,) and pos.is_contiguous()
           and pos.device == dev, "pos must be contiguous int32 (B,) on x's device")
    for arg, t in (("k_dst", k_dst), ("v_dst", v_dst)):
        _check(t.dtype == cdtype and t.dim() == 3 and t.shape[2] == d
               and t.is_contiguous() and t.device == dev and t.shape == k_dst.shape,
               f"{arg} must be contiguous {cdtype} (rows, S or page size, D) on x's device: "
               "k_dst and v_dst take one dtype")
    if page_table is None:
        _check(k_dst.shape[0] == b, "a dense cache takes one row of slots per batch row")
    else:
        _check(page_table.dtype == torch.int32 and page_table.dim() == 2
               and page_table.shape[0] == b and page_table.stride(1) == 1
               and page_table.device == dev,
               "page_table must be (B, P) int32 with unit column stride on x's device")


def int8_gemv_rope_kv(
    x: torch.Tensor,  # (B, K) the layer's input (with norm: before its RMSNorm)
    w8: torch.Tensor,  # (K, (H + 2) * D) int8 q|k|v
    s: torch.Tensor,  # ((H + 2) * D,) fp32
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,  # (B, D)
    pos: torch.Tensor,  # (B,) int32 position of this token per row
    n_heads: int,  # H: query heads (a tensor-parallel rank's local ones)
    k_dst: torch.Tensor,  # (B, S, D) dense cache of the layer, or (n_pages, ps, D) its pool
    v_dst: torch.Tensor,
    k_new: torch.Tensor,  # (B, D) out: the fresh key row
    v_new: torch.Tensor,  # (B, D) out: the fresh value row
    *,
    norm: Norm,  # (w (K,), eps): the layer's input RMSNorm, in the prologue
    page_table: Optional[torch.Tensor] = None,  # (B, P) int32: k_dst / v_dst are a page pool
    lora: Optional[LoraExpand] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The qkv projection of ``x``'s RMSNorm by ``norm`` (plus each row's
    adapter delta with ``lora``) with half-split RoPE on q and k, k
    and v written into row ``pos`` of the cache (dense: ``k_dst[b, pos]``;
    paged: slot ``page_table[b, pos // ps] * ps + pos % ps``, a row whose
    table is all 0 writes into the garbage page 0) and into ``k_new`` /
    ``v_new``, in place. One launch. Returns (q (B, H, D), k_new, v_new)."""
    if not x.is_cuda:
        return int8_gemv_rope_kv_reference(x, w8, s, cos, sin, pos, n_heads, k_dst, v_dst, k_new,
                                           v_new, norm=norm, page_table=page_table, lora=lora)
    b, d = x.shape[0], cos.shape[-1]
    _check_rope(b, w8.shape[-1], n_heads, cos, sin, pos, k_dst, v_dst, k_new, v_new, page_table,
                x.device, x.dtype)
    q = torch.empty((b, n_heads, d), dtype=x.dtype, device=x.device)
    _launch(x, w8, s, None, 4, lora, norm,
            (q, cos, sin, pos, k_dst, v_dst, k_new, v_new, page_table, n_heads, d))
    # the fp32 and the mixed forms' launches are counted apart
    _ROPE_FORMS[x.dtype, k_dst.dtype].launches += 1
    return q, k_new, v_new


int8_gemv_rope_kv.launches = 0


def _rope_form(name: str, x_dtype: torch.dtype, cache_dtype: torch.dtype, doc: str):
    """The wrapper that counts the launches of one (x, cache) dtype pair
    of :func:`int8_gemv_rope_kv` (which makes them), refusing any other."""
    def form(x, *args, **kw):
        _check(x.dtype == x_dtype, f"{name} takes {x_dtype} x, got {x.dtype}")
        k_dst = kw["k_dst"] if "k_dst" in kw else args[6]  # after w8, s, cos, sin, pos, H
        _check(k_dst.dtype == cache_dtype,
               f"{name} takes a {cache_dtype} cache, got {k_dst.dtype}")
        return int8_gemv_rope_kv(x, *args, **kw)

    form.__name__ = form.__qualname__ = name
    form.__doc__ = doc
    form.launches = 0
    return form


int8_gemv_rope_kv_fp32 = _rope_form(
    "int8_gemv_rope_kv_fp32", torch.float32, torch.float32,
    ":func:`int8_gemv_rope_kv` of fp32 x, an fp32 cache and fp32 cos / sin, on the tile's "
    "fp32 form; the count of its launches.")
int8_gemv_rope_kv_cache_fp32 = _rope_form(
    "int8_gemv_rope_kv_cache_fp32", torch.bfloat16, torch.float32,
    ":func:`int8_gemv_rope_kv` of bf16 x over an fp32 cache (a mixed form: each bf16 row "
    "widened into the cache and k_new / v_new); the count of its launches.")
int8_gemv_rope_kv_fp32_cache_bf16 = _rope_form(
    "int8_gemv_rope_kv_fp32_cache_bf16", torch.float32, torch.bfloat16,
    ":func:`int8_gemv_rope_kv` of fp32 x over a bf16 cache (a mixed form: each fp32 row "
    "rounded to bf16 into the cache and k_new / v_new); the count of its launches.")
_ROPE_FORMS = {(torch.bfloat16, torch.bfloat16): int8_gemv_rope_kv,
               (torch.float32, torch.float32): int8_gemv_rope_kv_fp32,
               (torch.bfloat16, torch.float32): int8_gemv_rope_kv_cache_fp32,
               (torch.float32, torch.bfloat16): int8_gemv_rope_kv_fp32_cache_bf16}
