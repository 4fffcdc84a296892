"""The LoRA shrink of multi-LoRA decode; the kernel is ``csrc/lora.cu``.

It computes the adapter-basis dot of the TPU kernel
paligemma_tpu/kernels/decode_layer.py ``_kernel_all`` with ``lora=True``
(and of decode_layer_paged.py ``_kernel_paged``), for one target group of
one layer and every lockstep row:

    z (B, nG) = cast(x (B, K) @ cast(A) (K, nG), fp32 sums) * mask,
    mask[b, c] = ((c % G) // rank == adapter_ids[b])

``A`` is a concat basis of kernels/decode_layer.repack_lora_bank_fused (one
G-wide block per target: 3 for qkv, 2 for gate | up, 1 for o and down),
fp32 or bf16; ``cast`` rounds to the activation dtype, as the TPU kernel
casts its LoRA operands and its basis. The expand ``z @ B`` runs in the
int8 GEMV's epilogue (kernels/int8_gemv ``lora=``).

One launch per call: each cluster of CTAs covers ``COLS_PER_CTA`` columns
of A and splits K over its ranks as :class:`ShrinkPlan` says; the ranks'
sums are added in rank order through distributed shared memory, and the
last rank applies the mask and the cast.

``norm=(w, eps)``: the shrink of x's Gemma RMSNorm, computed in the kernel
with the bits the int8 GEMV's norm prologue gives the same row
(kernels/int8_gemv ``norm=``), so the basis and the projection read one y.

fp32 x (``--dtype float32``) takes the kernel's fp32 form
(``pg_lora_shrink_fp32``): x, the norm weight and z are fp32 and every
cast is the identity, so z is the unrounded fp32 sum times the mask, as
the TPU kernel keeps it at fp32 (its ``.astype(inp.dtype)``). Its launches
are counted apart, on :func:`lora_shrink_fp32`.
"""

from __future__ import annotations

import dataclasses

from typing import Optional

import torch

from . import _build
from .int8_gemv import Norm, normed

COLS_PER_CTA = 8  # columns of A per CTA (csrc/lora.cu LS_COLS)
MIN_ROWS_PER_RANK = 256  # K rows per rank, at least, before K is split further
MAX_CLUSTER = 8  # the portable cluster size
STEP_K = 8  # a rank's K range is a multiple of this (x's 16-byte loads)
THREAD_CHOICES = (256, 512)  # threads per CTA: 256 up to SMALL_RANK rows a rank
SMALL_RANK = 256


@dataclasses.dataclass(frozen=True)
class ShrinkPlan:
    k: int
    ng: int
    cluster: int  # CTAs per cluster: the K splits of one column block
    k_per_cta: int  # K rows of each rank but the last (a multiple of STEP_K)
    threads: int  # threads per CTA (THREAD_CHOICES)

    @classmethod
    def make(cls, k: int, ng: int) -> "ShrinkPlan":
        """Split K over up to MAX_CLUSTER ranks of at least
        MIN_ROWS_PER_RANK rows each; CTAs of 256 threads where a rank has
        at most SMALL_RANK rows (3.6-3.8 us against 4.1-4.4 with 512 at K
        2048, B8, on an NVIDIA H100 80GB HBM3 at 700 W), else 512 (more loads
        in flight). Depends on (K, nG) only, so a row's sum has the same
        order in every batch."""
        if k % STEP_K or ng % COLS_PER_CTA or min(k, ng) < 1:
            raise ValueError(f"ShrinkPlan: K {k} must be a multiple of {STEP_K} and nG {ng} "
                             f"of {COLS_PER_CTA}")
        cluster = max(1, min(MAX_CLUSTER, -(-k // MIN_ROWS_PER_RANK)))
        per = -(-(-(-k // cluster)) // STEP_K) * STEP_K
        threads = THREAD_CHOICES[0] if per <= SMALL_RANK else THREAD_CHOICES[1]
        return cls(k, ng, -(-k // per), per, threads)


def block_mask(adapter_ids: torch.Tensor, n_cols: int, group: int, rank: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(B, n_cols) 0/1: column c belongs to row b's adapter block of its
    G-wide target block."""
    col = torch.arange(n_cols, device=adapter_ids.device)
    return (((col % group) // rank)[None] == adapter_ids.long()[:, None]).to(dtype)


def lora_shrink_reference(x: torch.Tensor, a: torch.Tensor, adapter_ids: torch.Tensor,
                          rank: int, group: int, *, norm: Optional[Norm] = None) -> torch.Tensor:
    """Plain version of :func:`lora_shrink`."""
    x = normed(x, norm)
    z = (x.float() @ a.to(x.dtype).float()).to(x.dtype)
    return z * block_mask(adapter_ids, a.shape[-1], group, rank, x.dtype)


def lora_shrink(
    x: torch.Tensor,  # (B, K) activations
    a: torch.Tensor,  # (K, nG) concat basis, fp32 or bf16
    adapter_ids: torch.Tensor,  # (B,) int32 bank rows (0 = base model)
    rank: int,
    group: int,  # G: the width of one target's block of columns
    *,
    norm: Optional[Norm] = None,  # (w (K,), eps): the basis of x's RMSNorm
) -> torch.Tensor:
    """Each row's masked adapter basis ``z (B, nG)`` in x's dtype (bf16, or
    fp32: the fp32 form, counted on :func:`lora_shrink_fp32`)."""
    if not x.is_cuda:
        return lora_shrink_reference(x, a, adapter_ids, rank, group, norm=norm)
    b, k = x.shape
    ng = a.shape[-1]
    dev = x.device
    fp32 = x.dtype == torch.float32
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("lora_shrink: x must be contiguous bf16 or fp32 (B, K)")
    if (a.dtype not in (torch.float32, torch.bfloat16) or a.shape != (k, ng)
            or not a.is_contiguous() or a.device != dev):
        raise ValueError(f"lora_shrink: a must be contiguous fp32 or bf16 ({k}, nG) on x's "
                         f"device, got {tuple(a.shape)} {a.dtype}")
    if (adapter_ids.dtype != torch.int32 or adapter_ids.shape != (b,)
            or not adapter_ids.is_contiguous() or adapter_ids.device != dev):
        raise ValueError("lora_shrink: adapter_ids must be contiguous int32 (B,) on x's device")
    if group <= 0 or rank <= 0 or ng % group:
        raise ValueError(f"lora_shrink: nG {ng} must be a multiple of G {group} (rank {rank})")
    if x.data_ptr() % 16 or a.data_ptr() % 16:
        raise ValueError("lora_shrink: x and a must be 16-byte aligned")
    if norm is not None and not (norm[0].dtype == x.dtype and norm[0].shape == (k,)
                                 and norm[0].is_contiguous() and norm[0].device == dev
                                 and norm[0].data_ptr() % 16 == 0):
        raise ValueError(f"lora_shrink: the norm weight must be contiguous 16-byte aligned "
                         f"{x.dtype} ({k},) on x's device, x's dtype")
    plan = ShrinkPlan.make(k, ng)  # raises unless K % 8 == 0 and nG % 8 == 0
    z = torch.empty((b, ng), dtype=x.dtype, device=dev)
    lib = _build.library()
    _build.check((lib.pg_lora_shrink_fp32 if fp32 else lib.pg_lora_shrink)(
        x.data_ptr(), a.data_ptr(), int(a.dtype == torch.float32), adapter_ids.data_ptr(),
        z.data_ptr(), b, k, ng, group, rank, plan.cluster, plan.k_per_cta, plan.threads,
        None if norm is None else norm[0].data_ptr(), 0.0 if norm is None else float(norm[1]),
        _build.stream_ptr(dev)), "lora_shrink fp32" if fp32 else "lora_shrink")
    (lora_shrink_fp32 if fp32 else lora_shrink).launches += 1
    return z


lora_shrink.launches = 0


def lora_shrink_fp32(x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """:func:`lora_shrink` of fp32 x on the kernel's fp32 form (fp32 z and
    norm weight); the count of its launches (which :func:`lora_shrink`
    makes for fp32 x)."""
    if x.dtype != torch.float32:
        raise ValueError(f"lora_shrink_fp32 takes fp32 x, got {x.dtype}")
    return lora_shrink(x, *args, **kw)


lora_shrink_fp32.launches = 0
