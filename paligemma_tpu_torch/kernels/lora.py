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
"""

from __future__ import annotations

import torch

from . import _build

COLS_PER_BLOCK = 32  # csrc/lora.cu LS_TX
KC_MAX = 512  # K rows per split, at most (LS_KC_MAX: x's rows in shared memory)
TARGET_BLOCKS = 264  # ~2 blocks per SM on the H100's 132 SMs
MIN_CHUNK = 64  # K rows per split, at least: the fp32 partials stay below A's bytes


def shrink_k_chunk(k: int, ng: int) -> int:
    """K rows per split block: enough splits to fill the card, each of
    MIN_CHUNK to KC_MAX rows."""
    col_blocks = -(-ng // COLS_PER_BLOCK)
    nsplit = max(1, min(-(-TARGET_BLOCKS // col_blocks), -(-k // MIN_CHUNK)), -(-k // KC_MAX))
    chunk = -(-k // nsplit)
    return -(-chunk // 8) * 8


def block_mask(adapter_ids: torch.Tensor, n_cols: int, group: int, rank: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(B, n_cols) 0/1: column c belongs to row b's adapter block of its
    G-wide target block."""
    col = torch.arange(n_cols, device=adapter_ids.device)
    return (((col % group) // rank)[None] == adapter_ids.long()[:, None]).to(dtype)


def lora_shrink_reference(x: torch.Tensor, a: torch.Tensor, adapter_ids: torch.Tensor,
                          rank: int, group: int) -> torch.Tensor:
    """Plain version of :func:`lora_shrink`."""
    z = (x.float() @ a.to(x.dtype).float()).to(x.dtype)
    return z * block_mask(adapter_ids, a.shape[-1], group, rank, x.dtype)


def lora_shrink(
    x: torch.Tensor,  # (B, K) activations
    a: torch.Tensor,  # (K, nG) concat basis, fp32 or bf16
    adapter_ids: torch.Tensor,  # (B,) int32 bank rows (0 = base model)
    rank: int,
    group: int,  # G: the width of one target's block of columns
) -> torch.Tensor:
    """Each row's masked adapter basis ``z (B, nG)`` in x's dtype."""
    if not x.is_cuda:
        return lora_shrink_reference(x, a, adapter_ids, rank, group)
    b, k = x.shape
    ng = a.shape[-1]
    dev = x.device
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("lora_shrink: x must be contiguous bf16 (B, K)")
    if (a.dtype not in (torch.float32, torch.bfloat16) or a.shape != (k, ng)
            or not a.is_contiguous() or a.device != dev):
        raise ValueError(f"lora_shrink: a must be contiguous fp32 or bf16 ({k}, nG) on x's "
                         f"device, got {tuple(a.shape)} {a.dtype}")
    if (adapter_ids.dtype != torch.int32 or adapter_ids.shape != (b,)
            or not adapter_ids.is_contiguous() or adapter_ids.device != dev):
        raise ValueError("lora_shrink: adapter_ids must be contiguous int32 (B,) on x's device")
    if group <= 0 or rank <= 0 or ng % group:
        raise ValueError(f"lora_shrink: nG {ng} must be a multiple of G {group} (rank {rank})")
    chunk = shrink_k_chunk(k, ng)
    nsplit = -(-k // chunk)
    part = torch.empty((nsplit, b, ng), dtype=torch.float32, device=dev)
    z = torch.empty((b, ng), dtype=torch.bfloat16, device=dev)
    _build.check(_build.library().pg_lora_shrink(
        x.data_ptr(), a.data_ptr(), int(a.dtype == torch.float32), part.data_ptr(),
        adapter_ids.data_ptr(), z.data_ptr(), b, k, ng, group, rank, chunk,
        _build.stream_ptr(dev)), "lora_shrink")
    lora_shrink.launches += 1
    return z


lora_shrink.launches = 0
