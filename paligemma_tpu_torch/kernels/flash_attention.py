"""Prefix-LM flash attention, forward and backward (port of
paligemma_tpu/kernels/flash_attention.py).

Mask rule: key ``j`` is visible to the query at absolute position ``i`` iff

    j < kv_len[b]  AND  (j < prefix_len[b]  OR  j <= i)

with ``i = query index + q_offset``. Prefill passes ``prefix_len == kv_len``
(bidirectional over valid tokens); training passes the image + prompt
length as ``prefix_len``. A row with no visible key gives 0 and lse 0.

``flash_attention`` is differentiable: when an input requires grad it runs
as a ``torch.autograd.Function`` whose forward also returns the fp32
log-sum-exp (B, Hq, Sq) and whose backward is FlashAttention-2:
``delta = rowsum(dO * O)`` in fp32 torch (the reference computes it in XLA),
then the dq kernel and the dk/dv kernel (``csrc/flash_attention_bwd.cu``),
which recompute the probabilities from (q, k, lse). For CUDA tensors the
wrappers launch ``csrc/flash_attention.cu`` and the backward kernels or
raise; for CPU tensors they run the plain versions here: fp32 scores and
softmax, and the same FA2 arithmetic in fp32 torch, with p (forward and
backward) and ds rounded to the inputs' dtype before their products where
the TPU kernels (and the CUDA kernels' bf16 tensor-core operands) round them.

fp32 q, k and v (``--dtype float32``, the Trainer on fp32 parameters) take
the fp32 forms: of the forward (``flash_fwd_f32_kernel``, counted apart as
:func:`flash_attention_fwd_fp32`) and of both backward kernels
(``flash_bwd_dq_f32_kernel`` and ``flash_bwd_dkv_f32_kernel``, counted as
:func:`flash_attention_bwd_dq_fp32` and :func:`flash_attention_bwd_dkv_fp32`;
all three take their products in 3xTF32 on the tensor cores,
``csrc/tf32.cuh``): the same functions with p and ds unrounded, as the TPU
kernels compute at fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
BWD_ROWS = 64  # folded rows per streamed tile of the dk/dv kernel (and per dq block)
BWD_KEYS = 64  # keys per dk/dv block
BWD32_ROWS = 32  # the fp32 form's: folded rows per streamed tile of the dk/dv kernel
BWD32_KEYS = 32  # keys per fp32 dk/dv block
BWD32_WAVES = 4  # waves of fp32 dk/dv blocks (dkv_splits)
# an H100's SMs: a dk/dv block (8 warps, 217 KB of shared memory) fills one
_SMS = 132


def _allowed(sq, skv, prefix_len, kv_len, q_offset, dev) -> torch.Tensor:
    """(B, Sq, Skv) bool: may query i attend key j."""
    row = torch.arange(sq, device=dev)[None, :, None] + q_offset
    col = torch.arange(skv, device=dev)[None, None, :]
    kvl = kv_len.to(dev).long()[:, None, None]
    pfx = prefix_len.to(dev).long()[:, None, None]
    return (col < kvl) & ((col < pfx) | (col <= row))


def _reference_forward(q, k, v, prefix_len, kv_len, scale, q_offset):
    """Plain version of the forward: (out (B, Sq, Hq, D) in q's dtype,
    lse (B, Hq, Sq) fp32). p = exp(s - max) is summed in fp32 and rounded
    to v's dtype before p·V, where the TPU kernel rounds it
    (paligemma_tpu/kernels/flash_attention.py ``_flash_kernel``; the
    identity for fp32 inputs); the division by the sum comes after."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    allowed = _allowed(sq, skv, prefix_len, kv_len, q_offset, q.device)
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    s = s.masked_fill(~allowed[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    den_q = torch.where(den > 0, den, torch.ones_like(den)).permute(0, 3, 1, 2, 4)
    out = out / den_q  # no key -> 0
    lse = torch.where(den > 0, m + torch.log(den), torch.zeros_like(den))
    return out.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq)


def reference_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    prefix_len: torch.Tensor,  # (B,) int
    kv_len: torch.Tensor,  # (B,) int
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain version: fp32 scores and softmax over the visible keys."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _reference_forward(q, k, v, prefix_len, kv_len, scale, q_offset)[0]


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, (B, Hq, Sq)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _reference_backward(q, k, v, dout, lse, delta, prefix_len, kv_len, scale, q_offset):
    """Plain version of the backward kernels: FA2 in fp32 from (q, k, lse)
    and delta, with p rounded to dO's dtype before dV and ds to q's dtype
    before dQ and dK, as the TPU kernels round them
    (paligemma_tpu/kernels/flash_attention.py ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``; the identity for fp32 inputs). Returns (dq, dk, dv)
    in the inputs' dtypes."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    allowed = _allowed(sq, skv, prefix_len, kv_len, q_offset, q.device)[:, None, None]
    qg = q.reshape(b, sq, hkv, g, d).float()
    dog = dout.reshape(b, sq, hkv, g, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    lse_g = lse.reshape(b, hkv, g, sq, 1)
    p = torch.where(allowed, torch.exp(s - lse_g), torch.zeros_like(s))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta.reshape(b, hkv, g, sq, 1))
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(), dog)
    return dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_attention_backward(q, k, v, out, lse, dout, prefix_len, kv_len,
                                 scale=None, q_offset=0):
    """Plain FA2 backward: (dq, dk, dv) from the forward's out and lse."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _reference_backward(q, k, v, dout, lse, _delta(out, dout), prefix_len, kv_len,
                               scale, q_offset)


def _check(q, k, v, prefix_len, kv_len):
    """Raise on anything the kernels do not take; returns the int32 lengths.
    q, k and v are all bf16 or all fp32 (the fp32 forms)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"flash_attention: q, k and v must be all bf16 or all fp32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    if d % 8 or d > 256 or hq % hkv:
        raise ValueError(f"flash_attention: head_dim {d} (multiple of 8, <= 256), Hq {hq}, Hkv {hkv}")
    lens = []
    for name, t in (("prefix_len", prefix_len), ("kv_len", kv_len)):
        if t.shape != (b,) or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be (B,) int32 on {q.device}")
        lens.append(t.contiguous())
    return lens


def _check_bwd(q, dout, lse, delta):
    """The backward kernels' extra inputs: dO like q (its dtype too), lse
    and delta fp32 (B, Hq, Sq), all contiguous on q's device."""
    b, sq, hq, _ = q.shape
    if (dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous()
            or dout.device != q.device or dout.data_ptr() % 16):
        raise ValueError(f"flash_attention backward: dout must be contiguous, 16-byte aligned "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}: q's dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, hq, sq) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"flash_attention backward: {name} must be contiguous fp32 "
                             f"{(b, hq, sq)} on {q.device}")


def _forward_kernel(q, k, v, prefix_len, kv_len, scale, q_offset, with_lse):
    """One launch of the forward: the bf16 kernel, or its fp32 form (counted
    on :func:`flash_attention_fwd_fp32`) for fp32 inputs."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    lens = _check(q, k, v, prefix_len, kv_len)
    fp32 = q.dtype == torch.float32
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.library()
    launch = lib.pg_flash_attention_fwd_fp32 if fp32 else lib.pg_flash_attention_fwd
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens[0].data_ptr(), lens[1].data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv, d,
        float(scale), int(q_offset), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_fwd_fp32" if fp32 else "flash_attention_fwd")
    (flash_attention_fwd_fp32 if fp32 else flash_attention).launches += 1
    return out, lse


def flash_attention_fwd_fp32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prefix_len: torch.Tensor,
    kv_len: torch.Tensor, scale: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's fp32 form: (out (B, Sq, Hq, D), lse (B, Hq, Sq)) of fp32
    q, k and v. Its ``launches`` count every fp32 forward launch, whichever
    wrapper made it (:func:`flash_attention`, :func:`flash_attention_with_lse`
    or this one)."""
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention_fwd_fp32: fp32 q, k and v, got {q.dtype}")
    return flash_attention_with_lse(q, k, v, prefix_len, kv_len, scale, q_offset)


flash_attention_fwd_fp32.launches = 0


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prefix_len: torch.Tensor,
    kv_len: torch.Tensor, scale: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward with the log-sum-exp: (out (B, Sq, Hq, D), lse (B, Hq, Sq)
    fp32). Not differentiable; :func:`flash_attention` is."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return _reference_forward(q, k, v, prefix_len, kv_len, scale, q_offset)
    return _forward_kernel(q, k, v, prefix_len, kv_len, scale, q_offset, True)


class _Flash(torch.autograd.Function):
    """flash_attention with the FA2 backward (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, kv_len, scale, q_offset):
        out, lse = flash_attention_with_lse(q, k, v, prefix_len, kv_len, scale, q_offset)
        ctx.save_for_backward(q, k, v, out, lse, prefix_len, kv_len)
        ctx.scale, ctx.q_offset = scale, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, prefix_len, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout.contiguous(), prefix_len,
                                              kv_len, ctx.scale, ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prefix_len: torch.Tensor,
    kv_len: torch.Tensor,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Blockwise prefix-LM attention; (B, Sq, Hq, D) out. Differentiable in
    q, k and v (the forward then also writes the lse the backward reads)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, prefix_len, kv_len, float(scale), int(q_offset))
    if not q.is_cuda:
        return reference_attention(q, k, v, prefix_len, kv_len, scale, q_offset)
    return _forward_kernel(q, k, v, prefix_len, kv_len, scale, q_offset, False)[0]


flash_attention.launches = 0


def flash_attention_sharded(q, k, v, prefix_len, kv_len, mesh, scale=None) -> torch.Tensor:
    """:func:`flash_attention` under a tensor-parallel mesh (port of
    paligemma_tpu/kernels/flash_attention.py ``flash_attention_sharded``).
    Query heads shard over the model axis and attention is independent per
    head, so on a rank it is the kernel over that rank's heads: q holds its
    Hq/m heads, k and v their KV heads (one KV head: replicated). No
    collective runs here."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"flash_attention_sharded: {hq} local query heads over {hkv} KV heads "
                         f"(model axis {mesh.model})")
    return flash_attention(q, k, v, prefix_len, kv_len, scale=scale)


def flash_attention_backward(q, k, v, out, lse, dout, prefix_len, kv_len, scale=None,
                             q_offset=0):
    """(dq, dk, dv) of :func:`flash_attention` given its out and lse: delta
    in fp32 torch, then the dq and dk/dv kernels (plain version on CPU)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return reference_attention_backward(q, k, v, out, lse, dout, prefix_len, kv_len,
                                            scale, q_offset)
    delta = _delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, prefix_len, kv_len, scale, q_offset)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, prefix_len, kv_len, scale,
                                     q_offset)
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, prefix_len, kv_len, scale, q_offset=0):
    """dq (B, Sq, Hq, D): one kernel block per 64 folded rows, KV head and
    batch row, streaming the key tiles its rows see. fp32 inputs take the
    fp32 form (3xTF32 on the tensor cores; 32-row blocks where 64-row ones
    would fill at most half the SMs; counted on
    :func:`flash_attention_bwd_dq_fp32`)."""
    if not q.is_cuda:
        return _reference_backward(q, k, v, dout, lse, delta, prefix_len, kv_len, scale,
                                   q_offset)[0]
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    lens = _check(q, k, v, prefix_len, kv_len)
    _check_bwd(q, dout, lse, delta)
    fp32 = q.dtype == torch.float32
    dq = torch.empty_like(q)
    lib = _build.library()
    err = (lib.pg_flash_attention_bwd_dq_fp32 if fp32 else lib.pg_flash_attention_bwd_dq)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), lens[0].data_ptr(), lens[1].data_ptr(), dq.data_ptr(),
        b, sq, skv, hq, hkv, d, float(scale), int(q_offset), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_bwd_dq_fp32" if fp32 else "flash_attention_bwd_dq")
    (flash_attention_bwd_dq_fp32 if fp32 else flash_attention_bwd_dq).launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dq_fp32(q, k, v, dout, lse, delta, prefix_len, kv_len, scale,
                                q_offset=0):
    """The dq kernel's fp32 form: dq of fp32 q, k, v and dout. Its
    ``launches`` count every fp32 dq launch (:func:`flash_attention_bwd_dq`
    makes them for fp32 inputs)."""
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_dq_fp32: fp32 q, k, v and dout, got {q.dtype}")
    return flash_attention_bwd_dq(q, k, v, dout, lse, delta, prefix_len, kv_len, scale,
                                  q_offset)


flash_attention_bwd_dq_fp32.launches = 0


def dkv_splits(b: int, hkv: int, rows: int, skv: int, keys: int = BWD_KEYS,
               tile_rows: int = BWD_ROWS, waves: int = 1) -> int:
    """Row ranges the dk/dv sweep is split into: the most that keep all
    blocks in ``waves`` waves of one block per SM (Gemma's one KV head
    leaves only Skv/keys * B key blocks), never more than there are row
    tiles. Each split writes B * Hkv * Skv * D fp32 partials of dk and of
    dv, so no more splits than the SMs need. ``keys`` and ``tile_rows``: a
    block's keys and a streamed tile's rows (the fp32 form's: BWD32_KEYS,
    BWD32_ROWS, and BWD32_WAVES: under the causal mask a key block's row
    tiles number from all to a few, and more, shorter blocks even out the
    SMs' work)."""
    key_blocks = -(-skv // keys) * hkv * b
    row_tiles = -(-rows // tile_rows)
    return max(1, min(row_tiles, waves * _SMS // key_blocks))


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, prefix_len, kv_len, scale, q_offset=0):
    """(dk, dv) (B, Skv, Hkv, D): one kernel block per 64 keys (32 in the
    fp32 form), KV head, batch row and row split, summing over every query
    head of the KV head; a second pass adds the splits' fp32 partials in a
    fixed order. fp32 inputs take the fp32 form (counted on
    :func:`flash_attention_bwd_dkv_fp32`)."""
    if not q.is_cuda:
        return _reference_backward(q, k, v, dout, lse, delta, prefix_len, kv_len, scale,
                                   q_offset)[1:]
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    lens = _check(q, k, v, prefix_len, kv_len)
    _check_bwd(q, dout, lse, delta)
    fp32 = q.dtype == torch.float32
    nsplit = dkv_splits(b, hkv, (hq // hkv) * sq, skv,
                        *((BWD32_KEYS, BWD32_ROWS, BWD32_WAVES) if fp32 else (BWD_KEYS, BWD_ROWS)))
    part = torch.empty((2, nsplit, b, hkv, skv, d), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    err = (lib.pg_flash_attention_bwd_dkv_fp32 if fp32 else lib.pg_flash_attention_bwd_dkv)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), lens[0].data_ptr(), lens[1].data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv, d, nsplit,
        float(scale), int(q_offset), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_bwd_dkv_fp32" if fp32 else "flash_attention_bwd_dkv")
    (flash_attention_bwd_dkv_fp32 if fp32 else flash_attention_bwd_dkv).launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dkv_fp32(q, k, v, dout, lse, delta, prefix_len, kv_len, scale,
                                 q_offset=0):
    """The dk/dv kernel's fp32 form (with the fp32-out split sum): (dk, dv)
    of fp32 q, k, v and dout. Its ``launches`` count every fp32 dk/dv
    launch (:func:`flash_attention_bwd_dkv` makes them for fp32 inputs)."""
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_dkv_fp32: fp32 q, k, v and dout, got {q.dtype}")
    return flash_attention_bwd_dkv(q, k, v, dout, lse, delta, prefix_len, kv_len, scale,
                                   q_offset)


flash_attention_bwd_dkv_fp32.launches = 0
