"""All decoder layers of one decode step (port of
paligemma_tpu/kernels/decode_layer.py ``layers_decode_fused``).

The TPU runs all L layers in one Pallas kernel so that its weight DMAs never
drain between layers. On Hopper each layer runs as a short chain of
hand-written kernels, each with its plain version beside it, six launches
a layer:

    int8_gemv_rope_kv (input norm in the prologue; q|k|v, RoPE and the
    fresh K/V rows in the epilogue) -> decode_attention (split + combine)
    -> int8_gemv o + residual -> int8_gemv gateup + GeGLU (post-attention
    norm in the prologue) -> int8_gemv down + residual

As in the TPU kernel, the two norms run inside the kernel that streams the
weights they feed, and RoPE on the qkv product in the same kernel
(decode_layer.py:267-274, :303-307, :321-324, :364).

The contract is the TPU function's: ``(h (B,1,K), k_new (L,B,D),
v_new (L,B,D))``, k_new and v_new in the cache's dtype. In this port the
qkv GEMV's epilogue also writes each layer's fresh K/V rows into the cache
in place (the TPU kernel leaves that to the caller), because the attention
kernel reads the fresh token from the cache.

The cache may be of the other dtype than the activations (bf16 over fp32,
fp32 over bf16: the engines' ``cache_dtype``); the GEMV and the attention
then take their mixed forms. The TPU kernel scores the fresh slot against
the unrounded ``k_new`` and adds ``p * v_new`` unrounded
(decode_layer.py:326-335); this chain reads the fresh row back from the
cache, as the TPU package's XLA path does (models/gemma.py:253). The two
agree bit for bit where the cache is the wider dtype (widening is exact);
under an fp32 model with a bf16 cache they differ by one bf16 rounding of
the newest key and value.

With ``lora_pack`` (:func:`repack_lora_bank_fused`) and ``adapter_ids``
each row decodes under its own adapter of a multi-LoRA bank, as in the TPU
kernel: per target group a ``lora_shrink`` (kernels/lora) computes the
row's masked adapter basis z = cast(y @ A_cat) * mask (y normalized in the
shrink as in the GEMV: the same bits), and the GEMV of that projection adds
z @ B in its epilogue (kernels/int8_gemv ``lora=``): q/k/v after the cast
and before RoPE, o and down after the residual, gate and up in fp32 before
the GeGLU; the down basis is summed over the whole intermediate dimension
before its one cast. Four shrinks per layer.

Without the TPU kernel's merged head: the greedy head runs as
kernels/decode_head right after this function.

The verify forward of speculative decoding (the TPU package runs it as
plain XLA, models/paligemma.py ``decode_verify``) is this chain at B s
rows: the s tokens of each row's block are s rows, each with its own
write position and mask row. ``rows_per_cache`` = s sends them to their
one cache row: the qkv GEMV's write sees the dense cache as a pool of one
page per row (a (B s, 1) table whose entries are r, no kernel change) and
the attention kernel reads the row's cache for each of its s query rows.
(The attention keeps the dense kernel, not the paged one over the same
view, because a dense row's valid slots need not be a prefix: a padded
prompt leaves holes that only a mask expresses.) The GEMV tile's sums
depend on (K, N) only, so each verify row has the bits of the decode step
at its position.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .decode_attention import MAX_BATCH, MAX_HEADS, decode_attention
from .gemv_plan import GemvPlan, norm_fits
from .int8_gemv import int8_gemv, int8_gemv_rope_kv
from .lora import block_mask, lora_shrink


def fused_gemvs_fit(k: int, n_qkv: int, n_gateup: int, n_heads: int, head_dim: int,
                    fp32: bool = False) -> bool:
    """The qkv (K, N_qkv) and gateup (K, N_gateup) GEMVs as the norm
    prologue and the RoPE epilogue take them: N_qkv = (H + 2) D with D / 2
    a multiple of 16 (a quad's 16 columns in one head's half), and each
    plan's K range per CTA within the prologue's buffer
    (kernels/gemv_plan.norm_fits; ``fp32``: the fp32 form's prologue)."""
    return ((head_dim // 2) % 16 == 0 and n_qkv == (n_heads + 2) * head_dim
            and norm_fits(GemvPlan.make(k, n_qkv), fp32)
            and norm_fits(GemvPlan.make(k, n_gateup), fp32))


def int8_leaves(layers: Dict):
    """The (qkv, gateup) int8 weights of the serving tree, or None."""
    qkv = layers.get("attn", {}).get("qkv")
    gateup = layers.get("mlp", {}).get("gateup")
    if isinstance(qkv, dict) and "w8" in qkv and isinstance(gateup, dict) and "w8" in gateup:
        return qkv["w8"], gateup["w8"]
    return None


def supported(cfg, layers: Dict, batch: int) -> bool:
    """Shapes and trees the kernel chain takes (the engine checks this once
    and raises when the kernel path was asked for and this is False).

    The limits are the CUDA kernels' own: one KV head, at most MAX_HEADS
    query heads, head_dim a multiple of 32 up to 256 (the RoPE epilogue
    pairs 16 columns of a head's half in a quad; the attention kernel's
    depth), the int8 serving tree with qkv and gateup as
    :func:`fused_gemvs_fit` takes them, and a batch that fits the grid's y
    dimension (decode_attention runs one block row per batch row). The
    activation dtype is the norm weights' (bf16, or fp32: the kernels' fp32
    forms), which the chain's inputs share; the cache is bf16 or fp32 (of
    the other dtype: the kernels' mixed forms)."""
    leaves = int8_leaves(layers)
    act = layers["input_norm"].dtype if "input_norm" in layers else None
    return (
        1 <= batch <= MAX_BATCH
        and cfg.num_key_value_heads == 1
        and cfg.num_attention_heads <= MAX_HEADS
        and cfg.head_dim % 32 == 0
        and cfg.head_dim <= 256
        and leaves is not None
        and act in (torch.bfloat16, torch.float32)
        and fused_gemvs_fit(leaves[0].shape[-2], leaves[0].shape[-1], leaves[1].shape[-1],
                            cfg.num_attention_heads, cfg.head_dim, act == torch.float32)
    )


def repack_layers(layers: Dict) -> Dict:
    """Stacked int8 serving tree -> the tree :func:`layers_decode_fused`
    reads, which is the same tree: the GEMV reads the (in, out) int8 weights
    and the (N,) fp32 scales of runtime.quantize as they are, in a bf16 or
    an fp32 tree alike (the norms take the tree's dtype). A leaf the
    kernels cannot read raises here, not at the first decode step."""
    for group, names in (("attn", ("qkv", "o")), ("mlp", ("gateup", "down"))):
        for name in names:
            leaf = layers[group][name]
            if not (leaf["w8"].dtype == torch.int8 and leaf["w8"].is_contiguous()
                    and leaf["s"].dtype == torch.float32 and leaf["s"].is_contiguous()):
                raise ValueError(f"repack_layers: {group}.{name} must be contiguous "
                                 "int8 w8 with contiguous fp32 s")
    return layers


def repack_lora_bank_fused(bank_layers: Dict, *, n_heads: int, head_dim: int, hidden: int,
                           intermediate: int) -> Dict:
    """Multi-LoRA bank (``train/lora.stack_lora_bank(...)["layers"]``, with
    its concat basis a_cat (L, in, G) and alpha-folded b_cat (L, G, out),
    G = (N+1)*r) -> the operands of the LoRA chain, per layer:

      qkv_a (L, K, 3G)    q | k | v bases side by side
      qkv_b (L, G, NQ2)   each column's own target rows: q rows in the q
                          columns of the fused qkv output, k in k's, v in v's
      o_a (L, NQ, G), o_b (L, G, K)
      gu_a (L, K, 2G)     gate | up bases
      gu_b (L, G, 2I)     gate rows in the gate columns of the fused
                          gateup output, up rows in the up columns
      down_a (L, I, G), down_b (L, G, K)

    The TPU layout (decode_layer.py ``repack_lora_bank_fused``) differs
    where its kernel differs: its qkv_b is block-diagonal (3G, NQ2) and its
    gate/up/down blocks are chunk-major like its MLP weight chunks; here the
    GEMV epilogue reads each column's own G rows, and the MLP is the fused
    (K, 2I) gateup of the int8 tree. Missing targets become zeros (delta
    0). G is padded to a multiple of 8, as in the TPU pack; the pad columns
    map to block ids > N and are never selected. The bank's dtype is kept
    (the kernels round each element to the activation dtype on load).

    Under a tensor-parallel mesh ``bank_layers`` is this rank's shard
    (core/mesh.shard_lora) and ``n_heads`` / ``intermediate`` the rank's
    widths (H/m, I/m): qkv_b's columns are then [q_r | k | v], split at
    (H/m D, H/m D + D) as the rank's fused qkv weight is, gu_b's [gate_r |
    up_r] at I/m, and o_a / down_a hold the rank's K rows. A target whose
    widths disagree with these raises."""
    ref = next(iter(bank_layers.values()))
    n_layers, _, g_true = ref["a_cat"].shape
    g = -(-g_true // 8) * 8
    nq = n_heads * head_dim
    opts = dict(dtype=ref["a_cat"].dtype, device=ref["a_cat"].device)

    def cat(name, in_dim):
        if name in bank_layers:
            a = bank_layers[name]["a_cat"]
            if a.shape[-2] != in_dim:
                raise ValueError(f"repack_lora_bank_fused: {name} A has {a.shape[-2]} input "
                                 f"rows, the layer {in_dim}")
            return torch.nn.functional.pad(a, (0, g - g_true))
        return torch.zeros((n_layers, in_dim, g), **opts)

    def bmat(name, out_dim):
        if name in bank_layers:
            b = bank_layers[name]["b_cat"]
            if b.shape[-1] != out_dim:
                raise ValueError(f"repack_lora_bank_fused: {name} B has {b.shape[-1]} output "
                                 f"columns, the layer {out_dim}")
            return torch.nn.functional.pad(b, (0, 0, 0, g - g_true))
        return torch.zeros((n_layers, g, out_dim), **opts)

    return {
        "qkv_a": torch.cat([cat("q", hidden), cat("k", hidden), cat("v", hidden)], dim=-1),
        "qkv_b": torch.cat([bmat("q", nq), bmat("k", head_dim), bmat("v", head_dim)], dim=-1),
        "o_a": cat("o", nq).contiguous(),
        "o_b": bmat("o", hidden).contiguous(),
        "gu_a": torch.cat([cat("gate", hidden), cat("up", hidden)], dim=-1),
        "gu_b": torch.cat([bmat("gate", intermediate), bmat("up", intermediate)], dim=-1),
        "down_a": cat("down", intermediate).contiguous(),
        "down_b": bmat("down", hidden).contiguous(),
        "g_true": g_true,
        "rank": ref["a"].shape[-1],
    }


def lora_row_masks(adapter_ids: torch.Tensor, g: int, rank: int, dtype: torch.dtype):
    """(B,) adapter ids -> (mask1 (B, G), mask2 (B, 2G), mask3 (B, 3G)): 1
    on the columns of the row's adapter block, 0 elsewhere (the TPU
    kernel's masks; ``lora_shrink`` builds the same mask in its kernel)."""
    return tuple(block_mask(adapter_ids, n * g, g, rank, dtype) for n in (1, 2, 3))


def lora_gemv(x: torch.Tensor, leaf: Dict, l: int, pack: Optional[Dict], name: str,
              adapter_ids: Optional[torch.Tensor], bounds: Sequence[int] = (), *,
              gemv=int8_gemv, norm=None, **kw):
    """``gemv`` (``int8_gemv`` or ``int8_gemv_rope_kv``) of layer ``l`` of
    ``leaf`` (of x's RMSNorm with ``norm``), plus each row's adapter delta
    of the ``name`` target group ("qkv", "o", "gu", "down") when ``pack``
    is given: the shrink of the same (normalized) ``x`` against
    ``pack[name + "_a"]``, then the expand in the GEMV's epilogue."""
    lora = None
    if pack is not None:
        g = pack["o_b"].shape[1]
        z = lora_shrink(x, pack[name + "_a"][l], adapter_ids, pack["rank"], g, norm=norm)
        lora = (z, pack[name + "_b"][l], bounds)
    return gemv(x, leaf["w8"][l], leaf["s"][l], lora=lora, norm=norm, **kw)


def layers_decode_fused(
    x: torch.Tensor,  # (B, 1, K)
    layers: Dict,  # stacked int8 serving tree (repack_layers)
    k_cache: torch.Tensor,  # (L, B / rows_per_cache, S, D), fresh rows written in place
    v_cache: torch.Tensor,  # (L, B / rows_per_cache, S, D)
    cache_pos: torch.Tensor,  # (B,) int32 per-row write positions
    kv_valid_window: torch.Tensor,  # (B, W) bool, incl. this token's slot
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,
    window: int,
    n_heads: int,
    head_dim: int,
    eps: float,
    *,
    lora_pack: Optional[Dict] = None,  # repack_lora_bank_fused() output
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
    rows_per_cache: int = 1,  # rows sharing a cache row (a verify block's s)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All L layers for B lockstep rows. Returns (hidden (B,1,K),
    k_new (L,B,D), v_new (L,B,D)). With ``lora_pack`` and ``adapter_ids``
    each row's adapter applies inside the chain; ``rows_per_cache``: rows
    ``[c s, (c + 1) s)`` write into and attend cache row c (module
    docstring)."""
    if (lora_pack is None) != (adapter_ids is None):
        raise ValueError("layers_decode_fused: lora_pack and adapter_ids go together")
    b, _, k = x.shape
    if rows_per_cache < 1 or b != k_cache.shape[1] * rows_per_cache:
        raise ValueError(f"layers_decode_fused: {b} rows != {k_cache.shape[1]} cache rows x "
                         f"rows_per_cache {rows_per_cache}")
    n_layers = k_cache.shape[0]
    window = min(window, k_cache.shape[2])
    if kv_valid_window.shape != (b, window):
        raise ValueError(f"kv_valid_window {tuple(kv_valid_window.shape)} != {(b, window)}")
    attn, mlp = layers["attn"], layers["mlp"]
    scale = head_dim**-0.5
    cos = cos.to(x.dtype).contiguous()
    sin = sin.to(x.dtype).contiguous()
    k_new = torch.empty((n_layers, b, head_dim), dtype=k_cache.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    h = x.reshape(b, k)
    ids = None if adapter_ids is None else adapter_ids.to(torch.int32).contiguous()
    nq = n_heads * head_dim
    inter = mlp["gateup"]["w8"].shape[-1] // 2
    pos = cache_pos.to(torch.int32)
    # rows_per_cache > 1: the cache as a pool of one page per cache row
    table = None if rows_per_cache == 1 else (
        torch.arange(b, dtype=torch.int32, device=x.device) // rows_per_cache)[:, None]
    for l in range(n_layers):
        # writes this layer's fresh K/V rows into the cache (in place)
        q, _, _ = lora_gemv(h, attn["qkv"], l, lora_pack, "qkv", ids, (nq, nq + head_dim),
                            gemv=int8_gemv_rope_kv, norm=(layers["input_norm"][l], eps),
                            cos=cos, sin=sin, pos=pos, n_heads=n_heads, k_dst=k_cache[l],
                            v_dst=v_cache[l], k_new=k_new[l], v_new=v_new[l], page_table=table)
        a = decode_attention(q, k_cache[l], v_cache[l], kv_valid_window, scale,
                             rows_per_cache=rows_per_cache)
        h = lora_gemv(a, attn["o"], l, lora_pack, "o", ids, residual=h)
        t = lora_gemv(h, mlp["gateup"], l, lora_pack, "gu", ids, (inter,), geglu=True,
                      norm=(layers["post_norm"][l], eps))
        h = lora_gemv(t, mlp["down"], l, lora_pack, "down", ids, residual=h)
    return h.reshape(b, 1, k), k_new, v_new
