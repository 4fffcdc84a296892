"""The split of the int8 GEMV (``kernels/gemv_plan.GemvPlan``) on the CPU,
at PaliGemma-3B-224's decode shapes (Gemma-2B: hidden 2048, 8 heads of
256, one KV head, intermediate 16384, vocab 257152) and at the
tensor-parallel shards of m = 2, 4, 8 ranks; and the launches the
wrappers over the tile (``int8_gemv`` with and without a LoRA expand,
``head_argmax_fused``, ``int4_matmul`` at decode rows on the (K/2, N)
stored rows) and the LoRA shrink (``lora_shrink``, ``kernels/lora.
ShrinkPlan``) make, read from a stand-in for the kernel library, so that
the split they hand the card is checked here (the kernels themselves run
on the card: tests/test_torch_cuda.py). The same stand-in shows the fp32
forms reached from their entry points: a Trainer step on fp32 weights
(the flash forward and backward) and the fp32 tower through B12.
"""

import pytest
import torch

import ctypes
import dataclasses

import numpy as np

from paligemma_tpu_torch.convert import init_params
from paligemma_tpu_torch.core import config as t_config
from paligemma_tpu_torch.kernels import _build
from paligemma_tpu_torch.kernels import decode_head as t_head
from paligemma_tpu_torch.kernels import flash_attention as t_flash
from paligemma_tpu_torch.kernels import gemv_plan as t_plan
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv
from paligemma_tpu_torch.kernels import lora as t_lora
from paligemma_tpu_torch.kernels import w8a8 as t_w8a8
from paligemma_tpu_torch.kernels.ablation import _wq_gemm
from paligemma_tpu_torch.kernels.ablation import decode_attention as t_sda
from paligemma_tpu_torch.kernels.ablation import quant4 as t_q4
from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va
from paligemma_tpu_torch.models import siglip
from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

HIDDEN, HEADS, HEAD_DIM, INTER, VOCAB = 2048, 8, 256, 16384, 257152


def _shapes():
    """(label, K, N) of every GEMV of the one-card decode and of one rank's
    shard at m = 2, 4, 8 (query heads and I split over ranks, the vocab over
    ranks for the head)."""
    out = [("qkv", HIDDEN, (HEADS + 2) * HEAD_DIM), ("o", HEADS * HEAD_DIM, HIDDEN),
           ("gateup", HIDDEN, 2 * INTER), ("down", INTER, HIDDEN), ("head", HIDDEN, VOCAB)]
    for m in (2, 4, 8):
        out += [(f"qkv m{m}", HIDDEN, (HEADS // m + 2) * HEAD_DIM),
                (f"o m{m}", HEADS // m * HEAD_DIM, HIDDEN),
                (f"gateup m{m}", HIDDEN, 2 * INTER // m),
                (f"down m{m}", INTER // m, HIDDEN),
                (f"head m{m}", HIDDEN, VOCAB // m)]
    return out


SHAPES = _shapes()
# the shapes of the test this one replaces (the K split of the partials
# kernel), and ragged ones: K not a multiple of 16, N not of 128 or of 16
EXTRA = [("small", 64, 96), ("ragged K", 1000, 2560), ("K 77", 77, 388), ("N 300", 256, 300),
         ("one row", 1, 4)]


def _check_covers_k(k, cluster, warps, k_per_cta):
    """The ranks' K ranges [r * k_per_cta, (r + 1) * k_per_cta), cut at K,
    are consecutive and none is empty."""
    assert 1 <= cluster <= t_plan.MAX_CLUSTER and warps in t_plan.WARP_CHOICES
    assert k_per_cta > 0 and k_per_cta % t_plan.STEP_K == 0
    assert (cluster - 1) * k_per_cta < k <= cluster * k_per_cta


@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("label,k,n", SHAPES + EXTRA, ids=[s[0] for s in SHAPES + EXTRA])
def test_plan_covers_every_k_row_once(library, label, k, n, b):
    """The split int8_gemv hands the card at batch B covers K once, and is
    the plan of (K, N) whatever B: a row's sum has the same order in every
    batch."""
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    w8 = _card(torch.empty((k, n), dtype=torch.int8))  # never read: no pages touched
    t_gemv.int8_gemv(x, w8, _card(torch.ones(n)))
    [(gb, gk, gn, _, *split)] = _gemv_split(library)
    assert (gb, gk, gn) == (b, k, n) and t_plan.BATCH_TILE <= 8
    _check_covers_k(k, *split)
    plan = t_plan.GemvPlan.make(k, n)
    assert split == [plan.cluster, plan.warps, plan.k_per_cta]


@pytest.mark.parametrize("label,k,n,want", [
    # (cluster, warps, k_per_cta): ~16 warps an SM, 4-warp CTAs where the
    # column tiles are many, 8-warp CTAs in full clusters where they are few
    ("qkv", HIDDEN, 2560, (8, 8, 256)), ("o", HIDDEN, HIDDEN, (8, 8, 256)),
    ("gateup", HIDDEN, 2 * INTER, (2, 4, 1024)), ("down", INTER, HIDDEN, (8, 8, 2048)),
    ("head", HIDDEN, VOCAB, (1, 4, 2048)), ("o m8", HEAD_DIM, HIDDEN, (4, 4, 64)),
    ("qkv m8", HIDDEN, 3 * HEAD_DIM, (8, 8, 256)), ("head m8", HIDDEN, VOCAB // 8, (2, 4, 1024)),
])
def test_plan_at_the_3b_shapes(label, k, n, want):
    plan = t_plan.GemvPlan.make(k, n)
    assert (plan.cluster, plan.warps, plan.k_per_cta) == want
    _check_covers_k(k, *want)
    # every warp of every rank has a 16-row step: rank r's warp w takes
    # steps w, w + warps, ... of its range
    cluster, warps, k_per_cta = want
    last = k - (cluster - 1) * k_per_cta  # rows of the last rank
    assert min(k_per_cta, last) > t_plan.STEP_K * (warps - 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a card's: they then check it
    and call the kernel library, which the tests replace."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_OnCard)


# the fp32 attention entry points whose outputs the stand-in zeroes, so that
# a run through them (a Trainer step, an encode) computes on defined values:
# name -> (output pointer's argument, its shape's arguments) for each output
_ZEROED = {
    # out (B, Sq, Hq, D), lse (B, Hq, Sq) or NULL; B, Sq, Skv, Hq, Hkv, D at 7
    "pg_flash_attention_fwd_fp32": ((5, (7, 8, 10, 12)), (6, (7, 10, 8))),
    # dq (B, Sq, Hq, D); B, Sq, Skv, Hq, Hkv, D at 9
    "pg_flash_attention_bwd_dq_fp32": ((8, (9, 10, 12, 14)),),
    # dk, dv (B, Skv, Hkv, D); B, Sq, Skv, Hq, Hkv, D at 12
    "pg_flash_attention_bwd_dkv_fp32": ((10, (12, 14, 16, 17)), (11, (12, 14, 16, 17))),
    # out (B, S, H, D) at 3; B, S, H, D at 4
    "pg_vision_attention_fp32": ((3, (4, 5, 6, 7)),),
}


class _Library:
    """Records every C call of the wrappers and returns 0 (no error); the
    fp32 attention entry points' outputs are zeroed (_ZEROED)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            for at, dims in _ZEROED.get(name, ()):
                if args[at]:
                    ctypes.memset(args[at], 0, 4 * int(np.prod([args[i] for i in dims])))
            return 0
        return call


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    for fn in (t_gemv.int8_gemv, t_gemv.int8_gemv_f32, t_gemv.int8_gemv_rope_kv,
               t_head.head_argmax_fused, t_lora.lora_shrink, t_q4.int4_matmul,
               t_lora.lora_shrink_fp32, t_gemv.int8_gemv_fp32, t_gemv.int8_gemv_f32_fp32,
               t_gemv.int8_gemv_f32_lora_fp32, t_gemv.int8_gemv_f32_lora,
               t_w8a8.w8a8_quant_rows_fp32, t_w8a8.w8a8_gemm_fp32, t_flash.flash_attention,
               t_flash.flash_attention_fwd_fp32, t_flash.flash_attention_bwd_dq,
               t_flash.flash_attention_bwd_dkv, t_flash.flash_attention_bwd_dq_fp32,
               t_flash.flash_attention_bwd_dkv_fp32, t_va.vision_attention,
               t_va.vision_attention_fp32, t_sda.decode_attention, t_sda.decode_attention_fp32):
        monkeypatch.setattr(fn, "launches", 0)  # the counts come back after the test
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    return lib


def _gemv_split(lib):
    """(B, K, N, mode, cluster, warps, k_per_cta) of each pg_int8_gemv
    call."""
    return [args[5:12] for name, args in lib.calls if name == "pg_int8_gemv"]


def _head_split(lib):
    """(B, K, N, n_valid, cluster, warps, k_per_cta) of each pg_head_argmax
    call."""
    return [args[6:13] for name, args in lib.calls if name == "pg_head_argmax"]


@pytest.mark.parametrize("vocab", [VOCAB, VOCAB // 8 - VOCAB // 8 % 16, 300])
@pytest.mark.parametrize("b", [1, 8])
def test_head_argmax_and_int8_gemv_share_the_plan(library, vocab, b):
    """The fused head (over the vocab padded to the tile) and the logits
    path's int8_gemv (over the unpadded head) hand the card the same K
    split, so their logits have the same bits."""
    w8 = torch.empty((HIDDEN, vocab), dtype=torch.int8)  # never read: no pages touched
    s = torch.ones(vocab)
    y = _card(torch.zeros((b, HIDDEN), dtype=torch.bfloat16))
    head = t_head.repack_head({"w8": w8, "s": s})
    blk = {name: _card(t) for name, t in head.items()}
    t_head.head_argmax_fused(y, blk)
    t_gemv.int8_gemv(y, _card(w8), _card(s))
    [(hb, hk, hn, n_valid, *h_split)] = _head_split(library)
    [(gb, gk, gn, mode, *g_split)] = _gemv_split(library)
    assert (hb, hk, n_valid) == (gb, gk, gn) == (b, HIDDEN, vocab) and mode == 0
    assert hn == -(-vocab // 128) * 128
    assert h_split == g_split
    plan = t_plan.GemvPlan.make(HIDDEN, vocab)
    assert g_split == [plan.cluster, plan.warps, plan.k_per_cta]


# every kind of shape the wrapper took before the tile moved to the tensor
# cores: N % 4 == 0 (not % 16 or % 128), any K, any B, the three epilogues,
# the fp32 partial and the LoRA expand
ACCEPTED = [(b, k, n, kw) for b in (1, 2, 5, 8, 9, 33)
            for k, n, kw in [(2048, 2560, {}), (2048, 2048, {"residual": True}),
                             (2048, 32768, {"geglu": True}), (16384, 2048, {"residual": True}),
                             (1000, 388, {}), (77, 300, {"geglu": True}),
                             (256, 2048, {"f32": True}), (40, 4, {})]]


@pytest.mark.parametrize("b,k,n,kw", ACCEPTED)
def test_int8_gemv_accepts_the_shapes_it_took(library, b, k, n, kw):
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    w8, s = _card(torch.zeros((k, n), dtype=torch.int8)), _card(torch.ones(n))
    if kw.get("f32"):
        out = t_gemv.int8_gemv_f32(x, w8, s)
        mode = 3
    else:
        res = _card(torch.zeros((b, n), dtype=torch.bfloat16)) if kw.get("residual") else None
        out = t_gemv.int8_gemv(x, w8, s, residual=res, geglu=kw.get("geglu", False))
        mode = 2 if kw.get("geglu") else (1 if res is not None else 0)
    assert out.shape == (b, n // 2 if mode == 2 else n)
    assert out.dtype == (torch.float32 if mode == 3 else torch.bfloat16)
    plan = t_plan.GemvPlan.make(k, n)
    assert _gemv_split(library) == [(b, k, n, mode, plan.cluster, plan.warps, plan.k_per_cta)]


@pytest.mark.parametrize("geglu", [False, True])
def test_int8_gemv_lora_expands_in_one_launch(library, geglu):
    """With a LoRA adapter the GEMV is one launch of the plan of (K, N),
    the expand's operands beside it: no sums to scratch, no second launch."""
    b, k, n, g = 8, 2048, 4096, 8
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    w8, s = _card(torch.zeros((k, n), dtype=torch.int8)), _card(torch.ones(n))
    bounds = (n // 2,) if geglu else ()
    z = _card(torch.zeros((b, g * (len(bounds) + 1)), dtype=torch.bfloat16))
    lb = _card(torch.zeros((g, n)))
    t_gemv.int8_gemv(x, w8, s, geglu=geglu, lora=(z, lb, bounds))
    plan = t_plan.GemvPlan.make(k, n)
    [(name, args)] = library.calls
    assert name == "pg_int8_gemv_lora" and t_gemv.int8_gemv.launches == 1
    assert args[5:12] == (b, k, n, 2 if geglu else 0, plan.cluster, plan.warps, plan.k_per_cta)
    # lb_f32, G, nz, seg1, seg2
    assert args[14:19] == (1, g, z.shape[1], n // 2 if geglu else n, n)


@pytest.mark.parametrize("bounds,kw", [((2048, 2304), {}), ((), {"residual": True})])
def test_int8_gemv_lora_hands_the_kernel_each_targets_block(library, bounds, kw):
    """qkv's two target boundaries and o's none reach the kernel as (seg1,
    seg2), N where there is none; a bf16 B is passed as such."""
    b, k, n, g = 3, 2048, 2560, 16
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    w8, s = _card(torch.zeros((k, n), dtype=torch.int8)), _card(torch.ones(n))
    res = _card(torch.zeros((b, n), dtype=torch.bfloat16)) if kw else None
    z = _card(torch.zeros((b, g * (len(bounds) + 1)), dtype=torch.bfloat16))
    lb = _card(torch.zeros((g, n), dtype=torch.bfloat16))
    out = t_gemv.int8_gemv(x, w8, s, residual=res, lora=(z, lb, bounds))
    assert out.shape == (b, n) and out.dtype == torch.bfloat16
    [(name, args)] = library.calls
    segs = list(bounds) + [n] * (2 - len(bounds))
    assert name == "pg_int8_gemv_lora" and args[8] == (1 if kw else 0)
    assert args[14:19] == (0, g, z.shape[1], *segs)


# the fp32 forms of the bank, the mesh and W8A8 (--dtype float32) at
# Gemma-2B's shapes: entry point, counter, and the arguments that differ
FP32_CALLS = ["shrink", "shrink+norm", "qkv expand", "gateup expand", "o expand", "f32", "k1",
              "quant", "quant amax", "gemm", "bwd dq", "bwd dkv", "vision", "seg"]


@pytest.mark.parametrize("what", FP32_CALLS)
def test_fp32_forms_reach_their_entry_points(library, what):
    """fp32 x reaches each fp32 entry point in one launch with the bf16
    form's plan (the shrink's of (K, nG), the GEMV's of (K, N)), fp32
    operands where the bf16 form has bf16 ones, and is counted on the fp32
    form's counter only."""
    b, g = 8, 32
    f32 = lambda *shape: _card(torch.zeros(shape))  # noqa: E731
    if what in ("bwd dq", "bwd dkv", "vision", "seg"):
        _attention_fp32_call(library, f32, what)
        return
    if what.startswith("shrink"):
        k, ng = HIDDEN, 3 * g
        norm = (f32(k), 1e-6) if what.endswith("norm") else None
        z = t_lora.lora_shrink(f32(b, k), _card(torch.zeros((k, ng), dtype=torch.bfloat16)),
                               _card(torch.zeros(b, dtype=torch.int32)), 8, g, norm=norm)
        [(name, args)] = library.calls
        plan = t_lora.ShrinkPlan.make(k, ng)
        assert name == "pg_lora_shrink_fp32" and z.dtype == torch.float32 and args[2] == 0
        assert args[5:13] == (b, k, ng, g, 8, plan.cluster, plan.k_per_cta, plan.threads)
        assert (args[13] is None) == (norm is None)
        assert (t_lora.lora_shrink_fp32.launches, t_lora.lora_shrink.launches) == (1, 0)
        return
    if what in ("quant", "quant amax", "gemm"):
        m, k, n = 266, HIDDEN, 2560
        if what == "gemm":
            out = t_w8a8.w8a8_gemm(_card(torch.zeros((m, k), dtype=torch.int8)),
                                   _card(torch.zeros((k, n), dtype=torch.int8)), f32(m), f32(n),
                                   out_dtype=torch.float32)
            [(name, args)] = library.calls
            plan = t_w8a8.GemmPlan.make(m, k, n)
            assert name == "pg_w8a8_gemm" and args[5:9] == (m, k, n, 2)
            assert args[9:13] == (plan.rows, plan.cluster, plan.k_stages, plan.ctas)
            assert out.dtype == torch.float32 and t_w8a8.w8a8_gemm_fp32.launches == 1
            return
        x8, a_s = t_w8a8.w8a8_quant_rows(f32(m, k), f32(m) if what.endswith("amax") else None)
        [(name, args)] = library.calls
        assert name == "pg_w8a8_quant_rows_fp32" and args[4:6] == (m, k)
        assert (args[1] is None) == (what == "quant")
        assert x8.dtype == torch.int8 and t_w8a8.w8a8_quant_rows_fp32.launches == 1
        return
    k, n, bounds, kw = {"qkv expand": (HIDDEN, 2560, (2048, 2304), {}),
                        "gateup expand": (HIDDEN, 2 * INTER, (INTER,), {"geglu": True}),
                        "o expand": (HIDDEN, HIDDEN, (), {"residual": f32(b, HIDDEN)}),
                        "f32": (INTER, HIDDEN, None, {}), "k1": (INTER, HIDDEN, (), {})}[what]
    w8, s = _card(torch.zeros((k, n), dtype=torch.int8)), f32(n)
    lora = None if bounds is None else (f32(b, g * (len(bounds) + 1)), f32(g, n), bounds)
    if what in ("f32", "k1"):
        out = t_gemv.int8_gemv_f32(f32(b, k), w8, s, lora=lora)
        mode, width = 3, (n if lora is None else 2 * n)
        counter = t_gemv.int8_gemv_f32_fp32 if lora is None else t_gemv.int8_gemv_f32_lora_fp32
    else:
        out = t_gemv.int8_gemv(f32(b, k), w8, s, lora=lora, **kw)
        mode = 2 if kw.get("geglu") else (1 if kw else 0)
        width, counter = (n // 2 if mode == 2 else n), t_gemv.int8_gemv_fp32
    [(name, args)] = library.calls
    plan = t_plan.GemvPlan.make(k, n)
    assert name == "pg_int8_gemv_fp32" and out.shape == (b, width)
    assert out.dtype == torch.float32 and counter.launches == 1
    assert args[5:12] == (b, k, n, mode, plan.cluster, plan.warps, plan.k_per_cta)
    if lora is not None:  # lb_f32, G, nz, seg1, seg2
        segs = list(bounds) + [n] * (2 - len(bounds))
        assert args[12] is not None and args[14:19] == (1, g, lora[0].shape[1], *segs)
    else:
        assert args[12] is None
    assert t_gemv.int8_gemv.launches == t_gemv.int8_gemv_f32.launches == 0
    assert t_gemv.int8_gemv_f32_lora.launches == 0


def _i32(*values):
    return _card(torch.tensor(values, dtype=torch.int32))


def _attention_fp32_call(library, f32, what):
    """test_fp32_forms_reach_their_entry_points' attention forms: the flash
    backward's two kernels at the training shape (B2 S512 Hq8 Hkv1 D256,
    the dk/dv sweep in the fp32 form's splits of 32-row tiles, four waves), B12 at the
    896 px tower (B1 S4096 H16 D72), B10 at the Gemma-2B cache (B8 Hq8
    Hkv1 D256 S2048)."""
    if what.startswith("bwd"):
        b, s, hq, d = 2, 512, 8, 256
        q, dout, kv = f32(b, s, hq, d), f32(b, s, hq, d), f32(b, s, 1, d)
        args = (q, kv, kv, dout, f32(b, hq, s), f32(b, hq, s), _i32(268, 268), _i32(512, 400),
                d**-0.5)
        if what == "bwd dq":
            out = (t_flash.flash_attention_bwd_dq(*args),)
            counter, bf16 = t_flash.flash_attention_bwd_dq_fp32, t_flash.flash_attention_bwd_dq
        else:
            out = t_flash.flash_attention_bwd_dkv(*args)
            counter, bf16 = t_flash.flash_attention_bwd_dkv_fp32, t_flash.flash_attention_bwd_dkv
        [(name, got)] = library.calls
        assert name == f"pg_flash_attention_{what.replace(' ', '_')}_fp32"
        n = 9 if what == "bwd dq" else 12
        assert got[n:n + 6] == (b, s, s, hq, 1, d)
        if what == "bwd dkv":  # 16 key blocks x B: 16 splits, four waves of 128 of 132 SMs
            assert got[18] == t_flash.dkv_splits(b, 1, hq * s, s, 32, 32, 4) == 16
        assert all(t.dtype == torch.float32 for t in out)
    elif what == "vision":
        q = f32(1, 4096, 16, 72)
        out = (t_va.vision_attention(q, q, q),)
        [(name, got)] = library.calls
        counter, bf16 = t_va.vision_attention_fp32, t_va.vision_attention
        assert name == "pg_vision_attention_fp32" and got[4:8] == (1, 4096, 16, 72)
        assert got[8] == 72**-0.5 and out[0].dtype == torch.float32
    else:
        b, s = 8, 2048
        q, cache = f32(b, 8, 256), f32(b, s, 1, 256)
        segs = [_i32(*([n] * b)) for n in (250, 256, 300)]
        out = (t_sda.decode_attention(q, cache, cache, *segs),)
        [(name, got)] = library.calls
        counter, bf16 = t_sda.decode_attention_fp32, t_sda.decode_attention
        plan = t_sda.split_plan(q, cache)
        assert name == "pg_seg_attention_fp32" and got[10:16] == (b, 8, 1, 256, s, plan.nsplit)
        assert out[0].dtype == torch.float32
    assert (counter.launches, bf16.launches) == (1, 0)


def _card_tree(tree):
    return {k: _card_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else _card(tree)


def test_fp32_trainer_step_reaches_the_fp32_backward(library, monkeypatch):
    """One Trainer step (LoRA) on fp32 weights that the wrappers take for a
    card's: each layer's attention reaches the fp32 forward and each fp32
    backward kernel once, and no bf16 flash entry point. (Autograd hands the
    backward its saved tensors as plain tensors; the stand-in marks them as
    the card's again. It cannot mark remat's replay, whose inputs come back
    the same way: chip_smoke.py counts that one on the card.)"""
    cfg = t_config.tiny_test_config()
    params = _card_tree(init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32))
    backward = t_flash.flash_attention_backward
    monkeypatch.setattr(t_flash, "flash_attention_backward", lambda q, k, v, out, lse, dout, *a:
                        backward(*(_card(t) for t in (q, k, v, out, lse, dout)), *a))
    tr = Trainer(params, cfg, TrainConfig(lora_rank=4, use_flash=True, remat=False))
    rng = np.random.default_rng(0)
    n_img, n_txt, b = cfg.vision_config.num_patches, 6, 2
    ids = np.concatenate([np.full((b, n_img), cfg.image_token_index),
                          rng.integers(3, 100, (b, n_txt))], 1).astype(np.int32)
    ttype = np.broadcast_to(np.arange(n_img + n_txt) >= n_img + 2, ids.shape).astype(np.int32)
    loss = tr.train_step({"pixel_values": rng.normal(size=(b, 3, 28, 28)).astype(np.float32),
                          "input_ids": ids, "attention_mask": np.ones_like(ids),
                          "token_type_ids": ttype,
                          "labels": np.where(ttype == 1, ids, -100).astype(np.int32)})
    n = cfg.text_config.num_hidden_layers
    names = [name for name, _ in library.calls]
    assert np.isfinite(loss) and len(names) == 3 * n
    assert (names.count("pg_flash_attention_fwd_fp32"),
            names.count("pg_flash_attention_bwd_dq_fp32"),
            names.count("pg_flash_attention_bwd_dkv_fp32")) == (n, n, n)
    assert (t_flash.flash_attention_fwd_fp32.launches, t_flash.flash_attention_bwd_dq_fp32.launches,
            t_flash.flash_attention_bwd_dkv_fp32.launches) == (n, n, n)
    assert (t_flash.flash_attention.launches, t_flash.flash_attention_bwd_dq.launches,
            t_flash.flash_attention_bwd_dkv.launches) == (0, 0, 0)


def test_fp32_fused_encode_reaches_b12_fp32(library):
    """siglip.encode(attn="fused") on fp32 weights that the wrappers take for
    a card's (a tiny tower of 256 patches: S a multiple of 128) reaches B12's
    fp32 entry point once a layer, and the bf16 kernel never."""
    vcfg = dataclasses.replace(t_config.tiny_test_config().vision_config, image_size=224)
    vp = _card_tree(init_params(dataclasses.replace(t_config.tiny_test_config(),
                                                    vision_config=vcfg),
                                torch.Generator().manual_seed(0), "cpu",
                                torch.float32)["vision"])
    px = _card(torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 3, 224, 224), dtype=np.float32)))
    feats = siglip.encode(vp, vcfg, px, attn="fused")
    heads, width = vcfg.num_attention_heads, vcfg.hidden_size
    assert feats.shape == (1, 256, width) and torch.isfinite(feats).all()
    want = ["pg_vision_attention_fp32"] * vcfg.num_hidden_layers
    assert [name for name, _ in library.calls] == want
    assert all(args[4:8] == (1, 256, heads, width // heads) for _, args in library.calls)
    assert (t_va.vision_attention_fp32.launches, t_va.vision_attention.launches) == (
        vcfg.num_hidden_layers, 0)


# (label, K, N) of Gemma-2B's four projections for the int4 tile, and
# ragged ones: stored rows K/2 a multiple of 64, N of 16 but not of 128
INT4_SHAPES = [("qkv", HIDDEN, (HEADS + 2) * HEAD_DIM), ("o", HEADS * HEAD_DIM, HIDDEN),
               ("gateup", HIDDEN, 2 * INTER), ("down", INTER, HIDDEN), ("small", 256, 208),
               ("K 128", 128, 96)]


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("label,k,n", INT4_SHAPES, ids=[c[0] for c in INT4_SHAPES])
def test_int4_matmul_decode_rows_take_the_stored_row_plan(library, label, k, n, m):
    """At M <= 16 int4_matmul is one launch of the GEMV tile in its int4
    form, split as GemvPlan plans the (K/2, N) stored rows: every rank's
    range a multiple of 16 stored rows, K/2 covered once, the split a
    function of (K, N) whatever M."""
    x = _card(torch.zeros((m, k), dtype=torch.bfloat16))
    w4p = _card(torch.empty((k // 2, n), dtype=torch.int8))  # never read
    out = t_q4.int4_matmul(x, w4p, _card(torch.ones(n)))
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    [(name, args)] = library.calls
    assert name == "pg_int4_gemv" and t_q4.int4_matmul.launches == 1
    gm, gk, gn, *split = args[4:10]
    assert (gm, gk, gn) == (m, k, n)
    _check_covers_k(k // 2, *split)
    plan = t_plan.GemvPlan.make(k // 2, n)
    assert split == [plan.cluster, plan.warps, plan.k_per_cta]


@pytest.mark.parametrize("m", [17, 266])
def test_int4_matmul_prefill_rows_keep_the_dequantizing_tile(library, m):
    """Above 16 rows int4_matmul is one launch of the dequantizing wgmma
    tile (csrc/wq_wgmma.cuh, pg_int4_matmul), its K split added in the same
    launch: no second call, the plan of (M, K, N)."""
    k, n = HIDDEN, 2048
    x = _card(torch.zeros((m, k), dtype=torch.bfloat16))
    t_q4.int4_matmul(x, _card(torch.empty((k // 2, n), dtype=torch.int8)), _card(torch.ones(n)))
    [(name, args)] = library.calls
    plan = _wq_gemm.WqPlan.make(m, k, n, "int4")
    assert name == "pg_int4_matmul" and args[4:7] == (m, k, n)
    assert args[7:10] == (plan.rows, plan.cluster, plan.k_per_cta // _wq_gemm.BK)
    assert t_q4.int4_matmul.launches == 1


# (label, K, nG) of the LoRA shrink at Gemma-2B with a bank of 3 rank-8
# adapters (G 32): qkv, o, gate | up, down; and small ones
SHRINK_SHAPES = [("qkv", HIDDEN, 96), ("o", HEADS * HEAD_DIM, 32), ("gu", HIDDEN, 64),
                 ("down", INTER, 32), ("K 320", 320, 48), ("K 8", 8, 8), ("K 40000", 40000, 16)]


@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("label,k,ng", SHRINK_SHAPES, ids=[c[0] for c in SHRINK_SHAPES])
def test_lora_shrink_is_one_launch_of_its_plan(library, label, k, ng, b):
    """lora_shrink is one launch; its K split (the cluster's ranks, each a
    multiple of 8 rows, consecutive, none empty) covers K once and is the
    plan of (K, nG) whatever B."""
    g = 8 if ng % 16 else 16
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    a = _card(torch.zeros((k, ng)))
    ids = _card(torch.zeros(b, dtype=torch.int32))
    z = t_lora.lora_shrink(x, a, ids, 4, g)
    assert z.shape == (b, ng) and z.dtype == torch.bfloat16
    [(name, args)] = library.calls
    assert name == "pg_lora_shrink" and args[2] == 1 and t_lora.lora_shrink.launches == 1
    gb, gk, gng, gg, grank, cluster, per, threads = args[5:13]
    assert (gb, gk, gng, gg, grank) == (b, k, ng, g, 4)
    assert 1 <= cluster <= t_lora.MAX_CLUSTER and per % t_lora.STEP_K == 0
    assert (cluster - 1) * per < k <= cluster * per and threads in t_lora.THREAD_CHOICES
    plan = t_lora.ShrinkPlan.make(k, ng)
    assert (cluster, per, threads) == (plan.cluster, plan.k_per_cta, plan.threads)


@pytest.mark.parametrize("label,k,ng,want", [
    ("qkv", HIDDEN, 96, (8, 256, 256)), ("down", INTER, 32, (8, 2048, 512)),
    ("K 320", 320, 48, (2, 160, 256)), ("K 8", 8, 8, (1, 8, 256)),
])
def test_shrink_plan_at_the_3b_shapes(label, k, ng, want):
    """At Gemma-2B's widths every rank of a full cluster takes 256 (hidden,
    CTAs of 256 threads) or 2048 (intermediate, 512 threads) rows of A: one
    round of its loads in flight."""
    plan = t_lora.ShrinkPlan.make(k, ng)
    assert (plan.cluster, plan.k_per_cta, plan.threads) == want


@pytest.mark.parametrize("k,ng", [(100, 32), (2048, 20)])
def test_lora_shrink_refuses_what_the_kernel_cannot_take(library, k, ng):
    x = _card(torch.zeros((2, k), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple"):
        t_lora.lora_shrink(x, _card(torch.zeros((k, ng))),
                           _card(torch.zeros(2, dtype=torch.int32)), 2, 4)
    assert library.calls == []


@pytest.mark.parametrize("k,n,msg", [(64, 98, "N % 4"), (64, 6, "N % 4")])
def test_int8_gemv_still_refuses(library, k, n, msg):
    x = _card(torch.zeros((2, k), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=msg):
        t_gemv.int8_gemv(x, _card(torch.zeros((k, n), dtype=torch.int8)), _card(torch.ones(n)))
    assert library.calls == []


def _norm(k):
    return (_card(torch.zeros(k, dtype=torch.bfloat16)), 1e-6)


@pytest.mark.parametrize("b", [1, 8, 9])
@pytest.mark.parametrize("label,k,n,geglu", [
    ("qkv", HIDDEN, (HEADS + 2) * HEAD_DIM, False), ("gateup", HIDDEN, 2 * INTER, True),
    ("qkv m8", HIDDEN, 3 * HEAD_DIM, False), ("gateup m8", HIDDEN, 2 * INTER // 8, True)])
def test_int8_gemv_with_norm_is_one_fused_launch_of_its_plan(library, b, label, k, n, geglu):
    """With a norm the GEMV is one launch (pg_int8_gemv_fused) of the plan of
    (K, N), the norm's weight and eps beside it, no LoRA and no RoPE
    operands; the plan's staged rows fit the prologue's buffer."""
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    w8, s = _card(torch.zeros((k, n), dtype=torch.int8)), _card(torch.ones(n))
    norm = _norm(k)
    out = t_gemv.int8_gemv(x, w8, s, geglu=geglu, norm=norm)
    assert out.shape == (b, n // 2 if geglu else n) and t_gemv.int8_gemv.launches == 1
    [(name, args)] = library.calls
    plan = t_plan.GemvPlan.make(k, n)
    assert name == "pg_int8_gemv_fused" and t_plan.norm_fits(plan)
    assert args[5:12] == (b, k, n, 2 if geglu else 0, plan.cluster, plan.warps, plan.k_per_cta)
    assert args[12:19] == (None, None, 0, 0, 0, 0, 0)  # no LoRA
    assert args[19:21] == (norm[0].data_ptr(), 1e-6)
    assert args[21:29] == (None,) * 8 and args[29:33] == (0, 0, 0, 0)  # no RoPE


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("hl", [HEADS, 1])
def test_int8_gemv_rope_kv_is_one_launch_of_mode_4(library, paged, hl):
    """int8_gemv_rope_kv hands the kernel mode 4 over the plan of (K, (H +
    2) D), q as its output, the heads, the depth and the destination's rows
    (S of a dense cache, the page size of a pool) and the table's stride."""
    b, d, s_len, ps = 3, HEAD_DIM, 1024, 64
    n = (hl + 2) * d
    x = _card(torch.zeros((b, HIDDEN), dtype=torch.bfloat16))
    w8, s = _card(torch.zeros((HIDDEN, n), dtype=torch.int8)), _card(torch.ones(n))
    cos = sin = _card(torch.zeros((b, d), dtype=torch.bfloat16))
    pos = _card(torch.zeros(b, dtype=torch.int32))
    shape = (40, ps, d) if paged else (b, s_len, d)
    kd, vd = (_card(torch.zeros(shape, dtype=torch.bfloat16)) for _ in range(2))
    kn, vn = (_card(torch.zeros((b, d), dtype=torch.bfloat16)) for _ in range(2))
    table = _card(torch.zeros((b, 16), dtype=torch.int32)) if paged else None
    q, k_new, _ = t_gemv.int8_gemv_rope_kv(x, w8, s, cos, sin, pos, hl, kd, vd, kn, vn,
                                           norm=_norm(HIDDEN), page_table=table)
    assert q.shape == (b, hl, d) and k_new is kn and t_gemv.int8_gemv_rope_kv.launches == 1
    [(name, args)] = library.calls
    plan = t_plan.GemvPlan.make(HIDDEN, n)
    assert name == "pg_int8_gemv_fused" and args[4] == q.data_ptr()
    assert args[5:12] == (b, HIDDEN, n, 4, plan.cluster, plan.warps, plan.k_per_cta)
    assert args[21] == cos.data_ptr() and args[23] == pos.data_ptr()
    assert args[28] == (table.data_ptr() if paged else None)
    assert args[29:33] == (hl, d, ps if paged else s_len, 16 if paged else 0)


def test_norm_and_rope_refuse_what_the_kernel_cannot_take(library):
    """A K range per CTA past the prologue's buffer (a plan of one CTA over
    K 2048), K not a multiple of 8, a head whose half is not a multiple of
    16, N other than (H + 2) D: each raises before any launch."""
    x = _card(torch.zeros((2, HIDDEN), dtype=torch.bfloat16))
    wide = 40000
    assert not t_plan.norm_fits(t_plan.GemvPlan.make(HIDDEN, wide))
    with pytest.raises(ValueError, match="norm prologue"):
        t_gemv.int8_gemv(x, _card(torch.zeros((HIDDEN, wide), dtype=torch.int8)),
                         _card(torch.ones(wide)), norm=_norm(HIDDEN))
    x12 = _card(torch.zeros((2, 12), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="norm prologue"):
        t_gemv.int8_gemv(x12, _card(torch.zeros((12, 64), dtype=torch.int8)),
                         _card(torch.ones(64)), norm=_norm(12))
    for hl, d, n in ((2, 16, 64), (2, 64, 5 * 64)):  # D/2 = 8; N != (H + 2) D
        cs = _card(torch.zeros((2, d), dtype=torch.bfloat16))
        kd = _card(torch.zeros((2, 32, d), dtype=torch.bfloat16))
        kn = _card(torch.zeros((2, d), dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="RoPE"):
            t_gemv.int8_gemv_rope_kv(x, _card(torch.zeros((HIDDEN, n), dtype=torch.int8)),
                                     _card(torch.ones(n)), cs, cs,
                                     _card(torch.zeros(2, dtype=torch.int32)), hl, kd, kd, kn, kn,
                                     norm=_norm(HIDDEN))
    assert library.calls == []


def test_lora_shrink_hands_the_kernel_the_norm(library):
    """lora_shrink with a norm passes its weight and eps; without one a
    null weight (the plain shrink)."""
    b, k, ng = 8, HIDDEN, 96
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    a = _card(torch.zeros((k, ng)))
    ids = _card(torch.zeros(b, dtype=torch.int32))
    norm = _norm(k)
    t_lora.lora_shrink(x, a, ids, 8, 32, norm=norm)
    t_lora.lora_shrink(x, a, ids, 8, 32)
    [(_, with_norm), (_, plain)] = library.calls
    assert with_norm[13:15] == (norm[0].data_ptr(), 1e-6) and plain[13:15] == (None, 0.0)
    assert with_norm[:4] == plain[:4] and with_norm[5:13] == plain[5:13]  # 4: each call's z
