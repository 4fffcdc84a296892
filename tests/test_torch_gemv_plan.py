"""The split of the int8 GEMV (``kernels/gemv_plan.GemvPlan``) on the CPU,
at PaliGemma-3B-224's decode shapes (Gemma-2B: hidden 2048, 8 heads of
256, one KV head, intermediate 16384, vocab 257152) and at the
tensor-parallel shards of m = 2, 4, 8 ranks; and the launches the two
wrappers over the tile (``int8_gemv``, ``head_argmax_fused``) make, read
from a stand-in for the kernel library, so that the split they hand the
card is checked here (the kernels themselves run on the card:
tests/test_torch_cuda.py).
"""

import pytest
import torch

from paligemma_tpu_torch.kernels import _build
from paligemma_tpu_torch.kernels import decode_head as t_head
from paligemma_tpu_torch.kernels import gemv_plan as t_plan
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv

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


class _Library:
    """Records every C call of the wrappers and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    for fn in (t_gemv.int8_gemv, t_gemv.int8_gemv_f32, t_head.head_argmax_fused):
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
def test_int8_gemv_lora_takes_the_sums_then_the_expand(library, geglu):
    """With a LoRA adapter the tile writes its unscaled sums (mode 4), one
    (1, B, N) split, and the LoRA epilogue reads them with nsplit = 1."""
    b, k, n, g = 8, 2048, 4096, 8
    x = _card(torch.zeros((b, k), dtype=torch.bfloat16))
    w8, s = _card(torch.zeros((k, n), dtype=torch.int8)), _card(torch.ones(n))
    bounds = (n // 2,) if geglu else ()
    z = _card(torch.zeros((b, g * (len(bounds) + 1)), dtype=torch.bfloat16))
    lb = _card(torch.zeros((g, n)))
    t_gemv.int8_gemv(x, w8, s, geglu=geglu, lora=(z, lb, bounds))
    plan = t_plan.GemvPlan.make(k, n)
    assert _gemv_split(library) == [(b, k, n, 4, plan.cluster, plan.warps, plan.k_per_cta)]
    [(name, args)] = [c for c in library.calls if c[0] != "pg_int8_gemv"]
    assert name == "pg_int8_gemv_epilogue_lora" and args[1:4] == (1, b, n)
    assert args[7] == (2 if geglu else 0)


@pytest.mark.parametrize("k,n,msg", [(64, 98, "N % 4"), (64, 6, "N % 4")])
def test_int8_gemv_still_refuses(library, k, n, msg):
    x = _card(torch.zeros((2, k), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=msg):
        t_gemv.int8_gemv(x, _card(torch.zeros((k, n), dtype=torch.int8)), _card(torch.ones(n)))
    assert library.calls == []
