"""The pure-Python plans of two attention kernels of paligemma_tpu_torch,
on the CPU (the kernels themselves run on the card: tests/test_torch_cuda.py):

- the split-K decode attention of ``csrc/attention_split.cuh``, shared by
  the dense (``kernels.decode_attention``), paged (``kernels.paged_attention``)
  and seg (``kernels.ablation.decode_attention``) wrappers: its key tiles
  and merge order depend on the split index only, which is what makes the
  three return the same bits on the same keys;
- the vision-tower attention (B12, ``kernels.ablation.vision_attention``):
  its rows per block and the shapes it refuses.
"""

import pytest
import torch

from paligemma_tpu_torch.kernels import decode_attention as t_dattn
from paligemma_tpu_torch.kernels import paged_attention as t_paged
from paligemma_tpu_torch.kernels.ablation import decode_attention as t_sda
from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va

torch.set_num_threads(2)


def _plans(b, g, d, w, ps=16):
    """The three wrappers' plans for one KV head of G query heads: the dense
    window and the seg cache are ``w`` keys, the paged table the pages that
    cover ``w`` (so its window is w rounded up to the page)."""
    q = torch.zeros(b, g, d, dtype=torch.bfloat16)
    n_p = -(-w // ps)
    return {
        "dense": t_dattn.split_plan(q, torch.zeros(b, w, dtype=torch.bool)),
        "paged": t_paged.split_plan(q, torch.zeros(3, 4, ps, 1, d), torch.zeros(b, n_p)),
        "seg": t_sda.split_plan(q, torch.zeros(b, w, 1, d)),
    }


@pytest.mark.parametrize("w", [80, 96, 512, 1000, 2048])
@pytest.mark.parametrize("b", [1, 8])
def test_split_tiles_and_merge_order_depend_on_the_split_index_only(b, w):
    ref = t_dattn.SplitPlan(rows=1, groups=8, head_dim=256, window=32)
    for name, plan in _plans(b, 8, 256, w).items():
        assert plan.nsplit == -(-plan.window // t_dattn.KEYS_PER_SPLIT), name
        for s in range(plan.nsplit):
            assert plan.tile(s) == ref.tile(s) == (32 * s, 32 * s + 32)
            assert plan.merge_slot(s) == ref.merge_slot(s) == (s % 8, s // 8)
    # a wider window only appends splits: the shared ones keep their tiles
    # and their place in every merge lane
    narrow = t_dattn.SplitPlan(rows=b, groups=8, head_dim=256, window=w)
    wide = t_dattn.SplitPlan(rows=b, groups=8, head_dim=256, window=2 * w + 64)
    assert [narrow.merge_slot(s) for s in range(narrow.nsplit)] == \
        [wide.merge_slot(s) for s in range(narrow.nsplit)]


@pytest.mark.parametrize("g,hkv,d", [(1, 1, 256), (2, 4, 128), (4, 2, 72), (8, 1, 256)])
def test_split_scratch_matches_the_wrappers(g, hkv, d):
    b, s_max, ps, n_p = 3, 200, 16, 7
    q = torch.zeros(b, g * hkv, d, dtype=torch.bfloat16)
    plans = {
        "seg": t_sda.split_plan(q, torch.zeros(b, s_max, hkv, d)),
        "paged": t_paged.split_plan(q, torch.zeros(2, 9, ps, hkv, d), torch.zeros(b, n_p)),
    }
    if hkv == 1:
        plans["dense"] = t_dattn.split_plan(q, torch.zeros(b, s_max, dtype=torch.bool))
    windows = {"seg": s_max, "paged": n_p * ps, "dense": s_max}
    for name, plan in plans.items():
        assert (plan.rows, plan.groups, plan.head_dim, plan.window) == \
            (b * hkv, g, d, windows[name]), name
        nsplit = -(-windows[name] // 32)
        want = {"part_m": (b * hkv, nsplit, g), "part_l": (b * hkv, nsplit, g),
                "part_o": (b * hkv, nsplit, g, d)}
        assert plan.scratch_shapes() == want
        got = plan.scratch(torch.device("cpu"))
        assert [tuple(t.shape) for t in got] == [want["part_m"], want["part_l"], want["part_o"]]
        assert all(t.dtype == torch.float32 for t in got)


@pytest.mark.parametrize("b,s,h,rows", [(1, 256, 16, 64), (1, 1024, 16, 128), (1, 4096, 16, 128),
                                        (2, 128, 3, 64), (2, 2048, 8, 128), (8, 1024, 16, 128),
                                        (1, 512, 16, 64), (1, 512, 17, 128), (1, 1024, 8, 64)])
def test_vision_attention_rows_per_block(b, s, h, rows):
    """128-row blocks (two consumer warpgroups) where (S / 128) * H * B
    blocks keep at least half of the 132 SMs busy (66), else 64-row blocks."""
    assert t_va.rows_per_block(b, s, h) == rows
    assert t_va.launch_plan(b, s, h, 72) == rows


@pytest.mark.parametrize("d,ok", [(8, True), (64, True), (72, True), (96, True), (128, True),
                                  (0, False), (4, False), (12, False), (136, False), (256, False)])
def test_vision_attention_head_dims(d, ok):
    if ok:
        assert t_va.launch_plan(1, 256, 16, d) in (64, 128)
    else:
        with pytest.raises(ValueError):
            t_va.launch_plan(1, 256, 16, d)


@pytest.mark.parametrize("s", [100, 200, 264, 1000])
def test_vision_attention_refuses_seq_not_a_multiple_of_128(s):
    x = torch.zeros(1, s, 4, 8)
    with pytest.raises(NotImplementedError):
        t_va.vision_attention(x, x, x)


def test_vision_attention_refuses_head_block_not_dividing_heads():
    x = torch.zeros(1, 128, 6, 8)
    with pytest.raises(ValueError):
        t_va.vision_attention(x, x, x, head_block=4)
    assert t_va.vision_attention(x, x, x, head_block=3).shape == x.shape
