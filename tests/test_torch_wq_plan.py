"""The plan of the weight-only quantized matmuls B9 and B11
(``kernels/ablation/_wq_gemm.WqPlan``) on the CPU, at Gemma-2B's four
projections of one layer (qkv 2048 -> 2560, o 2048 -> 2048, gate | up 2048
-> 32768, down 16384 -> 2048) and decode, prefill and training rows, for
int8 (K, N), int8 (N, K) and int4 weights; and the C calls the wrappers
make, read from a stand-in for the kernel library (the kernels run on the
card: tests/test_torch_cuda.py).
"""

import pytest
import torch

from paligemma_tpu_torch.kernels import _build
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv
from paligemma_tpu_torch.kernels.ablation import _wq_gemm as wq
from paligemma_tpu_torch.kernels.ablation import quant4 as t_q4
from paligemma_tpu_torch.kernels.ablation import quant_pallas as t_qp
from paligemma_tpu_torch.kernels.gemv_plan import GemvPlan

torch.set_num_threads(2)

PROJECTIONS = [("qkv", 2048, 2560), ("o", 2048, 2048), ("gateup", 2048, 32768),
               ("down", 16384, 2048)]
ROWS = [1, 8, 16, 17, 64, 266, 1024, 4096]
LAYOUTS = ["kn", "nk", "int4"]
CASES = [(label, k, n, m, layout) for label, k, n in PROJECTIONS for m in ROWS
         for layout in LAYOUTS]
IDS = [f"{label}-M{m}-{layout}" for label, k, n, m, layout in CASES]


def _busiest(route, m, n, rows, stages):
    """The stages (each rows + STAGE_COST) of the busiest CTA with tiles of
    ``rows`` rows: one wave of clusters splitting K where they all fit,
    else waves of persistent CTAs."""
    tiles = -(-n // 128) * -(-m // rows)
    fits = wq.CLUSTERS_RESIDENT[route]
    split = [c for c in fits if 1 < c <= stages and tiles <= fits[c]]
    if tiles < fits[1] and split:
        per = -(-stages // max(split))
        return per * (rows + wq.STAGE_COST)
    return -(-tiles // fits[1]) * stages * (rows + wq.STAGE_COST)


@pytest.mark.parametrize("label,k,n,m,layout", CASES, ids=IDS)
def test_plan_routes_and_covers(label, k, n, m, layout):
    """The route by rows; a grid within CUDA's limits and a cluster within
    its size; the ranks' K ranges cover every stored row once, in order;
    the tiles cover M and N."""
    plan = wq.WqPlan.make(m, k, n, layout)
    stored = k // 2 if layout == "int4" else k
    assert plan.stored_rows == stored
    if m <= wq.GEMV_ROWS:
        want = {"kn": "gemv", "int4": "int4_gemv", "nk": "wgmma16"}[layout]
    else:
        want = "wgmma"
    assert plan.route == want
    gx, gy, gz = plan.grid
    assert 1 <= gx <= wq.MAX_GRID_X and 1 <= gy <= wq.MAX_GRID_YZ and 1 <= gz <= wq.MAX_GRID_YZ
    assert 1 <= plan.cluster <= 8 and gx % plan.cluster == 0
    ranges = plan.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == stored
    assert all(lo < hi for lo, hi in ranges)  # no rank is empty
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # consecutive, in order
    if plan.route.endswith("gemv"):
        gp = GemvPlan.make(stored, n)
        assert (plan.cluster, plan.k_per_cta, plan.warps) == (gp.cluster, gp.k_per_cta, gp.warps)
        assert gx == -(-n // plan.cols) * plan.cluster and gz * plan.rows >= m
    else:
        assert plan.k_per_cta % wq.BK == 0
        if m <= 16:
            assert plan.rows == 16
        else:  # the row tile whose busiest CTA takes the fewest stages
            cost = {r: _busiest(plan.route, m, n, r, stored // wq.BK) for r in wq.ROW_TILES}
            assert cost[plan.rows] == min(cost.values())
        col_tiles, row_tiles = -(-n // plan.cols), -(-m // plan.rows)
        assert col_tiles * plan.cols >= n and row_tiles * plan.rows >= m
        assert plan.tiles == col_tiles * row_tiles
        fits = wq.CLUSTERS_RESIDENT[plan.route]
        if plan.cluster == 1:  # persistent CTAs: at most one wave, every tile taken
            assert gx == min(plan.tiles, fits[1]) and gy == gz == 1
        else:  # one tile a cluster, split only where all clusters fit at once
            assert (gx, gy) == (col_tiles * plan.cluster, row_tiles)
            table = min(c for c in fits if c >= plan.cluster)  # its row of the table
            assert plan.tiles <= fits[table] < fits[1]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_is_a_function_of_its_shape(layout):
    """The same (M, K, N, layout) gives the same plan: the sum order, and so
    the bits, of every output."""
    for m in (1, 17, 266, 1024):
        assert wq.WqPlan.make(m, 2048, 2048, layout) == wq.WqPlan.make(m, 2048, 2048, layout)


def test_plan_refuses_empty_and_unknown():
    with pytest.raises(ValueError):
        wq.WqPlan.make(0, 2048, 2048, "kn")
    with pytest.raises(ValueError):
        wq.WqPlan.make(1, 2048, 2048, "int2")


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
    for fn in (t_qp.int8_matmul, t_qp.int8_matmul_nmajor, t_q4.int4_matmul, t_gemv.int8_gemv):
        monkeypatch.setattr(fn, "launches", 0)  # the counts come back after the test
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    return lib


def _operands(layout, m, k, n, x_dtype=torch.bfloat16):
    x = _card(torch.zeros((m, k), dtype=x_dtype))
    shape = {"kn": (k, n), "nk": (n, k), "int4": (k // 2, n)}[layout]
    return x, _card(torch.empty(shape, dtype=torch.int8)), _card(torch.ones(n))


_WRAPPERS = {"kn": t_qp.int8_matmul, "nk": t_qp.int8_matmul_nmajor, "int4": t_q4.int4_matmul}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("m", [1, 16, 17, 266])
@pytest.mark.parametrize("label,k,n", PROJECTIONS, ids=[p[0] for p in PROJECTIONS])
def test_wrappers_launch_their_plan_once(library, label, k, n, m, layout):
    """One C call per wrapper call, with the plan's route and split, and one
    launch counted (the GEMV route counts on the B11 wrapper, not on
    int8_gemv)."""
    fn = _WRAPPERS[layout]
    x, w, s = _operands(layout, m, k, n)
    out = fn(x, w, s)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    plan = wq.WqPlan.make(m, k, n, layout)
    [(name, args)] = library.calls
    assert fn.launches == 1 and t_gemv.int8_gemv.launches == 0
    if plan.route == "gemv":
        assert name == "pg_int8_gemv"
        assert args[5:12] == (m, k, n, 0, plan.cluster, plan.warps, plan.k_per_cta)
    elif plan.route == "int4_gemv":
        assert name == "pg_int4_gemv"
        assert args[4:10] == (m, k, n, plan.cluster, plan.warps, plan.k_per_cta)
    elif layout == "int4":
        assert name == "pg_int4_matmul"
        assert args[4:11] == (m, k, n, plan.rows, plan.cluster, plan.k_per_cta // wq.BK,
                              plan.ctas)
    else:
        assert name == "pg_int8_matmul"
        assert args[4:12] == (m, k, n, int(layout == "nk"), plan.rows, plan.cluster,
                              plan.k_per_cta // wq.BK, plan.ctas)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("what", ["x fp32", "x misaligned", "w int16", "w shape", "w strided",
                                  "s shape", "K rows", "N multiple"])
def test_operand_checks_raise(library, layout, what):
    """Operands the kernels do not take raise before any launch: dtypes,
    shapes, 16-byte aligned x and weights, the stored K rows a multiple of
    64, N a multiple of 16."""
    m, k, n = 17, 256, 208
    if what == "K rows":  # 160 int8 rows, 96 stored int4 rows: not multiples of 64
        k = 192 if layout == "int4" else 160
    if what == "N multiple":
        n = 200
    x, w, s = _operands(layout, m, k, n)
    if what == "x fp32":
        x = _card(torch.zeros((m, k)))
    elif what == "x misaligned":
        x = _card(torch.zeros(m * k + 1, dtype=torch.bfloat16)[1:].view(m, k))
    elif what == "w int16":
        w = _card(torch.empty(w.shape, dtype=torch.int16))
    elif what == "w shape":
        w = _card(torch.empty((w.shape[0], w.shape[1] + 16), dtype=torch.int8))
    elif what == "w strided":
        w = _card(torch.empty((w.shape[1], w.shape[0]), dtype=torch.int8).t())
    elif what == "s shape":
        s = _card(torch.ones(n + 1))
    fn = _WRAPPERS[layout]
    with pytest.raises(ValueError):
        fn(x, w, s)
    assert library.calls == [] and fn.launches == 0
