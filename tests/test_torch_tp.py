"""The port's tensor-parallel kernels and sharding against the JAX
package's (CPU, the conftest's 8 virtual devices, Pallas in interpret mode).

Per module, in one process (a hand-built ``Mesh`` names the rank; no
process group is needed to shard or to run one rank's kernels):
``mlp_decode_fused`` (B7b), ``attn_decode_tp`` (B7) and
``attn_decode_paged_tp`` (B8) on rank r of m against the JAX functions on
the same local slices, and ``repack_for_tp`` against the JAX
``repack_for_tp`` arrays sliced by their specs. The engines as a whole, on
m processes: tests/test_torch_tp_serving.py.
"""

import functools

import numpy as np
import pytest
import torch

from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.core.config import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig
from paligemma_tpu_torch.core.mesh import Mesh, make_mesh
from paligemma_tpu_torch.kernels import decode_layer_paged_tp as t_ptp
from paligemma_tpu_torch.kernels import decode_layer_tp as t_tp
from paligemma_tpu_torch.kernels import decode_mlp as t_mlp

torch.set_num_threads(2)

N_IMG = 4  # 28 px / 14 px patches
HD = 256


def _cfg(vocab=256, cls=(PaliGemmaConfig, SiglipVisionConfig, GemmaConfig)):
    """tests/test_decode_layer_tp.py:147 (``_pg_cfg``) in either package's
    config classes."""
    pg, sv, gm = cls
    return pg(
        vision_config=sv(image_size=28, patch_size=14, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, projection_dim=256),
        text_config=gm(vocab_size=vocab, hidden_size=256, intermediate_size=2048,
                       num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=1,
                       head_dim=HD, max_position_embeddings=256),
        projection_dim=256, hidden_size=256, image_token_index=250, vocab_size=vocab,
    )


def _jcfg(vocab=256):
    from paligemma_tpu.core import config as jc

    return _cfg(vocab, (jc.PaliGemmaConfig, jc.SiglipVisionConfig, jc.GemmaConfig))


@functools.lru_cache(maxsize=None)
def _weights(vocab=256, seed=0):
    """JAX params (fp32) and the int8 tree JAX quantized; the port's copies."""
    import jax

    from paligemma_tpu.models import paligemma as j_pg
    from paligemma_tpu.runtime.quantize import quantize_lm_for_serving

    jp = j_pg.init_params(jax.random.PRNGKey(seed), _jcfg(vocab))
    jq = quantize_lm_for_serving(jp)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jp, jq, to_port(jp), to_port(jq)


def _local(arr, spec, m, r):
    """Rank r's slice of a JAX array by its PartitionSpec."""
    a = np.asarray(arr)
    for d, name in enumerate(tuple(spec)):
        if name == "model":
            n = a.shape[d] // m
            a = np.take(a, np.arange(r * n, (r + 1) * n), axis=d)
    return a


@functools.lru_cache(maxsize=None)
def _jax_packed(m):
    """JAX repack_for_tp of the int8 tree on make_mesh(1, m), numpy."""
    import jax

    from paligemma_tpu.core.mesh import make_mesh as j_make_mesh
    from paligemma_tpu.kernels import decode_layer_tp as j_tp

    _, jq, _, _ = _weights()
    packed, specs = j_tp.repack_for_tp(jq["lm"], _jcfg().text_config, j_make_mesh(1, m))
    return jax.tree.map(np.asarray, packed), specs


def _jax_local(m, r):
    """Rank r's slices of the JAX packed tree (the kernels' local operands)."""
    import jax

    packed, specs = _jax_packed(m)
    return jax.tree.map(lambda a, s: _local(a, s, m, r), packed, specs)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_repack_for_tp_matches_jax_slices(m):
    """Each rank's tree holds exactly the JAX repack_for_tp arrays sliced by
    their specs: [q_r | k | v], [gate_r | up_r], o / down rows, the vocab
    shards of the embedding and the int8 head; norms whole."""
    _, _, _, tq = _weights()
    cfg = _cfg().text_config
    for r in range(m):
        got = t_tp.repack_for_tp(tq["lm"], cfg, Mesh(model=m, rank=r))
        want = _jax_local(m, r)
        att, mlp = got["layers"]["attn"], got["layers"]["mlp"]
        eq = np.array_equal
        assert eq(att["qkv"]["w8"], np.concatenate([want["q_w8"], want["kv_w8"]], -1))
        assert eq(att["qkv"]["s"], np.concatenate([want["q_s"], want["kv_s"]], -1)[:, 0])
        assert eq(att["o"]["w8"], want["o_w8"]) and eq(att["o"]["s"], want["o_s"][:, 0])
        unblk = lambda b: b.transpose(0, 2, 1, 3).reshape(b.shape[0], b.shape[2], -1)  # noqa: E731
        jm = want["mlp"]
        assert eq(mlp["gateup"]["w8"], np.concatenate([unblk(jm["gate_blk"]),
                                                       unblk(jm["up_blk"])], -1))
        assert eq(mlp["gateup"]["s"], np.concatenate([jm["gs"].reshape(jm["gs"].shape[0], -1),
                                                      jm["us"].reshape(jm["us"].shape[0], -1)],
                                                     -1))
        assert eq(mlp["down"]["w8"], jm["down_w8"]) and eq(mlp["down"]["s"], jm["ds"][:, 0])
        assert eq(got["layers"]["input_norm"], want["input_norm"][:, 0])
        assert eq(got["layers"]["post_norm"], want["post_norm"][:, 0])
        assert eq(got["head_q"]["w8"], want["head"]["w8"])
        assert eq(got["head_q"]["s"], want["head"]["s"])
        assert eq(got["embed"], want["embed"]) and eq(got["final_norm"], want["final_norm"])


def test_supported_gating():
    """tests/test_decode_layer_tp.py:130: a mesh is needed, and the heads
    must split over the model axis."""
    _, _, _, tq = _weights()
    layers, cfg = tq["lm"]["layers"], _cfg().text_config
    assert t_tp.supported(cfg, Mesh(model=2), layers, batch=2)
    assert t_ptp.supported(cfg, Mesh(model=8), layers, batch=8, page_size=16)
    assert not t_tp.supported(cfg, None, layers, batch=1)
    assert not t_ptp.supported(cfg, Mesh(model=2), layers, batch=2, page_size=12)
    bad = GemmaConfig(vocab_size=256, hidden_size=256, intermediate_size=2048,
                      num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=1,
                      head_dim=256, max_position_embeddings=128)
    assert not t_tp.supported(bad, Mesh(model=4), layers, batch=1)
    with pytest.raises(ValueError, match="repack_for_tp"):
        t_tp.repack_for_tp(tq["lm"], bad, Mesh(model=4))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(data=2)  # a data axis too needs the process group (tests/test_torch_dp.py)


@pytest.mark.parametrize("out_dtype", [torch.float32, None])
def test_mlp_decode_fused_matches_jax_every_layer(out_dtype):
    """B7b on the whole int8 MLP, every layer, against the JAX kernel
    (interpret mode; tests/test_decode_mlp.py:31). The fp32 partial within
    1e-3 of max|ref| (the same fp32 products, summed in another order); the
    bf16 output within 1e-2 (a bf16 rounding of the GeGLU input apart)."""
    import jax.numpy as jnp

    from paligemma_tpu.kernels import decode_mlp as j_mlp

    _, jq, _, tq = _weights()
    y = (np.random.default_rng(0).standard_normal((3, 256)) * 0.5).astype(np.float32)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    for layer in range(2):
        got = t_mlp.mlp_decode_fused(yb, tq["lm"]["layers"]["mlp"], layer, out_dtype=out_dtype)
        want = j_mlp.mlp_decode_fused(
            jnp.asarray(y, jnp.bfloat16), j_mlp.repack(jq["lm"]["layers"]["mlp"]), layer,
            interpret=True, out_dtype=jnp.float32 if out_dtype is not None else None)
        want = np.asarray(want, np.float32)
        assert got.dtype == (out_dtype or torch.bfloat16) and got.shape == (3, 256)
        tol = (1e-3 if out_dtype is not None else 1e-2) * np.abs(want).max()
        assert np.abs(got.float().numpy() - want).max() <= tol


def _attn_inputs(b=2, s_len=64, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, 256)) * 0.5).astype(np.float32)
    kc = (rng.standard_normal((2, b, s_len, HD)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((2, b, s_len, HD)) * 0.5).astype(np.float32)
    pos = np.array([9, 23][:b], np.int32)
    ang = rng.random((b, HD)).astype(np.float32) * 6.28
    return x, kc, vc, pos, np.cos(ang), np.sin(ang)


def _bf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_attn_half_matches_jax_on_each_shard(m, paged):
    """B7 / B8 on ranks 0 and m-1 against the JAX function on the same
    local slices, layer 1: the fp32 o partial within 1e-2 of max|ref| (bf16
    activations, reduction orders apart), k_new / v_new and the written
    cache rows within 5e-2 absolute (test_decode_layer_tp.py:113)."""
    import jax.numpy as jnp

    from paligemma_tpu.kernels import decode_layer_paged_tp as j_ptp
    from paligemma_tpu.kernels import decode_layer_tp as j_tp

    _, _, _, tq = _weights()
    cfg = _cfg().text_config
    x, kc, vc, pos, cos, sin = _attn_inputs()
    b, w, layer, ps = x.shape[0], 32, 1, 16
    eps = cfg.rms_norm_eps
    valid = np.arange(w)[None] <= pos[:, None]
    bias = np.where(valid, 0.0, -np.inf).astype(np.float32)
    posmask = (np.arange(w)[None] == pos[:, None]).astype(np.float32)
    jargs = (jnp.asarray(x, jnp.bfloat16),)
    cs = (jnp.asarray(cos, jnp.bfloat16), jnp.asarray(sin, jnp.bfloat16))
    for r in (0, m - 1):
        local = t_tp.repack_for_tp(tq["lm"], cfg, Mesh(model=m, rank=r))["layers"]
        jl = _jax_local(m, r)
        jlocal = {k: jnp.asarray(v) for k, v in jl.items() if k in (
            "q_w8", "q_s", "kv_w8", "kv_s", "o_w8", "o_s", "input_norm")}
        kt, vt = _bf(kc), _bf(vc)
        if not paged:
            part, kn, vn = t_tp.attn_decode_tp(
                _bf(x), local, kt, vt, layer, valid=torch.from_numpy(valid),
                cache_pos=torch.from_numpy(pos), cos=_bf(cos), sin=_bf(sin), head_dim=HD, eps=eps)
            wpart, wk, wv = j_tp.attn_decode_tp(
                *jargs, jlocal, jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
                jnp.asarray(layer, jnp.int32), jnp.asarray(bias), jnp.asarray(posmask), *cs,
                w, HD, eps, interpret=True)
            written = (kt[layer, np.arange(b), pos], vt[layer, np.arange(b), pos])
        else:
            # each row's window is 2 pages of a fragmented table; the pool
            # holds the dense cache's rows at those pages
            table = np.array([[5, 2], [1, 7]], np.int32)
            pool_k = np.zeros((2, 9, ps, HD), np.float32)
            pool_v = np.zeros_like(pool_k)
            for row in range(b):
                for j in range(2):
                    pool_k[:, table[row, j]] = kc[:, row, j * ps:(j + 1) * ps]
                    pool_v[:, table[row, j]] = vc[:, row, j * ps:(j + 1) * ps]
            pk, pv = _bf(pool_k), _bf(pool_v)
            part, kn, vn = t_ptp.attn_decode_paged_tp(
                _bf(x), local, pk, pv, layer, page_table=torch.from_numpy(table),
                write_pos=torch.from_numpy(pos), cos=_bf(cos), sin=_bf(sin), pages_bucket=2,
                head_dim=HD, eps=eps)
            start = table[:, 0]
            wpart, wk, wv = j_ptp.attn_decode_paged_tp(
                *jargs, jlocal, jnp.asarray(pool_k, jnp.bfloat16),
                jnp.asarray(pool_v, jnp.bfloat16), jnp.asarray(layer, jnp.int32),
                jnp.asarray(start), jnp.zeros((b,), jnp.int32), jnp.asarray(table),
                jnp.asarray(bias), jnp.asarray(posmask), *cs, HD, eps, interpret=True)
            slot = [(table[row, pos[row] // ps], pos[row] % ps) for row in range(b)]
            written = (torch.stack([pk[layer, p, o] for p, o in slot]),
                       torch.stack([pv[layer, p, o] for p, o in slot]))
        wpart = np.asarray(wpart, np.float32)
        assert part.dtype == torch.float32 and part.shape == (b, 256)
        assert np.abs(part.numpy() - wpart).max() <= 1e-2 * np.abs(wpart).max()
        for got, want in ((kn, wk), (vn, wv), (written[0], wk), (written[1], wv)):
            assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() <= 5e-2


def test_pick_first_max_ties_go_to_the_lowest_shard():
    maxes = torch.tensor([[1.0, 3.0, 2.0], [2.0, 3.0, 2.0], [0.5, 3.0, 1.0]])
    ids = torch.tensor([[5, 9, 7], [130, 140, 150], [260, 270, 280]], dtype=torch.int32)
    assert t_tp.pick_first_max(maxes, ids).tolist() == [130, 9, 7]


# (query heads, KV heads, model axis): the layouts the port takes, each
# rank's KV heads, and those it refuses
KV_LAYOUTS = [(4, 2, 2, "split"), (8, 4, 2, "split"), (4, 4, 4, "split"), (4, 2, 4, "shared"),
              (8, 2, 8, "shared"), (8, 1, 4, "whole")]
KV_REFUSED = [(6, 3, 2), (12, 6, 4), (12, 3, 2)]


def _kv_trees(hq, hkv, hd=8, hidden=16, layers=2, rank=2, seed=0):
    """A dense LM tree (unfused attention), an int8 one (fused qkv, as
    runtime.quantize lays it out) and a LoRA tree at these heads."""
    g = torch.Generator().manual_seed(seed)
    nq, nkv = hq * hd, hkv * hd

    def f(*shape):
        return torch.randn(shape, generator=g)

    def i8(k, n):
        return {"w8": torch.randint(-127, 128, (layers, k, n), generator=g, dtype=torch.int8),
                "s": f(layers, n).abs()}

    mlp = {"gate": f(layers, hidden, 32), "up": f(layers, hidden, 32),
           "down": f(layers, 32, hidden)}
    dense = {"layers": {"attn": {"q": f(layers, hidden, nq), "k": f(layers, hidden, nkv),
                                 "v": f(layers, hidden, nkv), "o": f(layers, nq, hidden)},
                        "mlp": mlp, "input_norm": f(layers, hidden)}}
    int8 = {"layers": {"attn": {"qkv": i8(hidden, nq + 2 * nkv), "o": i8(nq, hidden)},
                       "mlp": {"gateup": i8(hidden, 64), "down": i8(32, hidden)}}}
    lora = {"layers": {t: {"a": f(layers, k, rank), "b": f(layers, rank, n)} for t, k, n in (
        ("q", hidden, nq), ("k", hidden, nkv), ("v", hidden, nkv), ("o", nq, hidden))}}
    return dense, int8, lora


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    return [tree]


def _unshard_all(shards, fn, monkeypatch):
    """``fn(rank 0's shard, mesh)`` with the model group's gather answered
    from every rank's shard (no process group): a leaf of rank 0 maps to
    the same leaf of each rank."""
    from paligemma_tpu_torch.core import mesh as t_mesh

    m = len(shards)
    by_ptr = {}
    for leaves in zip(*(_leaves(s) for s in shards)):
        by_ptr[(leaves[0].data_ptr(), tuple(leaves[0].shape))] = leaves
    monkeypatch.setattr(t_mesh, "_gather_model", lambda x, mesh, host=False: torch.stack(
        by_ptr[(x.data_ptr(), tuple(x.shape))]))
    return fn(shards[0], Mesh(model=m, rank=0))


@pytest.mark.parametrize("hq,hkv,m,layout", KV_LAYOUTS)
def test_kv_layouts_shard_and_round_trip(hq, hkv, m, layout, monkeypatch):
    """``local_text_config`` gives each rank Hq/m query heads and its KV
    heads (Hkv/m split, one shared or whole); ``shard_params`` and
    ``shard_lora`` give rank r the k / v columns of exactly the KV heads its
    query heads read (head h reads KV head h // (Hq / Hkv)), q and o of its
    own heads; ``unshard_params`` / ``unshard_lora`` give the whole trees
    back, the dense, the fused int8 and the LoRA one."""
    from paligemma_tpu_torch.core import mesh as t_mesh

    hd = 8
    cfg = GemmaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                      num_attention_heads=hq, num_key_value_heads=hkv, head_dim=hd)
    local = t_mesh.local_text_config(cfg, m)
    assert t_mesh.kv_layout(hkv, m) == layout
    assert local.num_attention_heads == hq // m
    assert local.num_key_value_heads == (hkv // m if layout == "split" else 1)
    assert t_mesh.kv_share(hkv, m) == (m // hkv if layout == "shared" else 1)
    dense, int8, lora = _kv_trees(hq, hkv, hd)
    group = hq // hkv
    for r in range(m):
        mesh = Mesh(model=m, rank=r)
        heads = range(r * hq // m, (r + 1) * hq // m)
        kv_heads = sorted({h // group for h in heads})
        assert len(kv_heads) == local.num_key_value_heads
        cols = torch.cat([torch.arange(h * hd, (h + 1) * hd) for h in kv_heads])
        qcols = torch.cat([torch.arange(h * hd, (h + 1) * hd) for h in heads])
        got = t_mesh.shard_params(dense, mesh, kv_heads=hkv)["layers"]["attn"]
        assert torch.equal(got["q"], dense["layers"]["attn"]["q"][..., qcols])
        assert torch.equal(got["o"], dense["layers"]["attn"]["o"][:, qcols])
        for n in ("k", "v"):
            assert torch.equal(got[n], dense["layers"]["attn"][n][..., cols]), (r, n)
        qkv = t_mesh.shard_params(int8, mesh, kv_heads=hkv)["layers"]["attn"]["qkv"]["w8"]
        whole = int8["layers"]["attn"]["qkv"]["w8"]
        nq, nkv = hq * hd, hkv * hd
        want = torch.cat([whole[..., qcols], whole[..., nq + cols], whole[..., nq + nkv + cols]],
                         -1)
        assert torch.equal(qkv, want), r
        lo = t_mesh.shard_lora(lora, mesh, kv_heads=hkv)["layers"]
        for n in ("k", "v"):
            assert torch.equal(lo[n]["b"], lora["layers"][n]["b"][..., cols])
            assert torch.equal(lo[n]["a"], lora["layers"][n]["a"])
    specs = t_mesh.lora_specs(lora, kv_heads=hkv)
    assert (t_mesh.MODEL in specs["layers"]["k"]["b"]) == (layout != "whole")
    for tree in (dense, int8):
        shards = [t_mesh.shard_params(tree, Mesh(model=m, rank=r), kv_heads=hkv)
                  for r in range(m)]
        back = _unshard_all(shards, lambda t, mesh: t_mesh.unshard_params(t, mesh, kv_heads=hkv),
                            monkeypatch)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(tree)))
    shards = [t_mesh.shard_lora(lora, Mesh(model=m, rank=r), kv_heads=hkv) for r in range(m)]
    back = _unshard_all(shards, lambda t, mesh: t_mesh.unshard_lora(t, specs, mesh,
                                                                    kv_heads=hkv), monkeypatch)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(lora)))


@pytest.mark.parametrize("hq,hkv,m", KV_REFUSED)
def test_kv_layouts_refused(hq, hkv, m):
    """KV heads that neither divide nor are divided by the model axis: the
    local config, the sharding and the specs raise, naming the layouts the
    port takes."""
    from paligemma_tpu_torch.core import mesh as t_mesh

    cfg = GemmaConfig(vocab_size=48, hidden_size=16, intermediate_size=48, num_hidden_layers=2,
                      num_attention_heads=hq, num_key_value_heads=hkv, head_dim=8)
    dense, _, lora = _kv_trees(hq, hkv)
    for call in (lambda: t_mesh.local_text_config(cfg, m),
                 lambda: t_mesh.shard_params(dense, Mesh(model=m, rank=0), kv_heads=hkv),
                 lambda: t_mesh.shard_lora(lora, Mesh(model=m, rank=0), kv_heads=hkv)):
        with pytest.raises(NotImplementedError, match="one KV head"):
            call()
