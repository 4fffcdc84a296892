"""The training half of the mesh (CPU): the port's ``Trainer`` under
``make_mesh(2, 1)``, ``(1, 2)``, ``(2, 2)`` and ``(1, 4)``, with and
without ``fsdp=True``, against JAX's ``Trainer`` under the same meshes on
the conftest's 8 virtual devices; ``core/mesh.fsdp_param_specs`` against
JAX's; ``core/multihost`` as two processes through a coordinator.

Setup: tests/test_torch_train.py's tiny config with one KV head, and the
unmodified one (4 query heads over 2 KV heads: a KV head a rank at a
model axis of 2, two ranks a KV head at 4); weights from JAX's
``init_params`` at ``PRNGKey(0)`` moved over with
``convert.params_from_numpy``, the adapters JAX's ``init_lora`` at
``PRNGKey(1)``, fp32. Batches of 4 rows, made with numpy from a seed; the
second batch's last row has every label at -100, so under a data axis of 2
one shard holds fewer targets than the other.

Ranks: ``torch.multiprocessing`` spawns, once for the module, one set of
gloo ranks per mesh shape (a ``file://`` store in a temporary directory),
all three at once, while JAX's trainers run in this process. The spawned
entry ``_rank_main`` and this module's top level import no JAX. Each rank
runs every case of its mesh and returns (rank 0) the losses and the state
in one card's layout (``Trainer._state``: the trainable tree and the
optimizer's moments) after each step; every rank of a mesh must print the
same losses.

Cases: LoRA with accumulation and warmup (remat on, the flash route, whose
wrappers run their plain versions here) on 2 x 1, 1 x 2 and 2 x 2, and with
remat off and under ``fsdp=True`` at 2 x 2; a full fine-tune at 2 x 1 and
1 x 2; FSDP full fine-tune at 2 x 2, three steps; QLoRA over NF4 and int4
bases at 1 x 2; with two KV heads, LoRA at 1 x 2 and 1 x 4 and under
``fsdp=True`` at 2 x 2, a full fine-tune at 1 x 2 and 1 x 4 and FSDP full
fine-tune at 2 x 2; the save / restore round trip between one card and
each mesh.

Tolerances: losses within 2e-5 relative of JAX's (the port's one-card
Trainer holds 1e-5, JAX's sharded Trainer its unsharded one at 1e-4);
trained trees within 1e-5 relative plus 1 % of the learning rate per
update on all but 0.1 % of each leaf's elements, and every element within
a quarter of the learning rate per update. Adam divides a gradient by its
own size plus 1e-8, so an element whose gradient is near 1e-8 and whose
last digits the ranks sum in another order moves by a visibly different
fraction of a step (tests/test_torch_train.py; here up to 0.12 of it on 2
of a full fine-tune's 16384 elements of ``down``).
"""

import dataclasses
import datetime
import functools
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.core import config as t_config
from paligemma_tpu_torch.core import mesh as t_mesh

torch.set_num_threads(2)

LOSS_RTOL = 2e-5
TREE_RTOL = 1e-5
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
LORA = dict(lora_rank=4, learning_rate=5e-3, grad_accum_steps=2, warmup_steps=1)
FULL = dict(lora_rank=None, learning_rate=1e-3)
QGROUP = 32  # o's 64 rows in 2 blocks: a block a rank at m = 2
# case -> (TrainConfig kwargs, the port's own kwargs, meshes, batch seeds,
# base, the JAX run it is held to, the config's KV heads)
CASES = {
    "lora": (LORA, dict(use_flash=True), ("2x1", "1x2", "2x2"), (0, 1, 2, 3), None, "lora", 1),
    "lora_noremat": (LORA, dict(remat=False), ("2x2",), (0, 1, 2, 3), None, "lora", 1),
    "lora_fsdp": (LORA, dict(fsdp=True), ("2x2",), (0, 1, 2, 3), None, "lora", 1),
    "full": (FULL, {}, ("2x1", "1x2"), (0, 1), None, "full", 1),
    "fsdp": (dict(FULL, fsdp=True), {}, ("2x2",), (0, 1, 2), None, "fsdp", 1),
    "nf4": (dict(LORA, grad_accum_steps=1), {}, ("1x2",), (0, 1), "nf4", "nf4", 1),
    "int4": (dict(LORA, grad_accum_steps=1), {}, ("1x2",), (0, 1), "int4", "int4", 1),
    "lora_gqa": (LORA, dict(use_flash=True), ("1x2", "1x4"), (0, 1, 2, 3), None, "lora_gqa",
                 2),
    "lora_fsdp_gqa": (LORA, dict(fsdp=True), ("2x2",), (0, 1, 2, 3), None, "lora_gqa", 2),
    "full_gqa": (FULL, {}, ("1x2", "1x4"), (0, 1), None, "full_gqa", 2),
    "fsdp_gqa": (dict(FULL, fsdp=True), {}, ("2x2",), (0, 1, 2), None, "fsdp_gqa", 2),
}
RESUME_SEED = 2  # the step after the one-card state each mesh restores


def _cfg(cls, kv=1):
    """The tiny config with ``kv`` KV heads (2: as it is)."""
    base = cls.tiny_test_config()
    return dataclasses.replace(
        base, text_config=dataclasses.replace(base.text_config, num_key_value_heads=kv))


def _batch(seed, b=4):
    cfg = _cfg(t_config)
    rng = np.random.default_rng(seed)
    n_img, s_txt = cfg.vision_config.num_patches, 6
    ids = np.concatenate([np.full((b, n_img), cfg.image_token_index),
                          rng.integers(3, 100, (b, s_txt))], 1).astype(np.int32)
    ttype = np.concatenate([np.zeros((b, n_img + 2)), np.ones((b, s_txt - 2))],
                           1).astype(np.int32)
    labels = np.where(ttype == 1, ids, -100).astype(np.int32)
    if seed == 1:
        labels[-1] = -100  # a padding row: its data shard holds fewer targets
    return {"pixel_values": rng.normal(size=(b, 3, 28, 28)).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones_like(ids), "token_type_ids": ttype,
            "labels": labels}


def _tc(case):
    from paligemma_tpu_torch.train.trainer import TrainConfig

    tc, own, *_ = CASES[case]
    return TrainConfig(**{**tc, **own})


def _base(weights, kind):
    params, q = weights
    return params if kind is None else q[kind]


# ------------------------------------------------------------------ ranks ----
def _run_case(case, mesh, by_kv, out_dir=None):
    """(losses, the one-card-layout state after each step) of ``case``;
    ``by_kv``: KV heads -> (weights, adapters)."""
    from paligemma_tpu_torch.train.trainer import Trainer

    tc = _tc(case)
    kv = CASES[case][6]
    weights, lora = by_kv[kv]
    tr = Trainer(_base(weights, CASES[case][4]), _cfg(t_config, kv), tc, mesh=mesh,
                 lora=lora if tc.lora_rank is not None else None)
    losses, states = [], []
    for seed in CASES[case][3]:
        losses.append(tr.train_step(_batch(seed)))
        states.append(_copy(tr._state()))  # without a model axis it holds the live tensors
    if out_dir is not None and case in ("lora", "fsdp"):
        tr.save(os.path.join(out_dir, f"state_{case}"))
    return losses, states


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone() if torch.is_tensor(tree) else tree


def _resume(mesh, weights, lora, path):
    """Restore the one-card state at ``path`` and take one step."""
    from paligemma_tpu_torch.train.trainer import Trainer

    tr = Trainer(weights[0], _cfg(t_config), _tc("lora"), mesh=mesh, lora=lora)
    tr.restore(path)
    loss = tr.train_step(_batch(RESUME_SEED))
    return loss, tr._state()


def _rank_main(rank, world, data, init, weights_file, out_dir, one_card_state):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=240))
    try:
        by_kv = torch.load(weights_file, weights_only=False)
        mesh = t_mesh.make_mesh(data, world // data)
        name = f"{data}x{world // data}"
        out = {case: _run_case(case, mesh, by_kv, out_dir)
               for case, spec in CASES.items() if name in spec[2]}
        out["resume"] = _resume(mesh, *by_kv[1], one_card_state)
        every = [None] * world
        dist.all_gather_object(every, {k: v[0] for k, v in out.items()})
        assert all(e == every[0] for e in every), every  # every rank the same losses
        foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "paligemma_tpu")]
        assert not foreign, foreign  # the spawned ranks import no JAX
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "out.pt"))
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------- reference ----
@functools.lru_cache(maxsize=None)
def _jax_weights(kv=1):
    """JAX's params, its NF4 and int4 bases (group 32, unfused: the CLI's
    layout) and its adapters, as numpy trees, for ``kv`` KV heads."""
    import jax

    from paligemma_tpu.core import config as j_config
    from paligemma_tpu.models import paligemma as j_pg
    from paligemma_tpu.runtime.quantize import quantize_lm_for_training
    from paligemma_tpu.train import lora as j_lora

    cfg = _cfg(j_config, kv)
    jp = j_pg.init_params(jax.random.PRNGKey(0), cfg)
    q = {kind: quantize_lm_for_training(jp, kind=kind, group=QGROUP, fuse=False)
         for kind in ("nf4", "int4")}
    lo = j_lora.init_lora(jax.random.PRNGKey(1), cfg.text_config, LORA["lora_rank"],
                          8.0)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(jp), {k: to_np(v) for k, v in q.items()}, to_np(lo)


def _port_weights(kv=1):
    jp, q, lo = _jax_weights(kv)
    return ((params_from_numpy(jp, "cpu"), {k: params_from_numpy(v, "cpu") for k, v in q.items()}),
            params_from_numpy(lo, "cpu"))


def _jax_trainer(case, mesh_name):
    import jax

    from paligemma_tpu.core import config as j_config
    from paligemma_tpu.core import mesh as j_mesh
    from paligemma_tpu.train import trainer as j_trainer

    tc, _, _, _, base, _, kv = CASES[case]
    jp, q, _ = _jax_weights(kv)
    params = jp if base is None else q[base]
    mesh = j_mesh.make_mesh(*MESHES[mesh_name])
    return j_trainer.Trainer(jax.tree.map(jax.numpy.asarray, params), _cfg(j_config, kv),
                             j_trainer.TrainConfig(**tc), mesh=mesh,
                             rng=jax.random.PRNGKey(1))


def _jax_tree(tr):
    import jax

    tree = tr.lora if tr.lora is not None else {"lm": tr.params["lm"]}
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(case, mesh_name):
    """JAX's losses and trained tree after each step of ``case``'s batches,
    and one step more (seed 3) for the resume checks."""
    import jax.numpy as jnp

    tr = _jax_trainer(case, mesh_name)
    losses, trees = [], []
    for seed in CASES[case][3]:
        losses.append(tr.train_step({k: jnp.asarray(v) for k, v in _batch(seed).items()}))
        trees.append(_jax_tree(tr))
    extra = tr.train_step({k: jnp.asarray(v) for k, v in _batch(3).items()})
    return losses, trees, (extra, _jax_tree(tr))


def _one_card_state(path):
    """One card's trainer two LoRA steps in, saved for the meshes to resume;
    returns its next step (loss, state)."""
    from paligemma_tpu_torch.train.trainer import Trainer

    weights, lora = _port_weights()
    tr = Trainer(weights[0], _cfg(t_config), _tc("lora"), lora=lora)
    for seed in (0, 1):
        tr.train_step(_batch(seed))
    tr.save(path)
    return tr.train_step(_batch(RESUME_SEED)), tr._state()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh's rank 0 output ({"2x1": ..., ...}); JAX's runs and the
    one-card trainer's are made while the ranks run."""
    root = tmp_path_factory.mktemp("train_mesh")
    wf = str(root / "weights.pt")
    torch.save({kv: _port_weights(kv) for kv in (1, 2)}, wf)
    one_card = str(root / "one_card")
    resumed = _one_card_state(one_card)
    ctxs = {}
    for name, (d, m) in MESHES.items():
        (root / name).mkdir()
        ctxs[name] = tmp.start_processes(
            _rank_main, args=(d * m, d, str(root / name / "init"), wf, str(root / name),
                              one_card),
            nprocs=d * m, start_method="spawn", join=False)
    for case, spec in CASES.items():
        for name in spec[2]:
            _jax_run(spec[5], name)
    deadline = time.monotonic() + 300
    for name, ctx in ctxs.items():
        while not ctx.join(timeout=2):  # raises if a rank failed
            if time.monotonic() > deadline:
                for c in ctxs.values():
                    for p in c.processes:
                        p.kill()
                raise TimeoutError(f"the {name} ranks did not finish in 300 s")
    outs = {name: torch.load(str(root / name / "out.pt"), weights_only=False)
            for name in MESHES}
    return outs, resumed, root


def _assert_tree(got, want, lr, updates, what):
    """A port tree (tensors) against a JAX tree (numpy), leaf by leaf, after
    ``updates`` updates at ``lr`` (the module docstring's tolerances)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree(got[k], want[k], lr, updates, f"{what}.{k}")
        return
    got = got.detach().float().numpy()
    off = np.abs(got - want) > TREE_RTOL * np.abs(want) + 0.01 * lr * updates
    assert off.mean() <= 1e-3, (what, int(off.sum()), float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.25 * lr * updates, err_msg=what)


def _trained(state):
    return state["lora"] if "lora" in state else state["params"]


# ------------------------------------------------------------------ tests ----
@pytest.mark.parametrize("case,mesh", [(c, m) for c, spec in CASES.items() for m in spec[2]])
def test_mesh_trainer_matches_jax(ranks, case, mesh):
    """Losses and trained trees after every step against JAX's Trainer
    under the same mesh (for remat off and LoRA under FSDP: JAX's LoRA run,
    which neither changes)."""
    outs, _, _ = ranks
    losses, states = outs[mesh][case]
    want_losses, want_trees, _ = _jax_run(CASES[case][5], mesh)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    lr = CASES[case][0]["learning_rate"]
    for step, (state, want) in enumerate(zip(states, want_trees)):
        _assert_tree(_trained(state), want, lr, step + 1, f"{case} step {step}")
    if CASES[case][0].get("grad_accum_steps") == 2:
        # accumulation and warmup: the one update of the first three steps
        # has lr 0, so the adapters move on the fourth only
        b = [s["lora"]["layers"]["q"]["b"] for s in states]
        assert all(torch.equal(b[0], x) for x in b[1:3]) and not torch.equal(b[2], b[3])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_state_saved_on_one_card_resumes_under_a_mesh(ranks, mesh):
    """One card's state after two steps, restored under each mesh: the next
    step's loss, adapters and moments equal one card's own next step."""
    outs, (want_loss, want_state), _ = ranks
    loss, state = outs[mesh]["resume"]
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert state["opt_state"]["count"] == want_state["opt_state"]["count"]
    for key in ("mu", "nu"):
        for name, leaf in want_state["opt_state"][key]["layers"].items():
            for k, t in leaf.items():
                torch.testing.assert_close(state["opt_state"][key]["layers"][name][k], t,
                                           rtol=1e-4, atol=1e-9)
    torch.testing.assert_close(state["lora"]["layers"]["v"]["b"],
                               want_state["lora"]["layers"]["v"]["b"], rtol=TREE_RTOL,
                               atol=0.01 * LORA["learning_rate"])


@pytest.mark.parametrize("mesh,case", [("2x1", "lora"), ("1x2", "lora"), ("2x2", "lora"),
                                       ("2x2", "fsdp")])
def test_state_saved_under_a_mesh_resumes_on_one_card(ranks, mesh, case):
    """A mesh's state (rank 0 wrote it in one card's layout) restored by a
    one-card trainer: its tree is the mesh's, and one step more follows
    JAX's trainer under that mesh."""
    from paligemma_tpu_torch.train.trainer import Trainer

    outs, _, root = ranks
    weights, lora = _port_weights()
    tr = Trainer(weights[0], _cfg(t_config), _tc(case), lora=lora if case == "lora" else None)
    tr.restore(str(root / mesh / f"state_{case}"))
    saved = outs[mesh][case][1][-1]
    mine = tr._state()
    for a, b in zip(_flat(_trained(mine)), _flat(_trained(saved))):
        assert torch.equal(a, b)
    assert mine["opt_state"]["count"] == saved["opt_state"]["count"]
    _, want_trees, (want_loss, want_tree) = _jax_run(case, mesh)
    loss = tr.train_step(_batch(3))
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    lr = CASES[case][0]["learning_rate"]
    _assert_tree(_trained(tr._state()), want_tree, lr, len(want_trees) + 1, f"{case} resumed")


def _flat(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    return [tree]


def _spec_tree(tree):
    """A JAX PartitionSpec tree as the port's tuples, padded to each leaf's
    rank."""
    import jax
    from jax.sharding import PartitionSpec

    return jax.tree.map(lambda s: tuple(s), tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("which", ["tiny", "wide"])
def test_fsdp_param_specs_follow_jax(data, which):
    """``fsdp_param_specs`` against JAX's ``PartitionSpec``s on the same
    tree: every leaf where the TP specs agree gets JAX's data dimension
    (the largest free one the data axis divides, ties to the earliest, none
    under 64 KiB); where the port's TP rule differs (k and v of one KV head
    replicated, the patch embedding replicated), its data dimension follows
    JAX's rule on the port's spec."""
    import jax

    from paligemma_tpu.core import config as j_config
    from paligemma_tpu.core import mesh as j_mesh
    from paligemma_tpu.models import paligemma as j_pg
    from test_torch_tp import _jcfg

    jcfg = _cfg(j_config) if which == "tiny" else _jcfg()
    jp = j_pg.init_params(jax.random.PRNGKey(0), jcfg)
    want = _spec_tree(j_mesh.fsdp_param_specs(jp, j_mesh.make_mesh(data, 8 // data)))
    base_want = _spec_tree(j_mesh.param_specs(jp))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = t_mesh.fsdp_param_specs(tp, t_mesh.Mesh(data=data, model=8 // data))
    base_got = t_mesh.param_specs(tp)
    n_data = 0
    for (path, w), g, bw, bg, leaf in zip(
            jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.leaves(base_want, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.leaves(base_got, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.leaves(tp)):
        w = w + (None,) * (leaf.dim() - len(w))
        bw = bw + (None,) * (leaf.dim() - len(bw))
        n_data += t_mesh.DATA in g
        if bw == bg:
            assert g == w, jax.tree_util.keystr(path)
            continue
        free = [i for i in range(leaf.dim()) if bg[i] is None and leaf.shape[i] % data == 0
                and leaf.shape[i] > 1]
        small = leaf.numel() * leaf.element_size() < t_mesh.FSDP_MIN_BYTES
        if small or not free:
            assert g == bg
        else:
            ax = max(free, key=lambda i: leaf.shape[i])
            assert g == tuple(t_mesh.DATA if i == ax else a for i, a in enumerate(bg))
    assert n_data >= 4  # embed, and (wide) every large layer leaf
    assert t_mesh.fsdp_param_specs(tp, t_mesh.Mesh(data=1, model=8)) == base_got


def test_4bit_shards_on_a_block_boundary():
    """A 4-bit tree under a model axis: columns and their block scales for
    q / gate / up, whole packed rows and their blocks for o / down, the
    codebook whole; the shards' dequantized weights are the whole weight's
    slices, and ``unshard_params`` is the inverse. A row split inside a
    block raises ``ValueError``."""
    from paligemma_tpu_torch.kernels.quant import dequantize_4bit
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_training

    weights, _ = _port_weights()
    params = weights[0]
    for group, ok in ((32, True), (64, False)):
        q = quantize_lm_for_training(params, kind="nf4", group=group, fuse=False)
        for r in range(2):
            mesh = t_mesh.Mesh(model=2, rank=r)
            if not ok:
                with pytest.raises(ValueError, match="block"):
                    t_mesh.shard_params(q, mesh)
                continue
            shard = t_mesh.shard_params(q, mesh)["lm"]["layers"]
            whole = q["lm"]["layers"]
            for grp, name, dim in (("attn", "q", -1), ("attn", "o", -2), ("mlp", "gate", -1),
                                   ("mlp", "down", -2)):
                full = dequantize_4bit(whole[grp][name])
                n = full.shape[dim] // 2
                want = full.narrow(full.dim() + dim, r * n, n)
                assert torch.equal(dequantize_4bit(shard[grp][name]), want), (name, r)
                assert shard[grp][name]["grid"] is whole[grp][name]["grid"]
            assert shard["attn"]["k"] is whole["attn"]["k"]  # one KV head: whole


def test_multihost_helpers_without_a_group():
    """One process: all rows, the single-device mesh, a batch taken as this
    rank's rows."""
    from paligemma_tpu_torch.core import multihost

    assert multihost.process_local_rows(5) == slice(0, 5)
    assert multihost.make_multihost_mesh() == t_mesh.Mesh()
    with pytest.raises(ValueError):
        multihost.make_multihost_mesh(2, 1)
    batch = multihost.global_batch_from_local(t_mesh.Mesh(), {"a": np.arange(3)})
    assert isinstance(batch, t_mesh.LocalRows) and torch.equal(batch["a"], torch.arange(3))
    with pytest.raises(ValueError):
        multihost.global_batch_from_local(t_mesh.Mesh(), {}, (None, "data"))
    rows = [multihost.process_local_rows(7, mesh=t_mesh.Mesh(data=3, data_index=i))
            for i in range(3)]
    assert rows == [slice(0, 3), slice(3, 5), slice(5, 7)]  # JAX's split


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_multihost_mesh():
    """tests/torch_multihost_worker.py as two processes joined through
    ``--coordinator 127.0.0.1:<port>`` (core/multihost.initialize): each
    loads its own rows (process_local_rows over a data axis of 2), and
    both print the loss one process computes over the whole batch."""
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "torch_multihost_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, worker, coord, "2", str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for pid in range(2)]
    import torch_multihost_worker as worker_mod

    tr = Trainer(worker_mod.params(), worker_mod.CFG, TrainConfig(**worker_mod.TC))
    want = float(tr.loss_and_grads(worker_mod.batch())[0])
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out

    def parse(out, tag):
        return {ln.split()[1]: ln.split()[2:] for ln in out.splitlines() if ln.startswith(tag)}

    losses = [parse(o, "LOSS")[str(i)][0] for i, o in enumerate(outs)]
    rows = [tuple(map(int, parse(o, "ROWS")[str(i)])) for i, o in enumerate(outs)]
    assert losses[0] == losses[1], outs
    np.testing.assert_allclose(float(losses[0]), want, rtol=1e-6)
    assert rows == [(0, 2), (2, 4)]
