"""Training (port of paligemma_tpu/train/trainer.py): AdamW with
global-norm clipping, warmup, gradient accumulation and remat, on one card
or over a ``data`` x ``model`` mesh (core/mesh).

Two modes, as in the reference: full fine-tune of the LM with the vision
tower and projector frozen, or LoRA, where only the adapter tree (a, b and
alpha of every target) gets gradients and optimizer state.

The optimizer reproduces optax's ``MultiSteps(chain(clip_by_global_norm,
adamw))`` step by step (see :class:`Optimizer`) and updates the trainable
tensors in place. The trainable tensors belong to the trainer: LoRA
adapters are its own, and a full fine-tune works on a copy of the trained
subtree, so the caller's ``params`` keep their values, as in the reference.

Under a mesh (one process per rank, SPMD; every rank builds the trainer
from the same whole ``params`` and feeds it the same whole batches):

* each rank keeps its slices (core/mesh.shard_params; the adapters, drawn
  whole from the same generator on every rank, by shard_lora) and its
  rows of each batch (core/mesh.data_rows: a batch that does not split
  over the data axis raises ``ValueError``, as JAX's ``device_put`` does);
* the forward runs tensor parallel over the model axis (models/gemma
  ``forward_train(mesh=)``), the loss divides each rank's token-loss sum
  by the batch's count of targets (train/losses), and the gradients are
  summed over the data axis; over the model axis the gradients of the
  leaves each rank holds whole but uses only with its own heads or
  columns are summed too (the adapters' replicated halves and alphas,
  and in a full fine-tune the single KV head's k and v), and where
  ``model / Hkv`` ranks share a KV head (core/mesh ``kv_layout``
  "shared"), the gradients of its k and v slices (weights, or the k / v
  adapters' B) are summed over those ranks (core/mesh.sum_shared);
* the clipping norm counts a replicated leaf once and a sharded leaf's
  shards summed (a shared KV head's slice once): one card's norm;
* ``fsdp=True`` at ``data > 1`` is ZeRO-3 over core/mesh.fsdp_param_specs:
  between steps a rank holds 1/data of every chosen leaf of ``params``
  (the trained ones with their gradients and moments; the frozen base
  under LoRA), the model gathers each layer where it runs (and again in
  its remat recompute), the gradients come back summed and cut to the
  shard, and the optimizer updates the shard. At ``data == 1`` or without
  a mesh it changes nothing, as in the reference;
* ``save`` / ``restore`` / ``merged_params`` use one card's layout:
  ``save`` gathers the state and rank 0 writes it, ``restore`` reads it on
  every rank and keeps that rank's slices, so a state moves between meshes
  and one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import mesh as mesh_lib
from ..core.config import PaliGemmaConfig
from ..models import paligemma
from . import losses, lora as lora_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    grad_accum_steps: int = 1
    warmup_steps: int = 0
    lora_rank: Optional[int] = 8  # None => full fine-tune of the LM
    lora_alpha: float = 8.0
    freeze_vision: bool = True  # a full fine-tune leaves vision + projector frozen
    remat: bool = True
    use_flash: Optional[bool] = None  # None => on when the parameters are on CUDA
    # FSDP / ZeRO-3: shard params, gradients and optimizer state over the
    # mesh's "data" axis too (core/mesh.fsdp_param_specs); no-op without a
    # mesh or at data == 1
    fsdp: bool = False


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unflatten(tree, leaves: List[torch.Tensor]):
    """``leaves`` (in ``_leaves(tree)`` order) laid out as ``tree``."""
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


# the optimizer state's lists aligned with the trainable leaves
_PER_LEAF = ("mu", "nu", "acc")


class Optimizer:
    """optax's ``chain(clip_by_global_norm(c), adamw(lr, weight_decay=wd))``,
    wrapped in ``MultiSteps(k)`` when k > 1, with the same semantics:

    * clipping scales by ``c / |g|`` only when ``|g| >= c`` (no epsilon);
    * Adam with b1 0.9, b2 0.999, eps 1e-8 outside the square root and
      bias correction; decoupled weight decay on the pre-update parameter;
    * with warmup, ``linear_schedule(0, lr, warmup)`` read at the update
      count before it increments, so the first update has lr 0;
    * with accumulation, the chain runs on the running mean of k gradients
      (clipped as a whole) every k-th step, and the parameters stay as they
      are in between.

    State (``init``): plain ints and lists of tensors aligned with the
    parameter list, so ``torch.save`` / ``torch.load(weights_only=True)``
    round-trip it. The moments take each parameter's dtype, as optax's do."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig, norm_sq=None):
        self.tc = tc
        # the squared global norm of a gradient list; None: one card's sum
        self.norm_sq = norm_sq

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        state = {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        if self.tc.grad_accum_steps > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=[torch.zeros_like(p) for p in params])
        return state

    def learning_rate(self, count: int) -> float:
        """The schedule at update ``count`` (fp32, as optax computes it)."""
        lr, warmup = np.float32(self.tc.learning_rate), self.tc.warmup_steps
        if warmup <= 0:
            return float(lr)
        frac = np.float32(1) - np.float32(min(max(count, 0), warmup)) / np.float32(warmup)
        return float((np.float32(0) - lr) * frac + lr)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict[str, Any]) -> bool:
        """Apply one update in place; returns whether the parameters moved
        (False on the accumulating steps of ``MultiSteps``)."""
        k = self.tc.grad_accum_steps
        if k > 1:
            n = state["mini_step"]
            acc = [a + (g - a) / (n + 1) for a, g in zip(state["acc"], grads)]
            state["mini_step"] = (n + 1) % k
            if n != k - 1:
                state["acc"] = acc
                return False
            state["acc"] = [torch.zeros_like(a) for a in acc]
            state["gradient_step"] += 1
            grads = acc
        self._chain(params, grads, state)
        return True

    def _chain(self, params, grads, state):
        tc = self.tc
        if self.norm_sq is None:
            g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        else:
            g_norm = torch.sqrt(self.norm_sq(grads))
        keep = g_norm < tc.grad_clip
        grads = [torch.where(keep, g, (g / g_norm.to(g.dtype)) * tc.grad_clip) for g in grads]
        count = state["count"] + 1
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        step_size = -self.learning_rate(state["count"])
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g * g + self.b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if tc.weight_decay:
                upd = upd + tc.weight_decay * p
            p.copy_(p + step_size * upd)
        state["count"] = count


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def _pairs(like, tree, where=""):
    """``tree`` in ``like``'s key order (a restore pairs leaves by name),
    raising ``ValueError`` where the keys differ."""
    if not isinstance(like, dict):
        return tree
    if not isinstance(tree, dict) or set(tree) != set(like):
        raise ValueError(f"checkpoint tree differs at {where or 'the root'}")
    return {k: _pairs(like[k], tree[k], f"{where}/{k}") for k in like}


class Trainer:
    """The training step over the parameters' device, on one card or over
    ``mesh`` (module docstring).

    Batch dict (numpy arrays or tensors): pixel_values (B, C, H, W),
    input_ids (B, S), attention_mask (B, S), token_type_ids (B, S)
    [0 = prefix, 1 = suffix], labels (B, S) with -100 ignored: the whole
    batch on every rank of a mesh, or this rank's rows as a core/mesh
    ``LocalRows`` (core/multihost.global_batch_from_local).

    ``lora``: adapters to start from (default: ``init_lora`` drawn from
    ``generator``, seed 0 on the parameters' device)."""

    def __init__(
        self,
        params: Params,
        config: PaliGemmaConfig,
        train_config: TrainConfig = TrainConfig(),
        mesh: Optional[mesh_lib.Mesh] = None,
        generator: Optional[torch.Generator] = None,
        *,
        lora: Optional[Params] = None,
    ):
        self.config = config
        self.tc = tc = train_config
        self.mesh = mesh
        self.device = params["lm"]["embed"].device
        self.use_flash = tc.use_flash if tc.use_flash is not None else self.device.type == "cuda"
        # the model axis the forward shards over (None under pure DP) and
        # the data axis the rows split over
        tp, self._data = mesh_lib.split_axes(mesh)
        self._tp = tp = None if tp is None or tp.model == 1 else tp
        # k / v are cut by KV heads; ranks holding the same slice (core/mesh)
        self._kv_heads = kv = config.text_config.num_key_value_heads
        self._kv_share = 1 if tp is None else mesh_lib.kv_share(kv, tp.model)
        if tc.lora_rank is not None:
            if lora is None:
                if generator is None:
                    generator = torch.Generator(self.device).manual_seed(0)
                lora = lora_lib.init_lora(generator, config.text_config, tc.lora_rank,
                                          tc.lora_alpha)
            lora = _map(lambda t: t.detach().clone(), lora)
            self._lspecs = mesh_lib.lora_specs(lora, kv_heads=kv) if tp is not None else None
            self.lora = lora if tp is None else mesh_lib.shard_lora(lora, tp, kv_heads=kv)
        else:
            self.lora = None
            params = self._with_trainable(
                params, _map(lambda t: t.detach().clone(), self._trainable(params, None)))
            if tp is not None and any(n in params["lm"]["layers"][g] for g, n in
                                      (("attn", "qkv"), ("mlp", "gateup"))):
                raise ValueError("a full fine-tune under a model axis trains unfused q / k / v "
                                 "and gate / up (runtime.quantize's fuse=False layout)")
        pspecs = mesh_lib.param_specs(params, kv_heads=kv) if tp is not None else None
        self._fsdp = None
        self._dims = None
        fspecs = None
        if tc.fsdp and self._data is not None:
            fspecs = mesh_lib.fsdp_param_specs(params, mesh, kv_heads=kv)
        self.params = params if tp is None else mesh_lib.shard_params(params, tp, kv_heads=kv)
        if fspecs is not None:
            self._fspecs = fspecs
            self.params, self._dims = mesh_lib.shard_data(self.params, fspecs, mesh)
            self._fsdp = mesh_lib.Fsdp(mesh, self.params, self._dims)
        self._flags = self._leaf_flags(pspecs)
        self.opt = make_optimizer(tc)
        if mesh is not None:
            self.opt.norm_sq = self._norm_sq
        self.opt_state = self.opt.init(_leaves(self._trainable(self.params, self.lora)))

    # ------------------------------------------------------------------
    def _trainable(self, params, lora):
        if self.tc.lora_rank is not None:
            return lora
        if self.tc.freeze_vision:
            return {"lm": params["lm"]}
        return params

    def _with_trainable(self, params, trainable):
        """``params`` with the trainable subtree of a full fine-tune swapped in."""
        if self.tc.freeze_vision:
            return {**params, "lm": trainable["lm"]}
        return trainable

    def _leaf_flags(self, pspecs) -> List[Tuple[bool, bool, bool, int]]:
        """Per trainable leaf: (sharded over the model axis, sharded over the
        data axis, its gradient a partial to sum over the model axis, the
        ranks that hold the same slice: ``model / Hkv`` for a shared KV
        head's k and v, else 1)."""
        n = len(_leaves(self._trainable(self.params, self.lora)))
        if self.mesh is None:
            return [(False, False, False, 1)] * n
        if self._tp is None:
            model = [(None, ())] * n
        elif self.lora is not None:
            model = _leaves(_map_specs(self._lspecs))
        else:
            model = _leaves(_map_specs(self._trainable(pspecs, None)))
        tdims = self._trainable_dims()
        dims = [None] * n if tdims is None else [d for d, _ in _leaves(_map_specs(tdims))]
        flags = []
        for (spec, names), dim in zip(model, dims):
            sharded = spec is not None and mesh_lib.MODEL in spec
            # a replicated adapter leaf meets only this rank's heads or
            # columns; of the weights, only the single KV head's k and v
            partial = spec is not None and not sharded and (
                self.lora is not None or ("attn" in names and names[-1] in ("k", "v")))
            lm_kv = (names[-2:-1] in (("k",), ("v",)) if self.lora is not None
                     else names[:1] == ("lm",) and "attn" in names and names[-1] in ("k", "v"))
            share = self._kv_share if sharded and lm_kv else 1
            flags.append((sharded, dim is not None, partial, share))
        return flags

    def _norm_sq(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One card's squared global norm from this rank's gradients: a
        replicated leaf once, a sharded leaf's shards summed over its axes."""
        sums = {key: [] for key in ((False, False), (True, False), (False, True), (True, True))}
        for g, (m, d, _, share) in zip(grads, self._flags):
            sums[(m, d)].append((g.float() ** 2).sum() / share)
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        tot = {k: torch.stack(v).sum() if v else zero for k, v in sums.items()}
        over_m = mesh_lib.model_sum(torch.stack([tot[(True, False)], tot[(True, True)]]),
                                    self._tp)
        over_d = mesh_lib.data_sum(torch.stack([tot[(False, True)], over_m[1]]), self._data)
        return tot[(False, False)] + over_m[0] + over_d[0] + over_d[1]

    def _rows(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows of ``batch`` on the device."""
        if isinstance(batch, mesh_lib.LocalRows) or self._data is None:
            rows = slice(None)
        else:
            rows = mesh_lib.data_rows(len(batch["input_ids"]), self._data, "Trainer batch")
        return {k: torch.as_tensor(v)[rows].to(self.device) for k, v in batch.items()}

    def loss_and_grads(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The batch's loss and its gradients with respect to the trainable
        leaves (in the order of the trainable tree), without an update.
        Under a mesh: the whole batch's loss, and this rank's gradients,
        already summed over the ranks (those of its own slices)."""
        batch = self._rows(batch)
        leaves = _leaves(self._trainable(self.params, self.lora))
        for t in leaves:
            t.requires_grad_(True)
        try:
            logits = paligemma.forward_train(
                self.params, self.config, batch["pixel_values"], batch["input_ids"],
                batch["attention_mask"], batch["token_type_ids"], lora=self.lora,
                remat=self.tc.remat, use_flash=self.use_flash, mesh=self._tp, fsdp=self._fsdp)
            loss = losses.causal_lm_loss(logits, batch["labels"], self.config.ignore_index,
                                         mesh=self._data)
            grads = list(torch.autograd.grad(loss, leaves))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        if self.mesh is not None:
            for i, (g, (_, d, partial, share)) in enumerate(zip(grads, self._flags)):
                g = g.contiguous()
                if partial:
                    mesh_lib.model_sum(g, self._tp)
                elif share > 1:
                    mesh_lib.sum_shared(g, self._tp, self._kv_heads)
                if not d:  # an FSDP shard's gradient came back summed
                    mesh_lib.data_sum(g, self._data)
                grads[i] = g
            loss = mesh_lib.data_sum(loss.detach().clone(), self._data)
        return loss.detach(), grads

    def train_step(self, batch: Dict[str, Any]) -> float:
        loss, grads = self.loss_and_grads(batch)
        self.opt.step(_leaves(self._trainable(self.params, self.lora)), grads, self.opt_state)
        return float(loss)

    # ---------------------------------------------- one card's layout ----
    def _full(self, tree, dims):
        """A trainable-shaped tree (the trained leaves, or moments) in one
        card's layout, the joined leaves in host memory: the model slices
        joined, then the data shards (collective under a mesh)."""
        if self.mesh is None:
            return tree
        tp = self._tp
        if tp is not None:
            if self.lora is not None:
                tree = mesh_lib.unshard_lora(tree, self._lspecs, tp, kv_heads=self._kv_heads,
                                             host=True)
            else:
                tree = {k: mesh_lib.unshard_params(v, tp, kv_heads=self._lm_kv(k), host=True)
                        for k, v in tree.items()}
        if dims is not None:
            tree = mesh_lib.unshard_data(tree, dims, self.mesh, host=True)
        return tree

    def _local(self, full, like, fspecs):
        """A trainable-shaped tree in one card's layout cut to this rank's
        slices, on ``like``'s devices and dtypes (``like``: this rank's
        tree; its shapes are checked)."""
        full = _pairs(like, full)
        tp = self._tp
        if tp is not None:
            full = (mesh_lib.shard_lora(full, tp, kv_heads=self._kv_heads)
                    if self.lora is not None
                    else mesh_lib.shard_params(full, tp, kv_heads=self._kv_heads))
        if fspecs is not None:
            full = mesh_lib.shard_data(full, fspecs, self.mesh)[0]

        def place(t, ref):
            if t.shape != ref.shape:
                raise ValueError(f"checkpoint tensor {tuple(t.shape)} where this trainer holds "
                                 f"{tuple(ref.shape)}")
            return t.to(device=ref.device, dtype=ref.dtype)

        return _map2(place, full, like)

    def _lm_kv(self, key: str) -> Optional[int]:
        """``unshard_params``'s ``kv_heads`` for the subtree ``key``: the
        LM's KV heads for "lm"; the vision tower's k and v are as wide as
        q."""
        return self._kv_heads if key == "lm" else None

    def _trainable_dims(self):
        if self._dims is None or self.lora is not None:
            return None
        return self._trainable(self._dims, None)

    def _trainable_fspecs(self):
        if self._dims is None or self.lora is not None:
            return None
        return self._trainable(self._fspecs, None)

    def _state(self):
        """The training state in one card's layout: the trainable tree and
        the optimizer state, whose per-leaf moments are trees keyed like the
        trainable tree, so a restore pairs them by name whatever order the
        restoring trainer's adapter dict was built in."""
        trainable = self._trainable(self.params, self.lora)
        dims = self._trainable_dims()
        state = {"opt_state": {k: self._full(_unflatten(trainable, v), dims)
                               if k in _PER_LEAF else v for k, v in self.opt_state.items()}}
        whole = self._full(trainable, dims)
        state["lora" if self.lora is not None else "params"] = whole
        return state

    def _barrier(self) -> None:
        """Every rank of the mesh waits for the others (rank 0's write)."""
        if self._tp is not None:
            torch.distributed.barrier(group=self._tp.group)
        if self._data is not None:
            torch.distributed.barrier(group=self._data.data_group)

    def save(self, path: str) -> None:
        """Checkpoint the trainable tree and the optimizer state (resume), in
        one card's layout; under a mesh every rank calls it and rank 0
        writes."""
        from ..checkpoints.local import save_pytree

        state = self._state()
        if self.mesh is None or (self.mesh.rank == 0 and self.mesh.data_index == 0):
            save_pytree(path, state)
        self._barrier()

    def restore(self, path: str) -> None:
        """Read a state of one card's layout (saved by any mesh or one card)
        and keep this rank's slices."""
        from ..checkpoints.local import restore_pytree

        state = restore_pytree(path)
        key = "lora" if self.lora is not None else "params"
        if set(state) != {key, "opt_state"}:
            raise ValueError(f"checkpoint {path} holds {sorted(state)}, not {key!r} and "
                             "'opt_state' (a LoRA state restores into a LoRA trainer, a full "
                             "fine-tune's into a full fine-tune)")
        trainable = self._trainable(self.params, self.lora)
        fspecs = self._trainable_fspecs()
        opt = state["opt_state"]
        if set(opt) != set(self.opt_state):
            raise ValueError(f"checkpoint {path}: optimizer state {sorted(opt)} differs from "
                             f"{sorted(self.opt_state)} (grad_accum_steps)")
        self.opt_state = {k: _leaves(self._local(v, trainable, fspecs)) if k in _PER_LEAF
                          else v for k, v in opt.items()}
        local = self._local(state[key], trainable, fspecs)
        if self.lora is not None:
            self.lora = local
        else:
            self.params = self._with_trainable(self.params, local)
            if self._fsdp is not None:
                self._fsdp = mesh_lib.Fsdp(self.mesh, self.params, self._dims)

    def merged_params(self) -> Params:
        """Parameters with the adapters folded in (for the inference engine),
        in one card's layout (under a mesh every rank calls it and gets the
        whole tree)."""
        params = self.params
        if self.mesh is not None:
            with torch.no_grad():
                if self._tp is not None:
                    params = {k: mesh_lib.unshard_params(v, self._tp, kv_heads=self._lm_kv(k))
                              for k, v in params.items()}
                if self._dims is not None:
                    params = mesh_lib.unshard_data(params, self._dims, self.mesh)
        if self.lora is None:
            return params
        lora = self.lora if self._tp is None else mesh_lib.unshard_lora(
            self.lora, self._lspecs, self._tp, kv_heads=self._kv_heads)
        with torch.no_grad():
            return {**params, "lm": lora_lib.merge_lora(params["lm"], lora)}


def _map2(fn, tree, like):
    if isinstance(like, dict):
        return {k: _map2(fn, tree[k], like[k]) for k in like}
    return fn(tree, like)


def _map_specs(tree, names=()):
    """A spec (or dims) tree as (leaf, path) pairs, in the trainable
    tree's leaf order."""
    if isinstance(tree, dict):
        return {k: _map_specs(v, names + (k,)) for k, v in tree.items()}
    return (tree, names)
