"""Training on one GPU (port of paligemma_tpu/train/trainer.py):
AdamW with global-norm clipping, warmup, gradient accumulation and remat.

Two modes, as in the reference: full fine-tune of the LM with the vision
tower and projector frozen, or LoRA, where only the adapter tree (a, b and
alpha of every target) gets gradients and optimizer state. The mesh and
FSDP of the reference are not ported: they raise ``NotImplementedError``.

The optimizer reproduces optax's ``MultiSteps(chain(clip_by_global_norm,
adamw))`` step by step (see :class:`Optimizer`) and updates the trainable
tensors in place. The trainable tensors belong to the trainer: LoRA
adapters are its own, and a full fine-tune works on a copy of the trained
subtree, so the caller's ``params`` keep their values, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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
    fsdp: bool = False  # sharded training: not ported (raises)


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

    def __init__(self, tc: TrainConfig):
        self.tc = tc

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
        g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
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


class Trainer:
    """One-GPU training step over the parameters' device.

    Batch dict (numpy arrays or tensors): pixel_values (B, C, H, W),
    input_ids (B, S), attention_mask (B, S), token_type_ids (B, S)
    [0 = prefix, 1 = suffix], labels (B, S) with -100 ignored.

    ``lora``: adapters to start from (default: ``init_lora`` drawn from
    ``generator``, seed 0 on the parameters' device)."""

    def __init__(
        self,
        params: Params,
        config: PaliGemmaConfig,
        train_config: TrainConfig = TrainConfig(),
        mesh=None,
        generator: Optional[torch.Generator] = None,
        *,
        lora: Optional[Params] = None,
    ):
        if mesh is not None or train_config.fsdp:
            raise NotImplementedError("paligemma_tpu_torch trains on one GPU: no mesh, no FSDP")
        self.config = config
        self.tc = tc = train_config
        self.device = params["lm"]["embed"].device
        self.use_flash = tc.use_flash if tc.use_flash is not None else self.device.type == "cuda"
        if tc.lora_rank is not None:
            if lora is None:
                if generator is None:
                    generator = torch.Generator(self.device).manual_seed(0)
                lora = lora_lib.init_lora(generator, config.text_config, tc.lora_rank,
                                          tc.lora_alpha)
            self.lora = _map(lambda t: t.detach().clone(), lora)
            self.params = params
        else:
            self.lora = None
            self.params = self._with_trainable(
                params, _map(lambda t: t.detach().clone(), self._trainable(params, None)))
        self.opt = make_optimizer(tc)
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

    def loss_and_grads(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The batch's loss and its gradients with respect to the trainable
        leaves (in the order of the trainable tree), without an update."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        leaves = _leaves(self._trainable(self.params, self.lora))
        for t in leaves:
            t.requires_grad_(True)
        try:
            logits = paligemma.forward_train(
                self.params, self.config, batch["pixel_values"], batch["input_ids"],
                batch["attention_mask"], batch["token_type_ids"], lora=self.lora,
                remat=self.tc.remat, use_flash=self.use_flash)
            loss = losses.causal_lm_loss(logits, batch["labels"], self.config.ignore_index)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return loss.detach(), list(grads)

    def train_step(self, batch: Dict[str, Any]) -> float:
        loss, grads = self.loss_and_grads(batch)
        self.opt.step(_leaves(self._trainable(self.params, self.lora)), grads, self.opt_state)
        return float(loss)

    def _state(self):
        # per-leaf moments are saved as trees keyed like the trainable
        # tree, so a restore pairs them by name whatever order the
        # restoring trainer's adapter dict was built in
        trainable = self._trainable(self.params, self.lora)
        state = {"opt_state": {k: _unflatten(trainable, v) if k in _PER_LEAF else v
                               for k, v in self.opt_state.items()}}
        if self.lora is not None:
            state["lora"] = self.lora
        else:
            state["params"] = self._trainable(self.params, None)
        return state

    def save(self, path: str) -> None:
        """Checkpoint the trainable tree and the optimizer state (resume)."""
        from ..checkpoints.local import save_pytree

        save_pytree(path, self._state())

    def restore(self, path: str) -> None:
        from ..checkpoints.local import restore_pytree

        state = restore_pytree(path, like=self._state())
        # the trees come back in this trainer's key order: flatten in it
        self.opt_state = {k: _leaves(v) if k in _PER_LEAF else v
                          for k, v in state["opt_state"].items()}
        if self.lora is not None:
            self.lora = state["lora"]
        else:
            self.params = self._with_trainable(self.params, state["params"])

    def merged_params(self) -> Params:
        """Parameters with the adapters folded in (for the inference engine)."""
        if self.lora is None:
            return self.params
        with torch.no_grad():
            return {**self.params, "lm": lora_lib.merge_lora(self.params["lm"], self.lora)}
