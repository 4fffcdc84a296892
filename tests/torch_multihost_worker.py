"""Worker for tests/test_torch_train_mesh.py: one of N CPU processes of
the port's multi-host mesh (no JAX).

Run as:  python torch_multihost_worker.py <coordinator> <num_procs> <pid>

Joins the group through the coordinator (core/multihost.initialize),
builds a data x 1 mesh over the processes, loads only its rows of a
seeded global batch (process_local_rows, global_batch_from_local) and
prints the Trainer's loss over the whole batch (a LOSS line) and its row
range (a ROWS line), which the parent asserts on.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paligemma_tpu_torch.convert import init_params  # noqa: E402
from paligemma_tpu_torch.core import config as t_config  # noqa: E402

_BASE = t_config.tiny_test_config()
CFG = dataclasses.replace(
    _BASE, text_config=dataclasses.replace(_BASE.text_config, num_key_value_heads=1))
TC = dict(lora_rank=4, learning_rate=1e-3)
ROWS = 4


def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu", torch.float32)


def batch():
    """The global batch, the same on every process (a seeded stream)."""
    rng = np.random.default_rng(0)
    n_img = CFG.vision_config.num_patches
    ids = np.concatenate([np.full((ROWS, n_img), CFG.image_token_index),
                          rng.integers(3, 100, (ROWS, 8))], 1).astype(np.int32)
    ttype = (np.arange(ids.shape[1]) >= n_img + 3)[None].repeat(ROWS, 0).astype(np.int32)
    labels = np.where(ttype == 1, ids, -100).astype(np.int32)
    labels[-1] = -100  # the second process's rows hold fewer targets
    return {"pixel_values": rng.normal(size=(ROWS, 3, 28, 28)).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones_like(ids), "token_type_ids": ttype,
            "labels": labels}


def main():
    from paligemma_tpu_torch.core import multihost
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    multihost.initialize(coord, nproc, pid)
    multihost.initialize(coord, nproc, pid)  # idempotent
    mesh = multihost.make_multihost_mesh(nproc, 1, only_cpu=True)
    assert (mesh.data, mesh.model, mesh.data_index) == (nproc, 1, pid), mesh
    rows = multihost.process_local_rows(ROWS, mesh=mesh)
    print(f"ROWS {pid} {rows.start} {rows.stop}", flush=True)
    local = {k: v[rows] for k, v in batch().items()}
    tr = Trainer(params(), CFG, TrainConfig(**TC), mesh=mesh)
    loss, _ = tr.loss_and_grads(multihost.global_batch_from_local(mesh, local))
    print(f"LOSS {pid} {float(loss):.10f}", flush=True)
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "paligemma_tpu")]
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
