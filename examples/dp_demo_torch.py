"""Data-parallel demo of paligemma_tpu_torch: the counterpart of
examples/dp_demo.py (the reference's DDP demo, ref: test.py:6-25) over the
port's mesh.

The same toy model, a Linear(100 -> 10) without bias trained by gradient
descent on a mean squared error, over a ``data`` axis of gloo ranks on the
CPU: one process per rank (SPMD), each holding its rows of the batch
(core/mesh.data_rows), dividing its sum of squared errors by the whole
batch's count and summing the gradients over the data axis
(core/mesh.data_sum), so every rank takes the step one process would take
on the whole batch. The port cannot draw JAX's PRNG, so the weights and
data are drawn with numpy from a seed (``arrays``). Rank 0 prints the five
losses:

    python examples/dp_demo_torch.py [--ranks 2]
"""

import argparse
import datetime
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paligemma_tpu_torch.core.mesh import data_rows, data_sum, make_mesh  # noqa: E402

STEPS = 5
LR = 0.1


def arrays(n_ranks: int, seed: int = 0):
    """(w (100, 10), x (8 n, 100), y (8 n, 10)) as float32, from ``seed``."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((100, 10)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8 * n_ranks, 100)).astype(np.float32)
    y = rng.standard_normal((8 * n_ranks, 10)).astype(np.float32)
    return w, x, y


def _rank(rank: int, world: int, init: str, seed: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(data=world, model=1)
        if rank == 0:
            print(f"mesh: data {mesh.data} x model {mesh.model} (gloo, CPU)", flush=True)
        w0, x, y = arrays(world, seed)
        rows = data_rows(len(x), mesh, "dp_demo batch")
        w = torch.from_numpy(w0)
        xs, ys = torch.from_numpy(x[rows]), torch.from_numpy(y[rows])
        for i in range(STEPS):
            w.requires_grad_(True)
            loss = ((xs @ w - ys) ** 2).sum() / y.size  # this shard's share of the mean
            (grad,) = torch.autograd.grad(loss, w)
            data_sum(grad, mesh)  # the gradient all-reduce
            loss = data_sum(loss.detach().clone(), mesh)
            w = (w.detach() - LR * grad)
            if rank == 0:
                print(f"step {i} loss {float(loss):.4f}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="data-parallel demo over gloo ranks on the CPU")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch.multiprocessing as mp

    store = tempfile.mkdtemp(prefix="dp_demo_")
    try:
        mp.start_processes(_rank, args=(args.ranks, f"file://{os.path.join(store, 'store')}",
                                        args.seed),
                           nprocs=args.ranks, start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
