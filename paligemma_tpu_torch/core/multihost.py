"""Multi-host meshes over torch.distributed (port of
paligemma_tpu/core/multihost.py).

JAX runs one process per host: ``jax.distributed.initialize`` joins the
hosts' processes into one runtime and a global ``Mesh`` spans every chip,
each process feeding its host's devices. The port is SPMD with one process
per rank (core/mesh): here a "process" is one rank, which drives one card,
and a host runs as many ranks as it has cards. So ``num_processes`` and
``process_id`` count ranks, the ranks of a host are those that share its
host name, and what JAX calls a process's local devices is here the ranks
of its host. Number the processes host by host (host h holds ranks
``h * per_host ... (h + 1) * per_host - 1``, as torchrun numbers them).

Axis placement is JAX's: ``data`` crosses hosts, ``model`` (whose
collectives sit on every layer's critical path) stays inside a host's
ranks. With one process this is ``core/mesh.make_mesh``.

The backend: NCCL for the model axis when every rank has a card of its own
(cli/ranks' rule), else gloo (ranks that share a card, or the CPU); the
default group and the data axis are gloo (core/mesh).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import mesh as mesh_lib

TIMEOUT_S = 1800  # the default group's collectives (cli/ranks' model group has the same)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Join this process to the global group as rank ``process_id`` of
    ``num_processes``, through ``tcp://<coordinator_address>`` (host:port;
    rank 0 listens there). Without an address the group comes from the
    environment (``env://``: torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE``). ``local_device_ids``: the card this rank
    drives (one id; default ``LOCAL_RANK``, else ``process_id`` modulo the
    cards here); made current when CUDA is available. Idempotent: a second
    call does nothing. The group itself is gloo (see the module docstring)."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address needs num_processes and "
                             "process_id")
        init, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    else:
        init, world, rank = "env://", None, None
    if torch.cuda.is_available():
        if local_device_ids is not None:
            ids = list(local_device_ids) if isinstance(local_device_ids, Sequence) else [
                local_device_ids]
            if len(ids) != 1:
                raise ValueError("initialize: one process drives one card; pass one "
                                 f"local_device_id (got {ids})")
            card = ids[0]
        elif "LOCAL_RANK" in os.environ:
            card = int(os.environ["LOCAL_RANK"])
        else:
            card = (rank if rank is not None else int(os.environ.get("RANK", 0)))
            card %= torch.cuda.device_count()
        torch.cuda.set_device(card)
    kw = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group("gloo", init_method=init,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)


def _hosts(only_cpu: bool) -> Tuple[List[str], List[str]]:
    """(every rank's host name, every rank's device), in rank order."""
    card = torch.cuda.is_available() and not only_cpu
    dev = f"cuda:{torch.cuda.current_device()}" if card else "cpu"
    names: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(names, (socket.gethostname(), dev))
    return [n for n, _ in names], [d for _, d in names]


def make_multihost_mesh(data: Optional[int] = None, model: Optional[int] = None, *,
                        only_cpu: bool = False) -> mesh_lib.Mesh:
    """The global ``data`` x ``model`` mesh with the model axis inside each
    host. ``model`` defaults to the ranks per host, ``data`` to the rest
    (pure TP inside a host, pure DP across hosts); ``model`` must divide the
    ranks per host. Every rank calls it (it makes the mesh's groups).
    ``only_cpu``: the ranks compute on the CPU (gloo), cards or not. Not
    initialized (one process): the single-device mesh."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        if (data or 1) * (model or 1) != 1:
            raise ValueError(f"make_multihost_mesh: data {data} x model {model} with one "
                             "process")
        return mesh_lib.Mesh() if not dist.is_initialized() else mesh_lib.make_mesh(1, 1)
    hosts, devices = _hosts(only_cpu)
    world, me = len(hosts), dist.get_rank()
    per_host = hosts.count(hosts[me])
    model = per_host if model is None else model
    data = world // model if data is None else data
    assert per_host % model == 0, (
        f"model={model} must divide local device count {per_host}: the "
        "model axis must stay inside one host's ICI domain"
    )
    if data * model != world:
        raise ValueError(f"make_multihost_mesh: data {data} x model {model} != {world} "
                         "processes")
    for i in range(data):
        group = hosts[i * model:(i + 1) * model]
        if len(set(group)) != 1:
            raise ValueError("make_multihost_mesh: a model group spans hosts "
                             f"{sorted(set(group))}; number the processes host by host")
    own_card = all(d.startswith("cuda") for d in devices) and len(
        set(zip(hosts, devices))) == world
    group = dist.new_group(backend="nccl") if own_card else None
    return mesh_lib.make_mesh(data, model, group=group)


def global_batch_from_local(mesh: mesh_lib.Mesh, local_batch: Any,
                            spec: Tuple = mesh_lib.batch_spec()) -> Any:
    """This rank's rows as the batch it trains or serves on: ``local_batch``
    (a dict of arrays, this data shard's rows: those of
    ``process_local_rows``) as tensors, marked as already cut
    (core/mesh.LocalRows) so train/trainer takes them whole. JAX assembles
    one global array from the processes' parts; in SPMD the global batch is
    the ranks' rows side by side and nothing moves. Only the leading
    dimension on ``"data"`` (JAX's default spec) is supported."""
    if tuple(spec)[:1] != (mesh_lib.DATA,) or any(a is not None for a in tuple(spec)[1:]):
        raise ValueError(f"global_batch_from_local: spec {spec}; only the rows on 'data'")
    del mesh  # the rows are this rank's already
    return mesh_lib.LocalRows({k: torch.as_tensor(v) for k, v in local_batch.items()})


def process_local_rows(global_rows: int, *, mesh: Optional[mesh_lib.Mesh] = None) -> slice:
    """The rows of a globally indexed dataset this rank loads: a contiguous
    split over the data shards (sizes differ by at most one, the first
    shards taking the remainder, as in JAX). Ranks that share a data index
    (one model group) load the same rows. Without ``mesh`` every rank of
    the group is a shard of its own (JAX's split by process); not
    initialized, all rows."""
    if mesh is not None:
        n, p = mesh.data, mesh.data_index
    elif dist.is_initialized():
        n, p = dist.get_world_size(), dist.get_rank()
    else:
        n, p = 1, 0
    base, rem = divmod(global_rows, n)
    start = p * base + min(p, rem)
    return slice(start, start + base + (1 if p < rem else 0))
