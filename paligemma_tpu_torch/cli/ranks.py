"""The ranks of the CLIs' mesh (``--data_parallel D --model_parallel M``).

The JAX package is single-controller: one process holds the whole mesh and
XLA places the collectives, so its CLIs build a mesh and go on. The port is
SPMD over torch.distributed (core/mesh): one process per rank, each holding
its slices (of the weights over the model axis, of the batch or the slots
over the data axis) and calling the collectives itself, so a CLI that
serves a D x M mesh needs D x M processes that each load the checkpoint and
run the same engine calls in the same order. This module starts them,
joins them into a group, builds the mesh (``core/mesh.make_mesh(D, M)``:
rank r is data index ``r // M`` and model rank ``r % M``) and gives each
its place (:class:`Rank`).

* Joining the group: under ``torchrun`` (``WORLD_SIZE`` in the
  environment) the process is one rank already and joins from the
  environment (``env://``). Otherwise the CLI spawns N processes with
  torch.multiprocessing (spawn start method: each imports the CLI module
  anew, so its entry stays under ``if __name__ == "__main__"``), joined
  through a ``file://`` store in a temporary directory.
* Devices and backend: rank r takes ``cuda:(r % device_count)``, or the
  CPU under ``--only_cpu``. The backend is NCCL when every rank has a card
  of its own, gloo when ranks share a card (its collectives stage CUDA
  tensors through host memory: every product stays on the card, but such a
  run shows correctness, not speed) or run on the CPU. Rank 0 prints the
  backend and the devices on a line of their own.
* Control: a second group, always gloo (``Rank.ops``), carries the CLI's
  own Python objects from rank 0 to the others: the request list of batch
  mode, the HTTP front end's engine calls. A follower waits there for as
  long as the front end has no call for it, so its timeout is an idle
  server's (:data:`IDLE_TIMEOUT`), not a collective's; the model group's
  is ``timeout_s``.
* Failure: a rank that raises ends the others (torch.multiprocessing
  terminates them; under torchrun, torchrun does), and the command exits
  nonzero: with the rank's own exit code (2 for a user error), or 1.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from ..core.mesh import Mesh, make_mesh
from .errors import CliError

IDLE_TIMEOUT = datetime.timedelta(days=30)  # the control group's: an idle server's wait
DEFAULT_TIMEOUT_S = 1800  # the model group's collectives


@dataclasses.dataclass
class Rank:
    """This process's place among the CLI's ranks."""

    rank: int
    world: int
    device: torch.device
    backend: str  # the model group's: "nccl" or "gloo"
    mesh: Mesh
    ops: Any  # the gloo group of the CLI's objects

    @property
    def data_index(self) -> int:
        """This rank's shard of the data axis."""
        return self.mesh.data_index

    @property
    def lead(self) -> bool:
        """Rank 0: it reads the requests, runs the front end and prints."""
        return self.rank == 0

    def say(self, *args, **kw) -> None:
        """``print`` on rank 0 only."""
        if self.lead:
            print(*args, **kw)

    def share(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank (pickled over the control group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.ops)
        return box[0]

    def agree(self, obj: Any, what: str, *, within_model: bool = False) -> None:
        """Raise unless every rank holds the same ``obj`` (e.g. the tokens
        each request read back, which every rank returns); with
        ``within_model``, every rank of this rank's model group (the same
        data index: e.g. the state of its shard's slots). Every rank calls
        it."""
        every: List[Any] = [None] * self.world
        dist.all_gather_object(every, obj, group=self.ops)
        if within_model:
            m = self.mesh.model
            every = every[self.data_index * m:(self.data_index + 1) * m]
        if any(o != every[0] for o in every[1:]):
            raise RuntimeError(f"the ranks disagree on {what}")


def devices(world: int, only_cpu: bool) -> List[torch.device]:
    """Each rank's device: ``cuda:(r % device_count)``, or the CPU."""
    if only_cpu:
        return [torch.device("cpu")] * world
    n = torch.cuda.device_count()
    if n == 0:
        raise CliError("no CUDA device found; pass --only_cpu to run on the CPU")
    return [torch.device("cuda", r % n) for r in range(world)]


def backend_for(devs: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    cards = [d for d in devs if d.type == "cuda"]
    return "nccl" if len(cards) == len(devs) and len(set(cards)) == len(devs) else "gloo"


Entry = Callable[[List[str], Rank], None]


def launch(entry: Entry, argv: Sequence[str], model_parallel: int, only_cpu: bool,
           timeout_s: float = DEFAULT_TIMEOUT_S, data_parallel: int = 1) -> None:
    """Run ``entry(argv, rank)`` on each of ``data_parallel x
    model_parallel`` ranks (module docstring) and return when all have
    returned; a failed rank makes this process exit nonzero. ``entry``
    must be a module-level function (the spawned processes import it by
    name)."""
    argv = list(argv)
    n = data_parallel * model_parallel
    devs = devices(n, only_cpu)  # no card: an error before any process starts
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise CliError(f"--data_parallel {data_parallel} x --model_parallel "
                           f"{model_parallel} under torchrun with {world} processes; pass "
                           f"--nproc_per_node {n}")
        _run_rank(int(os.environ["RANK"]), world, "env://", entry, argv, only_cpu, timeout_s,
                  data_parallel)
        return
    import torch.multiprocessing as mp

    store = tempfile.mkdtemp(prefix="paligemma_ranks_")
    try:
        ctx = mp.start_processes(
            _spawned, args=(n, f"file://{os.path.join(store, 'store')}", entry, argv, only_cpu,
                            timeout_s, data_parallel),
            nprocs=len(devs), start_method="spawn", join=False)
        try:
            while not ctx.join():
                pass
        except mp.ProcessExitedException as e:  # the others are terminated by join
            print(f"error: rank {e.error_index} exited with code {e.exit_code}",
                  file=sys.stderr)
            sys.exit(e.exit_code if e.exit_code and e.exit_code > 0 else 1)
        except mp.ProcessRaisedException as e:
            print(f"error: rank {e.error_index} failed:\n{e}", file=sys.stderr)
            sys.exit(1)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _spawned(rank: int, world: int, init: str, entry: Entry, argv: List[str], only_cpu: bool,
             timeout_s: float, data: int) -> None:
    # the ranks of one host: NCCL's bootstrap over the loopback device
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    _run_rank(rank, world, init, entry, argv, only_cpu, timeout_s, data)


def _run_rank(rank: int, world: int, init: str, entry: Entry, argv: List[str], only_cpu: bool,
              timeout_s: float, data: int = 1) -> None:
    """Join the group as ``rank``, run the entry, leave the group."""
    devs = devices(world, only_cpu)
    device = devs[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(devs)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        ops = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
        me = Rank(rank=rank, world=world, device=device, backend=backend,
                  mesh=make_mesh(data, world // data), ops=ops)
        mesh = f"; mesh data {data} x model {world // data}" if data > 1 else ""
        me.say(f"ranks: {world} over {backend}, devices {', '.join(map(str, devs))}{mesh}",
               file=sys.stderr, flush=True)
        entry(argv, me)
    finally:
        dist.destroy_process_group()
