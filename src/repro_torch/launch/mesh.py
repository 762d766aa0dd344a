"""The federated execution mesh over ``torch.distributed`` ranks.

The port's counterpart of the JAX package's ``launch/mesh.py:
engine_mesh``. There the engine re-views whatever devices exist as
("client", "dsub", "model") and shards the stacked client axis over
"client"; here the devices are processes, one a rank, and the launch
(``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``) says how
many there are. ``engine_mesh(cohorts)`` splits W ranks as client x dsub
by the JAX package's rule: the client width is the widest divisor of
both W and the cohort count. Client shard s trains the contiguous
cohort block ``[s C / client, (s + 1) C / client)``; the dsub ranks of
one shard hold the same cohorts as replicas. The port has no "model"
axis (no tensor parallelism). The server state is replicated on every
rank, as the JAX package replicates the global params across the
client axis, and the federated aggregation is the only cross-rank
traffic (``sharding.ctx``).

The backend is NCCL when every rank of the host has a card of its own,
gloo when ranks share a card (``cuda:{LOCAL_RANK % device_count}``) or
run on the CPU; under gloo the collectives stage device tensors through
the host. A failed NCCL initialisation raises: nothing falls back to
gloo or to the CPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device


def client_width(world: int, cohorts: int = 0) -> int:
    """The JAX package's rule: the widest divisor of ``world`` that also
    divides ``cohorts`` (any divisor when ``cohorts`` <= 0)."""
    client = 1
    for d in range(1, world + 1):
        if world % d == 0 and (cohorts <= 0 or cohorts % d == 0):
            client = d
    return client


@dataclass(frozen=True)
class FLMesh:
    """``client`` x ``dsub`` ranks; this process is ``rank`` of
    ``group`` (None: the degenerate one-process mesh, no collective).
    ``devices`` holds every rank's device, in rank order."""

    client: int = 1
    dsub: int = 1
    rank: int = 0
    group: object = None
    backend: str = "none"
    devices: tuple = ()

    @property
    def world(self) -> int:
        return self.client * self.dsub

    @property
    def shard(self) -> int:
        """This rank's client shard (ranks s * dsub ... (s + 1) * dsub - 1
        hold shard s, as the JAX mesh reshapes its devices)."""
        return self.rank // self.dsub

    @property
    def writer(self) -> bool:
        """Rank 0 evaluates, prints and writes files."""
        return self.rank == 0

    def cohorts(self, C: int) -> slice:
        """This rank's contiguous block of the C cohort slots."""
        if C % self.client:
            raise ValueError(f"{C} cohorts do not split over a client "
                             f"width of {self.client}")
        n = C // self.client
        return slice(self.shard * n, (self.shard + 1) * n)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def describe(self) -> str:
        return (f"mesh: world {self.world} = client {self.client} x dsub "
                f"{self.dsub}, backend {self.backend}, devices "
                f"{', '.join(self.devices) or 'this process only'}")


def _backend(device: torch.device, world: int) -> str:
    if device.type == "cpu":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def engine_mesh(cohorts: int = 0, device=None) -> FLMesh:
    """The mesh of this launch for ``cohorts`` cohorts a round.

    Without ``WORLD_SIZE`` in the environment: the degenerate mesh, no
    process group. With it (even at 1): this rank joins the default
    process group (``env://``: ``MASTER_ADDR``/``MASTER_PORT``, as
    torchrun sets them), or takes the one already initialised, which
    must have this launch's size, rank and backend. ``device`` is the
    rank's device as ``utils.device.resolve_device`` gives it."""
    if "WORLD_SIZE" not in os.environ:
        return FLMesh()
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    backend = _backend(dev, world)
    if backend == "nccl" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if backend == "nccl":
            dist.init_process_group("nccl", rank=rank, world_size=world,
                                    device_id=dev)
        else:
            dist.init_process_group("gloo", rank=rank, world_size=world)
    have = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
    if have != (world, rank, backend):
        raise ValueError(
            f"the initialised process group is (world, rank, backend) = "
            f"{have}; this launch needs {(world, rank, backend)}")
    devices = [None] * world
    dist.all_gather_object(devices, str(dev))
    client = client_width(world, cohorts)
    return FLMesh(client=client, dsub=world // client, rank=rank,
                  group=dist.group.WORLD, backend=backend,
                  devices=tuple(devices))
