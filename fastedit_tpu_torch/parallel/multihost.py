"""Multi-process data-parallel sweeps and tensor-parallel groups across
processes (the counterpart of the JAX package's ``parallel/multihost.py``
and of its ``make_mesh`` over every process's devices).

The JAX package joins one controller process per host into one global
device mesh (``jax.distributed.initialize``) and runs one program over it.
Here each process runs its own replicas, joined by ``torch.distributed``
over gloo (NCCL refuses two ranks on one device, which is how a one-card
machine runs two processes).

The layout is ``make_mesh``'s: the global device list is rank-major (rank
0's devices, then rank 1's, each process's in order), laid row-major into
``(data, model)``, so tensor-parallel group g takes global devices
``[g k, (g + 1) k)`` (:func:`members`).  A group may take devices of several
processes: where ``k`` divides a process's device count every group lies in
one process; where the count divides ``k`` a group spans ``k / local`` whole
processes; otherwise a process holds parts of two groups.  A group that
spans processes reduces its row-parallel partials over a gloo subgroup of
its processes (:func:`subgroups`, ``parallel/tp.py``).

Sweep semantics, as in the JAX package: every process builds the same global
work list from the shared mapping file, every member of a group dispatches
the group's rows, and the process that holds the group's first device owns
them: it alone saves them (:func:`local_rows`, the JAX package's
``mesh.devices[:, 0]`` rule; ``PendingEdit.local_result``).
Filesystem-dependent decisions (``--skip_existing``, missing sources) are
agreed across the processes before chunking (:func:`agree_bits`).  The
members of a group that spans processes compute the same replicated
activations, so they need the same noise: an unseeded edit takes rank 0's
draw on every process (:func:`shared_seed`), as the JAX package broadcasts
process 0's seed, whose key is a replicated input of its one program.  A
seeded edit needs no broadcast.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List

import numpy as np
import torch
import torch.distributed as dist

# How long a rank waits for its peers in a collective: the sweep's one
# collective follows each process's editor load.
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join this process to the sweep's process group: gloo, with process 0
    listening at ``coordinator_address`` (``host:port``)."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=TIMEOUT,
    )


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_and_world() -> tuple[int, int]:
    """(this process's rank, the number of processes): (0, 1) outside a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def share_cards(cards: int, local_rank: int, local_world: int) -> List[int]:
    """The cards of a host that its process ``local_rank`` of ``local_world``
    takes: an equal share each (a card left over stays idle), or, with more
    processes than cards, one card each in turn (the two processes of a
    one-card host share it)."""
    if local_world >= cards:
        return [local_rank % cards]
    per = cards // local_world
    return list(range(local_rank * per, (local_rank + 1) * per))


def layout(hosts: list) -> List[List[int]]:
    """Each rank's cards, from every rank's ``(host name, cards)``: the
    processes that name one host share its cards in rank order
    (:func:`share_cards`).  Raises where two processes would hold different
    numbers of replicas, since the chunk's rows assume as many on each."""
    shares = []
    for rank, (host, cards) in enumerate(hosts):
        if cards < 1:
            raise RuntimeError(f"rank {rank} on {host} sees no CUDA device")
        peers = [r for r, (h, _) in enumerate(hosts) if h == host]
        shares.append(share_cards(cards, peers.index(rank), len(peers)))
    if len({len(s) for s in shares}) > 1:
        raise ValueError(
            f"the processes would hold {[len(s) for s in shares]} replicas: every process "
            "of a sweep needs as many (the same number of cards per process on each host)")
    return shares


def local_devices(cards: int | None = None) -> List[torch.device]:
    """The CUDA devices this process's replicas use: every local card
    outside a process group, else this process's share of its host's
    (:func:`layout`; every process of the group must call it, since it
    gathers each one's host name and card count).  ``cards`` stands for
    ``torch.cuda.device_count()``."""
    cards = torch.cuda.device_count() if cards is None else cards
    rank, world = rank_and_world()
    if world == 1:
        return [torch.device("cuda", i) for i in range(cards)]
    hosts = [None] * world
    dist.all_gather_object(hosts, (socket.gethostname(), cards))
    return [torch.device("cuda", i) for i in layout(hosts)[rank]]


def members(world: int, local: int, k: int) -> List[List[tuple]]:
    """Every tensor-parallel group's members, ``(rank, local index, shard
    index)`` in shard order, for ``world`` processes of ``local`` devices
    each and groups of ``k``: group g takes global devices ``[g k, (g + 1)
    k)`` of the rank-major list, as ``make_mesh`` lays them.  Raises where
    ``k`` does not divide ``world * local``, as ``make_mesh`` asserts."""
    n = world * local
    if k < 1 or n % k:
        raise ValueError(f"model_parallel={k} does not divide the {n} devices of "
                         f"{world} processes x {local}")
    return [[((g * k + j) // local, (g * k + j) % local, j) for j in range(k)]
            for g in range(n // k)]


def owner(group_members: list) -> int:
    """The rank that owns a group's rows: the one holding its first device."""
    return group_members[0][0]


def ranks_of(group_members: list) -> List[int]:
    """The distinct ranks of a group's members, ascending."""
    return sorted({r for r, _, _ in group_members})


def spans_processes(group) -> bool:
    """True when the replica group includes other processes' replicas."""
    return group.world > 1


def groups_span(world: int, local: int, k: int) -> bool:
    """True when some tensor-parallel group of the layout spans processes."""
    return any(len(ranks_of(m)) > 1 for m in members(world, local, k))


def rows_per_group(group, batch: int) -> int:
    """The rows each group of the replica ``group`` takes of a chunk of
    ``batch``: ``batch // shape["data"]``, in group order; raises where
    they do not split evenly."""
    n = group.shape["data"]
    if batch % n:
        raise ValueError(f"a batch of {batch} rows does not split over {n} replicas")
    return batch // n


def _rows(group, batch: int, wanted) -> List[int]:
    """The rows of the groups ``wanted(members)`` picks."""
    per = rows_per_group(group, batch)
    return [row for g, m in enumerate(members(group.world, group.local, group.model_parallel))
            if wanted(m) for row in range(g * per, (g + 1) * per)]


def local_rows(group, batch: int) -> List[int]:
    """Global batch-row indices this process owns: the rows of the JAX
    package's ``P('data')`` sharding that land on its devices of the mesh's
    first model column (``mesh.devices[:, 0]``), i.e. the rows of every
    group whose first device is this process's (:func:`owner`).  These are
    the rows it saves."""
    return _rows(group, batch, lambda m: owner(m) == group.rank)


def computed_rows(group, batch: int) -> List[int]:
    """Global batch-row indices this process computes: the rows of every
    group it holds a shard of (its own rows, and those of groups another
    process owns)."""
    return _rows(group, batch, lambda m: group.rank in ranks_of(m))


def subgroups(world: int, local: int, k: int, rank: int) -> dict:
    """``{group index: gloo process group}`` for the groups of the layout
    that span processes and hold a shard of this ``rank``.  Every process
    must call it (``dist.new_group`` for every such group, in group order,
    member or not), or the processes deadlock."""
    out = {}
    for g, m in enumerate(members(world, local, k)):
        ranks = ranks_of(m)
        if len(ranks) > 1:
            pg = dist.new_group(ranks, timeout=TIMEOUT, backend="gloo")
            if rank in ranks:
                out[g] = pg
    return out


def shared_seed() -> int:
    """A fresh 32-bit seed drawn by rank 0 and broadcast to every process
    (the JAX package's ``broadcast_one_to_all`` of process 0's seed)."""
    seed = torch.tensor([int.from_bytes(os.urandom(4), "little")], dtype=torch.int64)
    dist.broadcast(seed, src=0)
    return int(seed.item())


def agree_bits(bits) -> np.ndarray:
    """The element-wise maximum of an integer array over every process (the
    JAX package's ``process_allgather(bits).max(axis=0)``)."""
    t = torch.as_tensor(np.asarray(bits, dtype=np.int32))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.numpy()
