"""Multi-process data-parallel sweeps (the counterpart of the JAX package's
``parallel/multihost.py``).

The JAX package joins one controller process per host into one global
device mesh (``jax.distributed.initialize``) and runs one program over it.
Here each process runs its rows through its own replicas, so only host
integers cross processes: ``torch.distributed`` over gloo (NCCL refuses two
ranks on one device, which is how a one-card machine runs two processes).

Sweep semantics, as in the JAX package: every process builds the same global
work list from the shared mapping file, and each edits and saves only the
rows it owns (``PendingEdit.local_result``).  Filesystem-dependent
decisions (``--skip_existing``, missing sources) are agreed across the
processes before chunking (:func:`agree_bits`).  The JAX package also
broadcasts process 0's seed where none is given, because its key is a
replicated input of one program; here an unseeded row takes its own
process's draw, which is what an unseeded generator gives anyway, and a
seeded sweep gives every row the same noise stream on every process.
"""

from __future__ import annotations

import datetime
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


def spans_processes(group) -> bool:
    """True when the replica group includes other processes' replicas."""
    return group.world > 1


def local_rows(group, batch: int) -> List[int]:
    """Global batch-row indices this process owns: the rows of the JAX
    package's ``P('data')`` sharding.  A chunk of ``batch`` rows gives each
    of the group's ``shape["data"]`` replicas ``batch // shape["data"]``
    rows, in order, process by process, so rank r with L local replicas
    owns ``[r * L * k, (r + 1) * L * k)`` for ``k`` rows per replica."""
    n = group.shape["data"]
    if batch % n:
        raise ValueError(f"a batch of {batch} rows does not split over {n} replicas")
    per_process = len(group.replicas) * (batch // n)
    return list(range(group.rank * per_process, (group.rank + 1) * per_process))


def agree_bits(bits) -> np.ndarray:
    """The element-wise maximum of an integer array over every process (the
    JAX package's ``process_allgather(bits).max(axis=0)``)."""
    t = torch.as_tensor(np.asarray(bits, dtype=np.int32))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.numpy()
