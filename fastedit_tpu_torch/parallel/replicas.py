"""The replica group of a data-parallel editor: the counterpart of the JAX
package's ``parallel/mesh.py``.

The JAX package lays a ``(data, model)`` mesh over the devices, replicates
the weights over ``data`` and shards the batch dimension over it, so one
jitted program edits a chunk.  Here each tensor-parallel group of devices
(one device where ``model_parallel`` is 1) holds a replica, a
``FastEditor`` with a copy of the weights, its own CUDA graphs and memory
pool (``FastEditor.enable_data_parallel``).  A chunk's rows split over the
groups in order (``multihost.members``: the rank-major device list, ``k``
devices a group).  A group may span processes: then each of its processes
holds a replica with its own shards (``parallel/tp.py``), every member
dispatches the group's rows, and only the group's owner, the process of its
first device, keeps them for ``PendingEdit.local_result``
(``multihost.local_rows``); the others' copies stay in
``PendingEdit.computed_result``.  Where a process holds several replicas
(several groups, or parts of two), each replica's rows are dispatched from a
long-lived worker thread of its own, so one replica's host work (the
input's upload, tokenizing, a group's gloo collectives) does not hold up
another's card (a replay enqueues without waiting) and a replica's captures
and replays always come from one thread; a process's only replica is
dispatched on the calling thread.  Each replica's rows are edited as one
``edit_batch`` of that replica, so with a fixed seed every row takes the
same noise stream as on one editor.  Unseeded, each replica draws its own,
but where a group spans processes its members must draw the same: rank 0
draws once per dispatch (``multihost.shared_seed``) and group g takes that
draw plus g.

Kernel flags are per thread (``ops/flags.py``): each worker runs under the
calling thread's flags, so the replicas capture and replay the graph key
the caller would, under tensor parallelism (``model_parallel > 1``,
``parallel/tp.py``) too.  A replica takes one call at a time, since the
dispatch waits for every replica's before it returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.parallel import multihost
from fastedit_tpu_torch.pipeline.editor import PendingEdit

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Staged:
    """A chunk staged under data parallelism: this process's rows, as
    ``(first row, uint8 tensor on the replica's device)`` per replica, out
    of ``batch`` rows."""

    parts: List[tuple]
    batch: int

    def __len__(self) -> int:
        return self.batch


class ReplicaGroup:
    """One editor replica per tensor-parallel group this process holds a
    shard of, across ``world`` processes of which this is ``rank``, each
    process with ``local`` devices (every process as many) and groups of
    ``model_parallel``; ``groups`` are the replicas' group indices
    (``multihost.members``), by default this process's whole groups in
    order."""

    def __init__(self, replicas: list, rank: int = 0, world: int = 1,
                 model_parallel: int = 1, local: int | None = None, groups=None):
        self.replicas = list(replicas)
        self.rank, self.world = rank, world
        self.model_parallel = model_parallel
        self.local = len(self.replicas) * model_parallel if local is None else local
        first = rank * self.local // model_parallel
        self.groups = (list(range(first, first + len(self.replicas))) if groups is None
                       else list(groups))
        self._workers = ([ThreadPoolExecutor(1, thread_name_prefix=f"replica{j}")
                          for j in range(len(self.replicas))]
                         if len(self.replicas) > 1 else [])

    @property
    def devices(self) -> list:
        return [r.device for r in self.replicas]

    @property
    def shape(self) -> dict:
        """The mesh's shape: ``data`` is the number of groups over every
        process, the chunk a sweep dispatches at once (one row per group);
        ``model`` the devices of each group."""
        return {DATA_AXIS: self.world * self.local // self.model_parallel,
                MODEL_AXIS: self.model_parallel}

    def _runs(self, batch: int) -> list:
        """(replica, group, first row, end row, owned) for this process's
        replicas: every row of each group it holds a shard of, ``owned``
        where this process owns the group's rows."""
        per = multihost.rows_per_group(self, batch)
        layout = multihost.members(self.world, self.local, self.model_parallel)
        return [(r, g, g * per, (g + 1) * per, multihost.owner(layout[g]) == self.rank)
                for r, g in zip(self.replicas, self.groups)]

    def stage(self, images) -> Staged:
        """Each replica's rows of a pre-resized uint8 batch, on its device."""
        arr = np.ascontiguousarray(images, dtype=np.uint8)
        return Staged([(a, r._stage_inputs(arr[a:b])) for r, _, a, b, _ in self._runs(len(arr))],
                      len(arr))

    def edit_batch_async(self, images, prompts: list, kw: dict) -> PendingEdit:
        """``edit_batch_async`` over the group: a list of PIL images, a
        uint8 array or a :class:`Staged` chunk, with every row's prompt."""
        runs = self._runs(len(prompts))
        if isinstance(images, Staged):
            if [a for _, _, a, _, _ in runs] != [a for a, _ in images.parts]:
                raise ValueError("a chunk staged for another batch size or group")
            parts = [t for _, t in images.parts]
        else:
            parts = [images[a:b] for _, _, a, b, _ in runs]
        kws = [kw] * len(runs)
        if kw.get("seed") is None and multihost.groups_span(self.world, self.local,
                                                            self.model_parallel):
            # the members of a group must draw the same noise: rank 0's draw
            seed = multihost.shared_seed()
            kws = [{**kw, "seed": (seed + g) % 2**32, "tile_noise": False}
                   for _, g, _, _, _ in runs]
        caller = dataclasses.asdict(flags.current())

        def dispatch(replica, part, first, end, kw):
            device = (torch.cuda.device(replica.device) if replica.device.type == "cuda"
                      else contextlib.nullcontext())
            with device, flags.override(**caller):
                return replica._dispatch(part, prompts[first:end], kw, first_row=first)

        jobs = [(r, part, a, b, k) for (r, _, a, b, _), part, k in zip(runs, parts, kws)]
        if self._workers:
            futures = [w.submit(dispatch, *job) for w, job in zip(self._workers, jobs)]
            handles = [f.result() for f in futures]
        else:
            handles = [dispatch(*job) for job in jobs]
        owned = [h for h, run in zip(handles, runs) if run[4]]
        return PendingEdit.join(owned, len(prompts), computed=handles)
