"""The replica group of a data-parallel editor: the counterpart of the JAX
package's ``parallel/mesh.py``.

The JAX package lays a 1-D ``data`` mesh over the devices, replicates the
weights on each and shards the batch dimension over it, so one jitted
program edits a chunk.  Here each device holds a replica, a ``FastEditor``
with a copy of the weights, its own CUDA graphs and memory pool
(``FastEditor.enable_data_parallel``).  A chunk's rows split over the
replicas in order, process by process (``multihost.local_rows``).  Where
a process holds several replicas, each replica's rows are dispatched from a
long-lived worker thread of its own, so one replica's host work (the
input's upload, tokenizing) does not hold up another's card (a replay
enqueues without waiting) and a replica's captures and replays always come
from one thread;
a process's only replica is dispatched on the calling thread.  Each
replica's rows are edited as
one ``edit_batch`` of that replica, so with a fixed seed every row takes the
same noise stream as on one editor; unseeded, each replica draws its own.

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
    """One editor replica per device, across ``world`` processes of which
    this is ``rank`` (every process holds as many replicas)."""

    def __init__(self, replicas: list, rank: int = 0, world: int = 1,
                 model_parallel: int = 1):
        self.replicas = list(replicas)
        self.rank, self.world = rank, world
        self.model_parallel = model_parallel
        self._workers = ([ThreadPoolExecutor(1, thread_name_prefix=f"replica{j}")
                          for j in range(len(self.replicas))]
                         if len(self.replicas) > 1 else [])

    @property
    def devices(self) -> list:
        return [r.device for r in self.replicas]

    @property
    def shape(self) -> dict:
        """The mesh's shape: ``data`` is the number of replicas over every
        process, the chunk a sweep dispatches at once; ``model`` the devices
        of each replica's tensor-parallel group."""
        return {DATA_AXIS: self.world * len(self.replicas), MODEL_AXIS: self.model_parallel}

    def _runs(self, batch: int) -> list:
        """(replica, first row, end row) for this process's replicas."""
        rows = multihost.local_rows(self, batch)
        k = len(rows) // len(self.replicas)
        return [(r, rows[0] + j * k, rows[0] + (j + 1) * k)
                for j, r in enumerate(self.replicas)]

    def stage(self, images) -> Staged:
        """Each replica's rows of a pre-resized uint8 batch, on its device."""
        arr = np.ascontiguousarray(images, dtype=np.uint8)
        return Staged([(a, r._stage_inputs(arr[a:b])) for r, a, b in self._runs(len(arr))],
                      len(arr))

    def edit_batch_async(self, images, prompts: list, kw: dict) -> PendingEdit:
        """``edit_batch_async`` over the group: a list of PIL images, a
        uint8 array or a :class:`Staged` chunk, with every row's prompt."""
        runs = self._runs(len(prompts))
        if isinstance(images, Staged):
            if [a for _, a, _ in runs] != [a for a, _ in images.parts]:
                raise ValueError("a chunk staged for another batch size or group")
            parts = [t for _, t in images.parts]
        else:
            parts = [images[a:b] for _, a, b in runs]
        caller = dataclasses.asdict(flags.current())

        def dispatch(replica, part, first, end):
            device = (torch.cuda.device(replica.device) if replica.device.type == "cuda"
                      else contextlib.nullcontext())
            with device, flags.override(**caller):
                return replica._dispatch(part, prompts[first:end], kw, first_row=first)

        jobs = [(r, part, a, b) for (r, a, b), part in zip(runs, parts)]
        if self._workers:
            futures = [w.submit(dispatch, *job) for w, job in zip(self._workers, jobs)]
            handles = [f.result() for f in futures]
        else:
            handles = [dispatch(*job) for job in jobs]
        return PendingEdit.join(handles, len(prompts))
