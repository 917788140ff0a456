"""Tensor parallelism over a group of devices: the counterpart of the JAX
package's ``parallel/tp.py``.

The JAX package shards the transformer blocks' parameters over the mesh's
``model`` axis (the Megatron split) and lets GSPMD insert the all-reduces.
Here the same rules, in diffusers state-dict names, split the modules of one
replica over its group's devices, each shard on one device, and the work
stays in one process, the counterpart of one GSPMD program:

  * column-parallel: ``attn*.to_q``, ``to_k`` and ``to_v``, split on head
    boundaries, each device computing its heads' attention;
    ``ff.net.0.proj``, whose value half and gate half are each split across
    the shards, so that GEGLU's ``value * gelu(gate)`` stays local to one
    shard.  (At tp = 2 the JAX package's contiguous split of the last dim
    puts the whole value half on one device and the gate half on the other,
    and GSPMD moves the data GEGLU needs; the products are the same either
    way.)
  * row-parallel: ``attn*.to_out.0`` and ``ff.net.2``, their weights split on
    the input dim; each partial product comes out of its shard's linear
    rounded to the model dtype, the partials are summed on the replica's
    device in a fixed order (shard 0, then 1, ...) in fp32, the bias, which
    is not split, is added once, and the sum rounds to the model dtype
    again: two roundings where the whole layer's product rounds once.
  * everything else (convs, norms, embeddings, ``proj_in`` / ``proj_out``)
    is replicated: it stays whole on the replica's device.  An attention
    whose heads, or a feed-forward whose hidden width, ``tp`` does not
    divide stays replicated, as the JAX package replicates a dimension that
    does not divide (``fastedit_tpu/parallel/tp.py`` ``tp_spec``).

:func:`tp_rule` is the rule for one state-dict entry; :func:`split_transformers`
applies it to a UNet's or a ControlNet's transformer blocks in place.  The
split modules run the same kernels as whole ones, under the caller's flags:
each shard's attention is ``ops.attention`` over whole heads on one device,
each feed-forward shard is local, and every conv runs whole on the
replica's device.  (The JAX package pins its XLA paths under TP because
GSPMD cannot partition a ``pallas_call``; here no program is partitioned,
so nothing is pinned.)  A group whose devices are all one card captures its
CUDA graphs as any replica does; a group over several cards runs eagerly
(``ops/flags.py``: one capture cannot span cards).

A group may span processes (``parallel/multihost.py``): each process then
holds a replica with only the shards on its own devices (a
:class:`Placement`) and runs the replicated rest whole, and each
row-parallel layer gathers every member's partials over the group's gloo
subgroup (:class:`GroupComm`) and sums all ``k`` in shard order on every
member, so each member computes the bits the group would in one process.
An all-reduce would not do: its order of summation is the backend's.  The
partials pass through host memory (pinned on the card): a copy out, the
gloo all-gather on CPU tensors, a copy back, the same code on the CPU and
on the card.  Such a group runs eagerly, since a gloo collective is host
work that no CUDA graph can hold.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch import ops
from fastedit_tpu_torch.models.layers import Attention, BasicTransformerBlock, FeedForward

def tp_rule(name: str, shape: Sequence[int], tp: int, heads: Optional[int] = None
            ) -> Optional[tuple[str, int]]:
    """How the state-dict entry ``name`` of ``shape`` (PyTorch's layout: a
    Linear's weight is [out, in]) splits over ``tp`` devices: ``("column",
    0)`` (its output rows: weight and bias), ``("row", 1)`` (its input
    columns: the weight; the bias stays whole), or None (replicated).
    ``heads`` is the attention's head count, for ``to_q``, ``to_k``,
    ``to_v`` and ``to_out.0``, which split on head boundaries only."""
    parts = name.split(".")
    module, leaf = ".".join(parts[:-1]), parts[-1]
    if tp <= 1 or "transformer_blocks" not in parts:
        return None
    if module.endswith(("to_q", "to_k", "to_v")):
        return ("column", 0) if heads and heads % tp == 0 else None
    if module.endswith("net.0.proj"):  # the value and the gate half, each split
        return ("column", 0) if shape[0] % (2 * tp) == 0 else None
    if leaf == "weight" and module.endswith("to_out.0"):
        return ("row", 1) if heads and heads % tp == 0 else None
    if leaf == "weight" and module.endswith("net.2"):
        return ("row", 1) if shape[1] % tp == 0 else None
    return None


class GroupComm:
    """The handle of a tensor-parallel group to its other processes: the
    group's gloo subgroup ``pg``, its ``members`` (``(rank, local index,
    shard index)``, ``multihost.members``) and this process's ``rank``.

    :meth:`gather` hands every member's partials to every member.  A member
    that holds fewer shards than another pads its part to the same number
    of slots (``slots``: the most shards any member holds), so one
    all-gather of equal parts serves every layout.  ``bytes_sent`` counts
    the bytes this process hands to the all-gathers (padding included);
    ``stage_s`` the host seconds of the copies to host memory (which wait
    for the device's work before them), ``exchange_s`` those of the
    all-gathers."""

    def __init__(self, pg, members: Sequence[tuple], rank: int):
        self.pg, self.rank = pg, rank
        self.tp = len(members)
        self.ranks = sorted({r for r, _, _ in members})
        self.shards_of = {r: [s for rr, _, s in members if rr == r] for r in self.ranks}
        self.slots = max(len(v) for v in self.shards_of.values())
        self.bytes_sent = 0
        self.stage_s = self.exchange_s = 0.0
        self._buffers: dict = {}

    def _host(self, nbytes: int, pinned: bool) -> tuple:
        """(send, receive) byte buffers in host memory, kept per size."""
        key = (nbytes, pinned)
        if key not in self._buffers:
            self._buffers[key] = (
                torch.empty(self.slots * nbytes, dtype=torch.uint8, pin_memory=pinned),
                torch.empty(len(self.ranks), self.slots * nbytes, dtype=torch.uint8,
                            pin_memory=pinned))
        return self._buffers[key]

    def gather(self, partials: list) -> list:
        """Every shard's partial in shard order, from this process's
        ``partials`` (its shards', in shard order, all of one shape and
        dtype): its own as they are, the others' copied from the host buffer
        to the device of ``partials[0]``."""
        first = partials[0]
        nbytes = first.numel() * first.element_size()
        send, recv = self._host(nbytes, first.is_cuda)
        t0 = time.perf_counter()
        for i, p in enumerate(partials):  # a copy to the host waits for p
            send[i * nbytes:(i + 1) * nbytes].view(first.dtype).view(first.shape).copy_(p)
        t1 = time.perf_counter()
        torch.distributed.all_gather(list(recv), send, group=self.pg)
        self.stage_s += t1 - t0
        self.exchange_s += time.perf_counter() - t1
        self.bytes_sent += send.numel()
        out = [None] * self.tp
        for pos, r in enumerate(self.ranks):
            for slot, shard in enumerate(self.shards_of[r]):
                if r == self.rank:
                    out[shard] = partials[slot]
                else:
                    part = recv[pos, slot * nbytes:(slot + 1) * nbytes]
                    out[shard] = part.view(first.dtype).view(first.shape).to(
                        first.device, non_blocking=True)
        return out

    def agree(self, value, what: str) -> None:
        """Raise on every member unless each holds the same ``value`` (a
        picklable summary) as the group's owner, naming the members that
        differ."""
        values = [None] * len(self.ranks)
        torch.distributed.all_gather_object(values, value, group=self.pg)
        differ = [r for r, v in zip(self.ranks, values) if v != values[0]]
        if differ:
            raise ValueError(
                f"the tensor-parallel group of ranks {self.ranks}: {what} of rank(s) {differ} "
                f"differ from rank {self.ranks[0]}'s; every process must run the same "
                "program on the same weights")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a replica's shards lie: ``tp`` shards in all, this process's
    ``(shard index, device)`` pairs in shard order, and the handle to the
    group's other processes (``None``: every shard is here)."""

    tp: int
    local: tuple
    comm: Optional[GroupComm] = None

    @classmethod
    def of(cls, devices) -> "Placement":
        """A placement as given, or every shard in this process: shard i on
        ``devices[i]``."""
        if isinstance(devices, Placement):
            return devices
        return cls(len(devices), tuple(enumerate(devices)))

    @property
    def devices(self) -> list:
        return [d for _, d in self.local]

    @property
    def shards(self) -> list:
        return [s for s, _ in self.local]


class TPAttention(nn.Module):
    """``Attention`` split by heads over ``tp`` shards: shard i holds heads
    ``[i h / tp, (i + 1) h / tp)`` of ``to_q``, ``to_k`` and ``to_v`` and the
    matching input columns of ``to_out.0``.  This module holds the shards of
    ``placement`` (a :class:`Placement`, or a list of devices, shard i on
    the i-th), each on its device; the output projection's bias stays whole
    on the first."""

    def __init__(self, attn: Attention, placement):
        super().__init__()
        place = Placement.of(placement)
        self.devices, self.shard_ids, self.comm = place.devices, place.shards, place.comm
        self.heads, self.head_dim = attn.heads // place.tp, attn.head_dim
        width = self.heads * self.head_dim
        self.shards = nn.ModuleList()
        for i, device in place.local:
            rows = slice(i * width, (i + 1) * width)
            shard = nn.Module()
            for name in ("to_q", "to_k", "to_v"):
                full = getattr(attn, name)
                setattr(shard, name, _linear(full.weight[rows], None if full.bias is None
                                             else full.bias[rows], device))
            shard.to_out = _linear(attn.to_out[0].weight[:, rows], None, device)
            self.shards.append(shard)
        self.out_bias = nn.Parameter(attn.to_out[0].bias.detach().to(self.devices[0]),
                                     requires_grad=False)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        b, sq, _ = x.shape
        skv = ctx.shape[1]
        partials = []
        for shard, device in zip(self.shards, self.devices):
            xs, cs = x.to(device), ctx.to(device)
            q = shard.to_q(xs).view(b, sq, self.heads, self.head_dim)
            k = shard.to_k(cs).view(b, skv, self.heads, self.head_dim)
            v = shard.to_v(cs).view(b, skv, self.heads, self.head_dim)
            out = ops.attention(q, k, v).reshape(b, sq, self.heads * self.head_dim)
            partials.append(shard.to_out(out))
        return _reduce(partials, self.out_bias, self.comm)


class TPFeedForward(nn.Module):
    """``FeedForward`` (GEGLU) split over ``tp`` shards: shard i holds rows
    ``[i w, (i + 1) w)`` of the value half and of the gate half of
    ``net.0.proj`` (w = hidden / tp) and the matching input columns of
    ``net.2``; this module holds the shards of ``placement``, as
    :class:`TPAttention`; ``net.2``'s bias stays whole on the first
    device."""

    def __init__(self, ff: FeedForward, placement):
        super().__init__()
        place = Placement.of(placement)
        self.devices, self.shard_ids, self.comm = place.devices, place.shards, place.comm
        proj, out = ff.net[0].proj, ff.net[2]
        hidden = proj.weight.shape[0] // 2
        width = hidden // place.tp
        self.shards = nn.ModuleList()
        for i, device in place.local:
            value = slice(i * width, (i + 1) * width)
            gate = slice(hidden + i * width, hidden + (i + 1) * width)
            shard = nn.Module()
            shard.proj = _linear(torch.cat([proj.weight[value], proj.weight[gate]]),
                                 torch.cat([proj.bias[value], proj.bias[gate]]), device)
            shard.out = _linear(out.weight[:, value], None, device)
            self.shards.append(shard)
        self.out_bias = nn.Parameter(out.bias.detach().to(self.devices[0]), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        partials = []
        for shard, device in zip(self.shards, self.devices):
            value, gate = shard.proj(x.to(device)).chunk(2, dim=-1)
            partials.append(shard.out(value * F.gelu(gate)))
        return _reduce(partials, self.out_bias, self.comm)


def _linear(weight: torch.Tensor, bias: Optional[torch.Tensor], device) -> nn.Linear:
    """An ``nn.Linear`` holding copies of ``weight`` (and ``bias``) on
    ``device``."""
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                    device="meta", dtype=weight.dtype)
    lin.weight = nn.Parameter(weight.detach().to(device).clone(), requires_grad=False)
    if bias is not None:
        lin.bias = nn.Parameter(bias.detach().to(device).clone(), requires_grad=False)
    return lin


def _reduce(partials: list, bias: torch.Tensor, comm: Optional[GroupComm] = None
            ) -> torch.Tensor:
    """The partial products (each already rounded to the model dtype by its
    shard's linear; with ``comm``, this process's, the others' gathered
    first) summed on the bias's device in fp32, shard 0 first, then the
    bias added once and the sum rounded to the partials' dtype."""
    if comm is not None:
        partials = comm.gather(partials)
    total = partials[0].to(bias.device, torch.float32)
    for p in partials[1:]:
        total = total + p.to(bias.device, torch.float32)
    return (total + bias.float()).to(partials[0].dtype)


def split_transformers(model: nn.Module, placement) -> dict:
    """Split every transformer block's attentions and feed-forward of
    ``model`` (a UNet or a ControlNet on the first device) over
    ``placement`` (a :class:`Placement`, or a list of devices: every shard
    here), in place, where :func:`tp_rule` splits their weights; returns
    the count of modules split and kept whole, by kind."""
    place = Placement.of(placement)
    tp = place.tp
    counts = {"attention_split": 0, "attention_replicated": 0, "ff_split": 0,
              "ff_replicated": 0}
    blocks = [(name, m) for name, m in model.named_modules()
              if isinstance(m, BasicTransformerBlock)]
    for prefix, block in blocks:
        for name in ("attn1", "attn2"):
            attn = getattr(block, name)
            weight = attn.to_q.weight
            if tp_rule(f"{prefix}.{name}.to_q.weight", weight.shape, tp, attn.heads):
                setattr(block, name, TPAttention(attn, place))
                counts["attention_split"] += 1
            else:
                counts["attention_replicated"] += 1
        weight = block.ff.net[0].proj.weight
        if tp_rule(f"{prefix}.ff.net.0.proj.weight", weight.shape, tp):
            block.ff = TPFeedForward(block.ff, place)
            counts["ff_split"] += 1
        else:
            counts["ff_replicated"] += 1
    return counts


def comms(modules) -> list:
    """The distinct :class:`GroupComm` handles the split modules of
    ``modules`` (nn.Modules) use: their counters."""
    found = {id(m.comm): m.comm for mod in modules for m in mod.modules()
             if isinstance(m, (TPAttention, TPFeedForward)) and m.comm is not None}
    return list(found.values())


def weights_checksum(modules) -> str:
    """An exact digest of ``modules``' state (nn.Modules): per tensor its
    name, dtype, shape and two integer sums over its bytes as 32-bit words
    (the plain sum and one weighted by position), computed where the tensor
    lies, so equal states give equal digests on any device."""
    h = hashlib.sha256()
    for mod in modules:
        for name, t in mod.state_dict().items():
            raw = t.detach().contiguous().view(-1).view(torch.uint8)
            raw = torch.cat([raw, raw.new_zeros(-raw.numel() % 4)])
            words = raw.view(torch.int32).to(torch.int64)
            pos = torch.arange(words.numel(), device=words.device) % 65521 + 1
            h.update(repr((name, str(t.dtype), tuple(t.shape), int(words.sum()),
                           int((words * pos).sum()))).encode())
    return h.hexdigest()
