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
    rounded to the model dtype, the partials are summed on the group's
    first device in a fixed order (shard 0, then 1, ...) in fp32, the bias,
    which is not split, is added once, and the sum rounds to the model dtype
    again: two roundings where the whole layer's product rounds once.
  * everything else (convs, norms, embeddings, ``proj_in`` / ``proj_out``)
    is replicated: it stays whole on the group's first device.  An attention
    whose heads, or a feed-forward whose hidden width, ``tp`` does not
    divide stays replicated, as the JAX package replicates a dimension that
    does not divide (``fastedit_tpu/parallel/tp.py`` ``tp_spec``).

:func:`tp_rule` is the rule for one state-dict entry; :func:`split_transformers`
applies it to a UNet's or a ControlNet's transformer blocks in place.  The
split modules run the same kernels as whole ones, under the caller's flags:
each shard's attention is ``ops.attention`` over whole heads on one device,
each feed-forward shard is local, and every conv runs whole on the group's
first device.  (The JAX package pins its XLA paths under TP because GSPMD
cannot partition a ``pallas_call``; here no program is partitioned, so
nothing is pinned.)  A group whose devices are all one card captures its
CUDA graphs as any replica does; a group over several cards runs eagerly
(``ops/flags.py``: one capture cannot span cards).
"""

from __future__ import annotations

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


class TPAttention(nn.Module):
    """``Attention`` split by heads over ``devices``: shard i holds heads
    ``[i h / tp, (i + 1) h / tp)`` of ``to_q``, ``to_k`` and ``to_v`` and the
    matching input columns of ``to_out.0``, on ``devices[i]``; the output
    projection's bias stays whole on ``devices[0]``."""

    def __init__(self, attn: Attention, devices: Sequence[torch.device]):
        super().__init__()
        tp = len(devices)
        self.devices = list(devices)
        self.heads, self.head_dim = attn.heads // tp, attn.head_dim
        width = self.heads * self.head_dim
        self.shards = nn.ModuleList()
        for i, device in enumerate(self.devices):
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
        return _reduce(partials, self.out_bias)


class TPFeedForward(nn.Module):
    """``FeedForward`` (GEGLU) split over ``devices``: shard i holds rows
    ``[i w, (i + 1) w)`` of the value half and of the gate half of
    ``net.0.proj`` (w = hidden / tp) and the matching input columns of
    ``net.2``; ``net.2``'s bias stays whole on ``devices[0]``."""

    def __init__(self, ff: FeedForward, devices: Sequence[torch.device]):
        super().__init__()
        tp = len(devices)
        self.devices = list(devices)
        proj, out = ff.net[0].proj, ff.net[2]
        hidden = proj.weight.shape[0] // 2
        width = hidden // tp
        self.shards = nn.ModuleList()
        for i, device in enumerate(self.devices):
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
        return _reduce(partials, self.out_bias)


def _linear(weight: torch.Tensor, bias: Optional[torch.Tensor], device) -> nn.Linear:
    """An ``nn.Linear`` holding copies of ``weight`` (and ``bias``) on
    ``device``."""
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                    device="meta", dtype=weight.dtype)
    lin.weight = nn.Parameter(weight.detach().to(device).clone(), requires_grad=False)
    if bias is not None:
        lin.bias = nn.Parameter(bias.detach().to(device).clone(), requires_grad=False)
    return lin


def _reduce(partials: list, bias: torch.Tensor) -> torch.Tensor:
    """The partial products (each already rounded to the model dtype by its
    shard's linear) summed on the bias's device in fp32, shard 0 first, then
    the bias added once and the sum rounded to the partials' dtype."""
    total = partials[0].to(bias.device, torch.float32)
    for p in partials[1:]:
        total = total + p.to(bias.device, torch.float32)
    return (total + bias.float()).to(partials[0].dtype)


def split_transformers(model: nn.Module, devices: Sequence[torch.device]) -> dict:
    """Split every transformer block's attentions and feed-forward of
    ``model`` (a UNet or a ControlNet on ``devices[0]``) over ``devices``, in
    place, where :func:`tp_rule` splits their weights; returns the count of
    modules split and kept whole, by kind."""
    tp = len(devices)
    counts = {"attention_split": 0, "attention_replicated": 0, "ff_split": 0,
              "ff_replicated": 0}
    blocks = [(name, m) for name, m in model.named_modules()
              if isinstance(m, BasicTransformerBlock)]
    for prefix, block in blocks:
        for name in ("attn1", "attn2"):
            attn = getattr(block, name)
            weight = attn.to_q.weight
            if tp_rule(f"{prefix}.{name}.to_q.weight", weight.shape, tp, attn.heads):
                setattr(block, name, TPAttention(attn, devices))
                counts["attention_split"] += 1
            else:
                counts["attention_replicated"] += 1
        weight = block.ff.net[0].proj.weight
        if tp_rule(f"{prefix}.ff.net.0.proj.weight", weight.shape, tp):
            block.ff = TPFeedForward(block.ff, devices)
            counts["ff_split"] += 1
        else:
            counts["ff_replicated"] += 1
    return counts
