"""The benchmark's weights: seeded fan-in-scaled normals, made on the device.

Every product weight is a normal of standard deviation ``fan_in ** -0.5``
(``fan_in`` = the size of one output's slice, ``Cin * k * k`` for a conv),
embeddings a normal of 0.02, norm scales 1, every bias and norm shift 0: the
pattern of the program's seeded smoke models, so activations keep their
scale through the depth.  The parameters are the reference's
(``reference/models.py``), in name order; the normals are drawn from one
``torch.Generator`` seeded with the run's seed, in few large fp32 calls
(parameters taken in order into chunks of at most :data:`CHUNK` values),
scaled, and rounded once to the dtype the configuration serves in.  The
program and the reference both take these values: the program in its own
dtype, the reference in fp32 from the same rounded numbers.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import models

CHUNK = 1 << 27  # values per draw: 512 MiB of fp32 at a time
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def spec(cfg: dict) -> list:
    """``[(name, shape, kind)]`` of every parameter of the configuration's
    five models, by name ("unet.conv_in.weight", ...)."""
    items = []
    for prefix, model in models.build(cfg).items():
        for name, (shape, kind) in models.param_kinds(model).items():
            items.append((f"{prefix}.{name}", shape, kind))
    return sorted(items)


def draw(cfg: dict, seed: int, device):
    """Yields ``(name, tensor)`` for every parameter, in the served dtype."""
    device = torch.device(device)
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    items = spec(cfg)
    random = [it for it in items if it[2] in (models.KIND_FAN_IN, models.KIND_EMBED)]
    for name, shape, kind in items:
        if kind == models.KIND_ONE:
            yield name, torch.ones(shape, dtype=dtype, device=device)
        elif kind == models.KIND_ZERO:
            yield name, torch.zeros(shape, dtype=dtype, device=device)
    chunk, size = [], 0
    for it in random + [None]:
        n = math.prod(it[1]) if it is not None else 0
        if chunk and (it is None or size + n > CHUNK):
            flat = torch.randn(size, generator=gen, device=device, dtype=torch.float32)
            at = 0
            for name, shape, kind in chunk:
                k = math.prod(shape)
                std = 0.02 if kind == models.KIND_EMBED else math.prod(shape[1:]) ** -0.5
                yield name, (flat[at:at + k] * std).view(shape).to(dtype)
                at += k
            del flat
            chunk, size = [], 0
        if it is not None:
            chunk.append(it)
            size += n


def program_parameters(editor) -> dict:
    """The program's parameters by the reference's names."""
    mod = editor.modules
    return {f"{prefix}.{name}": p
            for prefix in ("unet", "controlnet", "vae", "text_encoder", "text_encoder_2")
            for name, p in getattr(mod, prefix).named_parameters()}


def fill_program(editor, cfg: dict, seed: int) -> int:
    """Write the seeded weights into the program's editor, checking that
    its parameters are the configuration's, name for name and shape for
    shape.  Returns the number of values written."""
    params = program_parameters(editor)
    want = {name: shape for name, shape, _ in spec(cfg)}
    have = {name: tuple(p.shape) for name, p in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(n for n in set(want) & set(have) if want[n] != have[n])[:5]
        raise ValueError(f"the program's parameters are not the configuration's: missing "
                         f"{missing}, extra {extra}, other shapes {shapes}")
    total = 0
    with torch.no_grad():
        for name, value in draw(cfg, seed, editor.device):
            params[name].copy_(value)
            total += value.numel()
    return total
