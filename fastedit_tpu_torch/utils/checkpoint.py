"""Checkpoint I/O: flat-key safetensors and dataclass config JSON per module.

The layout the JAX package's ``utils/checkpoint.py`` reads and writes, so one
converted directory serves both packages:

    <ckpt_dir>/
      unet/        config.json weights.safetensors
      controlnet/  config.json weights.safetensors
      vae/         config.json weights.safetensors
      text_encoder/   config.json weights.safetensors
      text_encoder_2/ config.json weights.safetensors
      tokenizer/   vocab.json merges.txt
      tokenizer_2/ vocab.json merges.txt

Weights are stored flat (``"a/b/c"`` keys: the JAX package's parameter tree
paths) in bf16, fp16 or fp32; ``config.json`` is the dataclass's fields plus
``"__class__"``.  Tensors are torch tensors throughout, read and written by
``utils/safetensors_io.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Dict, Optional

import torch

from fastedit_tpu_torch.utils import safetensors_io

WEIGHTS = "weights.safetensors"


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params(path: str, params: Dict[str, Any],
                dtype: Optional[torch.dtype] = None) -> None:
    """Save a (possibly nested) tree to ``<path>/weights.safetensors``, each
    tensor cast to ``dtype`` (if given) and written contiguous."""
    os.makedirs(path, exist_ok=True)
    flat = flatten(params)
    if dtype is not None:
        flat = {k: v.to(dtype) for k, v in flat.items()}
    safetensors_io.save_file(flat, os.path.join(path, WEIGHTS))


def load_params(path: str, dtype: Optional[torch.dtype] = None,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The nested tree of ``<path>/weights.safetensors``, on the host (or
    ``device``), in the stored dtype unless ``dtype`` is given."""
    flat = safetensors_io.load_file(os.path.join(path, WEIGHTS))
    if dtype is not None or device is not None:
        flat = {k: v.to(device=device, dtype=dtype) for k, v in flat.items()}
    return unflatten(flat)


def save_config(path: str, config: Any) -> None:
    os.makedirs(path, exist_ok=True)
    d = dataclasses.asdict(config)
    d["__class__"] = type(config).__name__
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f, indent=2)


def _tupleize(x):
    return tuple(_tupleize(e) for e in x) if isinstance(x, list) else x


def load_config(path: str, cls) -> Any:
    """``cls`` from ``<path>/config.json``: lists become tuples, unknown
    keys are dropped, and a field whose type is a config dataclass
    (``ControlNetConfig.unet``) is built as that class.  The fields' types
    are strings under ``from __future__ import annotations``, so they are
    resolved with ``typing.get_type_hints``."""
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    d.pop("__class__", None)
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        hint = hints.get(k)
        if dataclasses.is_dataclass(hint) and isinstance(v, dict):
            kwargs[k] = hint(**{kk: _tupleize(vv) for kk, vv in v.items()})
        else:
            kwargs[k] = _tupleize(v)
    return cls(**kwargs)

