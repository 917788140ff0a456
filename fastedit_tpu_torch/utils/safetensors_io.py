"""A reader and writer of the safetensors format, on torch tensors.

The format: an 8-byte little-endian header length N, N bytes of JSON (padded
with spaces), then the tensors' raw little-endian bytes, back to back.  The
header maps each name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the bytes after the header) and may hold a
``"__metadata__"`` dict of strings, which the reader skips and the writer
does not write.

Here so that the port needs neither the ``safetensors`` package nor
``ml_dtypes`` (numpy has no bfloat16): bf16 is carried as torch tensors from
``torch.frombuffer``.  Files written here are read by ``safetensors`` and
the reverse (``tests/test_torch_checkpoint.py``).
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from typing import Dict

import torch

# The weights' types, and I64: transformers' text encoders carry their
# ``position_ids`` buffer in it.
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}
NAMES = {v: k for k, v in DTYPES.items()}

if sys.byteorder != "little":  # the format's bytes are little-endian
    raise ImportError("safetensors_io reads and writes on little-endian hosts only")


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` to ``path``.  Each is written contiguous in its
    logical (row-major) order, whatever its strides or memory format (a
    ``channels_last`` conv weight included), from the host.  Tensors are
    laid out by falling element size, then name, so each starts aligned."""
    items = []
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not supported")
        items.append((name, t.detach().to("cpu").contiguous()))
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header, offset = {}, 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of ``path`` onto the host, in its stored dtype.
    The tensors share one buffer of the file's bytes (a tensor whose offset
    is not a multiple of its element size gets its own aligned copy)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        data = bytearray(os.path.getsize(path) - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: short read")
    header.pop("__metadata__", None)
    spans = sorted((info["data_offsets"], name) for name, info in header.items())
    end = 0
    for (begin, stop), name in spans:
        if begin != end:
            raise ValueError(f"{path}: tensor {name} starts at {begin}, expected {end}")
        end = stop
    if end != len(data):
        raise ValueError(f"{path}: tensors end at {end}, the data holds {len(data)} bytes")
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                             f"{sorted(DTYPES)}")
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        begin, stop = info["data_offsets"]
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if stop - begin != count * itemsize:
            raise ValueError(f"{path}: {name} holds {stop - begin} bytes for shape {shape} "
                             f"of {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        if begin % itemsize:  # the buffer's start is aligned, this offset is not
            t = torch.frombuffer(bytearray(data[begin:stop]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        out[name] = t.reshape(shape)
    return out
