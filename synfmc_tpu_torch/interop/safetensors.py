"""A reader for the safetensors file format, without the safetensors package.

Layout: an unsigned 64-bit little-endian header length n, n bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``), then the byte buffer the offsets index, tensors little-endian and
row-major.  The file is memory-mapped: each tensor is a view of the map
(copy-on-write, so writing to one never reaches the file), and only the pages
a caller touches are read.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype).  numpy
# has no bfloat16: BF16 is read as uint16 and reinterpreted by torch.
DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_MAX_HEADER = 100 * 2**20  # the reference implementation's limit


class SafetensorsError(ValueError):
    """The file is not a valid safetensors file."""


def read_header(path: str) -> tuple[dict, int]:
    """The JSON header without ``__metadata__``, and the byte offset of the
    data buffer in the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        raw = fh.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: shorter than the 8-byte header length")
        n = int.from_bytes(raw, "little")
        if n > _MAX_HEADER or 8 + n > size:
            raise SafetensorsError(f"{path}: header length {n} does not fit a {size}-byte file")
        try:
            header = json.loads(fh.read(n).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SafetensorsError(f"{path}: the header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    return header, 8 + n


def _check_entries(path: str, header: dict, buffer_len: int) -> list[tuple[str, int, int]]:
    """Validate every entry; the tensors must tile the buffer exactly."""
    spans = []
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (KeyError, TypeError, ValueError) as e:
            raise SafetensorsError(f"{path}: malformed entry {name!r}: {info!r}") from e
        if dtype not in DTYPES:
            raise SafetensorsError(f"{path}: {name}: unsupported dtype {dtype!r}")
        if not all(isinstance(d, int) and d >= 0 for d in shape):
            raise SafetensorsError(f"{path}: {name}: bad shape {shape!r}")
        if not (isinstance(begin, int) and isinstance(end, int) and 0 <= begin <= end <= buffer_len):
            raise SafetensorsError(f"{path}: {name}: data_offsets {[begin, end]} outside the "
                                   f"{buffer_len}-byte buffer")
        want = math.prod(shape) * np.dtype(DTYPES[dtype][0]).itemsize
        if end - begin != want:
            raise SafetensorsError(f"{path}: {name}: {end - begin} bytes for {dtype} {shape} "
                                   f"(want {want})")
        spans.append((name, begin, end))
    spans.sort(key=lambda s: (s[1], s[2]))
    pos = 0
    for name, begin, end in spans:
        if begin != pos:
            raise SafetensorsError(f"{path}: {name} starts at {begin}, expected {pos} "
                                   "(overlapping tensors or a hole in the buffer)")
        pos = end
    if pos != buffer_len:
        raise SafetensorsError(f"{path}: the tensors cover {pos} of {buffer_len} buffer bytes")
    return spans


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, in header order."""
    header, start = read_header(path)
    buffer_len = os.path.getsize(path) - start
    _check_entries(path, header, buffer_len)
    mm = np.memmap(path, dtype=np.uint8, mode="c") if buffer_len else None
    out = {}
    for name, info in header.items():
        np_dtype, torch_dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=torch_dtype)
            continue
        raw = mm[start + begin:start + end]
        if (start + begin) % np.dtype(np_dtype).itemsize:
            raw = raw.copy()  # unaligned in the file: a copy aligns it
        arr = raw.view(np_dtype).reshape(shape)
        out[name] = torch.from_numpy(arr).view(torch_dtype)
    return out
