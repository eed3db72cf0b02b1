"""A reader of the ``.safetensors`` format, mapped from disk.

Replaces the JAX package's ``models/convert.py`` ``load_safetensors``, which
needs the ``safetensors`` package; the port reads the format itself. A file
is an 8-byte little-endian header length, a JSON header mapping each tensor
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into
the byte buffer after the header; an optional ``__metadata__`` entry holds
strings), then the raw little-endian bytes of every tensor.

:class:`SafetensorsFile` maps the file and checks its header when it is
opened; each tensor is a view of the map in the file's own dtype, read from
disk when it is touched, so a checkpoint of several GB is never copied
whole into host memory (the converter and the engine read it tensor by
tensor). :func:`load_safetensors` keeps the JAX loader's contract for
adapters and upscalers: a dict of numpy arrays of their own, F16 upcast to
f32. A dtype numpy cannot hold (BF16, the F8 formats) is refused with a
:class:`ValueError` naming the tensor, as the JAX loader cannot give it as
numpy either.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

#: safetensors dtype names -> little-endian numpy dtypes
DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
    "BOOL": "?",
}

#: a header larger than this is not a safetensors file (the format's own
#: reader refuses headers past 100 MB)
MAX_HEADER_BYTES = 100_000_000


class SafetensorsFile(Mapping):
    """A ``.safetensors`` file as a read-only mapping ``{name: tensor}``.

    The file is mapped copy-on-write: ``f[name]`` is a CPU tensor over the
    map in the file's dtype (writing to it never reaches the file), and
    the map lives as long as any such tensor does. Opening raises
    ``ValueError`` for a malformed header, offsets that do not match a
    tensor's shape and dtype, or a dtype numpy cannot hold."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: too short for a safetensors "
                                 f"header")
            (n,) = struct.unpack("<Q", f.read(8))
            if n > MAX_HEADER_BYTES or 8 + n > size:
                raise ValueError(f"{path}: header length {n} does not fit "
                                 f"the file")
            header = json.loads(f.read(n))
            if not isinstance(header, dict):
                raise ValueError(f"{path}: the header is not a JSON object")
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._start = 8 + n
        data_len = size - self._start
        self._entries: Dict[str, Tuple[np.dtype, Tuple[int, ...], int]] = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']}, which numpy cannot hold")
            dtype = np.dtype(dtype)
            begin, end = info["data_offsets"]
            shape = tuple(int(d) for d in info["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            if not 0 <= begin <= end <= data_len \
                    or end - begin != count * dtype.itemsize:
                raise ValueError(f"{path}: tensor {name!r} has offsets "
                                 f"{begin}..{end} for shape {shape} {dtype}")
            self._entries[name] = (dtype, shape, begin)

    def array(self, name: str) -> np.ndarray:
        """Tensor ``name`` as a numpy view of the map, in the file's byte
        order and dtype."""
        dtype, shape, begin = self._entries[name]
        count = int(np.prod(shape, dtype=np.int64))
        return np.frombuffer(self._map, dtype=dtype, count=count,
                             offset=self._start + begin).reshape(shape)

    def __getitem__(self, name: str) -> torch.Tensor:
        a = self.array(name)
        if not a.dtype.isnative:
            a = a.astype(a.dtype.newbyteorder("="))
        return torch.from_numpy(a)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: object) -> bool:
        return name in self._entries


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.safetensors`` file to ``{name: numpy array}`` of arrays of
    their own (writable, native byte order), F16 upcast to f32. Raises
    ``ValueError`` for a malformed file or a dtype numpy cannot hold."""
    f = SafetensorsFile(path)
    out: Dict[str, np.ndarray] = {}
    for name in f:
        a = f.array(name)
        # astype copies into a writable, native-order array of its own
        out[name] = a.astype(np.float32 if a.dtype == np.float16
                             else a.dtype.newbyteorder("="))
    return out
