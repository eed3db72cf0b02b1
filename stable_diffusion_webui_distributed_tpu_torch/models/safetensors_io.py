"""A numpy reader of the ``.safetensors`` format.

Replaces the JAX package's ``models/convert.py`` ``load_safetensors``, which
needs the ``safetensors`` package; the port reads the format itself. A file
is an 8-byte little-endian header length, a JSON header mapping each tensor
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into
the byte buffer after the header; an optional ``__metadata__`` entry holds
strings), then the raw little-endian bytes of every tensor.

As in the JAX package, F16 tensors come back as f32. A dtype numpy cannot
hold (BF16, the F8 formats) is refused with a :class:`ValueError` naming
the tensor, as the JAX loader cannot give it as numpy either.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

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


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.safetensors`` file to ``{name: numpy array}``, F16
    upcast to f32. Raises ``ValueError`` for a malformed file or a dtype
    numpy cannot hold."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if n > MAX_HEADER_BYTES or 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} does not fit the file")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which numpy cannot hold")
        begin, end = info["data_offsets"]
        shape = tuple(int(d) for d in info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= len(data) \
                or end - begin != count * np.dtype(dtype).itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{begin}..{end} for shape {shape} {dtype}")
        # astype copies into a writable, native-order array of its own
        native = (np.float32 if info["dtype"] == "F16"
                  else np.dtype(dtype).newbyteorder("="))
        out[name] = np.frombuffer(data[begin:end], dtype=dtype) \
            .reshape(shape).astype(native)
    return out
