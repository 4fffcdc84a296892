"""Read and write the safetensors file format, one tensor at a time.

The port's own reader and writer (the GPU host has no ``safetensors``
package), written against the format: an 8-byte little-endian header
length N, N bytes of JSON (``{name: {"dtype", "shape", "data_offsets":
[begin, end]}}`` plus an optional ``"__metadata__"`` of strings), then the
raw little-endian buffers, offsets counted from the end of the header.

* :class:`SafetensorsFile` maps the file (``np.memmap``, copy-on-write, so
  nothing is read until a tensor is asked for and the file is never
  written) and returns one tensor at a time, on the device asked for: a
  checkpoint of 11.7 GB is loaded with about one tensor's worth of host
  memory.
* :func:`write_stream` writes tensors one at a time: the header is laid
  out from the shapes first, and each tensor is produced only when its
  turn comes. The header is padded with spaces to a multiple of 8 bytes,
  as the ``safetensors`` library pads it.

bf16 has no numpy type: its buffers are read as uint16 and viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import json
import struct
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# format name -> (torch dtype, numpy dtype of the raw buffer)
DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
_NAMES = {t: name for name, (t, _) in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024  # the library's own limit


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype not in _NAMES:
        raise ValueError(f"safetensors: no format name for {dtype}")
    return _NAMES[dtype]


class SafetensorsFile:
    """One ``.safetensors`` file, its tensors read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{path}: header of {n} bytes")
            header = json.loads(f.read(n))
        self.metadata = header.pop("__metadata__", None)
        self.entries = header
        self._base = 8 + n
        self._map = None
        size = self._base
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}, which the port "
                                 f"does not read ({', '.join(DTYPES)})")
            begin, end = e["data_offsets"]
            want = int(np.prod(e["shape"], dtype=np.int64)) * np.dtype(DTYPES[e["dtype"]][1]).itemsize
            if end - begin != want or begin < 0:
                raise ValueError(f"{path}: {name} spans {end - begin} bytes, its shape "
                                 f"{e['shape']} needs {want}")
            size = max(size, self._base + end)
        self._size = size

    def keys(self) -> List[str]:
        return list(self.entries)

    def _buffer(self) -> np.ndarray:
        if self._map is None:
            # an empty data section cannot be mapped
            self._map = (np.memmap(self.path, dtype=np.uint8, mode="c", shape=(self._size,))
                         if self._size > 0 else np.zeros(0, np.uint8))
        return self._map

    def get_tensor(self, name: str, device="cpu") -> torch.Tensor:
        """The tensor ``name`` on ``device``, a tensor of its own (it does
        not share memory with the mapped file)."""
        e = self.entries[name]
        t_dtype, np_dtype = DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        raw = self._buffer()[self._base + begin:self._base + end]
        if (self._base + begin) % np.dtype(np_dtype).itemsize:
            raw = raw.copy()  # a view must be aligned to its element
        arr = raw.view(np_dtype).reshape(e["shape"])
        t = torch.from_numpy(arr)
        if t_dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        device = torch.device(device)
        # a copy either way: the host tensor must not alias the mapping
        return t.clone() if device.type == "cpu" else t.to(device)

    def close(self) -> None:
        self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of one file, on ``device``."""
    with SafetensorsFile(path) as f:
        return {k: f.get_tensor(k, device) for k in f.keys()}


Spec = Tuple[str, torch.dtype, Sequence[int]]


def write_stream(
    path: str,
    specs: Sequence[Spec],
    produce: Callable[[str], object],
    metadata: Optional[Mapping[str, str]] = None,
) -> int:
    """Write the tensors named by ``specs`` ((name, dtype, shape), in file
    order) to ``path``; ``produce(name)`` gives each one (a tensor on any
    device, or a numpy array) when its turn comes, and must match its
    spec. Returns the bytes written."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, dtype, shape in specs:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": _dtype_name(dtype), "shape": [int(s) for s in shape],
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, dtype, shape in specs:
            t = produce(name)
            t = torch.from_numpy(np.asarray(t)) if not torch.is_tensor(t) else t
            if t.dtype != dtype or tuple(t.shape) != tuple(int(s) for s in shape):
                raise ValueError(f"write_stream: {name} is {t.dtype} {tuple(t.shape)}, its "
                                 f"spec {dtype} {tuple(shape)}")
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().data)  # the buffer itself, no second host copy
    return 8 + len(blob) + offset


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write a dict of tensors (or numpy arrays) to ``path``."""
    def as_tensor(v):
        return v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))

    specs = [(k, as_tensor(v).dtype, tuple(v.shape)) for k, v in tensors.items()]
    return write_stream(path, specs, lambda k: as_tensor(tensors[k]), metadata)
