"""The safetensors format, read and written by the port's own code.

A file is an 8-byte little-endian header length N, N bytes of JSON header
(``{"__metadata__": {...}, name: {"dtype", "shape", "data_offsets"}}``,
offsets relative to the byte after the header), then the raw little-endian
tensor bytes. The HuggingFace ``safetensors`` package is not needed to read
or write it, and the card's machine does not have it.

- ``SafeTensorsFile``: parses the header and gives each tensor lazily, in
  its stored dtype, through ``read(name, use)``: ``use`` gets a CPU
  ``torch.Tensor`` view of a private, copy-on-write ``mmap`` of the
  tensor's own bytes (nothing is ever written back), which is unmapped as
  soon as ``use`` returns, so a streamed load's resident set stays near one
  tensor. BF16 is viewed as ``torch.bfloat16`` and never passes through
  fp32. A tensor whose offset in the file is not a multiple of its element
  size is copied into an aligned buffer instead.
- ``save_file``: streams one tensor at a time to a temporary file beside
  the target, fsyncs it and ``os.replace``s it into place; at most one
  tensor's host copy exists at a time (a device tensor, or a strided view
  of one, is made contiguous and copied to the host only when its bytes are
  written). The layout is the ``safetensors`` package's, byte for byte:
  tensors ordered by dtype (widest first, its enum order) then name, a
  compact JSON header padded with spaces to a multiple of 8.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import tempfile
from pathlib import Path
from typing import Callable, Mapping, TypeVar

import numpy as np
import torch

# safetensors dtype name -> torch dtype, in the format's enum order (the
# writer orders tensors by this, descending)
DTYPES: dict[str, torch.dtype] = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "F8_E5M2": torch.float8_e5m2,
    "F8_E4M3": torch.float8_e4m3fn,
    "I16": torch.int16,
    "U16": torch.uint16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "U32": torch.uint32,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
    "U64": torch.uint64,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
_RANK = {name: i for i, name in enumerate(DTYPES)}
_HEADER_ALIGN = 8
T = TypeVar("T")


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class SafeTensorsFile:
    """One ``.safetensors`` file: its header, and each tensor as a CPU view
    of a map of its own bytes for the time of a ``read``."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{self.path}: {size} bytes, too short for a safetensors file")
            (n,) = struct.unpack("<Q", f.read(8))
            if 8 + n > size:
                raise ValueError(f"{self.path}: header of {n} bytes runs past the file's {size}")
            header = json.loads(f.read(n))
        self._file = open(self.path, "rb")
        self._data_start = 8 + n
        self._metadata = header.pop("__metadata__", None)
        self._entries: dict[str, tuple[str, tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            dtype = info["dtype"]
            if dtype not in DTYPES:
                raise ValueError(f"{self.path}: tensor {name!r} has dtype {dtype}, not one this "
                                 f"reader knows ({', '.join(DTYPES)})")
            shape = tuple(int(s) for s in info["shape"])
            begin, end = (int(x) for x in info["data_offsets"])
            itemsize = torch.empty((), dtype=DTYPES[dtype]).element_size()
            if end - begin != _numel(shape) * itemsize or self._data_start + end > size:
                raise ValueError(f"{self.path}: tensor {name!r} of {dtype} {list(shape)} has "
                                 f"offsets [{begin}, {end}] in a file of {size} bytes")
            self._entries[name] = (dtype, shape, begin, end)

    def keys(self) -> list[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def metadata(self) -> dict | None:
        return self._metadata

    def dtype_shape(self, name: str) -> tuple[torch.dtype, tuple[int, ...]]:
        dtype, shape, _b, _e = self._entries[name]
        return DTYPES[dtype], shape

    def _view(self, name: str, buf: np.ndarray | None, base: int) -> torch.Tensor:
        """The tensor as a view of ``buf`` (the file's bytes from offset
        ``base`` on), or of an aligned copy where its offset in the file is
        not a multiple of its element size."""
        dtype_name, shape, begin, end = self._entries[name]
        dtype, count = DTYPES[dtype_name], _numel(shape)
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        lo = self._data_start + begin - base
        if (self._data_start + begin) % ((end - begin) // count):
            aligned = buf[lo:lo + end - begin].copy()
            return torch.frombuffer(aligned, dtype=dtype, count=count).reshape(shape)
        return torch.frombuffer(buf, dtype=dtype, count=count, offset=lo).reshape(shape)

    def read(self, name: str, use: Callable[[torch.Tensor], T]) -> T:
        """``use(view)`` on the tensor as a CPU view of a map of its own byte
        range, unmapped as soon as ``use`` returns, so its pages leave the
        process's resident set. ``use`` must not keep the view."""
        _dtype, _shape, begin, end = self._entries[name]
        if begin == end:
            return use(self._view(name, None, 0))
        start = self._data_start + begin
        base = start // mmap.ALLOCATIONGRANULARITY * mmap.ALLOCATIONGRANULARITY
        part = mmap.mmap(self._file.fileno(), self._data_start + end - base,
                         access=mmap.ACCESS_COPY, offset=base)
        view = None
        try:
            view = self._view(name, np.frombuffer(part, dtype=np.uint8), base)
            return use(view)
        finally:
            view = None
            try:
                part.close()
            except BufferError:
                pass  # a raising ``use``'s traceback still holds the view; it unmaps with it

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "SafeTensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_shards(checkpoint_dir: str | Path) -> list[SafeTensorsFile]:
    """Every ``*.safetensors`` file of a directory, in sorted order (an
    index JSON, where one exists, is not read)."""
    path = Path(checkpoint_dir)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return [SafeTensorsFile(f) for f in files]


class ShardIndex:
    """Tensor name -> the shard that holds it, over a directory's shards (a
    name in two shards is taken from the later one, as a dict built shard by
    shard would take it)."""

    def __init__(self, checkpoint_dir: str | Path, rename: Callable[[str], str] | None = None):
        self.shards = open_shards(checkpoint_dir)
        self._where: dict[str, tuple[SafeTensorsFile, str]] = {}
        for shard in self.shards:
            for name in shard.keys():
                self._where[rename(name) if rename else name] = (shard, name)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def __len__(self) -> int:
        return len(self._where)

    def read(self, name: str, use: Callable[[torch.Tensor], T]) -> T:
        shard, stored = self._where[name]
        return shard.read(stored, use)

    def close(self) -> None:
        for shard in self.shards:
            shard.close()


def _host_bytes(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in row-major order, from one host copy."""
    t = t.detach().contiguous().to("cpu").reshape(-1)
    if t.dtype != torch.uint8:
        t = t.view(torch.uint8)
    return memoryview(t.numpy())


def _header(order: list[tuple[str, torch.dtype, tuple[int, ...]]],
            metadata: Mapping[str, str] | None) -> bytes:
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, dtype, shape in order:
        size = _numel(shape) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": _NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % _HEADER_ALIGN)
    return struct.pack("<Q", len(raw)) + raw


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_file(tensors: Mapping[str, torch.Tensor], path: str | Path,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` as one safetensors file at ``path``, atomically: the
    bytes go to a temporary file in the same directory, one tensor at a
    time, which is fsynced and then renamed over ``path``."""
    path = Path(path)
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
    order = sorted(((n, t.dtype, tuple(t.shape)) for n, t in tensors.items()),
                   key=lambda e: (-_RANK[_NAMES[e[1]]], e[0]))
    head = _header(order, metadata)
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", suffix=".tmp", dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(head)
            for name, _dtype, _shape in order:
                f.write(_host_bytes(tensors[name]))  # freed before the next is made
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise
    _fsync_dir(path.parent)

