"""Portable weight files without JAX: a reader of the flax msgpack files
that the JAX package's ``export/checkpoints.py::save_msgpack`` writes
(``flax.serialization.to_bytes``), for a machine that has no JAX, no flax
and no ``msgpack`` package.

The decoder takes the subset of msgpack that ``to_bytes`` writes: maps,
arrays, str, bin, ints, floats, nil and bool, and two ext types of flax
(serialization.py, ``_MsgpackExtType``): 1, an ndarray, and 3, a numpy
scalar, each a packed ``(shape, dtype name, C-order bytes)``. A leaf above
2^30 bytes, which flax splits into a ``__msgpack_chunked_array__`` map of
flat chunks, is joined again. bfloat16, which numpy lacks, comes back as a
``torch.bfloat16`` tensor (the bytes viewed as uint16, then as bfloat16);
every other leaf as a numpy array or scalar. The orbax training
checkpoints (``save_checkpoint``/``load_checkpoint``) belong to training
and are not ported.
"""
from __future__ import annotations

import pathlib
import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """msgpack values from ``data``, one at a time from the front."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",   # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}   # str
        if b in sized:
            raw = self.take(self.unpack(sized[b]))
            return raw if b <= 0xC6 else raw.decode()
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is outside the subset "
                         "flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack value from ``data``, which it must fill."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack value")
    return out


def _ndarray(data: bytes):
    shape, name, buf = unpackb(data)
    if name == "bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape, order="C")
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        a = _ndarray(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack ext type {code} is outside the subset flax writes for weights")


def _unchunk(tree):
    """Joins flax's chunked leaves (a map with CHUNKED, 'shape' and 'chunks'
    maps keyed '0', '1', ...) back into arrays, everywhere in ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_msgpack(path: str | pathlib.Path) -> dict:
    """A flax msgpack weight file -> the nested dict of its leaves
    ({'params': ..., 'batch_stats': ...} for the JAX package's networks),
    which convert/from_jax.py::variables_to_state_dict takes."""
    return _unchunk(unpackb(pathlib.Path(path).read_bytes()))
