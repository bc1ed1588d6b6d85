"""Checkpoints without JAX: the flax msgpack weight files of the JAX
package's ``export/checkpoints.py`` (``save_msgpack``/``load_msgpack``,
``flax.serialization.to_bytes``), read and written for a machine that has
no JAX, no flax and no ``msgpack`` package, and the training checkpoints
(``save_checkpoint``/``load_checkpoint``).

The decoder takes the subset of msgpack that ``to_bytes`` writes: maps,
arrays, str, bin, ints, floats, nil and bool, and two ext types of flax
(serialization.py, ``_MsgpackExtType``): 1, an ndarray, and 3, a numpy
scalar, each a packed ``(shape, dtype name, C-order bytes)``. A leaf above
2^30 bytes, which flax splits into a ``__msgpack_chunked_array__`` map of
flat chunks, is joined again. bfloat16, which numpy lacks, comes back as a
``torch.bfloat16`` tensor (the bytes viewed as uint16, then as bfloat16);
every other leaf as a numpy array or scalar.

``save_msgpack`` writes the same subset with the bytes ``to_bytes`` gives
for a tree of numpy arrays (str keys in the tree's order, the shortest
msgpack form of each value, leaves above MAX_CHUNK_SIZE chunked), so that
the JAX package's ``load_msgpack`` reads a file the port wrote;
convert/from_jax.py::state_dict_to_variables gives the tree of a module.

The JAX package keeps its training state with orbax, which the card's
machine lacks. The port keeps a ``TrainState`` (train/train_step.py: the
module, the optimizer, the step and the EMA) with ``torch.save`` in its own
``path/step_N`` layout, the newest ``keep`` steps kept; ``load_checkpoint``
restores it bit for bit.
"""
from __future__ import annotations

import pathlib
import shutil
import struct
from typing import Any, Optional

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization's: the most bytes of one leaf or chunk
CKPT_FILE = "state.pt"


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


# ------------------------------------------------------------------ writing

def _sized(out: bytearray, n: int, small: Optional[int], tags) -> None:
    """The header of a str, bin, array or map of ``n`` items: the fix form
    below ``small`` (None: there is none), else the 8-, 16- or 32-bit one."""
    if small is not None and n < small[0]:
        out.append(small[1] | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"{n} items: more than msgpack holds")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2 ** 64 - 1)) if v >= 0 else (
        (0xD0, ">b", -2 ** 7, 0), (0xD1, ">h", -2 ** 15, 0), (0xD2, ">i", -2 ** 31, 0),
        (0xD3, ">q", -2 ** 63, 0))
    for tag, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(tag)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"{v} is outside msgpack's integers")


def _array_bytes(a) -> bytes:
    """flax's _ndarray_to_bytes: packb((shape, dtype name, C-order bytes))."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return packb((tuple(a.shape), "bfloat16", a.contiguous().view(torch.int16)
                          .numpy().tobytes()))
        a = a.numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no flax msgpack form")
    return packb((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _sized(out, len(data), None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, v: Any) -> None:
    if v is None or isinstance(v, bool):
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[v])
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        raw = v.encode()
        _sized(out, len(raw), (32, 0xA0), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        _sized(out, len(v), None, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), (16, 0x90), (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _sized(out, len(v), (16, 0x80), (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, str(k))
            _pack(out, x)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(v)))
    else:
        raise TypeError(f"{type(v).__name__} has no flax msgpack form")


def packb(value: Any) -> bytes:
    """``value`` (dicts, lists and tuples of numpy arrays and scalars, CPU
    tensors, str, bytes, int, float, bool, None) as msgpack."""
    out = bytearray()
    _pack(out, value)
    return bytes(out)


def _itemsize(a) -> int:
    return a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize


def _chunked(tree):
    """flax's _chunk_array_leaves_in_place on a copy: a leaf above
    MAX_CHUNK_SIZE bytes becomes {CHUNKED: True, 'shape': {'0': ...},
    'chunks': {'0': flat chunk, ...}}."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and \
                v.reshape(-1).shape[0] * _itemsize(v) > MAX_CHUNK_SIZE:
            flat = v.reshape(-1)
            size = max(1, int(MAX_CHUNK_SIZE / _itemsize(v)))
            chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
            v = {CHUNKED: True, "shape": {str(i): n for i, n in enumerate(v.shape)},
                 "chunks": {str(i): c for i, c in enumerate(chunks)}}
        out[k] = _chunked(v)
    return out


def save_msgpack(path: str | pathlib.Path, variables: Any) -> None:
    """Portable single-file weights in flax's msgpack: what the JAX
    package's ``save_msgpack`` writes for the same tree of arrays."""
    pathlib.Path(path).write_bytes(packb(_chunked(variables)))


# ---------------------------------------------------------- training state

def _steps(path: pathlib.Path):
    found = []
    for d in path.glob("step_*"):
        if d.is_dir() and d.name[5:].isdigit() and (d / CKPT_FILE).exists():
            found.append(int(d.name[5:]))
    return sorted(found)


def _step_file(path, step: Optional[int]) -> pathlib.Path:
    """The file of the latest (or given) step under ``path``; raises
    FileNotFoundError when there is none."""
    path = pathlib.Path(path).resolve()
    steps = _steps(path)
    s = step if step is not None else (steps[-1] if steps else None)
    if s is None or s not in steps:
        raise FileNotFoundError(f"no checkpoint {'' if s is None else f'step {s} '}under {path}")
    return path / f"step_{s}" / CKPT_FILE


def save_checkpoint(path: str | pathlib.Path, state: Any, step: Optional[int] = None,
                    keep: int = 3) -> pathlib.Path:
    """Save a TrainState (module, optimizer, step, EMA) under path/step_N
    (N = ``step``, else ``state.step``), written to a temporary directory
    and renamed into place; then only the newest ``keep`` steps stay."""
    path = pathlib.Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    s = int(step if step is not None else state.step)
    tmp = path / f".step_{s}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step), "ema": state.ema}, tmp / CKPT_FILE)
    final = path / f"step_{s}"
    shutil.rmtree(final, ignore_errors=True)
    tmp.rename(final)
    for old in _steps(path)[:-keep]:
        shutil.rmtree(path / f"step_{old}")
    return path


def load_checkpoint(path: str | pathlib.Path, target: Any, step: Optional[int] = None) -> Any:
    """Restore the latest (or given) step into ``target``, a TrainState of
    the same module and optimizer: its module's parameters and buffers and
    its optimizer's state are loaded in place, its step and EMA replaced.
    Returns ``target``."""
    device = next(target.model.parameters()).device
    blob = torch.load(_step_file(path, step), map_location=device, weights_only=True)
    target.model.load_state_dict(blob["model"], strict=True)
    target.optimizer.load_state_dict(blob["optimizer"])
    target.step = blob["step"]
    target.ema = blob["ema"]
    return target


def load_checkpoint_weights(path: str | pathlib.Path, step: Optional[int] = None) -> dict:
    """The module's state_dict of the latest (or given) ``path/step_N``
    checkpoint, on the CPU, for a reader that has no TrainState (the
    eval CLI)."""
    return torch.load(_step_file(path, step), map_location="cpu", weights_only=True)["model"]
