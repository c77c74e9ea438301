"""flax's msgpack checkpoint format, read and written in pure Python and NumPy.

Counterpart of ``flax.serialization.msgpack_restore`` / ``to_bytes``, so the
port reads the converted weights that ``tools/convert_torchvision.py`` and
``tools/convert_clap.py`` write, with neither flax nor the ``msgpack``
package. The format:

  * msgpack maps (str keys), arrays, str, bin, ints, floats, nil and bool;
  * extension 1: an ndarray, itself a msgpack array ``[shape, dtype name,
    row-major bytes]``; extension 2: a complex scalar ``[real, imag]``;
    extension 3: a NumPy scalar, packed as a 0-d ndarray;
  * a leaf over ``MAX_CHUNK_SIZE`` bytes as ``{"__msgpack_chunked_array__":
    True, "shape": {"0": …}, "chunks": {"0": flat chunk, …}}``.

NumPy has no bfloat16, so a bfloat16 leaf is a ``torch.bfloat16`` tensor
here, and :func:`to_bytes` writes such tensors (any torch tensor) as flax
writes the same array. :func:`to_bytes` encodes as flax does, byte for byte:
the smallest msgpack form of each int, str and container, float64 floats.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ----------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def value(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sized:
            return self.take(self.unpack(sized[c]))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
            return self.ext(self.unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        if 0xD4 <= c <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c]))
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).value()
            return complex(re, im)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unknown msgpack extension type {code}")


def _ndarray_from_bytes(data: bytes):
    shape, name, buffer = _Reader(data, raw=True).value()
    name = name.decode()
    if name == "bfloat16":
        bits = torch.frombuffer(bytearray(buffer), dtype=torch.int16) if buffer else torch.empty(0, dtype=torch.int16)
        return bits.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes):
    """flax msgpack bytes → the tree: nested dicts of NumPy arrays (bfloat16
    leaves as torch tensors) and Python scalars."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return _unchunk(tree)


def read(path: str):
    """:func:`restore` of a file."""
    with open(path, "rb") as f:
        return restore(f.read())


# ----------------------------------------------------------------- encoding


def _sized(out: bytearray, n: int, small: int | None, small_max: int, forms: tuple) -> None:
    """A header: the fix form ``small | n`` up to ``small_max``, else the first (byte, fmt, max) that fits."""
    if small is not None and n <= small_max:
        out.append(small | n)
        return
    for byte, fmt, most in forms:
        if n <= most:
            out += struct.pack(fmt, byte, n)
            return
    raise ValueError(f"msgpack object of size {n} is too large")


def _int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out += struct.pack("B", x)
    elif -0x20 <= x < 0:
        out += struct.pack("b", x)
    else:
        for lo, hi, fmt, byte in ((0x80, 0xFF, ">BB", 0xCC), (-0x80, -1, ">Bb", 0xD0),
                                  (0x100, 0xFFFF, ">BH", 0xCD), (-0x8000, -0x81, ">Bh", 0xD1),
                                  (0x10000, 0xFFFFFFFF, ">BI", 0xCE), (-0x80000000, -0x8001, ">Bi", 0xD2),
                                  (0x100000000, 0xFFFFFFFFFFFFFFFF, ">BQ", 0xCF),
                                  (-0x8000000000000000, -0x80000001, ">Bq", 0xD3)):
            if lo <= x <= hi:
                out += struct.pack(fmt, byte, x)
                return
        raise OverflowError(f"integer {x} out of msgpack's range")


def _bin(out: bytearray, b: bytes) -> None:
    _sized(out, len(b), None, 0, ((0xC4, ">BB", 0xFF), (0xC5, ">BH", 0xFFFF), (0xC6, ">BI", 0xFFFFFFFF)))
    out += b


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _sized(out, len(data), None, 0, ((0xC7, ">BB", 0xFF), (0xC8, ">BH", 0xFFFF), (0xC9, ">BI", 0xFFFFFFFF)))
    out += struct.pack("b", code) + data


def _ndarray_to_bytes(arr) -> bytes:
    """flax ``_ndarray_to_bytes``: msgpack of (shape, dtype name, C-order bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        shape, name = tuple(t.shape), str(t.dtype).removeprefix("torch.")
        raw = t.view(torch.int16).numpy().tobytes() if t.dtype == torch.bfloat16 else t.numpy().tobytes()
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serialised")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack(out, [list(shape), name, raw])
    return bytes(out)


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif type(x) is bool:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out += struct.pack(">Bd", 0xCB, x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _sized(out, len(b), 0xA0, 0x1F, ((0xD9, ">BB", 0xFF), (0xDA, ">BH", 0xFFFF), (0xDB, ">BI", 0xFFFFFFFF)))
        out += b
    elif type(x) in (bytes, bytearray):
        _bin(out, bytes(x))
    elif type(x) is list:
        _sized(out, len(x), 0x90, 0x0F, ((0xDC, ">BH", 0xFFFF), (0xDD, ">BI", 0xFFFFFFFF)))
        for v in x:
            _pack(out, v)
    elif type(x) is dict:
        _sized(out, len(x), 0x80, 0x0F, ((0xDE, ">BH", 0xFFFF), (0xDF, ">BI", 0xFFFFFFFF)))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext(out, _EXT_NDARRAY, _ndarray_to_bytes(x))
    elif isinstance(x, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    elif type(x) is complex:
        pair = bytearray()
        _pack(pair, [x.real, x.imag])
        _ext(out, _EXT_COMPLEX, bytes(pair))
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def _state_tree(tree):
    """flax ``to_state_dict``: dict keys as str, lists and tuples as {"0": …}; oversized array leaves chunked."""
    if isinstance(tree, dict):
        return {str(k): _state_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_tree(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        size = tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else tree.nbytes
        if size > MAX_CHUNK_SIZE:
            flat = tree.reshape(-1)
            step = max(1, MAX_CHUNK_SIZE // (tree.element_size() if isinstance(tree, torch.Tensor)
                                             else tree.dtype.itemsize))
            chunks = [flat[i : i + step] for i in range(0, len(flat), step)]
            return {_CHUNKED: True, "shape": {str(i): n for i, n in enumerate(tree.shape)},
                    "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def to_bytes(tree) -> bytes:
    """A tree of dicts (lists, tuples) with array (NumPy or torch) and scalar leaves → the
    bytes ``flax.serialization.to_bytes`` writes for the same tree."""
    out = bytearray()
    _pack(out, _state_tree(tree))
    return bytes(out)


def write(path: str, tree) -> None:
    """:func:`to_bytes` of ``tree`` into a file."""
    with open(path, "wb") as f:
        f.write(to_bytes(tree))
