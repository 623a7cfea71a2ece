"""A reader for the checkpoints the JAX package writes (flax msgpack `.ckpt`).

`flax.serialization.to_bytes` turns a tree into msgpack: nested maps with
str keys (a tuple becomes a map keyed "0", "1", ...), Python scalars, str
and bin, and every array as msgpack ext type 1 whose payload is itself
msgpack of (shape, dtype name, C-order bytes). Ext type 2 holds a complex
number as (real, imag) and ext type 3 a numpy scalar in the array layout.
An array larger than flax's MAX_CHUNK_SIZE (2^30 bytes) is written as a map
{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}} of
flat pieces.

This module reads that subset with the standard library and numpy, and
returns torch tensors (`bfloat16` as torch.bfloat16); no flax, msgpack or
jax is imported. Anything outside the subset raises a ValueError that names
the byte offset where it was found; nothing is skipped.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# the numpy dtype names flax writes, and the torch dtype of each
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint64": torch.uint64, "uint32": torch.uint32,
    "uint16": torch.uint16, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


class _Reader:
    """A msgpack decoder over one buffer; `pos` is the offset of the next byte."""

    def __init__(self, data, ext: bool = True):
        self.data = memoryview(data)
        self.pos = 0
        self.ext = ext

    def fail(self, at: int, what: str):
        raise ValueError(f"flax checkpoint: {what} at byte offset {at}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            self.fail(self.pos, f"truncated data (wanted {n} bytes)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, at)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n, at)
            return self.array(n) if kind == "array" else self.map(n, at)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        exts = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in exts:
            return self.extension(exts[b], at)
        if b in (0xC7, 0xC8, 0xC9):
            return self.extension(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]), at)
        self.fail(at, f"msgpack type byte 0x{b:02x} outside flax's subset")

    def str(self, n: int, at: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError:
            self.fail(at, "a str that is not UTF-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if not isinstance(key, str):
                self.fail(key_at, f"a map key of type {type(key).__name__} (flax writes str keys)")
            out[key] = self.value()
        return _unchunk(out, at, self) if out.get(_CHUNKED) is True else out

    def extension(self, n: int, at: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if not self.ext:
            self.fail(at, "an ext type inside an array payload")
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(payload, at, self)
            return arr if code == _EXT_NDARRAY else arr.reshape(()).item()
        if code == _EXT_COMPLEX:
            inner = _Reader(payload, ext=False)
            parts = inner.value()
            if (not isinstance(parts, list) or len(parts) != 2
                    or inner.pos != len(payload)):
                self.fail(at, "a complex ext payload that is not (real, imag)")
            return complex(parts[0], parts[1])
        self.fail(at, f"msgpack ext type {code} (flax writes 1, 2 and 3)")


def _ndarray(payload: memoryview, at: int, outer: _Reader) -> torch.Tensor:
    """flax's array payload, msgpack (shape, dtype name, C-order bytes) -> tensor."""
    inner = _Reader(payload, ext=False)
    parts = inner.value()
    if (not isinstance(parts, list) or len(parts) != 3 or inner.pos != len(payload)
            or not isinstance(parts[0], list) or not isinstance(parts[2], bytes)):
        outer.fail(at, "an array payload that is not (shape, dtype, bytes)")
    shape, name, raw = parts
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        outer.fail(at, f"array dtype '{name}'")
    dtype = _DTYPES[name]
    np_dtype = np.uint16 if dtype == torch.bfloat16 else np.dtype(name)
    count = int(np.prod(shape, dtype=np.int64))
    if count * np.dtype(np_dtype).itemsize != len(raw):
        outer.fail(at, f"{len(raw)} bytes for a {name} array of shape {tuple(shape)}")
    arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy()
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _unchunk(node: dict, at: int, reader: _Reader) -> torch.Tensor:
    """A chunked array (flax's _chunk) -> one tensor of its shape."""
    try:
        shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    except (KeyError, TypeError):
        reader.fail(at, "a chunked array without its shape and chunks")
    if not chunks or not all(isinstance(c, torch.Tensor) and c.dim() == 1 for c in chunks):
        reader.fail(at, "a chunked array whose chunks are not flat arrays")
    flat = torch.cat(chunks)
    if flat.numel() != int(np.prod(shape, dtype=np.int64)):
        reader.fail(at, f"chunks of {flat.numel()} elements for shape {tuple(shape)}")
    return flat.reshape(shape)


def msgpack_restore(data) -> object:
    """The tree of `flax.serialization.msgpack_restore(data)`, with tensors
    for arrays (chunked arrays reassembled)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        reader.fail(reader.pos, f"{len(reader.data) - reader.pos} bytes after the tree")
    return tree


def strip_remat_prefix(tree):
    """Map keys written by older remat-wrapped models ('CheckpointConvINReLU_0')
    to the module names ('ConvINReLU_0'), as the JAX package's loader does."""
    if not isinstance(tree, dict):
        return tree
    return {(k[len("Checkpoint"):] if k.startswith("Checkpoint") else k): strip_remat_prefix(v)
            for k, v in tree.items()}


def read_flax_checkpoint(path: str):
    """A `.ckpt` file of the JAX package -> its tree (tensors on the CPU)."""
    with open(path, "rb") as fp:
        return strip_remat_prefix(msgpack_restore(fp.read()))


def numpy_tree(tree):
    """Tensor leaves -> float32 / integer numpy arrays (bf16 widened exactly),
    the form `hoig_torch.models.convert` maps."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return tree
