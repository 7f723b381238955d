"""Checkpoint reading without flax: a pure-Python reader for the msgpack
files ``flax.serialization.to_bytes`` writes, and the map from the flax
parameter tree to this package's module state dict.

The reader covers the msgpack subset flax writes (nil, bool, ints,
floats, str, bin, arrays, maps) plus flax's extension types
(``flax.serialization._MsgpackExtType``): 1 is an ndarray packed as
``(shape, dtype name, C-order bytes)``, 2 a complex, 3 a numpy scalar.
Chunked oversized arrays (``__msgpack_chunked_array__``) are rejoined.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                  0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                  0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self.unpack(scalar[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).obj()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = _Reader(data).obj()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":   # stored as the high half of an f32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """Counterpart of ``flax.serialization.msgpack_restore``."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_tree(path) -> Any:
    """The whole state tree stored in a flax msgpack checkpoint file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def model_params(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The network's parameter dict (the ``params`` collection) from a
    checkpoint tree: a TrainState (``{"params": {"params": ...}, ...}``),
    a variables dict (``{"params": ...}``) or the bare collection."""
    while isinstance(tree.get("params"), dict):
        tree = tree["params"]
    return tree


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _leaf_to_torch(path: Tuple[str, ...], a: np.ndarray):
    """(torch name, torch-layout array) for one flax leaf."""
    name, t = path[-1], torch.as_tensor(np.array(a, copy=True))
    head = ".".join(path[:-1])
    if name.startswith("down_b_"):                 # stride-2 conv bias
        return f"{head}.down_{name[len('down_b_'):]}.bias", t
    if name.startswith("down_") and t.ndim == 3:   # (8, Cin, Cout)
        cin, cout = t.shape[1], t.shape[2]
        return (f"{head}.{name}.weight",
                t.reshape(2, 2, 2, cin, cout).permute(4, 3, 0, 1, 2))
    if name.startswith("up_") and t.ndim == 3:     # transposed stride-2
        cin, cout = t.shape[1], t.shape[2]
        return (f"{head}.{name}.weight",
                t.reshape(2, 2, 2, cin, cout).permute(3, 4, 0, 1, 2))
    if name == "kernel" and t.ndim == 3:           # (27, Cin, Cout) conv
        cin, cout = t.shape[1], t.shape[2]
        return (f"{head}.weight",
                t.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2))
    if name == "kernel":                           # Dense (in, out)
        return f"{head}.weight", t.T
    if name == "scale":                            # GroupNorm
        return f"{head}.weight", t
    return ".".join(path), t


def params_to_torch(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> state dict of ``models.network.NKSRNetwork``:
    Dense ``(in, out)`` -> ``nn.Linear`` ``(out, in)``; SparseConv
    ``(27, Cin, Cout)`` -> conv3d ``(Cout, Cin, 3, 3, 3)``; the stride-2
    ``down_d``/``up_d`` ``(8, Cin, Cout)`` -> conv3d / transposed conv3d
    with kernel 2; GroupNorm ``scale`` -> ``weight``."""
    out = {}
    for path, leaf in _flatten(model_params(tree)):
        name, t = _leaf_to_torch(path, leaf)
        out[name] = t.contiguous()
    return out


def torch_to_params(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``params_to_torch``: state dict -> flax-layout numpy
    tree."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        parts = key.split(".")
        a = t.detach().cpu()
        *head, mod, kind = parts
        if mod.startswith("down_") and kind == "bias":
            path, arr = head + [f"down_b_{mod[len('down_'):]}"], a
        elif mod.startswith("down_"):
            path = head + [mod]
            arr = a.permute(2, 3, 4, 1, 0).reshape(8, a.shape[1], a.shape[0])
        elif mod.startswith("up_"):
            path = head + [mod]
            arr = a.permute(2, 3, 4, 0, 1).reshape(8, a.shape[0], a.shape[1])
        elif kind == "weight" and a.ndim == 5:
            path = head + [mod, "kernel"]
            arr = a.permute(2, 3, 4, 1, 0).reshape(27, a.shape[1], a.shape[0])
        elif kind == "weight" and a.ndim == 2:
            path, arr = head + [mod, "kernel"], a.T
        elif kind == "weight" and mod.startswith("MaskedGroupNorm"):
            path, arr = head + [mod, "scale"], a
        else:
            path, arr = parts, a
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr.numpy())
    return tree
