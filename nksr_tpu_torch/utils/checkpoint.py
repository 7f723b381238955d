"""Checkpoints without flax or msgpack: a pure-Python reader and writer
of the msgpack files ``flax.serialization.to_bytes`` writes and reads,
the map between the flax parameter tree and this package's module state
dict, and the train state in the JAX package's layout.

The reader covers the msgpack subset flax writes (nil, bool, ints,
floats, str, bin, arrays, maps) plus flax's extension types
(``flax.serialization._MsgpackExtType``): 1 is an ndarray packed as
``(shape, dtype name, C-order bytes)``, 2 a complex, 3 a numpy scalar.
Chunked oversized arrays (``__msgpack_chunked_array__``) are rejoined.
The writer (``msgpack_serialize``) is its mirror for what a train state
holds: maps with string keys, and arrays as extension 1.

``save_train_state`` writes (params, optimizer state, step) as
``nksr_tpu.utils.checkpoint.save_params`` writes the JAX package's
``TrainState``, so that package's ``load_params`` restores it into
``train.loop.init_state``'s template, and ``load_train_state`` resumes
from a checkpoint of either package.

The torch-style state dicts of the JAX package, on numpy trees: its
canonical export (``params_to_torch_state_dict`` and its inverse
``torch_state_dict_to_params``), the family import of the reference
wheel's checkpoints (``import_reference_state_dict``), and
``load_checkpoint_from_url``, which resolves a checkpoint's name in the
local cache ``NKSR_TPU_CKPT_DIR``.
"""

from __future__ import annotations

import os
import pickle
import re
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

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


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def pack(self, fmt: str, *v):
        self.out += struct.pack(fmt, *v)

    def obj(self, x: Any) -> None:
        if x is None:
            self.out.append(0xC0)
        elif isinstance(x, bool):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int):
            self.int(x)
        elif isinstance(x, float):
            self.pack(">Bd", 0xCB, x)
        elif isinstance(x, str):
            self.str(x)
        elif isinstance(x, (bytes, bytearray)):
            self.sized(len(x), None, (0xC4, ">B"), (0xC5, ">H"),
                       (0xC6, ">I"))
            self.out += x
        elif isinstance(x, (list, tuple)):
            self.sized(len(x), 0x90, (0xDC, ">H"), (0xDD, ">I"))
            for v in x:
                self.obj(v)
        elif isinstance(x, dict):
            self.sized(len(x), 0x80, (0xDE, ">H"), (0xDF, ">I"))
            for k, v in x.items():
                self.str(str(k))
                self.obj(v)
        else:
            self.ndarray(x)

    def sized(self, n: int, fix: Optional[int], *forms):
        """A length header: the fix form below 16 entries, else the first
        of ``forms`` ((type byte, struct format)) that holds ``n``."""
        if fix is not None and n < 16:
            self.out.append(fix | n)
            return
        for byte, fmt in forms:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.pack(">B" + fmt[1:], byte, n)
                return
        raise ValueError(f"msgpack: length {n} too large")

    def int(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.pack(">b" if v < 0 else ">B", v)
        elif v >= 0:
            for byte, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                              (0xCF, ">Q")):
                if v < 1 << (8 * struct.calcsize(fmt)):
                    self.pack(">B" + fmt[1:], byte, v)
                    return
        else:
            for byte, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                              (0xD3, ">q")):
                if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    self.pack(">B" + fmt[1:], byte, v)
                    return

    def str(self, v: str) -> None:
        b = v.encode("utf-8")
        if len(b) < 32:
            self.out.append(0xA0 | len(b))
        else:
            self.sized(len(b), None, (0xD9, ">B"), (0xDA, ">H"),
                       (0xDB, ">I"))
        self.out += b

    def ndarray(self, x: Any) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        a = np.asarray(x)
        inner = _Writer()
        inner.obj([list(a.shape), a.dtype.name, a.tobytes("C")])
        data = bytes(inner.out)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            self.out.append(fixed[len(data)])
        else:
            self.sized(len(data), None, (0xC7, ">B"), (0xC8, ">H"),
                       (0xC9, ">I"))
        self.pack(">b", _EXT_NDARRAY)
        self.out += data


def msgpack_serialize(tree: Any) -> bytes:
    """Counterpart of ``flax.serialization.msgpack_serialize`` for a tree
    of string-keyed dicts with numpy or torch arrays (and python
    scalars) at the leaves."""
    w = _Writer()
    w.obj(tree)
    return bytes(w.out)


def save_tree(path, tree: Any) -> None:
    """Write a state tree as a flax msgpack checkpoint file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(msgpack_serialize(tree))
    tmp.replace(path)


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


# ---------------------------------------------------------------- train state
def _opt_to_tree(opt: Dict[str, Any]) -> Dict[str, Any]:
    """Optimizer state (``train.loop.init_opt_state``'s layout, moments
    by torch parameter name) -> the flax state dict of optax's
    ``ApplyIfFiniteState``."""
    def moments(m):
        return {"params": torch_to_params(m)}
    ams = opt["inner_state"]["1"]
    return {"notfinite_count": opt["notfinite_count"],
            "last_finite": opt["last_finite"],
            "total_notfinite": opt["total_notfinite"],
            "inner_state": {
                "0": {}, "1": {"count": ams["count"], "mu": moments(ams["mu"]),
                               "nu": moments(ams["nu"]),
                               "nu_max": moments(ams["nu_max"])},
                "2": {}, "3": {"count": opt["inner_state"]["3"]["count"]}}}


def _tree_to_opt(tree: Dict[str, Any], device) -> Dict[str, Any]:
    def t(a, dtype=None):
        return torch.as_tensor(np.array(a, copy=True), device=device,
                               dtype=dtype)

    def moments(m):
        return {k: v.to(device) for k, v in params_to_torch(m).items()}
    ams = tree["inner_state"]["1"]
    return {"notfinite_count": t(tree["notfinite_count"], torch.int32),
            "last_finite": t(tree["last_finite"], torch.bool),
            "total_notfinite": t(tree["total_notfinite"], torch.int32),
            "inner_state": {
                "0": {}, "1": {"count": t(ams["count"], torch.int32),
                               "mu": moments(ams["mu"]),
                               "nu": moments(ams["nu"]),
                               "nu_max": moments(ams["nu_max"])},
                "2": {}, "3": {"count": t(tree["inner_state"]["3"]["count"],
                                          torch.int32)}}}


def save_train_state(path, net: torch.nn.Module, opt_state: Dict[str, Any],
                     step: int) -> None:
    """Write (params, optimizer state, step) as the JAX package's
    ``save_params(path, TrainState(...))`` does."""
    save_tree(path, {
        "params": {"params": torch_to_params(net.state_dict())},
        "opt_state": _opt_to_tree(opt_state),
        "step": np.asarray(step, np.int32)})


def load_train_state(path, net: torch.nn.Module, device
                     ) -> Tuple[Dict[str, Any], int]:
    """Load a train-state checkpoint of either package: the params into
    ``net`` (in place), and (optimizer state, step)."""
    tree = load_tree(path)
    net.load_state_dict(params_to_torch(model_params(tree)), strict=True)
    return _tree_to_opt(tree["opt_state"], device), int(tree["step"])


# ------------------------------------------------- torch-style state dicts
# The JAX package's exchange layouts (nksr_tpu/utils/checkpoint.py), on
# numpy trees: its canonical export (flax paths with "kernel" -> "weight",
# Dense kernels transposed, conv kernels (27, Cin, Cout) -> (Cout, Cin,
# 27)) and the import of the reference wheel's family layout.
def _flat_dotted(tree) -> Dict[str, Any]:
    """{"a.b.c": leaf} of a nested dict, as the JAX package flattens."""
    return {".".join(path): leaf for path, leaf in _flatten(tree)}


def _rebuild(tree, flat: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with the leaves of ``flat`` (by dotted path)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    return flat[prefix[:-1]]


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def params_to_torch_state_dict(params) -> Dict[str, np.ndarray]:
    """The JAX package's canonical torch-style export of a flax tree
    (``nksr_tpu.utils.checkpoint.params_to_torch_state_dict``): the
    top-level ``params`` dropped from the paths, ``kernel`` leaves
    transposed (all axes reversed) under ``weight``, ``scale`` leaves
    under ``weight``, everything else as it is."""
    out = {}
    for k, v in _flat_dotted(params).items():
        tk = k.replace("params.", "")
        arr = np.asarray(v)
        if tk.endswith("kernel"):
            out[tk[: -len("kernel")] + "weight"] = arr.T
        elif tk.endswith("scale"):
            out[tk[: -len("scale")] + "weight"] = arr
        else:
            out[tk] = arr
    return out


def torch_state_dict_to_params(cfg, state_dict: Dict[str, Any], template):
    """Inverse of ``params_to_torch_state_dict`` onto a flax-layout numpy
    ``template`` (``nksr_tpu.utils.checkpoint.torch_state_dict_to_params``):
    each template leaf takes the state-dict tensor at its normalised path
    (transposed for a ``kernel``) where the shapes agree, and keeps its
    own value elsewhere; raises if no leaf matches.  ``cfg`` is unused,
    as in the JAX package."""
    flat_t = {k: _as_numpy(v) for k, v in state_dict.items()}
    flat_p = _flat_dotted(template)
    new, missing = {}, []
    for pk, pv in flat_p.items():
        tk = pk.replace("params.", "").replace("/", ".")
        cand = None
        for suffix, name in (("kernel", "weight"), ("scale", "weight"),
                             ("bias", "bias"), ("", None)):
            if suffix and not tk.endswith(suffix):
                continue
            base = tk[: -len(suffix)].rstrip(".") if suffix else tk
            key = f"{base}.{name}" if name else base
            if key in flat_t:
                cand = flat_t[key].T if suffix == "kernel" else flat_t[key]
                break
        if cand is None or cand.shape != np.shape(pv):
            missing.append(pk)
            new[pk] = pv
        else:
            new[pk] = np.asarray(cand, np.asarray(pv).dtype)
    if missing and len(missing) == len(flat_p):
        raise ValueError(f"state_dict matched no parameters; first keys: "
                         f"{list(flat_t)[:5]}")
    return _rebuild(template, new)


# The published NKSR checkpoints' top-level families (the reference
# wheel's ``NKSRNetwork`` submodules).  The interpolator and decoder
# families are plain MLPs in both networks and map by registration order
# and shape; the wheel's encoder and UNet are another architecture and
# are never transplanted.  The JAX package's canonical export has the
# same five top-level names, so these names alone do not tell a wheel
# checkpoint from it (``models.network.NKSRNetwork.load_state_dict``
# decides by key set and shapes first).
REFERENCE_FAMILIES = ("encoder", "unet", "interpolators",
                      "sdf_decoder", "udf_decoder")

FAMILY_TO_PARAM_SUBTREE = {
    "interpolators": ("params", "interpolators"),
    "sdf_decoder": ("params", "sdf_decoder"),
    "udf_decoder": ("params", "udf_decoder"),
    "encoder": ("params", "encoder"),
    "unet": ("params", "unet"),
}


def looks_like_reference_state_dict(state_dict: Dict[str, Any]) -> bool:
    """A top-level family name and no ``params.`` key (the JAX package's
    test, which its own canonical export also passes)."""
    tops = {k.split(".")[0] for k in state_dict}
    return bool(tops & set(REFERENCE_FAMILIES)) and \
        not any(k.startswith("params.") for k in state_dict)


def _family_leaves_in_order(subtree, prefix: str = ""):
    """[(path, leaf)] of a flax subtree, keys sorted with each numeric
    suffix as a number (``Dense_2`` before ``Dense_10``): the order the
    layers were registered in."""
    def sort_key(k):
        m = re.search(r"_(\d+)$", k)
        return (re.sub(r"_\d+$", "", k), int(m.group(1)) if m else -1)

    if isinstance(subtree, dict):
        out = []
        for k in sorted(subtree, key=sort_key):
            out.extend(_family_leaves_in_order(subtree[k], f"{prefix}{k}."))
        return out
    return [(prefix[:-1], subtree)]


def import_reference_state_dict(state_dict: Dict[str, Any], template,
                                strict: bool = False):
    """Import a reference-wheel state dict by family onto a flax-layout
    numpy ``template`` (``nksr_tpu.utils.checkpoint.
    import_reference_state_dict``).  In each of the interpolator and
    decoder families the 2-D weights, in the state dict's order, pair
    with the family's Dense kernels in registration order (transposed),
    each with its bias where the shapes agree.  Returns ``(params,
    report)``, report mapping each family to ``mapped (N tensors)``,
    ``skipped (...)`` or ``absent``; ``strict=True`` raises where an
    interpolator or decoder family does not map."""
    flat_t = {k: _as_numpy(v) for k, v in state_dict.items()}
    report: Dict[str, str] = {}
    new_flat = dict(_flat_dotted(template))

    for fam in ("interpolators", "sdf_decoder", "udf_decoder"):
        fam_items = [(k, v) for k, v in flat_t.items()
                     if k.split(".")[0] == fam]
        if not fam_items:
            report[fam] = "absent"
            continue
        weights = [(k, v) for k, v in fam_items if v.ndim == 2]
        biases = {k.rsplit(".", 1)[0]: v for k, v in fam_items
                  if v.ndim == 1}
        sub = template
        for p in FAMILY_TO_PARAM_SUBTREE[fam]:
            sub = sub.get(p, {}) if isinstance(sub, dict) else {}
        our_kernels = [(p, leaf) for p, leaf in _family_leaves_in_order(sub)
                       if p.endswith("kernel")]
        if len(weights) != len(our_kernels):
            report[fam] = (f"skipped (layer count mismatch: ckpt "
                           f"{len(weights)} vs ours {len(our_kernels)})")
            if strict:
                raise ValueError(f"{fam}: {report[fam]}")
            continue
        ok, staged = True, {}
        prefix = ".".join(FAMILY_TO_PARAM_SUBTREE[fam])
        for (tk, tw), (pk, pl) in zip(weights, our_kernels):
            if tw.T.shape != np.shape(pl):
                report[fam] = (f"skipped (shape mismatch at {tk}: "
                               f"{tw.shape} vs {np.shape(pl)})")
                ok = False
                break
            staged[f"{prefix}.{pk}"] = np.asarray(tw.T, np.asarray(pl).dtype)
            tb = biases.get(tk.rsplit(".", 1)[0])
            bkey = f"{prefix}.{pk[: -len('kernel')]}bias"
            if tb is not None and bkey in new_flat and \
                    tb.shape == np.shape(new_flat[bkey]):
                staged[bkey] = np.asarray(tb,
                                          np.asarray(new_flat[bkey]).dtype)
        if ok:
            new_flat.update(staged)
            report[fam] = f"mapped ({len(staged)} tensors)"
        elif strict:
            raise ValueError(f"{fam}: {report[fam]}")

    for fam in ("encoder", "unet"):
        has = any(k.split(".")[0] == fam for k in flat_t)
        report[fam] = ("skipped (architecture differs: TPU re-design; "
                       "see utils/checkpoint.py REFERENCE_FAMILIES note)"
                       if has else "absent")
    return _rebuild(template, new_flat), report


# ------------------------------------------------------------ name lookup
PRETRAINED = {
    # the published checkpoints' names
    "ks": "ks.pth",
    "snet-n3k-wnormal": "snet-n3k-wnormal.pth",
    "p2s": "p2s.pth",
    "carla": "carla.pth",
}


def load_checkpoint_from_url(url: str) -> Dict[str, Any]:
    """The checkpoint a URL or a ``PRETRAINED`` name names, from the local
    cache ``NKSR_TPU_CKPT_DIR`` (default ``~/.cache/nksr_tpu``): the file
    named by the URL's last component, or by its ``PRETRAINED`` entry.
    A ``.pkl``/``.pickle`` file is unpickled, anything else read by
    ``torch.load`` (unpickled if that fails).  Nothing is downloaded:
    a name not in the cache raises ``FileNotFoundError``."""
    cache = Path(os.environ.get("NKSR_TPU_CKPT_DIR",
                                Path("~/.cache/nksr_tpu").expanduser()))
    name = url.rstrip("/").split("/")[-1]
    for p in (cache / name, cache / PRETRAINED.get(name, name)):
        if p.exists():
            if p.suffix in (".pkl", ".pickle"):
                with open(p, "rb") as f:
                    return pickle.load(f)
            try:
                return torch.load(p, map_location="cpu")
            except Exception:
                with open(p, "rb") as f:
                    return pickle.load(f)
    raise FileNotFoundError(
        f"checkpoint '{name}' not found under {cache}; place the file "
        f"there (nothing is downloaded)")
