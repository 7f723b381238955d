"""Run configurations (counterpart of nksr_tpu/utils/config.py), read and
written without PyYAML.

``parse_yaml`` reads the YAML the repo's configs (``configs/**/*.yaml``,
``runs/*/config.yaml``) are written in: block mappings and ``- ``
sequences (of scalars, of mappings, of flow collections), flow
sequences and mappings (``[a, b]``, ``{name: x, args: {...}}``, nested,
spanning lines), single- and double-quoted scalars, plain int, float,
bool, null and string scalars, and ``#`` comments.  Each plain scalar
resolves as PyYAML's ``safe_load`` resolves it (the YAML 1.1 core
types), so a config reads the same here as in the JAX package.
Anchors, aliases, tags, block scalars, several documents and duplicate
keys raise ``ValueError`` naming the line.

``load_config`` resolves ``include_configs`` chains, extra includes,
dotted ``k=v`` overrides and ``${a.b}`` interpolation as the JAX
package's loader does; ``save_config`` writes a config back that both
readers read equal.
"""

from __future__ import annotations

import copy
import json
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True,
         "True": True, "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*([eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)")
_NAN = re.compile(r"\.(nan|NaN|NAN)")
# other YAML 1.1 numbers (octal, hex, binary, base 60) and what this
# reader does not parse
_OTHER_NUMBER = re.compile(r"[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+"
                           r"|[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?)")
_UNSUPPORTED_START = set("&*!|>%@`")
_QUOTES = "'\""
_FLOW_OPEN = {"[": "]", "{": "}"}
# double-quoted escapes (YAML 1.1), besides \x, \u and \U
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _scalar(text: str, where: str) -> Any:
    """A plain scalar's value, resolved as PyYAML resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.fullmatch(text):
        return float("nan")
    if _OTHER_NUMBER.fullmatch(text):
        raise ValueError(f"{where}: number form {text!r} is not supported "
                         "(decimal ints and floats only)")
    if text[0] in _UNSUPPORTED_START or text[0] in _QUOTES \
            or text[0] in "[]{}" or ": " in text or text.endswith(":") \
            or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: {text!r} is outside the YAML this "
                         "reader supports")
    return text


def _quoted(text: str, i: int, where: str) -> Tuple[str, int]:
    """The quoted scalar that starts at ``text[i]`` and the index past its
    closing quote."""
    q = text[i]
    out: List[str] = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if c == q:
            if q == "'" and text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if c == "\\" and q == '"':
            e = text[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            n = _HEX_LEN.get(e)
            digits = text[j + 2:j + 2 + n] if n else ""
            if not n or not re.fullmatch(r"[0-9a-fA-F]+", digits) \
                    or len(digits) != n:
                raise ValueError(f"{where}: bad escape in {text[i:]!r}")
            out.append(chr(int(digits, 16)))
            j += 2 + n
            continue
        out.append(c)
        j += 1
    raise ValueError(f"{where}: unterminated quoted scalar {text[i:]!r}")


def _opens_token(text: str, i: int) -> bool:
    """Whether a quote or bracket at ``text[i]`` starts a token (the
    line's start or after ``:``, ``-``, ``,``, ``[`` or ``{`` and
    spaces), and not the inside of a plain scalar such as ``it's``."""
    before = text[:i].rstrip(" ")
    return not before or before[-1] in ":-,[{"


def _scan(text: str, where: str) -> Tuple[str, int]:
    """``text`` without its comment, and the depth of flow brackets left
    open at its end (quotes skipped)."""
    depth = 0
    i = 0
    while i < len(text):
        c = text[i]
        if c in _QUOTES and _opens_token(text, i):
            i = _quoted(text, i, where)[1]
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip(), depth
        if depth or _opens_token(text, i):
            if c in "[{":
                depth += 1
            elif c in "]}" and depth:
                depth -= 1
        i += 1
    return text.rstrip(), depth


def _lines(text: str, name: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of each line with content, comments
    stripped; a flow collection left open at a line's end takes in the
    lines that close it."""
    raw = text.splitlines()
    out = []
    no = 0
    while no < len(raw):
        body = raw[no].rstrip()
        no += 1
        if "\t" in body[:len(body) - len(body.lstrip(" \t"))]:
            raise ValueError(f"{name}:{no}: tab in indentation")
        where = f"{name}:{no}"
        content, depth = _scan(body.lstrip(" "), where)
        first = no
        while depth:
            if no >= len(raw):
                raise ValueError(f"{where}: flow collection not closed")
            more, _ = _scan(raw[no].strip(), f"{name}:{no + 1}")
            no += 1
            content, depth = _scan(f"{content} {more}", where)
        if not content:
            continue
        if content in ("---", "...") or content.startswith("%"):
            raise ValueError(f"{where}: document markers and directives "
                             "are not supported")
        out.append((first, len(body) - len(body.lstrip(" ")), content))
    return out


class _Flow:
    """A recursive-descent reader of one flow node (and of a block
    value's quoted scalar) in ``text``."""

    def __init__(self, text: str, where: str):
        self.text = text
        self.where = where
        self.i = 0

    def ws(self):
        while self.i < len(self.text) and self.text[self.i] == " ":
            self.i += 1

    def peek(self) -> str:
        return self.text[self.i:self.i + 1]

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what} at column {self.i + 1} of "
                         f"{self.text!r}")

    def node(self) -> Any:
        self.ws()
        c = self.peek()
        if c in _FLOW_OPEN:
            return self.collection(c)
        if c and c in _QUOTES:
            value, self.i = _quoted(self.text, self.i, self.where)
            return value
        return self.plain()

    def plain(self) -> Any:
        start = self.i
        while self.i < len(self.text):
            c = self.text[self.i]
            if c in ",[]{}":
                break
            if c == ":" and self.text[self.i + 1:self.i + 2] in \
                    ("", " ", ",", "]", "}"):
                break
            self.i += 1
        text = self.text[start:self.i].strip()
        if not text:
            return None
        return _scalar(text, self.where)

    def collection(self, open_: str) -> Any:
        close = _FLOW_OPEN[open_]
        self.i += 1
        out: Any = [] if open_ == "[" else {}
        while True:
            self.ws()
            if self.peek() == close:
                self.i += 1
                return out
            if open_ == "[":
                out.append(self.node())
            else:
                key = self.node()
                self.ws()
                if self.peek() != ":":
                    self.fail("expected ':' after a flow mapping key")
                self.i += 1
                self.ws()
                value = None if self.peek() in (",", "}") else self.node()
                if key in out:
                    self.fail(f"duplicate key {key!r}")
                out[key] = value
            self.ws()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != close:
                self.fail(f"expected ',' or {close!r}")

    def whole(self) -> Any:
        value = self.node()
        self.ws()
        if self.i != len(self.text):
            self.fail("unexpected content")
        return value


def _value(text: str, where: str) -> Any:
    """A block value given on its key's or dash's line."""
    if text[0] in _FLOW_OPEN or text[0] in _QUOTES:
        return _Flow(text, where).whole()
    return _scalar(text, where)


def _key_value(content: str, where: str):
    """(key, value text) of a mapping entry, or None."""
    if content[0] in _QUOTES:
        key, end = _quoted(content, 0, where)
        m = re.fullmatch(r" *:( +(.*))?", content[end:])
        return None if m is None else (key, m.group(2) or "")
    m = re.fullmatch(r"([^\s#:][^:]*?):( +(.*))?", content)
    if m is None:
        return None
    key = m.group(1)
    if key[0] in _UNSUPPORTED_START or key[0] in "[]{}" \
            or key.startswith("- ") or key == "-":
        if key[0] in _FLOW_OPEN:
            return None      # a flow collection, not a key
        raise ValueError(f"{where}: key {key!r} is outside the supported "
                         "subset")
    return key, (m.group(3) or "")


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Parser:
    def __init__(self, lines, name):
        self.lines = lines
        self.name = name
        self.i = 0

    def where(self, i=None) -> str:
        i = self.i if i is None else i
        return f"{self.name}:{self.lines[i][0]}"

    def block(self, indent: int) -> Any:
        """The node whose lines start at ``self.i`` at column ``indent``."""
        _, _, content = self.lines[self.i]
        if _is_item(content):
            return self.sequence(indent)
        if _key_value(content, self.where()) is not None:
            return self.mapping(indent)
        value = _value(content, self.where())
        self.i += 1
        return value

    def value_after_key(self, indent: int, text: str) -> Any:
        """A mapping entry's value: inline, or the block below it (deeper,
        or a ``- `` list at the key's own column, as PyYAML allows)."""
        where = self.where()
        self.i += 1
        if text:
            return _value(text, where)
        if self.i < len(self.lines):
            _, ind, content = self.lines[self.i]
            if ind > indent or (ind == indent and _is_item(content)):
                return self.block(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            _, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"{self.where()}: unexpected indentation")
            kv = _key_value(content, self.where())
            if kv is None:
                if _is_item(content):
                    break            # the parent's list continues
                raise ValueError(f"{self.where()}: expected 'key: value'")
            key, text = kv
            if key in out:
                raise ValueError(f"{self.where()}: duplicate key {key!r}")
            out[key] = self.value_after_key(indent, text)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            no, ind, content = self.lines[self.i]
            if ind != indent or not _is_item(content):
                if ind > indent:
                    raise ValueError(f"{self.where()}: unexpected "
                                     "indentation")
                break
            item = content[2:].lstrip(" ")
            if not item:
                raise ValueError(f"{self.where()}: empty list item")
            col = indent + len(content) - len(item)
            if _is_item(item):
                raise ValueError(f"{self.where()}: nested inline lists are "
                                 "not supported")
            if _key_value(item, self.where()) is not None:
                # "- key: value": a mapping whose first entry shares the
                # dash's line, the rest at the key's column
                self.lines[self.i] = (no, col, item)
                out.append(self.mapping(col))
            else:
                out.append(_value(item, self.where()))
                self.i += 1
        return out


def parse_yaml(text: str, name: str = "<yaml>") -> Any:
    """The document ``text`` as Python data (see the module docstring)."""
    lines = _lines(text, name)
    if not lines:
        return None
    p = _Parser(lines, name)
    node = p.block(lines[0][1])
    if p.i != len(lines):
        raise ValueError(f"{p.where()}: unexpected content")
    return node


# ------------------------------------------------------------- load, save
def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_INTERP = re.compile(r"\$\{([^}]+)\}")


def _lookup(root: Dict, dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _interpolate(node: Any, root: Dict) -> Any:
    """``${a.b}`` references resolved against ``root``: a whole-value
    reference keeps the referenced value's type, one inside a string is
    formatted into it."""
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        if _INTERP.fullmatch(node.strip()):
            return _lookup(root, node.strip()[2:-1])
        return _INTERP.sub(lambda m: str(_lookup(root, m.group(1))), node)
    return node


def _load_with_includes(path: Path, chain: Tuple[Path, ...] = ()) -> Dict:
    """The file's mapping over its ``include_configs`` (each relative to
    the including file, merged base-first); a chain that comes back to a
    file raises."""
    path = path.resolve()
    if path in chain:
        raise ValueError(f"{path}: include_configs cycle through "
                         + " -> ".join(str(p) for p in chain + (path,)))
    raw = parse_yaml(path.read_text(), str(path))
    if raw is None:
        raw = {}
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: a config is a mapping")
    incs = raw.pop("include_configs", []) or []
    if isinstance(incs, str):
        incs = [incs]
    base: Dict = {}
    for inc in incs:
        base = _deep_merge(base, _load_with_includes(path.parent / inc,
                                                     chain + (path,)))
    return _deep_merge(base, raw)


def apply_overrides(cfg: Dict, overrides: Sequence[str]) -> Dict:
    """Dotted ``key.sub=value`` overrides in place (the mappings on the
    way made as needed), each value read as a YAML scalar or flow
    collection; returns ``cfg``."""
    for ov in overrides or []:
        key, _, text = ov.partition("=")
        *head, last = key.strip().split(".")
        node = cfg
        for k in head:
            node = node.setdefault(k, {})
        node[last] = parse_yaml(text.strip(), f"override {ov!r}")
    return cfg


def load_config(path, overrides: Optional[Sequence[str]] = None,
                includes: Optional[Sequence[str]] = None) -> dict:
    """A config as a plain dict: the file over its ``include_configs``
    chain, each of ``includes`` merged on top, then the dotted ``k=v``
    ``overrides``, then ``${}`` interpolation (the JAX package's
    ``load_config``)."""
    cfg = _load_with_includes(Path(path))
    for inc in includes or []:
        cfg = _deep_merge(cfg, _load_with_includes(Path(inc)))
    apply_overrides(cfg, overrides)
    return _interpolate(cfg, cfg)


def _emit_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:    # YAML 1.1 floats need the dot
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, str):
        if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_./-]*", v) and \
                _scalar(v, "") == v:
            return v
        return json.dumps(v)
    raise TypeError(f"save_config: cannot write {type(v).__name__} {v!r}")


def _emit_flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_emit_scalar(str(k))}: {_emit_flow(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit_flow(x) for x in v) + "]"
    return _emit_scalar(v)


def _emit(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _emit_scalar(str(k))
            if isinstance(x, dict) and x:
                out.append(f"{pad}{key}:")
                _emit(x, indent + 2, out)
            elif isinstance(x, (list, tuple)) and x and \
                    any(isinstance(e, dict) for e in x):
                out.append(f"{pad}{key}:")
                _emit(x, indent, out)
            else:
                out.append(f"{pad}{key}: {_emit_flow(x)}")
        return
    for x in v:                        # a list holding mappings
        if isinstance(x, dict) and x:
            sub: List[str] = []
            _emit(x, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
        else:
            out.append(f"{pad}- {_emit_flow(x)}")


def save_config(cfg: Dict, path) -> None:
    """Write ``cfg`` as YAML (block mappings, lists of mappings as ``- ``
    items, other lists and empty collections in flow style, strings
    quoted where plain would read otherwise) that ``load_config`` and
    ``yaml.safe_load`` both read back equal."""
    out: List[str] = []
    _emit(dict(cfg), 0, out)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(out) + "\n")
