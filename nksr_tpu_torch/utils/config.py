"""Run configurations (counterpart of nksr_tpu/utils/config.py
``load_config``), read without PyYAML.

The repo's run configs (``runs/*/config.yaml``) are block YAML of a small
subset: nested mappings, ``- `` lists of scalars and of mappings, and
plain int, float, bool, null and string scalars, with ``#`` comments.
``parse_yaml`` reads exactly that subset and resolves each scalar as
PyYAML's ``safe_load`` does (the YAML 1.1 core types), so a config reads
the same here as in the JAX package.  Anything else (flow ``[]``/``{}``,
quotes, anchors, aliases, tags, block scalars, ``${}`` interpolation,
``include_configs``, several documents) raises ``ValueError`` naming the
line.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Tuple

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
_UNSUPPORTED_START = set("[]{}'\"&*!|>%@`")


def _scalar(text: str, where: str) -> Any:
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
    if text[0] in _UNSUPPORTED_START or "${" in text or ": " in text \
            or text.endswith(":") or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: {text!r} is outside the block-YAML "
                         "subset this reader supports")
    return text


def _lines(text: str, name: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of each line with content, comments
    stripped."""
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip()
        if "\t" in body[:len(body) - len(body.lstrip(" \t"))]:
            raise ValueError(f"{name}:{no}: tab in indentation")
        stripped = body.lstrip(" ")
        if stripped.startswith("#"):
            continue
        cut = re.search(r"\s#", stripped)
        if cut:
            stripped = stripped[:cut.start()].rstrip()
        if not stripped:
            continue
        if stripped in ("---", "...") or stripped.startswith("%"):
            raise ValueError(f"{name}:{no}: document markers and "
                             "directives are not supported")
        out.append((no, len(body) - len(body.lstrip(" ")), stripped))
    return out


def _key_value(content: str, where: str):
    """(key, value text) of a mapping entry, or None."""
    m = re.fullmatch(r"([^\s#:][^:]*?):( +(.*))?", content)
    if m is None:
        return None
    key = m.group(1)
    if key[0] in _UNSUPPORTED_START or key.startswith("- ") \
            or key == "-":
        raise ValueError(f"{where}: key {key!r} is outside the supported "
                         "subset")
    return key, (m.group(3) or "")


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
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if _key_value(content, self.where()) is not None:
            return self.mapping(indent)
        value = _scalar(content, self.where())
        self.i += 1
        return value

    def value_after_key(self, indent: int, text: str) -> Any:
        """A mapping entry's value: inline, or the block below it (deeper,
        or a ``- `` list at the key's own column, as PyYAML allows)."""
        where = self.where()
        self.i += 1
        if text:
            return _scalar(text, where)
        if self.i < len(self.lines):
            _, ind, content = self.lines[self.i]
            if ind > indent or (ind == indent and (
                    content == "-" or content.startswith("- "))):
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
                if content == "-" or content.startswith("- "):
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
            if ind != indent or not (content == "-"
                                     or content.startswith("- ")):
                if ind > indent:
                    raise ValueError(f"{self.where()}: unexpected "
                                     "indentation")
                break
            item = content[2:].lstrip(" ")
            if not item:
                raise ValueError(f"{self.where()}: empty list item")
            col = indent + len(content) - len(item)
            if item == "-" or item.startswith("- "):
                raise ValueError(f"{self.where()}: nested inline lists are "
                                 "not supported")
            if _key_value(item, self.where()) is not None:
                # "- key: value": a mapping whose first entry shares the
                # dash's line, the rest at the key's column
                self.lines[self.i] = (no, col, item)
                out.append(self.mapping(col))
            else:
                out.append(_scalar(item, self.where()))
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


def load_config(path) -> dict:
    """A run config as a dict.  ``include_configs`` chains and ``${}``
    interpolation (which the JAX package's loader also handles) raise;
    no run config uses them."""
    path = Path(path)
    data = parse_yaml(path.read_text(), str(path))
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: a config is a mapping")
    if "include_configs" in data:
        raise ValueError(f"{path}: include_configs is not supported")
    return data
