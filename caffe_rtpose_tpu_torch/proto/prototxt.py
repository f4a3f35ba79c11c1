"""Protobuf text-format parser/printer for Caffe ``.prototxt`` files.

A copy of ``caffe_rtpose_tpu/proto/prototxt.py`` (that package imports jax).

Clean-room implementation of the subset of proto text format that Caffe
configs use: ``name: value`` scalars, ``name { ... }`` nested messages
(``name: { ... }`` also accepted), repeated fields by repetition, ``#``
comments, string/number/bool/enum literals.

Reference behavior: ``ReadProtoFromTextFile`` (reference
``src/caffe/util/io.cpp``) via google::protobuf::TextFormat.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from . import caffe_pb
from .wire import Field

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<punct>[{}:,;])
  | (?P<atom>[^\s{}:,;"']+)
    """,
    re.VERBOSE,
)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'", '"': '"', "0": "\0"}


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _tokenize(text: str) -> List[str]:
    toks = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"prototxt tokenize error at offset {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append(m.group())
    return toks


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise ValueError("unexpected end of prototxt")
        self.pos += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise ValueError(f"expected {tok!r}, got {got!r} at token {self.pos}")

    def parse_message(self, message_name: str, until_brace: bool) -> Dict[str, Any]:
        fields = caffe_pb._BY_NAME[message_name]
        out: Dict[str, Any] = {}
        while True:
            tok = self.peek()
            if tok is None:
                if until_brace:
                    raise ValueError("unterminated message block")
                return out
            if tok == "}":
                if not until_brace:
                    raise ValueError("unexpected '}'")
                self.next()
                return out
            name = self.next()
            fld = fields.get(name)
            nxt = self.peek()
            if nxt == ":":
                self.next()
                nxt = self.peek()
            if nxt == "{":
                self.next()
                if fld is None:
                    self._skip_block()
                    continue
                if fld.kind != "message":
                    raise ValueError(f"field {name} is not a message")
                val = self.parse_message(fld.message, until_brace=True)
            else:
                raw = self.next()
                if fld is None:
                    continue  # unknown scalar: skip silently like TextFormat w/ AllowUnknown off would error; we tolerate
                val = self._coerce(fld, raw)
            if fld.repeated:
                out.setdefault(fld.name, []).append(val)
            else:
                out[fld.name] = val
            # optional separators
            while self.peek() in (",", ";"):
                self.next()

    def _skip_block(self) -> None:
        depth = 1
        while depth:
            tok = self.next()
            if tok == "{":
                depth += 1
            elif tok == "}":
                depth -= 1

    def _coerce(self, fld: Field, raw: str) -> Any:
        if raw.startswith(('"', "'")):
            text = _unquote(raw)
            if fld.kind in ("string", "bytes"):
                return text if fld.kind == "string" else text.encode()
            raw = text
        if fld.kind == "string":
            return raw
        if fld.kind == "bytes":
            return raw.encode()
        if fld.kind == "bool":
            low = raw.lower()
            if low in ("true", "1"):
                return True
            if low in ("false", "0"):
                return False
            raise ValueError(f"bad bool literal {raw!r}")
        if fld.kind == "enum":
            if fld.enum_values and raw in fld.enum_values:
                return fld.enum_values[raw]
            return int(raw)
        if fld.kind in ("float", "double"):
            return float(raw)
        return int(float(raw)) if ("." in raw or "e" in raw.lower()) else int(raw)


def parse(text: str, message_name: str = "NetParameter") -> Dict[str, Any]:
    """Parse prototxt text into a message dict."""
    return _Parser(_tokenize(text)).parse_message(message_name, until_brace=False)


def parse_file(path: str, message_name: str = "NetParameter") -> Dict[str, Any]:
    with open(path, "r") as f:
        return parse(f.read(), message_name)


# ---------------------------------------------------------------- printing


def _fmt_scalar(fld: Field, val: Any) -> str:
    if fld.kind in ("string",):
        escaped = str(val).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        return f'"{escaped}"'
    if fld.kind == "bytes":
        return _fmt_scalar(Field(fld.num, fld.name, "string"), val.decode("utf-8", "replace"))
    if fld.kind == "bool":
        return "true" if val else "false"
    if fld.kind == "enum" and fld.enum_values:
        for k, v in fld.enum_values.items():
            if v == val:
                return k
        return str(int(val))
    if fld.kind in ("float", "double"):
        return repr(float(val))
    return str(int(val))


def dumps(msg: Dict[str, Any], message_name: str = "NetParameter", indent: int = 0) -> str:
    fields = caffe_pb._BY_NAME[message_name]
    pad = "  " * indent
    lines: List[str] = []
    # print in field-number order for stable output
    for fld in sorted(fields.values(), key=lambda f: f.num):
        if fld.name not in msg:
            continue
        vals = msg[fld.name] if fld.repeated else [msg[fld.name]]
        for v in vals:
            if fld.kind == "message":
                body = dumps(v, fld.message, indent + 1)
                lines.append(f"{pad}{fld.name} {{\n{body}{pad}}}")
            else:
                lines.append(f"{pad}{fld.name}: {_fmt_scalar(fld, v)}")
    return "".join(line + "\n" for line in lines)


def dump_file(msg: Dict[str, Any], path: str, message_name: str = "NetParameter") -> None:
    with open(path, "w") as f:
        f.write(dumps(msg, message_name))
