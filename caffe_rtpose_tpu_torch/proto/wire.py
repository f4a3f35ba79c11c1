"""Minimal protobuf (proto2) wire-format codec, written from the wire spec.

A copy of ``caffe_rtpose_tpu/proto/wire.py`` (that package imports jax).

This is a clean-room implementation: we only need to read/write the handful of
Caffe message types (``NetParameter``, ``SolverParameter``, ``BlobProto``, ...)
whose field numbers are an interface contract (see
``caffe_rtpose_tpu_torch.proto.caffe_pb``), without depending on generated protobuf
code.  Messages are represented as plain Python dicts keyed by field name;
schemas are declarative dicts (see :mod:`caffe_rtpose_tpu_torch.proto.caffe_pb`).

Reference behavior being matched: the reference loads ``.prototxt`` /
``.caffemodel`` files via protobuf (reference ``src/caffe/util/io.cpp``:
``ReadProtoFromTextFile`` / ``ReadProtoFromBinaryFile``).

Performance note: packed/unpacked repeated ``float`` fields (the weight payload
of ``BlobProto.data``, often hundreds of MB) decode through
``numpy.frombuffer`` fast paths rather than per-element varint walking.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Optional

import numpy as np

# Wire types
_VARINT = 0
_FIXED64 = 1
_LENGTH = 2
_FIXED32 = 5

_SCALAR_WIRETYPE = {
    "int32": _VARINT,
    "int64": _VARINT,
    "uint32": _VARINT,
    "uint64": _VARINT,
    "sint32": _VARINT,
    "sint64": _VARINT,
    "bool": _VARINT,
    "enum": _VARINT,
    "float": _FIXED32,
    "double": _FIXED64,
    "fixed32": _FIXED32,
    "fixed64": _FIXED64,
    "string": _LENGTH,
    "bytes": _LENGTH,
    "message": _LENGTH,
}

_VARINT_KINDS = ("int32", "int64", "uint32", "uint64", "sint32", "sint64", "bool", "enum")


@dataclass
class Field:
    """Declarative description of one proto field."""

    num: int
    name: str
    kind: str  # one of the keys of _SCALAR_WIRETYPE
    repeated: bool = False
    message: Optional[str] = None  # schema key for kind == 'message'
    default: Any = None
    enum_values: Optional[Dict[str, int]] = None  # for text-format parsing


def _decode_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long / corrupt buffer")


def _encode_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, proto2 int32/int64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _coerce_varint(kind: str, raw: int) -> Any:
    if kind == "bool":
        return bool(raw)
    if kind in ("int32", "int64"):
        # two's complement sign restore
        bits = 32 if kind == "int32" else 64
        raw &= (1 << 64) - 1
        if raw >= 1 << 63:
            raw -= 1 << 64
        return int(raw)
    if kind in ("sint32", "sint64"):
        return (raw >> 1) ^ -(raw & 1)
    return int(raw)  # uint32/uint64/enum


class SchemaError(ValueError):
    pass


def decode(buf: bytes, schema: Dict[str, Dict[int, Field]], message: str) -> Dict[str, Any]:
    """Decode a binary proto message into {field_name: value} dict."""
    return _decode_msg(memoryview(buf), 0, len(buf), schema, message)


def _decode_msg(buf: memoryview, pos: int, end: int, schema, message: str) -> Dict[str, Any]:
    fields = schema[message]
    out: Dict[str, Any] = {}
    while pos < end:
        key, pos = _decode_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        fld = fields.get(fnum)
        if fld is None:
            pos = _skip(buf, pos, wtype)
            continue
        if wtype == _VARINT:
            raw, pos = _decode_varint(buf, pos)
            val = _coerce_varint(fld.kind, raw)
            _store(out, fld, val)
        elif wtype == _FIXED32:
            if fld.kind == "float":
                (val,) = struct.unpack_from("<f", buf, pos)
            else:
                (val,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            _store(out, fld, val)
        elif wtype == _FIXED64:
            if fld.kind == "double":
                (val,) = struct.unpack_from("<d", buf, pos)
            else:
                (val,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            _store(out, fld, val)
        elif wtype == _LENGTH:
            ln, pos = _decode_varint(buf, pos)
            chunk_end = pos + ln
            if fld.kind == "message":
                val = _decode_msg(buf, pos, chunk_end, schema, fld.message)
                _store(out, fld, val)
            elif fld.kind == "string":
                _store(out, fld, bytes(buf[pos:chunk_end]).decode("utf-8", "replace"))
            elif fld.kind == "bytes":
                _store(out, fld, bytes(buf[pos:chunk_end]))
            elif fld.kind == "float":
                arr = np.frombuffer(buf[pos:chunk_end], dtype="<f4")
                _extend_packed(out, fld, arr)
            elif fld.kind == "double":
                arr = np.frombuffer(buf[pos:chunk_end], dtype="<f8")
                _extend_packed(out, fld, arr)
            elif fld.kind in _VARINT_KINDS:
                # packed varints
                vals = []
                p = pos
                while p < chunk_end:
                    raw, p = _decode_varint(buf, p)
                    vals.append(_coerce_varint(fld.kind, raw))
                _extend_packed(out, fld, vals)
            else:
                raise SchemaError(f"bad packed kind {fld.kind}")
            pos = chunk_end
        else:
            raise SchemaError(f"unsupported wire type {wtype}")
    return out


def _skip(buf: memoryview, pos: int, wtype: int) -> int:
    if wtype == _VARINT:
        _, pos = _decode_varint(buf, pos)
        return pos
    if wtype == _FIXED64:
        return pos + 8
    if wtype == _FIXED32:
        return pos + 4
    if wtype == _LENGTH:
        ln, pos = _decode_varint(buf, pos)
        return pos + ln
    if wtype in (3, 4):  # group start/end (legacy); no groups in caffe.proto
        raise SchemaError("proto groups unsupported")
    raise SchemaError(f"unknown wire type {wtype}")


def _store(out: dict, fld: Field, val: Any) -> None:
    if fld.repeated:
        out.setdefault(fld.name, []).append(val)
    else:
        out[fld.name] = val


def _extend_packed(out: dict, fld: Field, vals) -> None:
    if not fld.repeated:
        # packed encoding of non-repeated is malformed; take last
        if len(vals):
            out[fld.name] = vals[-1]
        return
    existing = out.get(fld.name)
    if existing is None:
        if isinstance(vals, np.ndarray):
            out[fld.name] = vals  # zero-copy; callers treat as sequence
        else:
            out[fld.name] = list(vals)
    else:
        if isinstance(existing, np.ndarray):
            out[fld.name] = np.concatenate([existing, np.asarray(vals, existing.dtype)])
        else:
            existing.extend(list(vals))


# ---------------------------------------------------------------- encoding


def encode(msg: Dict[str, Any], schema: Dict[str, Dict[int, Field]], message: str) -> bytes:
    """Encode a {field_name: value} dict into binary proto."""
    fields = schema[message]
    by_name = {f.name: f for f in fields.values()}
    chunks = []
    for name, value in msg.items():
        fld = by_name.get(name)
        if fld is None:
            raise SchemaError(f"unknown field {name} for {message}")
        if fld.repeated:
            if fld.kind in ("float", "double") and len(value):
                # packed encoding for numeric payloads
                arr = np.asarray(value, dtype="<f4" if fld.kind == "float" else "<f8")
                payload = arr.tobytes()
                chunks.append(_encode_varint((fld.num << 3) | _LENGTH))
                chunks.append(_encode_varint(len(payload)))
                chunks.append(payload)
            elif fld.kind in _VARINT_KINDS and len(value):
                payload = b"".join(_encode_varint(int(v)) for v in value)
                chunks.append(_encode_varint((fld.num << 3) | _LENGTH))
                chunks.append(_encode_varint(len(payload)))
                chunks.append(payload)
            else:
                for v in value:
                    chunks.append(_encode_one(fld, v, schema))
        else:
            chunks.append(_encode_one(fld, value, schema))
    return b"".join(chunks)


def _encode_one(fld: Field, value: Any, schema) -> bytes:
    wtype = _SCALAR_WIRETYPE[fld.kind]
    key = _encode_varint((fld.num << 3) | wtype)
    if fld.kind == "message":
        payload = encode(value, schema, fld.message)
        return key + _encode_varint(len(payload)) + payload
    if fld.kind == "string":
        payload = value.encode("utf-8")
        return key + _encode_varint(len(payload)) + payload
    if fld.kind == "bytes":
        return key + _encode_varint(len(value)) + value
    if fld.kind == "float":
        return key + struct.pack("<f", float(value))
    if fld.kind == "double":
        return key + struct.pack("<d", float(value))
    if fld.kind in _VARINT_KINDS:
        if fld.kind in ("sint32", "sint64"):
            v = int(value)
            return key + _encode_varint((v << 1) ^ (v >> 63))
        return key + _encode_varint(int(bool(value)) if fld.kind == "bool" else int(value))
    raise SchemaError(f"cannot encode kind {fld.kind}")
