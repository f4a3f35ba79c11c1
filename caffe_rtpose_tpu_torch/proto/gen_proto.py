"""Generate ``caffe.proto`` (proto2 text) from the declarative SCHEMA tables.

A copy of ``caffe_rtpose_tpu/proto/gen_proto.py``.

The schema registry in :mod:`caffe_rtpose_tpu_torch.proto.caffe_pb` is the single
source of truth for the wire interface (field numbers/types/defaults of the
reference ``src/caffe/proto/caffe.proto``, incl. the CPM additions).  This
module re-emits it as a ``.proto`` file so a real protobuf toolchain
(``protoc`` + ``google.protobuf``) can consume the exact same interface —
that is what powers the :mod:`caffe_rtpose_tpu_torch.proto.caffe_pb2` pycaffe
compatibility module (reference users do
``from caffe.proto import caffe_pb2``).

Enums are emitted NESTED in each message that uses them (value-name scoping
in proto2 is per enclosing type, so e.g. ``MAX`` can exist in both
PoolMethod and EltwiseOp); the enum type name comes from the registry
constant (``POOL_METHOD`` -> ``PoolMethod``).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict

from . import caffe_pb
from .wire import Field

_KIND_TO_PROTO = {
    "int32": "int32", "int64": "int64", "uint32": "uint32",
    "uint64": "uint64", "sint32": "sint32", "sint64": "sint64",
    "bool": "bool", "float": "float", "double": "double",
    "string": "string", "bytes": "bytes",
}


def _camel(const_name: str) -> str:
    return "".join(w.capitalize() for w in const_name.split("_"))


def _enum_names() -> Dict[int, str]:
    """Map id(enum value dict) -> type name, from the registry constants."""
    names: Dict[int, str] = {}
    for gname, gval in vars(caffe_pb).items():
        if gname.isupper() and isinstance(gval, dict) and gval and \
                all(isinstance(v, int) for v in gval.values()):
            names[id(gval)] = _camel(gname)
    return names


def _default_literal(fld: Field) -> str:
    if fld.kind == "enum":
        inv = {v: k for k, v in fld.enum_values.items()}
        return inv[int(fld.default)]
    if fld.kind == "bool":
        return "true" if fld.default else "false"
    if fld.kind == "string":
        return '"%s"' % fld.default
    if fld.kind in ("float", "double"):
        v = repr(float(fld.default))
        return v[:-2] if v.endswith(".0") else v
    return str(int(fld.default))


def generate_proto() -> str:
    enum_names = _enum_names()
    lines = [
        "// GENERATED from caffe_rtpose_tpu.proto.caffe_pb SCHEMA tables —",
        "// the clean-room registry of the reference caffe.proto wire",
        "// interface.  Do not edit; regenerate via proto.gen_proto.",
        'syntax = "proto2";',
        "package caffe;",
        "",
    ]
    anon = 0
    for msg_name, fields in caffe_pb.SCHEMA.items():
        lines.append(f"message {msg_name} {{")
        # nested enum types, one per distinct value-dict used here
        local: Dict[int, str] = {}
        for fld in fields.values():
            if fld.kind == "enum" and id(fld.enum_values) not in local:
                ename = enum_names.get(id(fld.enum_values))
                if ename is None:
                    anon += 1
                    ename = _camel(fld.name) + f"Enum{anon}"
                local[id(fld.enum_values)] = ename
                lines.append(f"  enum {ename} {{")
                for vname, vnum in sorted(fld.enum_values.items(),
                                          key=lambda kv: kv[1]):
                    lines.append(f"    {vname} = {vnum};")
                lines.append("  }")
        for fld in sorted(fields.values(), key=lambda f: f.num):
            label = "repeated" if fld.repeated else "optional"
            if fld.kind == "message":
                ptype = fld.message
            elif fld.kind == "enum":
                ptype = local[id(fld.enum_values)]
            else:
                ptype = _KIND_TO_PROTO[fld.kind]
            opt = ""
            if fld.default is not None and not fld.repeated:
                opt = f" [default = {_default_literal(fld)}]"
            lines.append(f"  {label} {ptype} {fld.name} = {fld.num}{opt};")
        lines.append("}")
        lines.append("")
    return "\n".join(lines)


def schema_digest() -> str:
    return hashlib.sha256(generate_proto().encode()).hexdigest()[:16]
