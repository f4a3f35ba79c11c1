"""A restricted MATLAB engine: executes the matcaffe M-files without MATLAB.

The port of ``caffe_rtpose_tpu/matlab_engine.py``.  The reference ships
matcaffe as M-classes over a C++ MEX binding (``matlab/+caffe/Net.m``,
``matlab/caffe_.cpp`` there); this repo's ``matlab/+caffe`` delegates to a
Python ``api`` module through MATLAB's Python engine (``py.`` namespace).
MATLAB itself is not installable in CI, so this module implements the
*subset of the MATLAB language those files use* — enough to parse and
actually EXECUTE every shipped ``.m`` file against the live Python bridge.
Layout conversions (column-major, 1-based, trailing-singleton rules),
``py.`` interop, classdef dispatch, and the bridge calls are all exercised
for real.

The shipped M-files name the JAX package (``py.importlib.import_module(
'caffe_rtpose_tpu.api')``, ``py.jax.config.update('jax_platforms', ...)``
in ``set_mode_cpu.m``/``set_mode_gpu.m``) and stay as they are.  This
engine resolves every ``py.`` name through one alias table,
:data:`PY_ALIASES`, in :meth:`PyModuleRef.resolve` and in the
``import_module`` reached as ``py.importlib.import_module``: the
``caffe_rtpose_tpu`` prefix names ``caffe_rtpose_tpu_torch``;
``jax.config.update('jax_platforms', 'cpu')`` is ``api.set_mode_cpu()`` and
``jax.config.update('jax_platforms', '')`` is ``api.set_mode_gpu()``.  Any
other ``py.jax`` name raises :class:`MatlabError`: the engine never imports
jax.  ``imread``/``imresize`` read and resize without OpenCV
(``core/data_layers.read_image``, ``api.resize_image``); the HDF5 builtins
read and write through the port's HDF5 codec (``utils/hdf5.py``).

Scope (deliberately): classdef (handle) with properties/methods blocks,
functions with nargin/varargin, if/elseif/else, for, assignment (including
indexed and property targets), cell/object arrays, the ``py.`` namespace
with MATLAB's documented conversion rules, and the builtins the files call.
Anything outside that subset raises ``MatlabError`` — silent
misinterpretation is the one failure mode a mock engine must not have.
"""

from __future__ import annotations

import importlib
import math
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .utils import hdf5


class MatlabError(Exception):
    pass


# =============================================================== lexer

_KEYWORDS = {
    "function", "classdef", "properties", "methods", "if", "elseif",
    "else", "for", "while", "end", "return", "try", "catch",
}

_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t]+)
  | (?P<cont>\.\.\..*\n)
  | (?P<comment>%[^\n]*)
  | (?P<nl>\n)
  | (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^'\n]|'')*')
  | (?P<dstr>"(?:[^"\n]|"")*")
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op>==|~=|<=|>=|&&|\|\||\.\*|\./|\.\^|[-+*/^<>=~&|:;,(){}\[\].@])
""", re.VERBOSE)


class Tok:
    __slots__ = ("kind", "val", "line")

    def __init__(self, kind: str, val: str, line: int):
        self.kind, self.val, self.line = kind, val, line

    def __repr__(self):
        return f"Tok({self.kind},{self.val!r},L{self.line})"


def tokenize(src: str) -> List[Tok]:
    toks: List[Tok] = []
    pos, line = 0, 1
    if not src.endswith("\n"):
        src += "\n"
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise MatlabError(f"lex error at line {line}: {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "cont":  # ... continuation swallows the newline
            line += 1
            continue
        if kind == "nl":
            if toks and toks[-1].kind not in ("nl", "semi"):
                toks.append(Tok("nl", "\n", line))
            line += 1
            continue
        if kind == "num":
            toks.append(Tok("num", text, line))
        elif kind == "str":
            toks.append(Tok("str", text[1:-1].replace("''", "'"), line))
        elif kind == "dstr":
            toks.append(Tok("str", text[1:-1].replace('""', '"'), line))
        elif kind == "id":
            toks.append(Tok("kw" if text in _KEYWORDS else "id", text, line))
        else:
            toks.append(Tok("semi" if text == ";" else "op", text, line))
    toks.append(Tok("eof", "", line))
    return toks


# =============================================================== AST

# Nodes are tuples: (tag, ...).  Tags:
#   num, str, ident, colonall, range(lo, step|None, hi), array(rows),
#   cellarr(items), call(base, args), brace(base, args), field(base, name),
#   dynfield(base, expr), binop(op, a, b), unop(op, a), handle(name),
#   endkw  (not supported -> parse error)


class Parser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    # ---- token helpers
    def peek(self, k=0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_op(self, *vals) -> bool:
        t = self.peek()
        return t.kind == "op" and t.val in vals

    def expect_op(self, val):
        t = self.next()
        if t.kind != "op" or t.val != val:
            raise MatlabError(f"expected {val!r}, got {t!r}")

    def expect_kw(self, val):
        t = self.next()
        if t.kind != "kw" or t.val != val:
            raise MatlabError(f"expected {val!r}, got {t!r}")

    def skip_terms(self):
        while self.peek().kind in ("nl", "semi"):
            self.next()

    # ---- file-level
    def parse_file(self):
        self.skip_terms()
        t = self.peek()
        if t.kind == "kw" and t.val == "classdef":
            return self.parse_classdef()
        if t.kind == "kw" and t.val == "function":
            funcs = []
            while self.peek().kind == "kw" and self.peek().val == "function":
                funcs.append(self.parse_function())
                self.skip_terms()
            if self.peek().kind != "eof":
                raise MatlabError(f"trailing content: {self.peek()!r}")
            return ("file_funcs", funcs)
        # a SCRIPT file: bare statements at file level (e.g. the reference
        # matlab/hdf5creation/demo.m), run in a shared workspace
        stmts = self.parse_block()
        if self.peek().kind != "eof":
            raise MatlabError(f"trailing content: {self.peek()!r}")
        return ("script", stmts)

    def parse_attrs(self) -> Dict[str, Any]:
        """(Access = private), (Static), (SetAccess = private) ..."""
        attrs: Dict[str, Any] = {}
        if not self.at_op("("):
            return attrs
        self.next()
        while not self.at_op(")"):
            name = self.next().val
            if self.at_op("="):
                self.next()
                attrs[name] = self.next().val
            else:
                attrs[name] = True
            if self.at_op(","):
                self.next()
        self.expect_op(")")
        return attrs

    def parse_classdef(self):
        self.expect_kw("classdef")
        name = self.next().val
        bases = []
        if self.at_op("<"):
            self.next()
            while True:
                base = self.next().val
                while self.at_op("."):
                    self.next()
                    base += "." + self.next().val
                bases.append(base)
                if self.at_op("&"):
                    self.next()
                    continue
                break
        self.skip_terms()
        props: List[str] = []
        methods: Dict[str, tuple] = {}
        static: set = set()
        tests: set = set()
        while not (self.peek().kind == "kw" and self.peek().val == "end"):
            t = self.next()
            if t.kind == "kw" and t.val == "properties":
                self.parse_attrs()
                self.skip_terms()
                while not (self.peek().kind == "kw" and self.peek().val == "end"):
                    props.append(self.next().val)
                    if self.at_op("="):
                        raise MatlabError("property defaults not supported")
                    self.skip_terms()
                self.next()  # end
                self.skip_terms()
            elif t.kind == "kw" and t.val == "methods":
                attrs = self.parse_attrs()
                is_static = "Static" in attrs
                is_test = "Test" in attrs
                self.skip_terms()
                while self.peek().kind == "kw" and self.peek().val == "function":
                    f = self.parse_function()
                    methods[f[1]] = f
                    if is_static:
                        static.add(f[1])
                    if is_test:
                        tests.add(f[1])
                    self.skip_terms()
                self.expect_kw("end")
                self.skip_terms()
            else:
                raise MatlabError(f"unexpected in classdef: {t!r}")
        self.next()  # end
        return ("classdef", name, bases, props, methods, static, tests)

    def parse_function(self):
        self.expect_kw("function")
        # forms: function out = name(args) | function [a, b] = name(args)
        #      | function name(args) | function name
        out_var = None
        out_vars: Optional[List[str]] = None
        if self.at_op("["):
            self.next()
            out_vars = []
            while not self.at_op("]"):
                out_vars.append(self.next().val)
                if self.at_op(","):
                    self.next()
            self.next()
            self.expect_op("=")
            name = self.next().val
            out_var = out_vars[0] if out_vars else None
            # fallthrough to params below
        else:
            name = self.next().val
            if self.at_op("="):
                self.next()
                out_var = name
                name = self.next().val
        if out_vars is None:
            out_vars = [out_var] if out_var is not None else []
        params: List[str] = []
        if self.at_op("("):
            self.next()
            while not self.at_op(")"):
                p = self.next()
                if p.kind == "op" and p.val == "~":
                    params.append("~")
                else:
                    params.append(p.val)
                if self.at_op(","):
                    self.next()
            self.next()
        self.skip_terms()
        body = self.parse_block()
        # MATLAB allows end-less function files: a file-level function body
        # runs until the next `function` keyword or EOF (the reference's
        # classification_demo.m style); explicit `end` is also accepted
        t = self.peek()
        if t.kind == "kw" and t.val == "end":
            self.next()
        elif not (t.kind == "eof" or (t.kind == "kw" and t.val == "function")):
            raise MatlabError(f"expected 'end' or next function, got {t!r}")
        return ("function", name, out_vars, params, body)

    # ---- statements
    def parse_block(self) -> List[tuple]:
        stmts = []
        self.skip_terms()
        while True:
            t = self.peek()
            if t.kind == "eof":
                break
            if t.kind == "kw" and t.val in ("end", "else", "elseif", "catch",
                                            "function"):
                # `function` ends an end-less file-level function body
                break
            stmts.append(self.parse_stmt())
            self.skip_terms()
        return stmts

    def parse_stmt(self) -> tuple:
        t = self.peek()
        if t.kind == "kw":
            if t.val == "if":
                return self.parse_if()
            if t.val == "for":
                return self.parse_for()
            if t.val == "while":
                return self.parse_while()
            if t.val == "try":
                return self.parse_try()
            if t.val == "return":
                self.next()
                return ("return",)
            if t.val == "function":
                raise MatlabError("nested function definitions not supported")
            raise MatlabError(f"unexpected keyword {t.val!r} at line {t.line}")
        if t.kind == "op" and t.val == "[":
            # [a, b] = f(...) multi-assign (also [~, b] = ...)
            save = self.i
            try:
                targets = self.parse_massign_targets()
                self.expect_op("=")
                rhs = self.parse_expr()
                return ("massign", targets, rhs)
            except MatlabError:
                self.i = save  # fall through: a bare matrix expression
        expr = self.parse_expr()
        if self.at_op("="):
            self.next()
            rhs = self.parse_expr()
            return ("assign", expr, rhs)
        return ("exprstmt", expr)

    def parse_massign_targets(self) -> List[Optional[tuple]]:
        """'[' lvalue (',' lvalue)* ']' where lvalue is an expression
        (ident / field / index) or '~' (discard, parsed as None)."""
        self.expect_op("[")
        targets: List[Optional[tuple]] = []
        while not self.at_op("]"):
            if self.at_op("~"):
                self.next()
                targets.append(None)
            else:
                targets.append(self.parse_postfix())
            if self.at_op(","):
                self.next()
        self.next()
        if not targets:
            raise MatlabError("empty multi-assign target list")
        return targets

    def parse_try(self):
        self.expect_kw("try")
        self.skip_terms()
        body = self.parse_block()
        err_var = None
        catch_body: List[tuple] = []
        if self.peek().kind == "kw" and self.peek().val == "catch":
            self.next()
            if self.peek().kind == "id":
                err_var = self.next().val
            self.skip_terms()
            catch_body = self.parse_block()
        self.expect_kw("end")
        return ("try", body, err_var, catch_body)

    def parse_if(self):
        self.expect_kw("if")
        branches = [(self.parse_expr(), None)]
        self.skip_terms()
        branches[0] = (branches[0][0], self.parse_block())
        else_body: List[tuple] = []
        while True:
            t = self.peek()
            if t.kind == "kw" and t.val == "elseif":
                self.next()
                cond = self.parse_expr()
                self.skip_terms()
                branches.append((cond, self.parse_block()))
            elif t.kind == "kw" and t.val == "else":
                self.next()
                self.skip_terms()
                else_body = self.parse_block()
            else:
                break
        self.expect_kw("end")
        return ("if", branches, else_body)

    def parse_for(self):
        self.expect_kw("for")
        var = self.next().val
        self.expect_op("=")
        it = self.parse_expr()
        self.skip_terms()
        body = self.parse_block()
        self.expect_kw("end")
        return ("for", var, it, body)

    def parse_while(self):
        self.expect_kw("while")
        cond = self.parse_expr()
        self.skip_terms()
        body = self.parse_block()
        self.expect_kw("end")
        return ("while", cond, body)

    # ---- expressions (precedence climbing)
    def parse_expr(self) -> tuple:
        return self.parse_or()

    def parse_or(self):
        a = self.parse_and()
        while self.at_op("||", "|"):
            op = self.next().val
            a = ("binop", op, a, self.parse_and())
        return a

    def parse_and(self):
        a = self.parse_cmp()
        while self.at_op("&&", "&"):
            op = self.next().val
            a = ("binop", op, a, self.parse_cmp())
        return a

    def parse_cmp(self):
        a = self.parse_range()
        while self.at_op("==", "~=", "<", "<=", ">", ">="):
            op = self.next().val
            a = ("binop", op, a, self.parse_range())
        return a

    def parse_range(self):
        a = self.parse_add()
        if self.at_op(":"):
            self.next()
            b = self.parse_add()
            if self.at_op(":"):
                self.next()
                c = self.parse_add()
                return ("range", a, b, c)  # lo, step, hi
            return ("range", a, None, b)
        return a

    def parse_add(self):
        a = self.parse_mul()
        while self.at_op("+", "-"):
            op = self.next().val
            a = ("binop", op, a, self.parse_mul())
        return a

    def parse_mul(self):
        a = self.parse_unary()
        while self.at_op("*", "/", ".*", "./"):
            op = self.next().val
            a = ("binop", op, a, self.parse_unary())
        return a

    def parse_unary(self):
        if self.at_op("-", "+", "~"):
            op = self.next().val
            return ("unop", op, self.parse_unary())
        return self.parse_power()

    def parse_power(self):
        a = self.parse_postfix()
        if self.at_op("^", ".^"):
            op = self.next().val
            return ("binop", op, a, self.parse_unary())
        return a

    def parse_postfix(self):
        a = self.parse_primary()
        while True:
            if self.at_op("("):
                self.next()
                args = self.parse_args(")")
                a = ("call", a, args)
            elif self.at_op("{"):
                self.next()
                args = self.parse_args("}")
                a = ("brace", a, args)
            elif self.at_op("."):
                self.next()
                if self.at_op("("):  # dynamic field .("name")
                    self.next()
                    e = self.parse_expr()
                    self.expect_op(")")
                    a = ("dynfield", a, e)
                else:
                    a = ("field", a, self.next().val)
            else:
                return a

    def parse_args(self, closer: str) -> List[tuple]:
        args: List[tuple] = []
        while not self.at_op(closer):
            if self.at_op(":") and (self.peek(1).kind == "op"
                                    and self.peek(1).val in (",", closer)):
                self.next()
                args.append(("colonall",))
            else:
                args.append(self.parse_expr())
            if self.at_op(","):
                self.next()
        self.next()
        return args

    def parse_primary(self):
        t = self.next()
        if t.kind == "num":
            return ("num", float(t.val))
        if t.kind == "str":
            return ("str", t.val)
        if t.kind == "id":
            return ("ident", t.val)
        if t.kind == "kw" and t.val == "end":
            # 'end' in an index expression: resolved at eval time against
            # the dimension being indexed (env["__endval__"])
            return ("endmarker",)
        if t.kind == "op" and t.val == "(":
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "op" and t.val == "@":
            return ("handle", self.next().val)
        if t.kind == "op" and t.val == "[":
            return self.parse_matrix()
        if t.kind == "op" and t.val == "{":
            items = []
            while not self.at_op("}"):
                items.append(self.parse_expr())
                if self.at_op(","):
                    self.next()
            self.next()
            return ("cellarr", items)
        raise MatlabError(f"unexpected token {t!r}")

    def parse_matrix(self):
        # '[' already consumed. rows separated by ';', elements by ','/space
        rows: List[List[tuple]] = [[]]
        while not self.at_op("]"):
            if self.peek().kind in ("semi",):
                self.next()
                rows.append([])
                continue
            if self.peek().kind == "nl":
                self.next()
                continue
            rows[-1].append(self.parse_expr())
            if self.at_op(","):
                self.next()
        self.next()
        return ("array", [r for r in rows if r])


# =============================================================== values

class MatArray:
    """A MATLAB numeric/logical array: >=2 logical dims, column-major
    reshape semantics, 1-based indexing, trailing-singleton trimming."""

    __slots__ = ("a",)

    def __init__(self, a: np.ndarray):
        a = np.asarray(a)
        if a.ndim == 0:
            a = a.reshape(1, 1)
        elif a.ndim == 1:
            a = a.reshape(1, -1)  # MATLAB default: row vector
        # trailing singleton trim (beyond 2 dims)
        shape = list(a.shape)
        while len(shape) > 2 and shape[-1] == 1:
            shape.pop()
        self.a = a.reshape(shape)

    @property
    def size(self) -> Tuple[int, ...]:
        return self.a.shape

    def is_scalar(self) -> bool:
        return self.a.size == 1

    def scalar(self):
        return self.a.reshape(-1)[0]

    def __repr__(self):
        return f"MatArray({self.a!r})"


class MatCell:
    __slots__ = ("items",)

    def __init__(self, items: List[Any]):
        self.items = list(items)


class MatClass:
    def __init__(self, name, bases, props, methods, static, engine, pkg,
                 tests=None):
        self.name, self.bases = name, bases
        self.props, self.methods, self.static = props, methods, static
        self.tests = tests or set()
        self.engine, self.pkg = engine, pkg

    @property
    def is_testcase(self) -> bool:
        return any("unittest" in b for b in self.bases)


class MatObject:
    __slots__ = ("cls", "props")

    def __init__(self, cls: MatClass):
        self.cls = cls
        self.props: Dict[str, Any] = {}


class MatObjArray:
    __slots__ = ("cls", "items")

    def __init__(self, cls: Optional[MatClass], items: List[Any]):
        self.cls, self.items = cls, items


class MatFunction:
    def __init__(self, node, engine, pkg, name=None):
        _, fname, out_vars, params, body = node
        self.name = name or fname
        self.out_vars = list(out_vars or [])
        self.out_var = self.out_vars[0] if self.out_vars else None
        self.params, self.body = params, body
        self.engine, self.pkg = engine, pkg
        # sibling functions defined in the same .m file (MATLAB
        # subfunctions) — visible only from inside this file's functions
        self.file_locals: Dict[str, "MatFunction"] = {}


class MatStruct:
    """A MATLAB struct: ordered field dict.  Created by struct(...) or by
    assignment to a field of an undefined name (s.f = v)."""

    __slots__ = ("fields",)

    def __init__(self, fields: Optional[Dict[str, Any]] = None):
        self.fields: Dict[str, Any] = dict(fields or {})


class MatStructArray:
    """1-D array of structs (e.g. h5info().Datasets); s(i) indexes."""

    __slots__ = ("items",)

    def __init__(self, items: List[MatStruct]):
        self.items = list(items)


class BoundMethod:
    __slots__ = ("obj", "fn")

    def __init__(self, obj, fn: MatFunction):
        self.obj, self.fn = obj, fn


class Builtin:
    __slots__ = ("name", "fn")

    def __init__(self, name, fn):
        self.name, self.fn = name, fn


class Package:
    """A +pkg directory: resolves classes, functions, and subpackages."""

    def __init__(self, engine: "MatlabEngine", path: str, name: str):
        self.engine, self.path, self.name = engine, path, name
        self._cache: Dict[str, Any] = {}

    def resolve(self, name: str):
        if name in self._cache:
            return self._cache[name]
        sub = os.path.join(self.path, "+" + name)
        mfile = os.path.join(self.path, name + ".m")
        if os.path.isdir(sub):
            val = Package(self.engine, sub, f"{self.name}.{name}")
        elif os.path.isfile(mfile):
            val = self.engine._load_mfile(mfile, self)
        else:
            raise MatlabError(f"unknown name {self.name}.{name}")
        self._cache[name] = val
        return val


class PyRoot:
    """The MATLAB ``py.`` namespace."""
    pass


class _ContainersNS:
    """The MATLAB ``containers.`` namespace (Map only)."""
    pass


class MatMap:
    """containers.Map over string keys; m(key) reads, m(key) = v writes."""

    __slots__ = ("d",)

    def __init__(self, keys=None, vals=None):
        self.d: Dict[str, Any] = {}
        if keys is not None:
            ks = keys.items if isinstance(keys, MatCell) else [keys]
            if isinstance(vals, MatCell):
                vs = vals.items
            elif isinstance(vals, MatArray):
                vs = [MatlabEngine._scalarize(x)
                      for x in vals.a.reshape(-1, order="F")]
            else:
                vs = [vals]
            if len(ks) != len(vs):
                raise MatlabError("containers.Map: keys/values length mismatch")
            for k, v in zip(ks, vs):
                if not isinstance(k, str):
                    raise MatlabError("containers.Map: only string keys supported")
                self.d[k] = v

    def get(self, key):
        if not isinstance(key, str) or key not in self.d:
            raise MatlabError(f"containers.Map: no key {key!r}")
        return self.d[key]


# ============================================== the py. alias table

JAX_PACKAGE, PORT_PACKAGE = "caffe_rtpose_tpu", "caffe_rtpose_tpu_torch"


def _port_module_name(name: str) -> str:
    """A module name the M-files write -> the one this engine imports: the
    JAX package's prefix names the port's; a jax module is refused."""
    if name == "jax" or name.startswith("jax."):
        raise MatlabError(f"py.{name}: jax is not available to this engine; only "
                          "jax.config.update('jax_platforms', 'cpu' | '') is mapped")
    if name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + "."):
        return PORT_PACKAGE + name[len(JAX_PACKAGE):]
    return name


def _import_module(name, package=None):
    """``py.importlib.import_module`` through the alias table."""
    return importlib.import_module(_port_module_name(str(name)), package)


def _jax_config_update(key, value):
    """``py.jax.config.update('jax_platforms', 'cpu' | '')`` -> the port's
    ``api.set_mode_cpu()`` / ``api.set_mode_gpu()``."""
    api = importlib.import_module(PORT_PACKAGE + ".api")
    if str(key) == "jax_platforms" and str(value) == "cpu":
        return api.set_mode_cpu()
    if str(key) == "jax_platforms" and str(value) == "":
        return api.set_mode_gpu()
    raise MatlabError(f"py.jax.config.update({key!r}, {value!r}) has no counterpart here")


# full dotted py. names that resolve to a function of this engine
PY_ALIASES = {
    "importlib.import_module": _import_module,
    "jax.config.update": _jax_config_update,
}


class PyModuleRef:
    """Lazy dotted path under py. — resolves to a module or attr chain,
    through :data:`PY_ALIASES` and :func:`_port_module_name`."""

    __slots__ = ("parts",)

    def __init__(self, parts: Tuple[str, ...]):
        self.parts = parts

    def aliased(self) -> bool:
        """A name the alias table answers (or refuses) without an import."""
        return ".".join(self.parts) in PY_ALIASES or self.parts[0] == "jax"

    def resolve(self):
        name = ".".join(self.parts)
        if name in PY_ALIASES:
            return PY_ALIASES[name]
        parts = tuple(_port_module_name(name).split("."))
        # import the longest importable module prefix, then getattr the rest
        obj = None
        for k in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:k]))
                rest = parts[k:]
                break
            except ImportError:
                continue
        else:
            raise MatlabError(f"py module not found: {name}")
        for name in rest:
            obj = getattr(obj, name)
        return obj


# ============================================== MATLAB <-> Python boundary

def matlab_to_py(v):
    """MATLAB value -> Python, per MATLAB's pass-to-Python conversion:
    char -> str, scalars -> float/int/bool, numeric arrays -> ndarray with
    the same logical shape and values."""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, MatArray):
        if v.is_scalar():
            s = v.scalar()
            if isinstance(s, (np.integer,)):
                return int(s)
            if isinstance(s, (np.bool_,)):
                return bool(s)
            return float(s) if v.a.dtype != np.float32 else np.float32(s)
        return np.ascontiguousarray(v.a)
    if isinstance(v, MatCell):
        return [matlab_to_py(x) for x in v.items]
    return v  # py objects pass through


def py_to_matlab(v):
    """Python value -> MATLAB, per MATLAB's convert-from-Python rules used
    by single()/double()/char()/cell() and auto-scalar conversion.  Most py
    values stay opaque py objects until explicitly converted — this helper
    is only applied where MATLAB itself would auto-convert (never for
    attribute access results)."""
    return v


# =============================================================== engine

class _ReturnSignal(Exception):
    pass


class MatlabEngine:
    """Interpret the repo's matcaffe M-files against the live Python api.

    >>> eng = MatlabEngine("matlab")  # the repository's matlab/ directory
    >>> eng.call("caffe.version")
    """

    def __init__(self, matlab_root: str):
        self.root = matlab_root
        self.packages: Dict[str, Package] = {}
        for entry in os.listdir(matlab_root):
            if entry.startswith("+"):
                self.packages[entry[1:]] = Package(
                    self, os.path.join(matlab_root, entry), entry[1:])
        # engine-bound builtins (need self): the matlab.unittest test runner
        self._engine_builtins: Dict[str, Builtin] = {
            "run": Builtin("run", self._run_testcase),
        }

    def _run_testcase(self, cls) -> str:
        """run(caffe.test.test_x): construct the TestCase, invoke every
        method declared in a ``methods (Test)`` block, report pass/fail.
        A failed verification raises MatlabError out of run() — test
        failures must fail run_tests(), like the reference runner."""
        if not isinstance(cls, MatClass) or not cls.is_testcase:
            raise MatlabError("run() expects a matlab.unittest.TestCase class")
        passed = []
        for name in sorted(cls.tests):
            # MATLAB's unittest constructs a FRESH TestCase instance per
            # test method — one method's fixture mutations must not leak
            # into the next
            obj = self.construct(cls, [])
            self.call_function(cls.methods[name], [], self_obj=obj)
            passed.append(name)
        summary = f"{cls.name}: {len(passed)}/{len(cls.tests)} passed"
        _FPRINTF_OUT.append(summary + "\n")
        return summary

    # ---- loading
    def _load_mfile(self, path: str, pkg: Package):
        with open(path) as f:
            src = f.read()
        node = Parser(tokenize(src)).parse_file()
        base = os.path.splitext(os.path.basename(path))[0]
        if node[0] == "classdef":
            _, name, bases, props, methods, static, tests = node
            if name != base:
                raise MatlabError(f"classdef {name} in {base}.m")
            return MatClass(name, bases, props,
                            {k: MatFunction(v, self, pkg) for k, v in methods.items()},
                            static, self, pkg, tests=tests)
        funcs = node[1]
        fns = [MatFunction(f_node, self, pkg) for f_node in funcs]
        main = None
        for f in fns:
            if f.name == base:
                main = f
        if main is None:
            main = fns[0]
            main.name = base
        # MATLAB subfunctions: every function in the file sees its siblings
        table = {f.name: f for f in fns}
        for f in fns:
            f.file_locals = table
        return main

    # ---- public API
    def resolve(self, qualname: str):
        parts = qualname.split(".")
        obj: Any = self.packages[parts[0]]
        for p in parts[1:]:
            if isinstance(obj, Package):
                obj = obj.resolve(p)
            elif isinstance(obj, MatClass):
                obj = obj.methods[p]
            else:
                raise MatlabError(f"cannot resolve {qualname}")
        return obj

    def call(self, qualname: str, *args):
        fn = self.resolve(qualname)
        margs = [self._in(a) for a in args]
        if isinstance(fn, MatClass):
            return self.construct(fn, margs)
        return self.call_function(fn, margs)

    def call_method(self, obj, name: str, *args):
        margs = [self._in(a) for a in args]
        return self._invoke_method(obj, name, margs)

    def run_script(self, path: str) -> Dict[str, Any]:
        """Execute a script .m file (bare statements, shared workspace) the
        way MATLAB runs e.g. matlab/hdf5creation/demo.m from its own
        directory: sibling .m function files resolve unqualified, package
        namespaces (caffe.*) resolve from this engine's root.  Returns the
        script workspace for inspection."""
        with open(path) as f:
            src = f.read()
        node = Parser(tokenize(src)).parse_file()
        if node[0] != "script":
            raise MatlabError(f"{path} is not a script file")
        pkg = Package(self, os.path.dirname(os.path.abspath(path)),
                      os.path.splitext(os.path.basename(path))[0])
        env: Dict[str, Any] = {}
        self.exec_block(node[1], env, pkg)
        return env

    def run_mfile(self, path: str, *args, nargout: int = 1):
        """Call a function .m file that lives OUTSIDE a +package (e.g.
        matlab/demo/classification_demo.m): siblings in its directory are
        visible unqualified, like the MATLAB path."""
        pkg = Package(self, os.path.dirname(os.path.abspath(path)),
                      os.path.splitext(os.path.basename(path))[0])
        fn = self._load_mfile(path, pkg)
        margs = [self._in(a) for a in args]
        return self.call_function(fn, margs, nargout=nargout)

    def _in(self, v):
        """Python test value -> MATLAB value."""
        if isinstance(v, np.ndarray):
            return MatArray(v)
        if isinstance(v, (list, tuple)):
            return MatCell([self._in(x) for x in v])
        return v

    # ---- function machinery
    def call_function(self, fn, args: List[Any], self_obj=None, nargout=1):
        if isinstance(fn, Builtin):
            return fn.fn(*args)
        if isinstance(fn, BoundMethod):
            return self.call_function(fn.fn, args, self_obj=fn.obj,
                                      nargout=nargout)
        if isinstance(fn, MatClass):
            return self.construct(fn, args)
        if not isinstance(fn, MatFunction):
            raise MatlabError(f"not callable: {fn!r}")
        env: Dict[str, Any] = {}
        if fn.file_locals:
            env["__file_locals__"] = fn.file_locals
        params = list(fn.params)
        if self_obj is not None:
            args = [self_obj] + args
        nargin = len(args)
        if params and params[-1] == "varargin":
            fixed = params[:-1]
            for i, p in enumerate(fixed):
                if i < len(args) and p != "~":
                    env[p] = args[i]
            env["varargin"] = MatCell(args[len(fixed):])
        else:
            if len(args) > len(params):
                raise MatlabError(
                    f"too many args to {fn.name} ({len(args)} > {len(params)})")
            for i, a in enumerate(args):
                if params[i] != "~":
                    env[params[i]] = a
        env["nargin"] = float(nargin)
        env["nargout"] = float(nargout)
        if fn.out_var is not None and fn.out_var not in env:
            env[fn.out_var] = MatArray(np.zeros((0, 0)))
        try:
            self.exec_block(fn.body, env, fn.pkg)
        except _ReturnSignal:
            pass
        if nargout > 1:
            if len(fn.out_vars) < nargout:
                raise MatlabError(
                    f"{fn.name} returns {len(fn.out_vars)} values, "
                    f"{nargout} requested")
            return tuple(env.get(ov) for ov in fn.out_vars[:nargout])
        if fn.out_var is not None:
            return env.get(fn.out_var)
        return None

    def construct(self, cls: MatClass, args: List[Any]):
        ctor = cls.methods.get(cls.name)
        if ctor is None:
            return MatObject(cls)
        obj = MatObject(cls)
        env: Dict[str, Any] = {}
        params = list(ctor.params)
        nargin = len(args)
        # constructor params are the user args; out_var is the object
        if params and params[-1] == "varargin":
            fixed = params[:-1]
            for i, p in enumerate(fixed):
                if i < len(args):
                    env[p] = args[i]
            env["varargin"] = MatCell(args[len(fixed):])
        else:
            for i, a in enumerate(args):
                env[params[i]] = a
        env["nargin"] = float(nargin)
        env[ctor.out_var] = obj
        try:
            self.exec_block(ctor.body, env, ctor.pkg)
        except _ReturnSignal:
            pass
        return env[ctor.out_var]

    def _invoke_method(self, obj, name: str, args: List[Any]):
        if isinstance(obj, MatObject):
            m = obj.cls.methods.get(name)
            if m is not None:
                return self.call_function(m, args, self_obj=obj)
            raise MatlabError(f"no method {name} on {obj.cls.name}")
        raise MatlabError(f"method call on non-object {type(obj)}")

    # ---- statement execution
    def exec_block(self, stmts, env, pkg):
        for s in stmts:
            self.exec_stmt(s, env, pkg)

    def exec_stmt(self, s, env, pkg):
        tag = s[0]
        if tag == "exprstmt":
            self.eval(s[1], env, pkg)
        elif tag == "assign":
            val = self.eval(s[2], env, pkg)
            self.store(s[1], val, env, pkg)
        elif tag == "if":
            _, branches, else_body = s
            for cond, body in branches:
                if self._truth(self.eval(cond, env, pkg)):
                    self.exec_block(body, env, pkg)
                    return
            self.exec_block(else_body, env, pkg)
        elif tag == "for":
            _, var, it_expr, body = s
            it = self.eval(it_expr, env, pkg)
            for v in self._iterate(it):
                env[var] = v
                self.exec_block(body, env, pkg)
        elif tag == "while":
            _, cond, body = s
            while self._truth(self.eval(cond, env, pkg)):
                self.exec_block(body, env, pkg)
        elif tag == "return":
            raise _ReturnSignal()
        elif tag == "try":
            _, body, err_var, catch_body = s
            try:
                self.exec_block(body, env, pkg)
            except _ReturnSignal:
                raise
            except Exception as exc:  # MATLAB catches everything
                if err_var is not None:
                    env[err_var] = MatStruct({
                        "message": str(exc),
                        "identifier": type(exc).__name__,
                    })
                self.exec_block(catch_body, env, pkg)
        elif tag == "massign":
            self._exec_massign(s[1], s[2], env, pkg)
        else:
            raise MatlabError(f"unknown statement {tag}")

    def _exec_massign(self, targets, rhs, env, pkg):
        """[a, b, ~] = f(...): call with nargout=len(targets)."""
        n = len(targets)
        vals = None
        if rhs[0] == "call":
            base_e, arg_es = rhs[1], rhs[2]
            target = None
            if base_e[0] == "ident" and base_e[1] not in env:
                name = base_e[1]
                if name in _MULTI_BUILTINS:
                    args = [self.eval(a, env, pkg) for a in arg_es]
                    vals = _MULTI_BUILTINS[name](n, *args)
                else:
                    target = self._lookup(name, env, pkg)
            elif base_e[0] == "field":
                # pkg.fn or obj.method in multi-output position
                obj = self.eval(base_e[1], env, pkg)
                got = self._getfield(obj, base_e[2], env, pkg) \
                    if not isinstance(obj, MatObject) else None
                if isinstance(obj, MatObject):
                    m = obj.cls.methods.get(base_e[2])
                    if m is not None:
                        got = BoundMethod(obj, m)
                target = got
            else:
                target = self.eval(base_e, env, pkg)
            if vals is None:
                if not isinstance(target, (MatFunction, BoundMethod)):
                    raise MatlabError(
                        "multi-assign needs a function with multiple outputs")
                args = [self.eval(a, env, pkg) for a in arg_es]
                vals = self.call_function(target, args, nargout=n)
        else:
            v = self.eval(rhs, env, pkg)
            vals = v if isinstance(v, tuple) else (v,)
        if len(vals) < n:
            raise MatlabError(f"expected {n} outputs, got {len(vals)}")
        for t, v in zip(targets, vals):
            if t is not None:
                self.store(t, v, env, pkg)

    def _iterate(self, it):
        if isinstance(it, MatArray):
            # iterate columns; for row vectors that is each element
            a = it.a
            if a.ndim == 2 and a.shape[0] == 1:
                return [self._scalarize(x) for x in a.reshape(-1)]
            return [MatArray(a[..., j]) for j in range(a.shape[-1])]
        raise MatlabError(f"cannot iterate {type(it)}")

    @staticmethod
    def _scalarize(x):
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, np.bool_):
            return bool(x)
        return x

    def _truth(self, v) -> bool:
        if isinstance(v, MatArray):
            return bool(v.a.size) and bool(np.all(v.a))
        if isinstance(v, (bool, np.bool_)):
            return bool(v)
        if isinstance(v, (int, float, np.integer, np.floating)):
            return v != 0
        if isinstance(v, str):
            return len(v) > 0
        raise MatlabError(f"no truth value for {type(v)}")

    # ---- lvalue store
    def store(self, lhs, val, env, pkg):
        tag = lhs[0]
        if tag == "ident":
            env[lhs[1]] = val
            return
        if tag == "field":
            # s.f = v on an undefined name creates a struct (MATLAB)
            if lhs[1][0] == "ident" and lhs[1][1] not in env:
                env[lhs[1][1]] = MatStruct()
            base = self.eval(lhs[1], env, pkg)
            if isinstance(base, MatStruct):
                base.fields[lhs[2]] = val
            elif isinstance(base, MatObject):
                base.props[lhs[2]] = val
            else:  # python object attribute (e.g. pyblob.data = ...)
                setattr(base, lhs[2], matlab_to_py(val))
            return
        if tag == "brace":
            base = self.eval(lhs[1], env, pkg)
            idx = [self.eval(a, env, pkg) for a in lhs[2]]
            if isinstance(base, MatCell):
                i = self._int_index(idx)
                while len(base.items) < i:
                    base.items.append(MatArray(np.zeros((0, 0))))
                base.items[i - 1] = val
            elif isinstance(base, dict):
                if len(idx) != 1 or not isinstance(idx[0], str):
                    raise MatlabError("py dict brace-assign needs one str key")
                base[idx[0]] = matlab_to_py(val)
            elif hasattr(base, "__setitem__"):
                key = idx[0]
                if isinstance(key, str):
                    base[key] = matlab_to_py(val)
                else:
                    base[self._int_index(idx) - 1] = matlab_to_py(val)
            else:
                raise MatlabError(f"cannot brace-assign into {type(base)}")
            return
        if tag == "call":  # paren-assign: array element or object array
            base = self.eval(lhs[1], env, pkg)
            if isinstance(base, MatArray):
                idx = self._eval_index_args(lhs[2], env, pkg, base)
            else:
                idx = [self.eval(a, env, pkg) for a in lhs[2]]
            if isinstance(base, MatObjArray):
                i = self._int_index(idx)
                while len(base.items) < i:
                    base.items.append(None)
                base.items[i - 1] = val
                if base.cls is None and isinstance(val, MatObject):
                    base.cls = val.cls
                return
            if isinstance(base, MatArray):
                self._array_assign(base, idx, val)
                return
            raise MatlabError(f"cannot paren-assign into {type(base)}")
        raise MatlabError(f"bad assignment target {tag}")

    @staticmethod
    def _int_index(idx) -> int:
        if len(idx) != 1:
            raise MatlabError("only linear indexing supported here")
        v = idx[0]
        if isinstance(v, MatArray):
            v = v.scalar()
        return int(v)

    def _array_assign(self, arr: MatArray, idx, val):
        if len(idx) == 1:
            sel = self._linear_sel(arr, idx[0])
            flat = arr.a.reshape(-1, order="F").copy()
            v = val.a.reshape(-1, order="F") if isinstance(val, MatArray) else val
            flat[sel] = v
            arr.a = flat.reshape(arr.a.shape, order="F")
            return
        # multi-dim: ':' / index-vectors / scalars (no growth — MATLAB
        # grows on out-of-range assign; the ported demos preallocate)
        a = arr.a
        if a.ndim < len(idx):
            a = a.reshape(a.shape + (1,) * (len(idx) - a.ndim))
        sels = []
        for d, ix in enumerate(idx):
            if ix == ("colonall",):
                sels.append(np.arange(a.shape[d]))
            elif isinstance(ix, MatArray):
                sels.append(ix.a.reshape(-1, order="F").astype(np.int64) - 1)
            else:
                sels.append(np.array([int(self._num(ix)) - 1]))
        out = a.copy()
        block = tuple(len(s) for s in sels)
        if isinstance(val, MatArray):
            v = val.a.reshape(-1, order="F").reshape(block, order="F")
        else:
            v = np.full(block, val)
        out[np.ix_(*sels)] = v
        arr.a = out.reshape(arr.a.shape, order="F") \
            if out.shape != arr.a.shape else out

    def _linear_sel(self, arr: MatArray, ix):
        if isinstance(ix, MatArray):
            return ix.a.reshape(-1, order="F").astype(np.int64) - 1
        return np.array([int(ix) - 1])

    # ---- expression evaluation
    def eval(self, e, env, pkg):
        tag = e[0]
        if tag == "colonall":
            # the magic ':' marker survives argument re-evaluation in
            # _eval_call/_array_index
            return ("colonall",)
        if tag == "endmarker":
            v = env.get("__endval__")
            if v is None:
                raise MatlabError("'end' used outside array indexing")
            return v
        if tag == "num":
            return e[1]
        if tag == "str":
            return e[1]
        if tag == "ident":
            v = self._lookup(e[1], env, pkg)
            # a bare name that resolves to a function is INVOKED in value
            # context (MATLAB semantics: `model = tempname;`); function
            # *handles* (@name) stay uncalled
            if isinstance(v, (Builtin, MatFunction)) and e[1] not in env:
                return self.call_function(v, [])
            return v
        if tag == "handle":
            name = e[1]
            if name in BUILTINS:
                return BUILTINS[name]
            return self._lookup(name, env, pkg)
        if tag == "range":
            lo = self._num(self.eval(e[1], env, pkg))
            step = self._num(self.eval(e[2], env, pkg)) if e[2] is not None else 1.0
            hi = self._num(self.eval(e[3], env, pkg))
            n = math.floor((hi - lo) / step + 1e-10) + 1
            vals = [lo + i * step for i in range(max(0, int(n)))]
            return MatArray(np.array(vals, dtype=np.float64))
        if tag == "array":
            return self._build_array(e[1], env, pkg)
        if tag == "cellarr":
            return MatCell([self.eval(x, env, pkg) for x in e[1]])
        if tag == "binop":
            return self._binop(e[1], e[2], e[3], env, pkg)
        if tag == "unop":
            v = self.eval(e[2], env, pkg)
            if e[1] == "-":
                return self._neg(v)
            if e[1] == "+":
                return v
            if e[1] == "~":
                if isinstance(v, MatArray):
                    return MatArray(~v.a.astype(bool))
                return not self._truth(v)
        if tag == "field":
            base = self.eval(e[1], env, pkg)
            v = self._getfield(base, e[2], env, pkg)
            # MATLAB invokes a zero-arg method on dot-access in value
            # context (obj.shape); explicit calls never reach here — the
            # call node's field base is resolved in _eval_call instead
            if isinstance(v, BoundMethod):
                return self.call_function(v, [])
            return v
        if tag == "dynfield":
            base = self.eval(e[1], env, pkg)
            name = self.eval(e[2], env, pkg)
            return self._getfield(base, str(name), env, pkg)
        if tag == "brace":
            base = self.eval(e[1], env, pkg)
            idx = [self.eval(a, env, pkg) for a in e[2]]
            return self._brace_index(base, idx)
        if tag == "call":
            return self._eval_call(e, env, pkg)
        raise MatlabError(f"unknown expr {tag}")

    def _lookup(self, name, env, pkg):
        if name in env:
            return env[name]
        locs = env.get("__file_locals__")
        if locs is not None and name in locs:
            return locs[name]
        if name == "py":
            return PyRoot()
        if name == "true":
            return True
        if name == "false":
            return False
        if name == "pi":
            return math.pi
        if name in ("Inf", "inf"):
            return math.inf
        if name in ("NaN", "nan"):
            return math.nan
        if name == "containers":
            return _ContainersNS()
        if name in self._engine_builtins:
            return self._engine_builtins[name]
        if name in self.packages:
            return self.packages[name]
        if pkg is not None:
            # a sibling file in the same package is visible unqualified
            try:
                return pkg.resolve(name)
            except MatlabError:
                pass
        if name in BUILTINS:
            return BUILTINS[name]
        raise MatlabError(f"undefined name {name!r}")

    @staticmethod
    def _num(v) -> float:
        if isinstance(v, MatArray):
            return float(v.scalar())
        if isinstance(v, (bool, np.bool_)):
            return float(bool(v))
        return float(v)

    def _build_array(self, rows, env, pkg):
        out_rows = []
        for row in rows:
            vals = [self.eval(x, env, pkg) for x in row]
            if any(isinstance(v, str) for v in vals):
                if len(rows) > 1:
                    raise MatlabError("string matrix rows not supported")
                return "".join(self._char(v) for v in vals)
            cells = []
            for v in vals:
                if isinstance(v, MatArray):
                    cells.append(np.atleast_2d(v.a))
                else:
                    cells.append(np.array([[self._num(v)]]))
            out_rows.append(np.hstack(cells) if cells else np.zeros((1, 0)))
        if not out_rows:
            return MatArray(np.zeros((0, 0)))
        return MatArray(np.vstack(out_rows))

    @staticmethod
    def _char(v) -> str:
        if isinstance(v, str):
            return v
        raise MatlabError(f"cannot concat {type(v)} into char array")

    def _neg(self, v):
        if isinstance(v, MatArray):
            return MatArray(-v.a)
        return -v

    def _binop(self, op, ae, be, env, pkg):
        if op == "&&":
            return self._truth(self.eval(ae, env, pkg)) and \
                self._truth(self.eval(be, env, pkg))
        if op == "||":
            return self._truth(self.eval(ae, env, pkg)) or \
                self._truth(self.eval(be, env, pkg))
        a = self.eval(ae, env, pkg)
        b = self.eval(be, env, pkg)
        if op in ("==", "~=") and (isinstance(a, str) or isinstance(b, str)):
            if isinstance(a, str) and isinstance(b, str):
                eq = a == b
                return eq if op == "==" else not eq
        an = a.a if isinstance(a, MatArray) else a
        bn = b.a if isinstance(b, MatArray) else b
        if isinstance(an, str) or isinstance(bn, str):
            raise MatlabError(f"bad operands for {op}")
        ops = {
            "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
            ".*": np.multiply, "./": np.divide, "^": np.power, ".^": np.power,
            "==": np.equal, "~=": np.not_equal, "<": np.less,
            "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
            "&": np.logical_and, "|": np.logical_or,
        }
        r = ops[op](an, bn)
        if isinstance(r, np.ndarray) and r.ndim > 0:
            return MatArray(r)
        return self._scalarize(np.asarray(r).reshape(-1)[0])

    # ---- member access / indexing / calls
    def _getfield(self, base, name, env, pkg):
        if isinstance(base, MatStruct):
            if name in base.fields:
                return base.fields[name]
            raise MatlabError(f"no struct field {name!r}")
        if isinstance(base, PyRoot):
            if name in _PY_SPECIAL:
                return _PY_SPECIAL[name]
            return PyModuleRef((name,))
        if isinstance(base, _ContainersNS):
            if name == "Map":
                return Builtin("containers.Map", lambda *a: MatMap(*a))
            raise MatlabError(f"containers.{name} not supported")
        if isinstance(base, PyModuleRef):
            ref = PyModuleRef(base.parts + (name,))
            if ref.aliased():
                return ref
            try:
                return getattr(base.resolve(), name)
            except MatlabError:
                return ref
        if isinstance(base, Package):
            return base.resolve(name)
        if isinstance(base, MatClass):
            if name == "empty":
                return Builtin("empty", lambda *a, _c=base: MatObjArray(_c, []))
            m = base.methods.get(name)
            if m is not None and name in base.static:
                return m
            raise MatlabError(f"no static {name} on class {base.name}")
        if isinstance(base, MatObject):
            if name in base.props or name in base.cls.props:
                return base.props.get(name, MatArray(np.zeros((0, 0))))
            m = base.cls.methods.get(name)
            if m is not None:
                return BoundMethod(base, m)
            if base.cls.is_testcase and name in ("verifyEqual", "verifyTrue"):
                # matlab.unittest.TestCase verification surface
                if name == "verifyTrue":
                    return Builtin(name, lambda c: _verify_true(c))
                return Builtin(name, lambda a, b: _verify_equal(a, b))
            raise MatlabError(f"no property/method {name} on {base.cls.name}")
        # python object
        return getattr(base, name)

    def _brace_index(self, base, idx):
        if isinstance(base, MatCell):
            return base.items[self._int_index(idx) - 1]
        if isinstance(base, dict):
            return base[idx[0]]
        if hasattr(base, "__getitem__"):
            key = idx[0]
            if isinstance(key, str):
                return base[key]
            # MATLAB brace-indexes py sequences 1-based
            return base[self._int_index(idx) - 1]
        raise MatlabError(f"cannot brace-index {type(base)}")

    def _eval_call(self, e, env, pkg):
        _, base_e, arg_es = e
        # builtin / function-name call with the callee as bare ident
        if base_e[0] == "ident":
            name = base_e[1]
            if name not in env:
                # exist(x, 'var') asks about the CALLER's workspace — it
                # cannot be a plain builtin (no env access), so resolve here
                if name == "exist" and len(arg_es) == 2:
                    args = [self.eval(a, env, pkg) for a in arg_es]
                    if args[1] == "var":
                        return 1.0 if str(args[0]) in env else 0.0
                    return BUILTINS["exist"].fn(*args)
                if name in self._engine_builtins:
                    args = [self.eval(a, env, pkg) for a in arg_es]
                    return self._engine_builtins[name].fn(*args)
                if name in BUILTINS:
                    args = [self.eval(a, env, pkg) for a in arg_es]
                    return BUILTINS[name].fn(*args)
                target = self._lookup(name, env, pkg)
                return self._call_value(target, arg_es, env, pkg)
            target = env[name]
            if isinstance(target, MatArray):
                idx = self._eval_index_args(arg_es, env, pkg, target)
                return self._array_index(target, idx)
            return self._call_value(target, arg_es, env, pkg)
        # method call obj.m(args) — resolve without auto-invoking the method
        if base_e[0] == "field":
            obj = self.eval(base_e[1], env, pkg)
            name = base_e[2]
            if isinstance(obj, MatObject):
                m = obj.cls.methods.get(name)
                if m is not None:
                    args = [self.eval(a, env, pkg) for a in arg_es]
                    return self.call_function(m, args, self_obj=obj)
            target = self._getfield(obj, name, env, pkg)
            return self._call_value(target, arg_es, env, pkg)
        target = self.eval(base_e, env, pkg)
        return self._call_value(target, arg_es, env, pkg)

    def _call_value(self, target, arg_es, env, pkg):
        # Paren-applying an array value (field access or call result) is
        # indexing, so 'end' must resolve against that array — route through
        # _eval_index_args instead of the plain-arg path.
        if isinstance(target, MatArray):
            idx = self._eval_index_args(arg_es, env, pkg, target)
            return self._array_index(target, idx)
        if isinstance(target, (MatObjArray, MatStructArray)):
            items = target.items
            idx = self._eval_index_args(
                arg_es, env, pkg, MatArray(np.empty((1, len(items)))))
            return items[self._int_index(idx) - 1]
        args = [self.eval(a, env, pkg) for a in arg_es]
        if isinstance(target, Builtin):
            return target.fn(*args)
        if isinstance(target, (MatFunction, BoundMethod, MatClass)):
            return self.call_function(target, args) \
                if not isinstance(target, MatClass) else self.construct(target, args)
        if isinstance(target, MatMap):
            if len(args) != 1:
                raise MatlabError("Map lookup takes one key")
            return target.get(args[0])
        if isinstance(target, MatCell):
            raise MatlabError("cell paren-indexing not supported (use braces)")
        if isinstance(target, PyModuleRef):
            target = target.resolve()
        if callable(target):
            pyargs = [matlab_to_py(a) for a in args]
            return target(*pyargs)
        raise MatlabError(f"cannot call {type(target)}")

    def _eval_index_args(self, arg_es, env, pkg, arr: MatArray):
        """Evaluate index expressions with MATLAB 'end' in scope: for k-way
        indexing, 'end' in position d = size(arr, d) (the last position
        absorbs trailing dims); single-subscript: 'end' = numel."""
        n = len(arg_es)
        a = arr.a
        had = "__endval__" in env
        saved = env.get("__endval__")
        vals = []
        try:
            for d, ae in enumerate(arg_es):
                if n == 1:
                    env["__endval__"] = float(a.size)
                elif d == n - 1:
                    env["__endval__"] = float(
                        int(np.prod(a.shape[d:])) if d < a.ndim else 1)
                else:
                    env["__endval__"] = (float(a.shape[d])
                                         if d < a.ndim else 1.0)
                vals.append(self.eval(ae, env, pkg))
        finally:
            if had:
                env["__endval__"] = saved
            else:
                env.pop("__endval__", None)
        return vals

    def _array_index(self, arr: MatArray, idx):
        a = arr.a
        if len(idx) == 1 and not any(i == ("colonall",) for i in idx):
            ix = idx[0]
            flat = a.reshape(-1, order="F")
            if isinstance(ix, MatArray):
                sel = ix.a.reshape(-1, order="F").astype(np.int64) - 1
                out = flat[sel]
                return MatArray(out.reshape(ix.a.shape, order="F")) \
                    if ix.a.size > 1 else self._scalarize(out[0])
            return self._scalarize(flat[int(self._num(ix)) - 1])
        # multi-dim indexing with ':' / vectors / scalars
        sels = []
        for d, ix in enumerate(idx):
            if ix == ("colonall",) or (isinstance(ix, tuple) and ix == ("colonall",)):
                sels.append(slice(None))
            elif isinstance(ix, MatArray):
                sels.append(ix.a.reshape(-1, order="F").astype(np.int64) - 1)
            else:
                sels.append(int(self._num(ix)) - 1)
        out = a[np.ix_(*[np.arange(a.shape[d])[s] if isinstance(s, slice)
                         else np.atleast_1d(s)
                         for d, s in enumerate(sels)])]
        if out.size == 1 and all(not isinstance(s, slice) and np.ndim(s) == 0
                                 for s in sels):
            return self._scalarize(out.reshape(-1)[0])
        return MatArray(out)


# =============================================================== builtins

def _as_mat(v) -> MatArray:
    if isinstance(v, MatArray):
        return v
    if isinstance(v, (int, float, bool, np.integer, np.floating, np.bool_)):
        return MatArray(np.array([[v]]))
    if isinstance(v, np.ndarray):
        return MatArray(v)
    raise MatlabError(f"expected array, got {type(v)}")


def _b_numel(x):
    if isinstance(x, MatCell):
        return float(len(x.items))
    if isinstance(x, MatObjArray):
        return float(len(x.items))
    if isinstance(x, str):
        return float(len(x))
    return float(_as_mat(x).a.size)


def _b_ndims(x):
    return float(max(2, _as_mat(x).a.ndim))


def _b_size(x, dim=None):
    a = _as_mat(x).a
    shape = list(a.shape)
    while len(shape) < 2:
        shape.append(1)
    if dim is not None:
        d = int(MatlabEngine._num(dim))
        return float(shape[d - 1]) if d <= len(shape) else 1.0
    return MatArray(np.array(shape, dtype=np.float64))


def _b_reshape(x, *dims):
    a = _as_mat(x).a
    if len(dims) == 1:
        shape = [int(v) for v in _as_mat(dims[0]).a.reshape(-1)]
    else:
        shape = [int(MatlabEngine._num(d)) for d in dims]
    return MatArray(a.reshape(shape, order="F"))


def _b_permute(x, order):
    a = _as_mat(x).a
    od = [int(v) - 1 for v in _as_mat(order).a.reshape(-1)]
    # order may name more dims than x has: pad with trailing singletons
    while a.ndim < len(od):
        a = a.reshape(a.shape + (1,))
    return MatArray(np.transpose(a, od))


def _b_single(x):
    if isinstance(x, MatArray):
        return MatArray(x.a.astype(np.float32))
    if isinstance(x, (int, float, bool)):
        return MatArray(np.array([[x]], dtype=np.float32))
    if isinstance(x, np.ndarray):
        return MatArray(x.astype(np.float32))
    # python object: MATLAB converts buffer/array-like
    return MatArray(np.asarray(x, dtype=np.float32))


def _b_double(x):
    if isinstance(x, MatArray):
        return MatArray(x.a.astype(np.float64)) if not x.is_scalar() \
            else float(x.scalar())
    if isinstance(x, (int, float, bool, np.integer, np.floating)):
        return float(x)
    arr = np.asarray(x, dtype=np.float64)
    if arr.ndim == 0:
        return float(arr)
    return MatArray(arr)


def _b_char(x):
    if isinstance(x, str):
        return x
    return str(x)


def _b_cell(*args):
    if len(args) == 1 and not isinstance(args[0], (int, float, MatArray)):
        return MatCell([py_to_matlab(v) for v in list(args[0])])
    if len(args) == 2:
        r = int(MatlabEngine._num(args[0]))
        c = int(MatlabEngine._num(args[1]))
        if r != 1:
            raise MatlabError("cell(r,c) with r != 1 not supported")
        return MatCell([MatArray(np.zeros((0, 0))) for _ in range(c)])
    raise MatlabError("unsupported cell() form")


def _b_cellfun(fn, c, *opts):
    uniform = True
    i = 0
    while i < len(opts):
        if isinstance(opts[i], str) and opts[i] == "UniformOutput":
            uniform = bool(opts[i + 1]) if not isinstance(opts[i + 1], MatArray) \
                else bool(opts[i + 1].scalar())
            i += 2
        else:
            raise MatlabError("unsupported cellfun option")
    if not isinstance(c, MatCell):
        raise MatlabError("cellfun needs a cell array")
    eng_call = (lambda v: fn.fn(v)) if isinstance(fn, Builtin) else None
    out = []
    for item in c.items:
        if eng_call:
            out.append(eng_call(item))
        elif isinstance(fn, (MatFunction, BoundMethod)):
            out.append(fn.engine.call_function(fn, [item]))
        else:
            raise MatlabError("cellfun: bad function handle")
    if uniform:
        return MatArray(np.array([MatlabEngine._num(v) for v in out]))
    return MatCell(out)


def _b_isempty(x):
    if isinstance(x, MatCell):
        return len(x.items) == 0
    if isinstance(x, MatObjArray):
        return len(x.items) == 0
    if isinstance(x, str):
        return len(x) == 0
    if isinstance(x, MatArray):
        return x.a.size == 0
    if x is None:
        return True
    return False


def _b_find(x, k=None):
    a = _as_mat(x).a.reshape(-1, order="F")
    nz = np.nonzero(a)[0] + 1
    if k is not None:
        nz = nz[: int(MatlabEngine._num(k))]
    if nz.size == 0:
        return MatArray(np.zeros((0, 0)))
    return MatArray(nz.astype(np.float64)) if nz.size > 1 \
        else float(nz[0])


def _b_strcmp(a, b):
    if isinstance(a, MatCell) and isinstance(b, str):
        return MatArray(np.array([isinstance(x, str) and x == b
                                  for x in a.items]))
    if isinstance(b, MatCell) and isinstance(a, str):
        return _b_strcmp(b, a)
    return isinstance(a, str) and isinstance(b, str) and a == b


def _b_assert(cond, *msg):
    ok = _truth_static(cond)
    if not ok:
        text = msg[0] if msg and isinstance(msg[0], str) else "assertion failed"
        raise MatlabError(f"assert: {text}")


def _truth_static(v) -> bool:
    if isinstance(v, MatArray):
        return bool(v.a.size) and bool(np.all(v.a))
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, float, np.integer, np.floating)):
        return v != 0
    return bool(v)


_FPRINTF_FILES: Dict[int, Any] = {}
_FPRINTF_NEXT = [3]
_FPRINTF_OUT: List[str] = []


def _format_fprintf(fmt: str, args) -> str:
    fmt = fmt.replace("\\n", "\n").replace("\\t", "\t")
    out, ai = [], 0
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            if spec == "%":
                out.append("%")
                i += 2
                continue
            arg = args[ai]
            ai += 1
            if spec == "s":
                out.append(str(arg))
            elif spec in ("d", "i"):
                out.append(str(int(MatlabEngine._num(arg))))
            elif spec in ("f", "g", "e"):
                out.append(("%" + spec) % MatlabEngine._num(arg))
            else:
                raise MatlabError(f"fprintf spec %{spec} unsupported")
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _b_fprintf(*args):
    if args and not isinstance(args[0], str):
        fid = int(MatlabEngine._num(args[0]))
        text = _format_fprintf(args[1], args[2:])
        f = _FPRINTF_FILES.get(fid)
        if f is None:
            raise MatlabError(f"fprintf: bad fid {fid}")
        f.write(text)
    else:
        text = _format_fprintf(args[0], args[1:])
        _FPRINTF_OUT.append(text)
    return None


def _b_fopen(path, mode="r"):
    f = open(path, mode)
    fid = _FPRINTF_NEXT[0]
    _FPRINTF_NEXT[0] += 1
    _FPRINTF_FILES[fid] = f
    return float(fid)


def _b_fclose(fid):
    f = _FPRINTF_FILES.pop(int(MatlabEngine._num(fid)), None)
    if f is not None:
        f.close()
    return 0.0


def _b_exist(path, kind=None):
    if kind == "file" or kind is None:
        return 2.0 if os.path.isfile(str(path)) else 0.0
    if kind == "dir":
        return 7.0 if os.path.isdir(str(path)) else 0.0
    return 0.0


def _b_isequal(a, b):
    return _values_equal(a, b)


def _minmax_one(a, reduce_fn, arg_fn, nout):
    """MATLAB max/min on one array: column-wise (along the first
    non-singleton dimension) for matrices, scalar for vectors; optional
    second output is the 1-based index along that dimension."""
    m = _as_mat(a).a
    nonsingleton = [k for k, s in enumerate(m.shape) if s > 1]
    if len(nonsingleton) <= 1:  # scalar or vector -> scalar result
        arr = m.reshape(-1, order="F")
        i = int(arg_fn(arr)) if arr.size else 0
        v = MatlabEngine._scalarize(arr[i]) if arr.size else MatArray(m)
        return (v, float(i + 1))[:nout]
    ax = nonsingleton[0]
    vals = MatArray(reduce_fn(m, axis=ax, keepdims=True))
    if nout <= 1:
        return (vals,)
    idx = np.expand_dims(arg_fn(m, axis=ax), ax).astype(np.float64) + 1.0
    return vals, MatArray(idx)


def _b_max(a, b=None):
    if b is None:
        return _minmax_one(a, np.max, np.argmax, 1)[0]
    an = _as_mat(a).a if isinstance(a, MatArray) else a
    bn = _as_mat(b).a if isinstance(b, MatArray) else b
    r = np.maximum(an, bn)
    return MatArray(r) if isinstance(r, np.ndarray) and np.ndim(r) > 0 and np.size(r) > 1 \
        else float(np.asarray(r).reshape(-1)[0])


def _b_min(a, b=None):
    if b is None:
        return _minmax_one(a, np.min, np.argmin, 1)[0]
    an = _as_mat(a).a if isinstance(a, MatArray) else a
    bn = _as_mat(b).a if isinstance(b, MatArray) else b
    r = np.minimum(an, bn)
    return MatArray(r) if isinstance(r, np.ndarray) and np.ndim(r) > 0 and np.size(r) > 1 \
        else float(np.asarray(r).reshape(-1)[0])


def _b_rand(*dims):
    shape, dtype = _dims_from_args(dims)
    # column-major fill to mirror MATLAB's element order
    n = int(np.prod(shape))
    return MatArray(np.random.rand(n).reshape(shape, order="F").astype(dtype))


def _b_randi(imax, *dims):
    hi = int(MatlabEngine._num(imax))
    shape, dtype = _dims_from_args(dims)
    n = int(np.prod(shape))
    vals = np.random.randint(1, hi + 1, size=n).astype(dtype)
    return MatArray(vals.reshape(shape, order="F"))


def _b_ones(*dims):
    shape, dtype = _dims_from_args(dims)
    return MatArray(np.ones(shape, dtype))


def _b_zeros(*dims):
    shape, dtype = _dims_from_args(dims)
    return MatArray(np.zeros(shape, dtype))


def _b_length(x):
    if isinstance(x, (MatCell,)):
        return float(len(x.items))
    if isinstance(x, MatObjArray):
        return float(len(x.items))
    if isinstance(x, str):
        return float(len(x))
    a = _as_mat(x).a
    return 0.0 if a.size == 0 else float(max(a.shape))


def _b_isscalar(x):
    if isinstance(x, (int, float, bool, np.integer, np.floating)):
        return True
    return isinstance(x, MatArray) and x.a.size == 1


def _b_isnumeric(x):
    if isinstance(x, (bool, np.bool_)):
        return False  # MATLAB: logical is not numeric
    return isinstance(x, (int, float, np.integer, np.floating)) or \
        isinstance(x, MatArray)


def _b_num2str(x):
    v = MatlabEngine._num(x)
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _b_fliplr(x):
    a = _as_mat(x).a
    return MatArray(a[:, ::-1])


def _b_int32(x):
    return int(MatlabEngine._num(x))


def _b_tempname():
    fd, path = tempfile.mkstemp(prefix="mat_engine_")
    os.close(fd)
    os.remove(path)
    return path


def _b_delete(path):
    os.remove(str(path))
    return None


def _b_error(*args):
    raise MatlabError(_format_fprintf(args[0], args[1:]) if args else "error")


def _values_equal(a, b) -> bool:
    """MATLAB isequal/verifyEqual value comparison (class-insensitive for
    numerics, like isequal; cells compare recursively)."""
    if isinstance(a, MatCell) or isinstance(b, MatCell):
        if not (isinstance(a, MatCell) and isinstance(b, MatCell)):
            return False
        return len(a.items) == len(b.items) and all(
            _values_equal(x, y) for x, y in zip(a.items, b.items))
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    an = a.a if isinstance(a, MatArray) else np.array([[MatlabEngine._num(a)]])
    bn = b.a if isinstance(b, MatArray) else np.array([[MatlabEngine._num(b)]])
    # a 1x1 MatArray equals a scalar; otherwise shapes must match
    if an.size == 1 and bn.size == 1:
        return float(an.reshape(-1)[0]) == float(bn.reshape(-1)[0])
    return an.shape == bn.shape and bool(np.array_equal(
        an.astype(np.float64), bn.astype(np.float64)))


def _verify_equal(a, b):
    if not _values_equal(a, b):
        raise MatlabError(f"verifyEqual failed: {a!r} != {b!r}")
    return None


def _verify_true(cond):
    if not _truth_static(cond):
        raise MatlabError("verifyTrue failed")
    return None


def _dims_from_args(dims, default=(1, 1)):
    """MATLAB size args: scalars, a single size vector, or nothing; a
    trailing class string ('single'/'double') selects dtype."""
    dtype = np.float64
    dd = list(dims)
    if dd and isinstance(dd[-1], str):
        dtype = {"single": np.float32, "double": np.float64}[dd.pop()]
    if not dd:
        shape = list(default)
    elif len(dd) == 1 and isinstance(dd[0], MatArray) and dd[0].a.size > 1:
        shape = [int(v) for v in dd[0].a.reshape(-1, order="F")]
    else:
        shape = [int(MatlabEngine._num(d)) for d in dd]
        if len(shape) == 1:
            shape = [shape[0], shape[0]]
    return shape, dtype


def _b_struct(*args):
    if len(args) % 2:
        raise MatlabError("struct() takes name/value pairs")
    return MatStruct({str(args[i]): args[i + 1]
                      for i in range(0, len(args), 2)})


def _b_fieldnames(s):
    if not isinstance(s, MatStruct):
        raise MatlabError("fieldnames expects a struct")
    return MatCell(list(s.fields))


def _b_isfield(s, name):
    return isinstance(s, MatStruct) and str(name) in s.fields


def _b_floor(x):
    a = _as_mat(x).a
    r = np.floor(a)
    return MatArray(r) if r.size > 1 else float(r.reshape(-1)[0])


def _b_mean(x, dim=None):
    a = _as_mat(x).a
    if dim is None:
        # first non-singleton dimension (MATLAB default)
        dims = [d for d, s in enumerate(a.shape) if s > 1]
        d = dims[0] if dims else 0
    else:
        d = int(MatlabEngine._num(dim)) - 1
    r = np.mean(a, axis=d, keepdims=True)
    return MatArray(r) if r.size > 1 else float(r.reshape(-1)[0])


def _b_cat(dim, *arrs):
    d = int(MatlabEngine._num(dim)) - 1
    mats = [_as_mat(a).a for a in arrs]
    nd = max(d + 1, max(m.ndim for m in mats))
    mats = [m.reshape(m.shape + (1,) * (nd - m.ndim)) for m in mats]
    return MatArray(np.concatenate(mats, axis=d))


_TIC_STACK: List[float] = []


def _b_tic():
    import time as _t

    _TIC_STACK.append(_t.perf_counter())
    return None


def _b_toc():
    import time as _t

    t0 = _TIC_STACK[-1] if _TIC_STACK else _t.perf_counter()
    dt = _t.perf_counter() - t0
    _FPRINTF_OUT.append(f"Elapsed time is {dt:.6f} seconds.\n")
    return dt


def _b_get_report(err):
    if isinstance(err, MatStruct):
        return str(err.fields.get("message", ""))
    return str(err)


# ---- MATLAB HDF5 surface over utils/hdf5.py.  MATLAB arrays are column-major, so
# the on-disk dataset dims are the REVERSE of the MATLAB size vector —
# which is exactly why store2hdf5.m works: W*H*C*N MATLAB data lands as an
# N x C x H x W dataset, the layout caffe's HDF5Data layer reads.

def _mat_dims(v) -> List[float]:
    a = _as_mat(v).a
    return [float(x) for x in a.reshape(-1, order="F")]


def _b_h5create(filename, ds, size, *opts):
    dims = _mat_dims(size)
    dtype, chunks = np.float64, None
    i = 0
    while i < len(opts):
        key = str(opts[i]).lower()
        if key == "datatype":
            dtype = {"single": np.float32, "double": np.float64}[
                str(opts[i + 1])]
        elif key == "chunksize":
            chunks = tuple(int(x) for x in reversed(_mat_dims(opts[i + 1])))
        i += 2
    shape = tuple(0 if math.isinf(d) else int(d) for d in reversed(dims))
    maxshape = tuple(None if math.isinf(d) else int(d)
                     for d in reversed(dims))
    with hdf5.File(str(filename), "a") as f:
        name = str(ds)
        if name in f:
            raise MatlabError(f"h5create: dataset {name} exists")
        f.create_dataset(name, shape=shape, maxshape=maxshape,
                         dtype=dtype, chunks=chunks)
    return None


def _b_h5write(filename, ds, data, start=None, count=None):
    a = _as_mat(data).a
    disk = np.transpose(a, axes=tuple(reversed(range(a.ndim))))
    with hdf5.File(str(filename), "a") as f:
        d = f[str(ds)]
        if start is None:
            d[...] = disk
            return None
        st = [int(x) - 1 for x in reversed(_mat_dims(start))]
        ct = [int(x) for x in reversed(_mat_dims(count))] if count is not None \
            else list(disk.shape)
        if len(st) > disk.ndim:  # trailing singleton MATLAB dims
            disk = disk.reshape((1,) * (len(st) - disk.ndim) + disk.shape)
        need = [max(cur, s + c) for cur, s, c in zip(d.shape, st, ct)]
        if list(d.shape) != need:
            d.resize(need)
        d[tuple(slice(s, s + c) for s, c in zip(st, ct))] = disk
    return None


def _b_h5read(filename, ds, start=None, count=None):
    with hdf5.File(str(filename), "r") as f:
        d = f[str(ds)]
        if start is None:
            disk = d[...]
        else:
            st = [int(x) - 1 for x in reversed(_mat_dims(start))]
            ct = [int(x) for x in reversed(_mat_dims(count))]
            disk = d[tuple(slice(s, s + c) for s, c in zip(st, ct))]
    return MatArray(np.transpose(disk, axes=tuple(reversed(range(disk.ndim)))))


def _b_h5info(filename):
    dsets = []
    with hdf5.File(str(filename), "r") as f:
        for name in sorted(f.keys()):  # MATLAB lists alphabetically
            obj = f[name]
            if isinstance(obj, hdf5.Dataset):
                size = MatArray(np.array(
                    [float(s) for s in reversed(obj.shape)], np.float64))
                dsets.append(MatStruct({
                    "Name": "/" + name,
                    "Dataspace": MatStruct({"Size": size}),
                }))
    return MatStruct({"Filename": str(filename),
                      "Datasets": MatStructArray(dsets)})


def _b_h5disp(filename):
    lines = [f"HDF5 {os.path.basename(str(filename))}"]
    with hdf5.File(str(filename), "r") as f:
        for name in sorted(f.keys()):
            obj = f[name]
            if isinstance(obj, hdf5.Dataset):
                msize = "x".join(str(s) for s in reversed(obj.shape))
                lines.append(f"Dataset '{name}'  Size: {msize}")
    _FPRINTF_OUT.append("\n".join(lines) + "\n")
    return None


def _b_imread(path, *flag):
    """imread(path): RGB u8, read without OpenCV
    (``core/data_layers.read_image``: PNG, BMP and JPEG)."""
    from .core.data_layers import read_image

    try:
        img = read_image(str(path))
    except (OSError, ValueError) as e:
        raise MatlabError(f"imread: cannot read {path}: {e}") from e
    return MatArray(img[:, :, ::-1].copy())  # MATLAB returns RGB


def _b_imresize(im, size, method="bilinear"):
    """imresize(im, [h w], 'bilinear'|'bicubic'|'nearest') as ``cv2.resize``
    does, in the image's dtype (``api.resize_image``: u8 bilinear bit for
    bit, u8 bicubic within one level, ROADMAP C5).  Divergence note:
    MATLAB's imresize antialiases when downscaling, cv2's kernels do not —
    values differ at interpolation-rounding level."""
    from .api import resize_image

    a = _as_mat(im).a
    dims = _mat_dims(size)
    h, w = int(dims[0]), int(dims[1])
    order = {"nearest": 0, "bilinear": 1, "bicubic": 2}[str(method)]
    out = resize_image(np.asarray(a), (h, w), order)
    return MatArray(out.reshape((h, w) + a.shape[2:]).astype(a.dtype, copy=False))


def _multi_max(n, a, b=None):
    if b is not None:
        raise MatlabError("[m,i] = max(a,b) is not a MATLAB form")
    if n > 2:
        raise MatlabError("max: nargout > 2")
    return _minmax_one(a, np.max, np.argmax, n)


def _multi_min(n, a, b=None):
    if b is not None:
        raise MatlabError("[m,i] = min(a,b) is not a MATLAB form")
    if n > 2:
        raise MatlabError("min: nargout > 2")
    return _minmax_one(a, np.min, np.argmin, n)


def _multi_size(n, x):
    a = _as_mat(x).a
    shape = list(a.shape) + [1] * max(0, n - _as_mat(x).a.ndim)
    if n < len(shape):  # last output absorbs the remaining dims' product
        shape = shape[: n - 1] + [int(np.prod(shape[n - 1:]))]
    return tuple(float(s) for s in shape[:n])


def _b_all(x):
    v = _as_mat(x).a
    return bool(np.all(v))


def _b_any(x):
    v = _as_mat(x).a
    return bool(np.any(v))


def _b_load(path):
    """load('file.mat') -> struct of variables (scipy's MATLAB v5 reader;
    MATLAB arrays come back column-major-equivalent by construction)."""
    import scipy.io as sio

    d = sio.loadmat(str(path))
    return MatStruct({k: MatArray(np.asarray(v))
                      for k, v in d.items() if not k.startswith("__")})


def _b_addpath(p):
    # the engine resolves package namespaces from its root and siblings
    # from the calling file's directory, so MATLAB-path edits are moot —
    # accepted for compatibility with scripts that call addpath('..')
    return None


# builtins that can return multiple outputs under [a, b] = f(...)
_MULTI_BUILTINS = {"max": _multi_max, "min": _multi_min, "size": _multi_size}


BUILTINS: Dict[str, Builtin] = {name: Builtin(name, fn) for name, fn in {
    "numel": _b_numel,
    "ndims": _b_ndims,
    "size": _b_size,
    "reshape": _b_reshape,
    "permute": _b_permute,
    "single": _b_single,
    "double": _b_double,
    "char": _b_char,
    "cell": _b_cell,
    "cellfun": _b_cellfun,
    "isempty": _b_isempty,
    "find": _b_find,
    "strcmp": _b_strcmp,
    "assert": _b_assert,
    "fprintf": _b_fprintf,
    "fopen": _b_fopen,
    "fclose": _b_fclose,
    "exist": _b_exist,
    "ischar": lambda x: isinstance(x, str),
    "isequal": _b_isequal,
    "max": _b_max,
    "min": _b_min,
    "rand": _b_rand,
    "randi": _b_randi,
    "ones": _b_ones,
    "zeros": _b_zeros,
    "length": _b_length,
    "isscalar": _b_isscalar,
    "isnumeric": _b_isnumeric,
    "iscell": lambda x: isinstance(x, MatCell),
    "isstruct": lambda x: isinstance(x, MatStruct),
    "num2str": _b_num2str,
    "fliplr": _b_fliplr,
    "int32": _b_int32,
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "tempname": _b_tempname,
    "delete": _b_delete,
    "error": _b_error,
    "disp": lambda x: _FPRINTF_OUT.append(str(x) + "\n"),
    "struct": _b_struct,
    "fieldnames": _b_fieldnames,
    "isfield": _b_isfield,
    "floor": _b_floor,
    "mean": _b_mean,
    "cat": _b_cat,
    "all": _b_all,
    "any": _b_any,
    "tic": _b_tic,
    "toc": _b_toc,
    "getReport": _b_get_report,
    "h5create": _b_h5create,
    "h5write": _b_h5write,
    "h5read": _b_h5read,
    "h5info": _b_h5info,
    "h5disp": _b_h5disp,
    "imread": _b_imread,
    "imresize": _b_imresize,
    "load": _b_load,
    "addpath": _b_addpath,
}.items()}


# py.<special> names that are not modules
_PY_SPECIAL = {
    "len": Builtin("py.len", lambda x: len(x)),
    "getattr": Builtin("py.getattr", lambda o, n: getattr(o, str(n))),
    "dict": Builtin("py.dict", lambda *a: dict(*[matlab_to_py(x) for x in a])),
    "list": Builtin("py.list", lambda *a: list(*[matlab_to_py(x) for x in a])),
    "tuple": Builtin("py.tuple", lambda *a: tuple(*[matlab_to_py(x) for x in a])),
    "str": Builtin("py.str", lambda x: str(matlab_to_py(x))),
    "int": Builtin("py.int", lambda x: int(MatlabEngine._num(x))),
    "float": Builtin("py.float", lambda x: float(MatlabEngine._num(x))),
}


def engine_stdout() -> str:
    """Text fprintf'd to the MATLAB console so far (for tests)."""
    return "".join(_FPRINTF_OUT)


def to_python(v):
    """MATLAB value -> plain Python/numpy (for test assertions)."""
    if isinstance(v, MatArray):
        return np.array(v.a)
    if isinstance(v, MatCell):
        return [to_python(x) for x in v.items]
    return v
