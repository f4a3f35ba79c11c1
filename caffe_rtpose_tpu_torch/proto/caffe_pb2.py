"""pycaffe-compatible ``caffe_pb2``: real protobuf message classes for the
Caffe wire interface.

Reference users write ``from caffe.proto import caffe_pb2`` and then use
``google.protobuf.text_format`` / ``ParseFromString`` on the generated
classes (python/caffe/net_spec.py:23-51, draw.py, io.py).  This module
provides the same surface: it emits the schema registry as a ``.proto``
file (:mod:`caffe_rtpose_tpu_torch.proto.gen_proto`), compiles it with
``protoc`` into a private temporary directory of its own on each import
(``tempfile.mkdtemp``, so under ``TMPDIR``; removed at exit), and re-exports
every generated message/enum here, so

    from caffe_rtpose_tpu_torch.proto import caffe_pb2
    net = caffe_pb2.NetParameter()
    google.protobuf.text_format.Merge(text, net)

works exactly like upstream pycaffe.  A copy of
``caffe_rtpose_tpu/proto/caffe_pb2.py``.  Requires ``protoc`` on PATH and the
``google.protobuf`` runtime; raises ImportError with guidance otherwise
(the rest of the framework never depends on either — the native codecs in
:mod:`.wire` / :mod:`.prototxt` remain the default path).
"""

from __future__ import annotations

import atexit
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

from .gen_proto import generate_proto, schema_digest


def _build_and_load():
    protoc = shutil.which("protoc")
    if protoc is None:
        raise ImportError(
            "caffe_pb2 needs the `protoc` compiler on PATH (the built-in "
            "proto codecs caffe_rtpose_tpu_torch.proto.{wire,prototxt} work "
            "without it)")
    try:
        import google.protobuf  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "caffe_pb2 needs the google.protobuf runtime (the built-in "
            "proto codecs work without it)") from e

    # generate + compile into a fresh PRIVATE directory every import: a
    # predictable shared /tmp path would let another local user pre-plant
    # a file that gets exec'd (and races concurrent test runs); protoc on
    # this schema takes ~100 ms, not worth a shared cache
    digest = schema_digest()
    workdir = tempfile.mkdtemp(prefix="caffe_rtpose_pb2_")
    # the loaded module keeps no file dependency after exec_module, so the
    # generated sources can be swept at exit (avoids /tmp litter across
    # repeated test runs / long-lived services)
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    gen_py = os.path.join(workdir, "caffe_rtpose_pb2.py")
    src = os.path.join(workdir, "caffe_rtpose.proto")
    with open(src, "w") as f:
        f.write(generate_proto())
    subprocess.run([protoc, f"--python_out={workdir}", "-I", workdir,
                    "caffe_rtpose.proto"], check=True, cwd=workdir,
                   capture_output=True)
    # the messages go into a pool of their own: the process-wide default
    # pool refuses a second file that defines caffe.* (another package's
    # caffe_pb2 loaded in the same process)
    with open(gen_py) as f:
        code = f.read().replace("_descriptor_pool.Default()", "_descriptor_pool.DescriptorPool()")
    with open(gen_py, "w") as f:
        f.write(code)
    spec = importlib.util.spec_from_file_location(
        f"caffe_rtpose_torch_pb2_{digest}", gen_py)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_mod = _build_and_load()
for _name in dir(_mod):
    if not _name.startswith("_"):
        globals()[_name] = getattr(_mod, _name)
del _name, _mod
