"""The Caffe model-file codec: prototxt text, binary NetParameter
(``.caffemodel``), the legacy upgrade chain, Datum records and, loaded on
first use, ``caffe_pb2`` (protoc-compiled message classes, the pycaffe
``caffe.proto.caffe_pb2``).  A copy of ``caffe_rtpose_tpu/proto`` without
jax."""

from . import caffe_pb, caffemodel, prototxt, wire  # noqa: F401
from .caffe_pb import SCHEMA, View, view  # noqa: F401


def __getattr__(name):
    # loaded lazily: the first import generates and protoc-compiles the
    # schema (gen_proto.py)
    if name == "caffe_pb2":
        import importlib

        return importlib.import_module(".caffe_pb2", __name__)
    raise AttributeError(name)
