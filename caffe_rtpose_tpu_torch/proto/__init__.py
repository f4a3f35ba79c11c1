"""The Caffe model-file codec: prototxt text, binary NetParameter
(``.caffemodel``) and the legacy upgrade chain.  A copy of
``caffe_rtpose_tpu/proto`` without jax; ``caffe_pb2`` (protoc, the pycaffe
facade) and ``datum`` (data layers) are not ported."""

from . import caffe_pb, caffemodel, prototxt, wire  # noqa: F401
from .caffe_pb import SCHEMA, View, view  # noqa: F401
