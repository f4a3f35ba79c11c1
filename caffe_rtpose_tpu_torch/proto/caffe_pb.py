"""Declarative schemas for the Caffe protobuf messages we interoperate with.

A copy of ``caffe_rtpose_tpu/proto/caffe_pb.py`` (that package imports jax).

Field numbers/types are the *wire interface* of ``.prototxt`` / ``.caffemodel``
files (reference ``src/caffe/proto/caffe.proto``, including the CPM additions
``imresize_param = 148`` / ``nms_param = 149``, caffe.proto:407-408,1471-1484).
The representation here is a plain Python registry consumed by
:mod:`caffe_rtpose_tpu_torch.proto.wire` (binary) and
:mod:`caffe_rtpose_tpu_torch.proto.prototxt` (text format).

Messages are dicts; a :class:`View` wrapper provides attribute access with
proto2 defaults applied.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

from .wire import Field

# enum value tables (text-format names -> ints)
PHASE = {"TRAIN": 0, "TEST": 1}
POOL_METHOD = {"MAX": 0, "AVE": 1, "STOCHASTIC": 2}
ELTWISE_OP = {"PROD": 0, "SUM": 1, "MAX": 2}
DB_BACKEND = {"LEVELDB": 0, "LMDB": 1}
NORM_REGION = {"ACROSS_CHANNELS": 0, "WITHIN_CHANNEL": 1}
REDUCTION_OP = {"SUM": 1, "ASUM": 2, "SUMSQ": 3, "MEAN": 4}
HINGE_NORM = {"L1": 1, "L2": 2}
LOSS_NORMALIZATION = {"FULL": 0, "VALID": 1, "BATCH_SIZE": 2, "NONE": 3}
ENGINE = {"DEFAULT": 0, "CAFFE": 1, "CUDNN": 2}
SOLVER_MODE = {"CPU": 0, "GPU": 1}
SNAPSHOT_FORMAT = {"HDF5": 0, "BINARYPROTO": 1}
DIM_CHECK_MODE = {"STRICT": 0, "PERMISSIVE": 1}
VARIANCE_NORM = {"FAN_IN": 0, "FAN_OUT": 1, "AVERAGE": 2}


def _f(num, name, kind, repeated=False, message=None, default=None, enum=None):
    return Field(num=num, name=name, kind=kind, repeated=repeated,
                 message=message, default=default, enum_values=enum)


def _msg(*fields: Field) -> Dict[int, Field]:
    return {f.num: f for f in fields}


SCHEMA: Dict[str, Dict[int, Field]] = {}

SCHEMA["BlobShape"] = _msg(
    _f(1, "dim", "int64", repeated=True),
)

SCHEMA["BlobProto"] = _msg(
    _f(7, "shape", "message", message="BlobShape"),
    _f(5, "data", "float", repeated=True),
    _f(6, "diff", "float", repeated=True),
    _f(8, "double_data", "double", repeated=True),
    _f(9, "double_diff", "double", repeated=True),
    _f(1, "num", "int32", default=0),
    _f(2, "channels", "int32", default=0),
    _f(3, "height", "int32", default=0),
    _f(4, "width", "int32", default=0),
)

SCHEMA["BlobProtoVector"] = _msg(
    _f(1, "blobs", "message", repeated=True, message="BlobProto"),
)

SCHEMA["Datum"] = _msg(
    _f(1, "channels", "int32"),
    _f(2, "height", "int32"),
    _f(3, "width", "int32"),
    _f(4, "data", "bytes"),
    _f(5, "label", "int32"),
    _f(6, "float_data", "float", repeated=True),
    _f(7, "encoded", "bool", default=False),
)

SCHEMA["FillerParameter"] = _msg(
    _f(1, "type", "string", default="constant"),
    _f(2, "value", "float", default=0.0),
    _f(3, "min", "float", default=0.0),
    _f(4, "max", "float", default=1.0),
    _f(5, "mean", "float", default=0.0),
    _f(6, "std", "float", default=1.0),
    _f(7, "sparse", "int32", default=-1),
    _f(8, "variance_norm", "enum", default=0, enum=VARIANCE_NORM),
)

SCHEMA["NetState"] = _msg(
    _f(1, "phase", "enum", default=PHASE["TEST"], enum=PHASE),
    _f(2, "level", "int32", default=0),
    _f(3, "stage", "string", repeated=True),
)

SCHEMA["NetStateRule"] = _msg(
    _f(1, "phase", "enum", enum=PHASE),
    _f(2, "min_level", "int32"),
    _f(3, "max_level", "int32"),
    _f(4, "stage", "string", repeated=True),
    _f(5, "not_stage", "string", repeated=True),
)

SCHEMA["ParamSpec"] = _msg(
    _f(1, "name", "string"),
    _f(2, "share_mode", "enum", enum=DIM_CHECK_MODE),
    _f(3, "lr_mult", "float", default=1.0),
    _f(4, "decay_mult", "float", default=1.0),
)

SCHEMA["NetParameter"] = _msg(
    _f(1, "name", "string", default=""),
    _f(3, "input", "string", repeated=True),
    _f(8, "input_shape", "message", repeated=True, message="BlobShape"),
    _f(4, "input_dim", "int32", repeated=True),
    _f(5, "force_backward", "bool", default=False),
    _f(6, "state", "message", message="NetState"),
    _f(7, "debug_info", "bool", default=False),
    _f(100, "layer", "message", repeated=True, message="LayerParameter"),
    _f(2, "layers", "message", repeated=True, message="V1LayerParameter"),
)

SCHEMA["SolverParameter"] = _msg(
    _f(24, "net", "string"),
    _f(25, "net_param", "message", message="NetParameter"),
    _f(1, "train_net", "string"),
    _f(2, "test_net", "string", repeated=True),
    _f(21, "train_net_param", "message", message="NetParameter"),
    _f(22, "test_net_param", "message", repeated=True, message="NetParameter"),
    _f(26, "train_state", "message", message="NetState"),
    _f(27, "test_state", "message", repeated=True, message="NetState"),
    _f(3, "test_iter", "int32", repeated=True),
    _f(4, "test_interval", "int32", default=0),
    _f(19, "test_compute_loss", "bool", default=False),
    _f(32, "test_initialization", "bool", default=True),
    _f(5, "base_lr", "float"),
    _f(6, "display", "int32"),
    _f(33, "average_loss", "int32", default=1),
    _f(7, "max_iter", "int32"),
    _f(36, "iter_size", "int32", default=1),
    _f(8, "lr_policy", "string"),
    _f(9, "gamma", "float"),
    _f(10, "power", "float"),
    _f(11, "momentum", "float"),
    _f(12, "weight_decay", "float"),
    _f(29, "regularization_type", "string", default="L2"),
    _f(13, "stepsize", "int32"),
    _f(34, "stepvalue", "int32", repeated=True),
    _f(35, "clip_gradients", "float", default=-1.0),
    _f(14, "snapshot", "int32", default=0),
    _f(15, "snapshot_prefix", "string", default=""),
    _f(16, "snapshot_diff", "bool", default=False),
    _f(37, "snapshot_format", "enum", default=1, enum=SNAPSHOT_FORMAT),
    _f(17, "solver_mode", "enum", default=1, enum=SOLVER_MODE),
    _f(18, "device_id", "int32", default=0),
    _f(20, "random_seed", "int64", default=-1),
    _f(40, "type", "string", default="SGD"),
    _f(31, "delta", "float", default=1e-8),
    _f(39, "momentum2", "float", default=0.999),
    _f(38, "rms_decay", "float"),
    _f(23, "debug_info", "bool", default=False),
    _f(28, "snapshot_after_train", "bool", default=True),
    _f(30, "solver_type", "enum", default=0,
       enum={"SGD": 0, "NESTEROV": 1, "ADAGRAD": 2, "RMSPROP": 3, "ADADELTA": 4, "ADAM": 5}),
)

SCHEMA["SolverState"] = _msg(
    _f(1, "iter", "int32"),
    _f(2, "learned_net", "string"),
    _f(3, "history", "message", repeated=True, message="BlobProto"),
    _f(4, "current_step", "int32", default=0),
)

SCHEMA["LayerParameter"] = _msg(
    _f(1, "name", "string", default=""),
    _f(2, "type", "string", default=""),
    _f(3, "bottom", "string", repeated=True),
    _f(4, "top", "string", repeated=True),
    _f(10, "phase", "enum", enum=PHASE),
    _f(5, "loss_weight", "float", repeated=True),
    _f(6, "param", "message", repeated=True, message="ParamSpec"),
    _f(7, "blobs", "message", repeated=True, message="BlobProto"),
    _f(11, "propagate_down", "bool", repeated=True),
    _f(8, "include", "message", repeated=True, message="NetStateRule"),
    _f(9, "exclude", "message", repeated=True, message="NetStateRule"),
    _f(100, "transform_param", "message", message="TransformationParameter"),
    _f(101, "loss_param", "message", message="LossParameter"),
    _f(102, "accuracy_param", "message", message="AccuracyParameter"),
    _f(103, "argmax_param", "message", message="ArgMaxParameter"),
    _f(139, "batch_norm_param", "message", message="BatchNormParameter"),
    _f(141, "bias_param", "message", message="BiasParameter"),
    _f(104, "concat_param", "message", message="ConcatParameter"),
    _f(105, "contrastive_loss_param", "message", message="ContrastiveLossParameter"),
    _f(106, "convolution_param", "message", message="ConvolutionParameter"),
    _f(144, "crop_param", "message", message="CropParameter"),
    _f(107, "data_param", "message", message="DataParameter"),
    _f(108, "dropout_param", "message", message="DropoutParameter"),
    _f(109, "dummy_data_param", "message", message="DummyDataParameter"),
    _f(110, "eltwise_param", "message", message="EltwiseParameter"),
    _f(140, "elu_param", "message", message="ELUParameter"),
    _f(137, "embed_param", "message", message="EmbedParameter"),
    _f(111, "exp_param", "message", message="ExpParameter"),
    _f(135, "flatten_param", "message", message="FlattenParameter"),
    _f(112, "hdf5_data_param", "message", message="HDF5DataParameter"),
    _f(113, "hdf5_output_param", "message", message="HDF5OutputParameter"),
    _f(114, "hinge_loss_param", "message", message="HingeLossParameter"),
    _f(115, "image_data_param", "message", message="ImageDataParameter"),
    _f(116, "infogain_loss_param", "message", message="InfogainLossParameter"),
    _f(117, "inner_product_param", "message", message="InnerProductParameter"),
    _f(143, "input_param", "message", message="InputParameter"),
    _f(134, "log_param", "message", message="LogParameter"),
    _f(118, "lrn_param", "message", message="LRNParameter"),
    _f(119, "memory_data_param", "message", message="MemoryDataParameter"),
    _f(120, "mvn_param", "message", message="MVNParameter"),
    _f(145, "parameter_param", "message", message="ParameterParameter"),
    _f(121, "pooling_param", "message", message="PoolingParameter"),
    _f(122, "power_param", "message", message="PowerParameter"),
    _f(131, "prelu_param", "message", message="PReLUParameter"),
    _f(130, "python_param", "message", message="PythonParameter"),
    _f(146, "recurrent_param", "message", message="RecurrentParameter"),
    _f(136, "reduction_param", "message", message="ReductionParameter"),
    _f(123, "relu_param", "message", message="ReLUParameter"),
    _f(133, "reshape_param", "message", message="ReshapeParameter"),
    _f(142, "scale_param", "message", message="ScaleParameter"),
    _f(124, "sigmoid_param", "message", message="SigmoidParameter"),
    _f(125, "softmax_param", "message", message="SoftmaxParameter"),
    _f(132, "spp_param", "message", message="SPPParameter"),
    _f(126, "slice_param", "message", message="SliceParameter"),
    _f(127, "tanh_param", "message", message="TanHParameter"),
    _f(128, "threshold_param", "message", message="ThresholdParameter"),
    _f(138, "tile_param", "message", message="TileParameter"),
    _f(129, "window_data_param", "message", message="WindowDataParameter"),
    # CPM additions (caffe.proto:407-408)
    _f(148, "imresize_param", "message", message="ImResizeParameter"),
    _f(149, "nms_param", "message", message="NmsParameter"),
)

SCHEMA["TransformationParameter"] = _msg(
    _f(1, "scale", "float", default=1.0),
    _f(2, "mirror", "bool", default=False),
    _f(3, "crop_size", "uint32", default=0),
    _f(4, "mean_file", "string"),
    _f(5, "mean_value", "float", repeated=True),
    _f(6, "force_color", "bool", default=False),
    _f(7, "force_gray", "bool", default=False),
    # CPM training-augmentation knobs (caffe.proto:430-470 "CPM extra code")
    _f(22, "stride", "uint32", default=4),
    _f(23, "scale_cvg", "float", default=0.5),
    _f(8, "max_cvg_len", "uint32", default=50),
    _f(9, "min_cvg_len", "uint32", default=50),
    _f(10, "opaque_coverage", "bool", default=True),
    _f(11, "coverage", "string", default="gridbox_max"),
    _f(12, "flip_prob", "float", default=0.5),
    _f(13, "max_rotate_degree", "float", default=5.0),
    _f(14, "visualize", "bool", default=False),
    _f(15, "crop_size_x", "uint32", default=368),
    _f(16, "crop_size_y", "uint32", default=368),
    _f(17, "scale_prob", "float", default=0.5),
    _f(18, "scale_min", "float", default=0.9),
    _f(19, "scale_max", "float", default=1.1),
    _f(20, "bbox_norm_factor", "float", default=300.0),
    _f(21, "img_header", "string", default="."),
    _f(24, "target_dist", "float", default=1.0),
    _f(25, "center_perterb_max", "float", default=10.0),
    _f(26, "sigma", "float", default=7.0),
    _f(27, "sigma_center", "float", default=21.0),
    _f(28, "clahe_tile_size", "float", default=8.0),
    _f(29, "clahe_clip_limit", "float", default=4.0),
    _f(30, "do_clahe", "bool", default=False),
    _f(31, "num_parts", "uint32", default=14),
    _f(32, "num_total_augs", "uint32", default=82),
    _f(33, "aug_way", "string", default="rand"),
    _f(34, "gray", "uint32", default=0),
    _f(35, "np_in_lmdb", "uint32", default=16),
    _f(38, "transform_body_joint", "bool", default=True),
)

SCHEMA["LossParameter"] = _msg(
    _f(1, "ignore_label", "int32"),
    _f(3, "normalization", "enum", default=1, enum=LOSS_NORMALIZATION),
    _f(2, "normalize", "bool"),
)

SCHEMA["AccuracyParameter"] = _msg(
    _f(1, "top_k", "uint32", default=1),
    _f(2, "axis", "int32", default=1),
    _f(3, "ignore_label", "int32"),
)

SCHEMA["ArgMaxParameter"] = _msg(
    _f(1, "out_max_val", "bool", default=False),
    _f(2, "top_k", "uint32", default=1),
    _f(3, "axis", "int32"),
)

SCHEMA["ConcatParameter"] = _msg(
    _f(2, "axis", "int32", default=1),
    _f(1, "concat_dim", "uint32", default=1),
)

SCHEMA["BatchNormParameter"] = _msg(
    _f(1, "use_global_stats", "bool"),
    _f(2, "moving_average_fraction", "float", default=0.999),
    _f(3, "eps", "float", default=1e-5),
)

SCHEMA["BiasParameter"] = _msg(
    _f(1, "axis", "int32", default=1),
    _f(2, "num_axes", "int32", default=1),
    _f(3, "filler", "message", message="FillerParameter"),
)

SCHEMA["ContrastiveLossParameter"] = _msg(
    _f(1, "margin", "float", default=1.0),
    _f(2, "legacy_version", "bool", default=False),
)

SCHEMA["ConvolutionParameter"] = _msg(
    _f(1, "num_output", "uint32"),
    _f(2, "bias_term", "bool", default=True),
    _f(3, "pad", "uint32", repeated=True),
    _f(4, "kernel_size", "uint32", repeated=True),
    _f(6, "stride", "uint32", repeated=True),
    _f(18, "dilation", "uint32", repeated=True),
    _f(9, "pad_h", "uint32", default=0),
    _f(10, "pad_w", "uint32", default=0),
    _f(11, "kernel_h", "uint32"),
    _f(12, "kernel_w", "uint32"),
    _f(13, "stride_h", "uint32"),
    _f(14, "stride_w", "uint32"),
    _f(5, "group", "uint32", default=1),
    _f(7, "weight_filler", "message", message="FillerParameter"),
    _f(8, "bias_filler", "message", message="FillerParameter"),
    _f(15, "engine", "enum", default=0, enum=ENGINE),
    _f(16, "axis", "int32", default=1),
    _f(17, "force_nd_im2col", "bool", default=False),
)

SCHEMA["CropParameter"] = _msg(
    _f(1, "axis", "int32", default=2),
    _f(2, "offset", "uint32", repeated=True),
)

SCHEMA["DataParameter"] = _msg(
    _f(1, "source", "string"),
    _f(4, "batch_size", "uint32"),
    _f(7, "rand_skip", "uint32", default=0),
    _f(8, "backend", "enum", default=0, enum=DB_BACKEND),
    _f(2, "scale", "float", default=1.0),
    _f(3, "mean_file", "string"),
    _f(5, "crop_size", "uint32", default=0),
    _f(6, "mirror", "bool", default=False),
    _f(9, "force_encoded_color", "bool", default=False),
    _f(10, "prefetch", "uint32", default=4),
)

SCHEMA["DropoutParameter"] = _msg(
    _f(1, "dropout_ratio", "float", default=0.5),
)

SCHEMA["DummyDataParameter"] = _msg(
    _f(1, "data_filler", "message", repeated=True, message="FillerParameter"),
    _f(6, "shape", "message", repeated=True, message="BlobShape"),
    _f(2, "num", "uint32", repeated=True),
    _f(3, "channels", "uint32", repeated=True),
    _f(4, "height", "uint32", repeated=True),
    _f(5, "width", "uint32", repeated=True),
)

SCHEMA["EltwiseParameter"] = _msg(
    _f(1, "operation", "enum", default=1, enum=ELTWISE_OP),
    _f(2, "coeff", "float", repeated=True),
    _f(3, "stable_prod_grad", "bool", default=True),
)

SCHEMA["ELUParameter"] = _msg(
    _f(1, "alpha", "float", default=1.0),
)

SCHEMA["EmbedParameter"] = _msg(
    _f(1, "num_output", "uint32"),
    _f(2, "input_dim", "uint32"),
    _f(3, "bias_term", "bool", default=True),
    _f(4, "weight_filler", "message", message="FillerParameter"),
    _f(5, "bias_filler", "message", message="FillerParameter"),
)

SCHEMA["ExpParameter"] = _msg(
    _f(1, "base", "float", default=-1.0),
    _f(2, "scale", "float", default=1.0),
    _f(3, "shift", "float", default=0.0),
)

SCHEMA["FlattenParameter"] = _msg(
    _f(1, "axis", "int32", default=1),
    _f(2, "end_axis", "int32", default=-1),
)

SCHEMA["HDF5DataParameter"] = _msg(
    _f(1, "source", "string"),
    _f(2, "batch_size", "uint32"),
    _f(3, "shuffle", "bool", default=False),
)

SCHEMA["HDF5OutputParameter"] = _msg(
    _f(1, "file_name", "string"),
)

SCHEMA["HingeLossParameter"] = _msg(
    _f(1, "norm", "enum", default=1, enum=HINGE_NORM),
)

SCHEMA["ImageDataParameter"] = _msg(
    _f(1, "source", "string"),
    _f(4, "batch_size", "uint32", default=1),
    _f(7, "rand_skip", "uint32", default=0),
    _f(8, "shuffle", "bool", default=False),
    _f(9, "new_height", "uint32", default=0),
    _f(10, "new_width", "uint32", default=0),
    _f(11, "is_color", "bool", default=True),
    _f(2, "scale", "float", default=1.0),
    _f(3, "mean_file", "string"),
    _f(5, "crop_size", "uint32", default=0),
    _f(6, "mirror", "bool", default=False),
    _f(12, "root_folder", "string", default=""),
)

SCHEMA["InfogainLossParameter"] = _msg(
    _f(1, "source", "string"),
)

SCHEMA["InnerProductParameter"] = _msg(
    _f(1, "num_output", "uint32"),
    _f(2, "bias_term", "bool", default=True),
    _f(3, "weight_filler", "message", message="FillerParameter"),
    _f(4, "bias_filler", "message", message="FillerParameter"),
    _f(5, "axis", "int32", default=1),
    _f(6, "transpose", "bool", default=False),
)

SCHEMA["InputParameter"] = _msg(
    _f(1, "shape", "message", repeated=True, message="BlobShape"),
)

SCHEMA["LogParameter"] = _msg(
    _f(1, "base", "float", default=-1.0),
    _f(2, "scale", "float", default=1.0),
    _f(3, "shift", "float", default=0.0),
)

SCHEMA["LRNParameter"] = _msg(
    _f(1, "local_size", "uint32", default=5),
    _f(2, "alpha", "float", default=1.0),
    _f(3, "beta", "float", default=0.75),
    _f(4, "norm_region", "enum", default=0, enum=NORM_REGION),
    _f(5, "k", "float", default=1.0),
    _f(6, "engine", "enum", default=0, enum=ENGINE),
)

SCHEMA["MemoryDataParameter"] = _msg(
    _f(1, "batch_size", "uint32"),
    _f(2, "channels", "uint32"),
    _f(3, "height", "uint32"),
    _f(4, "width", "uint32"),
)

SCHEMA["MVNParameter"] = _msg(
    _f(1, "normalize_variance", "bool", default=True),
    _f(2, "across_channels", "bool", default=False),
    _f(3, "eps", "float", default=1e-9),
)

SCHEMA["ParameterParameter"] = _msg(
    _f(1, "shape", "message", message="BlobShape"),
)

SCHEMA["PoolingParameter"] = _msg(
    _f(1, "pool", "enum", default=0, enum=POOL_METHOD),
    _f(4, "pad", "uint32", default=0),
    _f(9, "pad_h", "uint32", default=0),
    _f(10, "pad_w", "uint32", default=0),
    _f(2, "kernel_size", "uint32"),
    _f(5, "kernel_h", "uint32"),
    _f(6, "kernel_w", "uint32"),
    _f(3, "stride", "uint32", default=1),
    _f(7, "stride_h", "uint32"),
    _f(8, "stride_w", "uint32"),
    _f(11, "engine", "enum", default=0, enum=ENGINE),
    _f(12, "global_pooling", "bool", default=False),
)

SCHEMA["PowerParameter"] = _msg(
    _f(1, "power", "float", default=1.0),
    _f(2, "scale", "float", default=1.0),
    _f(3, "shift", "float", default=0.0),
)

SCHEMA["PReLUParameter"] = _msg(
    _f(1, "filler", "message", message="FillerParameter"),
    _f(2, "channel_shared", "bool", default=False),
)

SCHEMA["PythonParameter"] = _msg(
    _f(1, "module", "string"),
    _f(2, "layer", "string"),
    _f(3, "param_str", "string", default=""),
    _f(4, "share_in_parallel", "bool", default=False),
)

SCHEMA["RecurrentParameter"] = _msg(
    _f(1, "num_output", "uint32", default=0),
    _f(2, "weight_filler", "message", message="FillerParameter"),
    _f(3, "bias_filler", "message", message="FillerParameter"),
    _f(4, "debug_info", "bool", default=False),
    _f(5, "expose_hidden", "bool", default=False),
)

SCHEMA["ReductionParameter"] = _msg(
    _f(1, "operation", "enum", default=1, enum=REDUCTION_OP),
    _f(2, "axis", "int32", default=0),
    _f(3, "coeff", "float", default=1.0),
)

SCHEMA["ReLUParameter"] = _msg(
    _f(1, "negative_slope", "float", default=0.0),
    _f(2, "engine", "enum", default=0, enum=ENGINE),
)

SCHEMA["ReshapeParameter"] = _msg(
    _f(1, "shape", "message", message="BlobShape"),
    _f(2, "axis", "int32", default=0),
    _f(3, "num_axes", "int32", default=-1),
)

SCHEMA["ScaleParameter"] = _msg(
    _f(1, "axis", "int32", default=1),
    _f(2, "num_axes", "int32", default=1),
    _f(3, "filler", "message", message="FillerParameter"),
    _f(4, "bias_term", "bool", default=False),
    _f(5, "bias_filler", "message", message="FillerParameter"),
)

SCHEMA["SigmoidParameter"] = _msg(
    _f(1, "engine", "enum", default=0, enum=ENGINE),
)

SCHEMA["SliceParameter"] = _msg(
    _f(3, "axis", "int32", default=1),
    _f(2, "slice_point", "uint32", repeated=True),
    _f(1, "slice_dim", "uint32", default=1),
)

SCHEMA["SoftmaxParameter"] = _msg(
    _f(1, "engine", "enum", default=0, enum=ENGINE),
    _f(2, "axis", "int32", default=1),
)

SCHEMA["TanHParameter"] = _msg(
    _f(1, "engine", "enum", default=0, enum=ENGINE),
)

SCHEMA["TileParameter"] = _msg(
    _f(1, "axis", "int32", default=1),
    _f(2, "tiles", "int32"),
)

SCHEMA["ThresholdParameter"] = _msg(
    _f(1, "threshold", "float", default=0.0),
)

SCHEMA["WindowDataParameter"] = _msg(
    _f(1, "source", "string"),
    _f(2, "scale", "float", default=1.0),
    _f(3, "mean_file", "string"),
    _f(4, "batch_size", "uint32"),
    _f(5, "crop_size", "uint32", default=0),
    _f(6, "mirror", "bool", default=False),
    _f(7, "fg_threshold", "float", default=0.5),
    _f(8, "bg_threshold", "float", default=0.5),
    _f(9, "fg_fraction", "float", default=0.25),
    _f(10, "context_pad", "uint32", default=0),
    _f(11, "crop_mode", "string", default="warp"),
    _f(12, "cache_images", "bool", default=False),
    _f(13, "root_folder", "string", default=""),
)

SCHEMA["SPPParameter"] = _msg(
    _f(1, "pyramid_height", "uint32"),
    _f(2, "pool", "enum", default=0, enum=POOL_METHOD),
    _f(6, "engine", "enum", default=0, enum=ENGINE),
)

# CPM additions (reference caffe.proto:1471-1484)
SCHEMA["NmsParameter"] = _msg(
    _f(1, "threshold", "float", default=0.5),
    _f(2, "num_peak", "uint32", default=100),
    _f(3, "max_peaks", "uint32", default=20),
    _f(4, "num_parts", "uint32", default=15),
)

SCHEMA["ImResizeParameter"] = _msg(
    _f(1, "target_spatial_width", "uint32", default=368),
    _f(2, "target_spatial_height", "uint32", default=368),
    _f(3, "factor", "float", default=0.0),
    _f(4, "start_scale", "float", default=1.0),
    _f(5, "scale_gap", "float", default=0.1),
)

# Legacy V1 layer support: only the pieces needed to recover weights/topology
# from old-format .caffemodel files (reference upgrade_proto.cpp behavior).
V1_LAYER_TYPE = {
    "NONE": 0, "ABSVAL": 35, "ACCURACY": 1, "ARGMAX": 30, "BNLL": 2,
    "CONCAT": 3, "CONTRASTIVE_LOSS": 37, "CONVOLUTION": 4, "DATA": 5,
    "DECONVOLUTION": 39, "DROPOUT": 6, "DUMMY_DATA": 32,
    "EUCLIDEAN_LOSS": 7, "ELTWISE": 25, "EXP": 38, "FLATTEN": 8,
    "HDF5_DATA": 9, "HDF5_OUTPUT": 10, "HINGE_LOSS": 28, "IM2COL": 11,
    "IMAGE_DATA": 12, "INFOGAIN_LOSS": 13, "INNER_PRODUCT": 14, "LRN": 15,
    "MEMORY_DATA": 29, "MULTINOMIAL_LOGISTIC_LOSS": 16, "MVN": 34,
    "POOLING": 17, "POWER": 26, "RELU": 18, "SIGMOID": 19,
    "SIGMOID_CROSS_ENTROPY_LOSS": 27, "SILENCE": 36, "SOFTMAX": 20,
    "SOFTMAX_LOSS": 21, "SPLIT": 22, "SLICE": 33, "TANH": 23,
    "WINDOW_DATA": 24, "THRESHOLD": 31,
}

# map V1 enum value -> V2 string type name (reference upgrade_proto.cpp,
# UpgradeV1LayerType)
V1_TO_V2_TYPE = {
    35: "AbsVal", 1: "Accuracy", 30: "ArgMax", 2: "BNLL", 3: "Concat",
    37: "ContrastiveLoss", 4: "Convolution", 5: "Data", 39: "Deconvolution",
    6: "Dropout", 32: "DummyData", 7: "EuclideanLoss", 25: "Eltwise",
    38: "Exp", 8: "Flatten", 9: "HDF5Data", 10: "HDF5Output",
    28: "HingeLoss", 11: "Im2col", 12: "ImageData", 13: "InfogainLoss",
    14: "InnerProduct", 15: "LRN", 29: "MemoryData",
    16: "MultinomialLogisticLoss", 34: "MVN", 17: "Pooling", 26: "Power",
    18: "ReLU", 19: "Sigmoid", 27: "SigmoidCrossEntropyLoss", 36: "Silence",
    20: "Softmax", 21: "SoftmaxWithLoss", 22: "Split", 33: "Slice",
    23: "TanH", 24: "WindowData", 31: "Threshold",
}

SCHEMA["V1LayerParameter"] = _msg(
    _f(1, "layer", "message", message="V0LayerParameter"),
    _f(2, "bottom", "string", repeated=True),
    _f(3, "top", "string", repeated=True),
    _f(4, "name", "string"),
    _f(32, "include", "message", repeated=True, message="NetStateRule"),
    _f(33, "exclude", "message", repeated=True, message="NetStateRule"),
    _f(5, "type", "enum", enum=V1_LAYER_TYPE),
    _f(6, "blobs", "message", repeated=True, message="BlobProto"),
    _f(1001, "param", "string", repeated=True),
    _f(1002, "blob_share_mode", "enum", repeated=True, enum=DIM_CHECK_MODE),
    _f(7, "blobs_lr", "float", repeated=True),
    _f(8, "weight_decay", "float", repeated=True),
    _f(35, "loss_weight", "float", repeated=True),
    _f(27, "accuracy_param", "message", message="AccuracyParameter"),
    _f(23, "argmax_param", "message", message="ArgMaxParameter"),
    _f(9, "concat_param", "message", message="ConcatParameter"),
    _f(40, "contrastive_loss_param", "message",
       message="ContrastiveLossParameter"),
    _f(10, "convolution_param", "message", message="ConvolutionParameter"),
    _f(11, "data_param", "message", message="DataParameter"),
    _f(12, "dropout_param", "message", message="DropoutParameter"),
    _f(26, "dummy_data_param", "message", message="DummyDataParameter"),
    _f(24, "eltwise_param", "message", message="EltwiseParameter"),
    _f(41, "exp_param", "message", message="ExpParameter"),
    _f(13, "hdf5_data_param", "message", message="HDF5DataParameter"),
    _f(14, "hdf5_output_param", "message", message="HDF5OutputParameter"),
    _f(29, "hinge_loss_param", "message", message="HingeLossParameter"),
    _f(15, "image_data_param", "message", message="ImageDataParameter"),
    _f(16, "infogain_loss_param", "message", message="InfogainLossParameter"),
    _f(17, "inner_product_param", "message", message="InnerProductParameter"),
    _f(18, "lrn_param", "message", message="LRNParameter"),
    _f(22, "memory_data_param", "message", message="MemoryDataParameter"),
    _f(34, "mvn_param", "message", message="MVNParameter"),
    _f(19, "pooling_param", "message", message="PoolingParameter"),
    _f(21, "power_param", "message", message="PowerParameter"),
    _f(30, "relu_param", "message", message="ReLUParameter"),
    _f(38, "sigmoid_param", "message", message="SigmoidParameter"),
    _f(39, "softmax_param", "message", message="SoftmaxParameter"),
    _f(31, "slice_param", "message", message="SliceParameter"),
    _f(37, "tanh_param", "message", message="TanHParameter"),
    _f(25, "threshold_param", "message", message="ThresholdParameter"),
    _f(20, "window_data_param", "message", message="WindowDataParameter"),
    _f(36, "transform_param", "message",
       message="TransformationParameter"),
    _f(42, "loss_param", "message", message="LossParameter"),
)

# Pre-V1 layer format (caffe.proto:1366-1456): a flat bag of per-type knobs
# dissected by UpgradeV0LayerParameter (upgrade_proto.cpp:190-540).
SCHEMA["V0LayerParameter"] = _msg(
    _f(1, "name", "string"),
    _f(2, "type", "string"),
    _f(3, "num_output", "uint32"),
    _f(4, "biasterm", "bool", default=True),
    _f(5, "weight_filler", "message", message="FillerParameter"),
    _f(6, "bias_filler", "message", message="FillerParameter"),
    _f(7, "pad", "uint32", default=0),
    _f(8, "kernelsize", "uint32"),
    _f(9, "group", "uint32", default=1),
    _f(10, "stride", "uint32", default=1),
    _f(11, "pool", "enum", enum=POOL_METHOD, default=0),
    _f(12, "dropout_ratio", "float", default=0.5),
    _f(13, "local_size", "uint32", default=5),
    _f(14, "alpha", "float", default=1.0),
    _f(15, "beta", "float", default=0.75),
    _f(22, "k", "float", default=1.0),
    _f(16, "source", "string"),
    _f(17, "scale", "float", default=1.0),
    _f(18, "meanfile", "string"),
    _f(19, "batchsize", "uint32"),
    _f(20, "cropsize", "uint32", default=0),
    _f(21, "mirror", "bool", default=False),
    _f(50, "blobs", "message", repeated=True, message="BlobProto"),
    _f(51, "blobs_lr", "float", repeated=True),
    _f(52, "weight_decay", "float", repeated=True),
    _f(53, "rand_skip", "uint32", default=0),
    _f(54, "det_fg_threshold", "float", default=0.5),
    _f(55, "det_bg_threshold", "float", default=0.5),
    _f(56, "det_fg_fraction", "float", default=0.25),
    _f(58, "det_context_pad", "uint32", default=0),
    _f(59, "det_crop_mode", "string", default="warp"),
    _f(60, "new_num", "int32", default=0),
    _f(61, "new_channels", "int32", default=0),
    _f(62, "new_height", "int32", default=0),
    _f(63, "new_width", "int32", default=0),
    _f(64, "shuffle_images", "bool", default=False),
    _f(65, "concat_dim", "uint32", default=1),
    _f(1001, "hdf5_output_param", "message", message="HDF5OutputParameter"),
)


# ------------------------------------------------------------------ helpers

_BY_NAME: Dict[str, Dict[str, Field]] = {
    m: {f.name: f for f in flds.values()} for m, flds in SCHEMA.items()
}


class View:
    """Attribute-style access over a decoded message dict with proto2 defaults.

    ``View(msg, 'ConvolutionParameter').pad`` returns ``[]``/default when the
    field is absent.  Nested message fields are wrapped lazily.
    """

    __slots__ = ("_msg", "_name")

    def __init__(self, msg: Dict[str, Any], message_name: str):
        if message_name not in SCHEMA:
            raise KeyError(f"unknown message {message_name}")
        self._msg = msg if msg is not None else {}
        self._name = message_name

    def has(self, name: str) -> bool:
        return name in self._msg

    @property
    def raw(self) -> Dict[str, Any]:
        return self._msg

    def __getattr__(self, name: str) -> Any:
        fields = _BY_NAME[self._name]
        if name not in fields:
            raise AttributeError(f"{self._name} has no field {name}")
        fld = fields[name]
        if name in self._msg:
            val = self._msg[name]
            if fld.kind == "message":
                if fld.repeated:
                    return [View(v, fld.message) for v in val]
                return View(val, fld.message)
            return val
        # defaults
        if fld.repeated:
            return []
        if fld.kind == "message":
            return View({}, fld.message)
        return fld.default

    def __repr__(self):
        return f"View<{self._name}>({self._msg!r})"


def view(msg: Dict[str, Any], message_name: str) -> View:
    return View(msg, message_name)


def fields_of(message_name: str) -> Iterable[Field]:
    return SCHEMA[message_name].values()
