"""The pycaffe facade (reference python/caffe/: pycaffe.py, classifier.py,
detector.py, io.py, draw.py), the port of ``caffe_rtpose_tpu/api.py``.

    from caffe_rtpose_tpu_torch import api as caffe
    caffe.set_mode_cpu()                   # on a machine without a card
    net = caffe.Net(proto, weights, caffe.TEST)
    out = net.forward(data=batch)          # {output_name: ndarray}
    net.blobs['conv1'].data                # activations (Caffe NCHW layout)
    net.params['conv1'][0].data            # weights (Caffe layout)
    diffs = net.backward(loss=np.ones(())) # input diffs; params' .diff filled

The facade starts in GPU mode (the first CUDA card), as the JAX facade
starts on the accelerator; ``set_mode_cpu()`` is how a caller without a card
asks for the CPU.  Blobs and parameters are numpy copies of the core net's
tensors (``core/net.py``): ``.data`` of a parameter is read from the device
when first asked for after a change, and a caller's edits are written back
before the next forward, backward, step or save.  Images are read by
``pipeline/image_io.py`` and resized in numpy (``resize_image``: orders 0,
1 and 2 as ``cv2.resize``'s nearest, linear and cubic on float images).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import coord_map  # noqa: F401  (caffe.coord_map)
from . import proto  # noqa: F401  (caffe.proto.caffe_pb2, loaded lazily)
from .core import net_spec  # noqa: F401  (caffe.net_spec)
from .core.net import Net as _CoreNet
from .core.net_spec import L as layers  # noqa: F401  (caffe.layers)
from .core.net_spec import NetSpec  # noqa: F401
from .core.net_spec import params  # noqa: F401  (caffe.params)

TRAIN = "TRAIN"
TEST = "TEST"

# ---------------------------------------------------------------- singleton
# Caffe's mode and device (_caffe.cpp:286-291, common.hpp:102-183): where new
# nets are built.  GPU mode is a CUDA card, picked by set_device.

_mode = "gpu"
_device_index = 0
_default_seed: Optional[int] = None


def set_mode_cpu() -> None:
    global _mode
    _mode = "cpu"


def set_mode_gpu() -> None:
    global _mode
    _mode = "gpu"


def set_device(device_id: int) -> None:
    global _device_index
    _device_index = int(device_id)


def device() -> torch.device:
    """The device new nets are built on."""
    return torch.device("cpu") if _mode == "cpu" else torch.device("cuda", _device_index)


def set_random_seed(seed: int) -> None:
    """Caffe::set_random_seed: seeds weight init (each new Net draws the
    next seed of a stream that starts here, so two nets built after one
    seeding differ, as the reference's one advancing RNG gives) and numpy's
    global generator."""
    global _default_seed
    _default_seed = int(seed)
    np.random.seed(int(seed) % (2 ** 32))


def _next_net_seed() -> Optional[int]:
    """Take one value of the seeded init stream (None: unseeded)."""
    global _default_seed
    if _default_seed is None:
        return None
    s = _default_seed
    _default_seed = (s * 6364136223846793005 + 1442695040888963407) % (2 ** 31)
    return s


def layer_type_list() -> List[str]:
    """caffe.layer_type_list() (LayerRegistry::LayerTypeList)."""
    from .core.data_layers import DATA_LAYER_TYPES
    from .core.layers import REGISTRY

    return sorted(set(REGISTRY) | set(DATA_LAYER_TYPES))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class _Blob:
    """pycaffe Blob: ``.data``, ``.diff``, ``.shape``."""

    def __init__(self, shape):
        self._shape = tuple(int(d) for d in shape)
        self._data = np.zeros(self._shape, np.float32)
        self._pending: Optional[Callable[[], np.ndarray]] = None
        self.diff = np.zeros(self._shape, np.float32)

    @property
    def data(self):
        if self._pending is not None:
            thunk, self._pending = self._pending, None
            self._data = thunk()
        return self._data

    @data.setter
    def data(self, value):
        self._pending = None
        self._data = value

    def _set_pending(self, thunk) -> None:
        """``.data`` is ``thunk()``, fetched on first read (a solver step
        fetches nothing it is not asked for)."""
        self._pending = thunk

    @property
    def shape(self):
        return self._shape

    @property
    def num(self):
        return self._shape[0]

    @property
    def channels(self):
        return self._shape[1] if len(self._shape) > 1 else 1

    def reshape(self, *shape):
        self._shape = tuple(int(d) for d in shape)
        self.data = np.zeros(self._shape, np.float32)
        self.diff = np.zeros(self._shape, np.float32)

    def reshape_dims(self, dims) -> None:
        """reshape() taking one sequence: the MATLAB bridge's call
        (matlab/+caffe/Blob.m)."""
        self.reshape(*[int(d) for d in np.asarray(dims).reshape(-1)])


class _ParamBlob(_Blob):
    """A parameter blob over one of the core net's blobs (looked up each
    time: a test net adopts its train net's tensors): read when first asked
    for after :meth:`stale`, written back by :meth:`push` when the caller
    changed it."""

    def __init__(self, net: _CoreNet, layer: str, index: int):
        self._net, self._layer, self._index = net, layer, index
        super().__init__(tuple(self.tensor.shape))
        self._data = None
        self._synced: Optional[np.ndarray] = None

    @property
    def tensor(self) -> torch.Tensor:
        return self._net.mods[self._layer].blobs()[self._index]

    @property
    def data(self):
        if self._data is None:
            self._data = _numpy(self.tensor).copy()
            self._synced = self._data.copy()
        return self._data

    @data.setter
    def data(self, value):
        self._data = np.asarray(value, np.float32)

    def stale(self) -> None:
        self._data = None
        self._synced = None

    def push(self) -> bool:
        if self._data is None or (self._synced is not None
                                  and np.array_equal(self._data, self._synced)):
            return False
        with torch.no_grad():
            self.tensor.copy_(torch.from_numpy(
                np.ascontiguousarray(self._data, np.float32).reshape(tuple(self.tensor.shape))))
        self._synced = np.array(self._data, np.float32, copy=True)
        return True


class Net:
    """pycaffe-style net over ``core.net.Net``, built on :func:`device`."""

    def __init__(self, prototxt, weights: Optional[str] = None, phase: str = TEST,
                 fetch_all_blobs: bool = True, **kw):
        """``fetch_all_blobs``: refresh every ``net.blobs[*].data`` after a
        forward (pycaffe's blobs alias device memory; here they are copied).
        False fetches only the outputs, the asked-for blobs and the data
        layers' tops."""
        if weights in (TRAIN, TEST):  # the Net(proto, phase) signature
            phase, weights = weights, None
        self._fetch_all = bool(fetch_all_blobs)
        if isinstance(prototxt, _CoreNet):
            # a facade over an existing core net (a solver's), its tensors shared
            self._proto, self._kw, self._net = None, {}, prototxt
            self._init_facades()
            return
        if _default_seed is not None and "seed" not in kw:
            kw["seed"] = _next_net_seed()
        # pycaffe passes level (default 0) to Net(file, phase, level), which
        # overrides a prototxt state.level (net.cpp:44)
        kw.setdefault("level", 0)
        kw.setdefault("device", device())
        self._proto, self._kw = prototxt, dict(kw)
        self._net = _CoreNet(prototxt, phase=phase, **kw)
        self._init_facades()
        if weights:
            self.copy_from(weights)

    def _init_facades(self) -> None:
        self.blobs: "OrderedDict[str, _Blob]" = OrderedDict(
            (name, _Blob(shape)) for name, shape in self._net.blob_shapes.items())
        self._params: "OrderedDict[str, List[_ParamBlob]]" = OrderedDict(
            (name, [_ParamBlob(self._net, name, i) for i in range(len(blobs))])
            for name, blobs in self._net.layer_blobs().items())

    # ------------------------------------------------------------- pycaffe

    @property
    def params(self) -> "OrderedDict[str, List[_ParamBlob]]":
        return self._params

    def _mark_params_stale(self) -> None:
        for blobs in self._params.values():
            for b in blobs:
                b.stale()

    def _push_params(self) -> None:
        """Write the caller's edits of ``params[...][i].data`` to the net."""
        pushed = [b.push() for blobs in self._params.values() for b in blobs]
        if any(pushed):
            self._net.params_changed()

    @property
    def inputs(self) -> List[str]:
        # data-layer tops are no inputs (pycaffe net.inputs is net_input_blobs_)
        return [n for n in self._net.input_names if n not in self._net._data_top_to_layer]

    @property
    def outputs(self) -> List[str]:
        return self._net.output_names(post_layers=True)

    @property
    def phase(self) -> str:
        return self._net.phase

    def copy_from(self, weights_path: str) -> None:
        self._net.load_weights(weights_path)
        self._mark_params_stale()

    def save(self, path: str) -> None:
        self._push_params()
        self._net.save_caffemodel(path)

    def save_hdf5(self, path: str) -> None:
        """Net::ToHDF5 (``Net.save_hdf5``: the port's HDF5 codec, no h5py)."""
        self._push_params()
        self._net.save_hdf5(path)

    def load_hdf5(self, path: str) -> None:
        """Net::CopyTrainedLayersFromHDF5 (``Net.load_hdf5``), by layer name."""
        self._net.load_hdf5(path)
        self._mark_params_stale()

    def set_input_arrays(self, data: np.ndarray, labels: Optional[np.ndarray] = None) -> None:
        """Bind arrays to the MemoryData layer (pycaffe Net.set_input_arrays)."""
        self._net.set_input_arrays(data, labels)

    def clear_param_diffs(self) -> None:
        """Net::ClearParamDiffs: the learnable parameters' diffs only."""
        for blobs in self._params.values():
            for b in blobs:
                b.diff = np.zeros(b.shape, np.float32)

    def share_with(self, other: "Net") -> None:
        """Net::ShareTrainedLayersWith: the other net's parameter values for
        the layers of the same name (copied, as in JAX)."""
        other._push_params()
        self._net.load_weights({name: [_numpy(b.tensor) for b in blobs]
                                for name, blobs in other._params.items() if name in self._params})
        self._mark_params_stale()

    def reshape(self) -> None:
        """Apply edits of the input blobs' shapes (``net.blobs['data']
        .reshape(...); net.reshape()``): the net is built again for them,
        the weights carried over by name."""
        shapes = {n: tuple(self.blobs[n].shape) for n in self.inputs}
        if all(shapes[n] == self._net.blob_shapes[n] for n in shapes):
            return
        if self._proto is None:
            raise RuntimeError("cannot reshape a facade over a solver's net (no prototxt to "
                               "build it again from)")
        self._push_params()
        weights = self._net.export_weights()
        kw = dict(self._kw)
        kw["input_shapes"] = {**kw.get("input_shapes", {}), **shapes}
        self._net = _CoreNet(self._proto, phase=self._net.phase, **kw)
        self._net.load_weights(weights)
        saved = dict(self.blobs)
        self._init_facades()
        for name, b in saved.items():
            if name in shapes:
                self.blobs[name] = b

    def _feed(self, arrays: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(self._net.device)
                for k, v in arrays.items()}

    def forward(self, blobs: Optional[Sequence[str]] = None, **inputs) -> Dict[str, np.ndarray]:
        """Run forward; returns the output blobs (and ``blobs``) and
        refreshes ``.blobs[*].data`` (pycaffe _Net_forward)."""
        self._push_params()
        for name in self.inputs:
            if name not in inputs:
                inputs[name] = self.blobs[name].data
        want = list(self.outputs) + [b for b in (blobs or []) if b not in self.outputs]
        # the data layers' tops are always fetched: backward reads the batch back
        extra = (list(self._net.blob_shapes) if self._fetch_all
                 else list(self._net._data_top_to_layer))
        fetch = list(dict.fromkeys(want + extra))
        with torch.no_grad():
            out = {k: _numpy(v) for k, v in self._net.forward(self._feed(inputs),
                                                              outputs=fetch).items()}
        for name, arr in out.items():
            if name in self.blobs:
                self.blobs[name].data = arr
        for name, arr in inputs.items():
            self.blobs[name].data = np.asarray(arr)
        return {k: out[k] for k in want}

    def forward_dict(self, inputs: Dict[str, np.ndarray],
                     blobs: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """forward() taking a plain dict: the MATLAB bridge's call
        (matlab/+caffe/Net.m), where keyword arguments cannot be written."""
        return self.forward(blobs=blobs, **{str(k): np.asarray(v) for k, v in inputs.items()})

    def backward_dict(self, top_diffs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """backward() taking a plain dict: the MATLAB bridge's call."""
        return self.backward(**{str(k): np.asarray(v) for k, v in top_diffs.items()})

    def backward(self, **top_diffs) -> Dict[str, np.ndarray]:
        """The gradients of sum(top * top_diff) with respect to the inputs
        (the last forward's, data-layer tops included) and the parameters;
        fills ``.blobs[input].diff`` and ``.params[*][i].diff``."""
        self._push_params()
        inputs = {name: self.blobs[name].data for name in self._net.input_names}
        in_diffs, param_diffs = self._net.backward(self._feed(inputs), top_diffs)
        out: Dict[str, np.ndarray] = {}
        for name, g in in_diffs.items():
            self.blobs[name].diff = out[name] = _numpy(g)
        for name, blobs in self._params.items():
            for b, g in zip(blobs, param_diffs.get(name, [])):
                b.diff = _numpy(g)
        return out

    def forward_all(self, blobs=None, **kwargs) -> Dict[str, np.ndarray]:
        """Forward over all given inputs, a batch at a time, the last batch
        padded (pycaffe _Net_forward_all)."""
        batch = self.blobs[self.inputs[0]].shape[0]
        total = len(next(iter(kwargs.values())))
        outs: Dict[str, List[np.ndarray]] = {}
        for i in range(0, total, batch):
            chunk = {k: _pad_batch(v[i: i + batch], batch) for k, v in kwargs.items()}
            out = self.forward(blobs=blobs, **chunk)
            take = min(batch, total - i)
            for k, v in out.items():
                outs.setdefault(k, []).append(v[:take])
        return {k: np.concatenate(v) for k, v in outs.items()}

    @property
    def layer_dict(self):
        return OrderedDict((l.name, self._net.mods[l.name]) for l in self._net.layers)

    @property
    def _layer_names(self) -> List[str]:
        return [l.name for l in self._net.layers]

    @property
    def layers(self) -> List["_LayerFacade"]:
        """pycaffe Net.layers: ``.type`` and ``.blobs`` (the parameter blobs)."""
        return [_LayerFacade(l.type, self._params.get(l.name, [])) for l in self._net.layers]

    @property
    def top_names(self) -> Dict[str, List[str]]:
        return OrderedDict((l.name, list(l.tops)) for l in self._net.layers)

    @property
    def bottom_names(self) -> Dict[str, List[str]]:
        return OrderedDict((l.name, list(l.bottoms)) for l in self._net.layers)


class _LayerFacade:
    """An element of Net.layers."""

    def __init__(self, type_: str, blobs):
        self.type = type_
        self.blobs = blobs


def _pad_batch(arr, batch):
    if len(arr) == batch:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], batch - len(arr), axis=0)])


# -------------------------------------------------------------------- io


def load_image(path: str, color: bool = True) -> np.ndarray:
    """An RGB (or gray, (H, W, 1)) float image in [0, 1] (caffe.io.load_image);
    read without OpenCV (PNG, BMP and PNM in numpy, JPEG by the port's codec)."""
    from .core.data_layers import read_image

    img = read_image(path, color)
    if color:
        img = img[:, :, ::-1]
    return img.astype(np.float32) / 255.0


def _nearest_index(n_out: int, n_src: int) -> np.ndarray:
    ifx = 1.0 / (n_out / float(n_src))
    return np.minimum(np.floor(np.arange(n_out) * ifx).astype(np.int64), n_src - 1)


def _cubic_taps(n_out: int, n_src: int):
    from .training.transformer import _resize_taps

    return _resize_taps(n_out, n_src, 1.0 / (n_out / float(n_src)))


def resize_image(im: np.ndarray, new_dims, interp_order: int = 1) -> np.ndarray:
    """``im`` (H, W, K) resized to ``new_dims`` (h, w) as ``cv2.resize`` does,
    in the input's dtype: order 0 nearest, 1 bilinear (the default), 2
    bicubic (a = -0.75); the edges replicate.  A u8 image is resized as cv2
    resizes u8: bilinear bit for bit (``utils/imgproc.resize_linear_u8``),
    bicubic within one level (``training/transformer.resize_cubic``, ROADMAP
    C5), both saturated to u8.  A float image is computed in f32 (f64 for
    f64) with cv2's f32 coefficients."""
    from .core.data_layers import apply_taps, linear_taps

    h, w = int(new_dims[0]), int(new_dims[1])
    x = np.asarray(im)
    if x.ndim == 2:
        x = x[..., None]
    sh, sw = x.shape[:2]
    if interp_order == 0:
        return x[_nearest_index(h, sh)][:, _nearest_index(w, sw)]
    if x.dtype == np.uint8:
        if interp_order == 2:
            from .training.transformer import resize_cubic

            return resize_cubic(x, w / sw, h / sh).reshape(h, w, -1)
        from .utils.imgproc import resize_linear_u8

        planes = [x] if x.shape[2] in (1, 3) else [x[..., k] for k in range(x.shape[2])]
        out = [resize_linear_u8(p, h, w).reshape(h, w, -1) for p in planes]
        return out[0] if len(out) == 1 else np.concatenate(out, 2)
    if x.dtype != np.float64:
        x = x.astype(np.float32)
    taps = _cubic_taps if interp_order == 2 else linear_taps
    (ix, wx), (iy, wy) = taps(w, sw), taps(h, sh)
    return apply_taps(apply_taps(x, ix, wx, 1), iy, wy, 0)


def oversample(images: Sequence[np.ndarray], crop_dims) -> np.ndarray:
    """10-crop oversampling: 4 corners and the centre, and their mirrors
    (caffe.io.oversample)."""
    ch, cw = int(crop_dims[0]), int(crop_dims[1])
    crops = []
    for im in images:
        h, w = im.shape[:2]
        for x, y in zip([0, w - cw, 0, w - cw, (w - cw) // 2],
                        [0, 0, h - ch, h - ch, (h - ch) // 2]):
            c = im[y: y + ch, x: x + cw]
            crops.append(c)
            crops.append(c[:, ::-1])
    return np.stack(crops)


class Transformer:
    """caffe.io.Transformer: the preprocessing of each input blob."""

    def __init__(self, inputs: Dict[str, Sequence[int]]):
        self.inputs = {k: tuple(v) for k, v in inputs.items()}
        self.transpose: Dict[str, tuple] = {}
        self.channel_swap: Dict[str, tuple] = {}
        self.raw_scale: Dict[str, float] = {}
        self.mean: Dict[str, np.ndarray] = {}
        self.input_scale: Dict[str, float] = {}

    def set_transpose(self, name, order):
        self.transpose[name] = tuple(order)

    def set_channel_swap(self, name, order):
        self.channel_swap[name] = tuple(order)

    def set_raw_scale(self, name, scale):
        self.raw_scale[name] = scale

    def set_mean(self, name, mean):
        self.mean[name] = np.asarray(mean, np.float32)

    def set_input_scale(self, name, scale):
        self.input_scale[name] = scale

    def _mean(self, name):
        m = self.mean[name]
        return m.reshape(-1, 1, 1) if m.ndim == 1 else m

    def preprocess(self, name, data: np.ndarray) -> np.ndarray:
        x = np.asarray(data, np.float32)
        if x.shape[:2] != tuple(self.inputs[name][2:]):
            x = resize_image(x, self.inputs[name][2:])
        if name in self.transpose:
            x = x.transpose(self.transpose[name])
        if name in self.channel_swap:
            x = x[np.asarray(self.channel_swap[name])]
        if name in self.raw_scale:
            x = x * self.raw_scale[name]
        if name in self.mean:
            x = x - self._mean(name)
        if name in self.input_scale:
            x = x * self.input_scale[name]
        return x

    def deprocess(self, name, data: np.ndarray) -> np.ndarray:
        x = np.asarray(data, np.float32).copy()
        if name in self.input_scale:
            x = x / self.input_scale[name]
        if name in self.mean:
            x = x + self._mean(name)
        if name in self.raw_scale:
            x = x / self.raw_scale[name]
        if name in self.channel_swap:
            x = x[np.argsort(self.channel_swap[name])]
        if name in self.transpose:
            x = x.transpose(np.argsort(self.transpose[name]))
        return x


def _transformer_for(net: Net, mean, input_scale, raw_scale, channel_swap) -> Transformer:
    in_ = net.inputs[0]
    tf = Transformer({in_: net.blobs[in_].shape})
    tf.set_transpose(in_, (2, 0, 1))
    for setter, value in ((tf.set_mean, mean), (tf.set_input_scale, input_scale),
                          (tf.set_raw_scale, raw_scale), (tf.set_channel_swap, channel_swap)):
        if value is not None:
            setter(in_, value)
    return tf


class Classifier(Net):
    """caffe.Classifier: images -> class probabilities, centre crop or
    10-crop oversampling."""

    def __init__(self, model_file, pretrained_file=None, image_dims=None, mean=None,
                 input_scale=None, raw_scale=None, channel_swap=None):
        super().__init__(model_file, pretrained_file, TEST)
        self.transformer = _transformer_for(self, mean, input_scale, raw_scale, channel_swap)
        self.crop_dims = np.array(self.blobs[self.inputs[0]].shape[2:])
        self.image_dims = np.array(image_dims if image_dims is not None else self.crop_dims)

    def predict(self, inputs: Sequence[np.ndarray], oversample_: bool = True) -> np.ndarray:
        in_ = self.inputs[0]
        images = [resize_image(im, self.image_dims) for im in inputs]
        if oversample_:
            crops = oversample(images, self.crop_dims)
        else:
            c = (np.asarray(images[0].shape[:2]) - self.crop_dims) // 2
            crops = np.stack([im[c[0]: c[0] + self.crop_dims[0], c[1]: c[1] + self.crop_dims[1]]
                              for im in images])
        data = np.stack([self.transformer.preprocess(in_, c) for c in crops])
        out = self.forward_all(**{in_: data})[self.outputs[0]]
        if oversample_:
            out = out.reshape(len(inputs), 10, -1).mean(1)
        return out


class Detector(Net):
    """caffe.Detector: classification of image windows (detect_windows)."""

    def __init__(self, model_file, pretrained_file=None, mean=None, input_scale=None,
                 raw_scale=None, channel_swap=None, context_pad=0):
        super().__init__(model_file, pretrained_file, TEST)
        self.transformer = _transformer_for(self, mean, input_scale, raw_scale, channel_swap)
        self.context_pad = context_pad

    def detect_windows(self, images_windows):
        in_ = self.inputs[0]
        dims = self.blobs[in_].shape[2:]
        window_inputs, meta = [], []
        for path, windows in images_windows:
            image = load_image(path)
            for window in windows:
                y0, x0, y1, x1 = [int(v) for v in window]
                window_inputs.append(self.transformer.preprocess(
                    in_, resize_image(image[y0:y1, x0:x1], dims)))
                meta.append((path, window))
        out = self.forward_all(**{in_: np.stack(window_inputs)})[self.outputs[0]]
        return [{"window": w, "filename": f, "prediction": out[i]}
                for i, (f, w) in enumerate(meta)]


# ---- caffe.io's blobproto and datum helpers (reference python/caffe/io.py:
# 18-107) on the dict-form messages and the wire codec


def blobproto_to_array(blob: dict, return_diff: bool = False) -> np.ndarray:
    data = np.array(blob.get("diff" if return_diff else "data", []), dtype=np.float64)
    if any(k in blob for k in ("num", "channels", "height", "width")):
        return data.reshape(blob.get("num", 0), blob.get("channels", 0),
                            blob.get("height", 0), blob.get("width", 0))
    return data.reshape(blob["shape"]["dim"])


def array_to_blobproto(arr: np.ndarray, diff=None) -> dict:
    blob = {"shape": {"dim": list(arr.shape)}, "data": [float(v) for v in np.ravel(arr)]}
    if diff is not None:
        blob["diff"] = [float(v) for v in np.ravel(diff)]
    return blob


def arraylist_to_blobprotovector_str(arraylist) -> bytes:
    from .proto import SCHEMA, wire

    return wire.encode({"blobs": [array_to_blobproto(a) for a in arraylist]}, SCHEMA,
                       "BlobProtoVector")


def blobprotovector_str_to_arraylist(s: bytes):
    from .proto import SCHEMA, wire

    return [blobproto_to_array(b) for b in wire.decode(s, SCHEMA, "BlobProtoVector")
            .get("blobs", [])]


def array_to_datum(arr: np.ndarray, label=None) -> dict:
    from .proto.datum import array_to_datum as _impl

    return _impl(arr, label)


def datum_to_array(datum: dict) -> np.ndarray:
    from .proto.datum import datum_to_array as _impl

    return _impl(datum)


def draw_net_text(net_param: dict) -> str:
    """The DAG as text (caffe.draw without graphviz)."""
    return "\n".join(f"{l.get('name')} ({l.get('type')}): [{', '.join(l.get('bottom', []))}] "
                     f"-> [{', '.join(l.get('top', []))}]" for l in net_param.get("layer", []))


def draw_net_dot(net_param: dict) -> str:
    """Graphviz .dot source of the DAG (caffe.draw.draw_net)."""
    lines = ["digraph net {", "  rankdir=LR;"]
    for l in net_param.get("layer", []):
        name = l.get("name")
        lines.append(f'  "{name}" [shape=record, label="{name}|{l.get("type")}"];')
        lines.extend(f'  "blob_{b}" -> "{name}";' for b in l.get("bottom", []))
        lines.extend(f'  "{name}" -> "blob_{t}";' for t in l.get("top", []))
    for l in net_param.get("layer", []):
        lines.extend(f'  "blob_{t}" [shape=oval, label="{t}"];' for t in l.get("top", []))
    lines.append("}")
    return "\n".join(lines)


class _PySolver:
    """pycaffe's Solver over ``training.solver.Solver``: step, solve, iter,
    snapshot, restore, and ``.net``/``.test_nets`` as :class:`Net` facades
    over the solver's nets."""

    def __init__(self, solver):
        self._solver = solver
        self.net = Net(solver.net)
        self.test_nets = [Net(tn[0]) for tn in solver.test_nets]

    @property
    def iter(self) -> int:
        return self._solver.iter

    def _sync_facades(self) -> None:
        """Parameters are read again when next asked for; the output blobs
        of the last training forward become the facade's ``.data``, fetched
        on first read (``solver.step(1); solver.net.blobs['loss'].data``)."""
        self.net._mark_params_stale()
        solver = self._solver
        cache: Dict[str, np.ndarray] = {}

        def make_thunk(name):
            def thunk():
                if not cache:
                    cache.update(solver.train_outputs())
                return cache[name]
            return thunk

        for name in solver.last_outputs:
            b = self.net.blobs.get(name)
            if b is not None:
                b._set_pending(make_thunk(name))
        for tn in self.test_nets:
            tn._mark_params_stale()

    def step(self, iters: int = 1):
        self.net._push_params()
        r = self._solver.step(int(iters))
        self._sync_facades()
        return r

    def solve(self) -> None:
        self.net._push_params()
        self._solver.solve()
        self._sync_facades()

    def snapshot(self, prefix=None):
        self.net._push_params()
        return self._solver.snapshot(prefix)

    def restore(self, path: str) -> None:
        self._solver.restore(path)
        self._sync_facades()


def SGDSolver(solver_file: str, data_fn=None, test_data_fn=None):
    """pycaffe's solver constructor.  ``data_fn(it) -> {input: array}``
    feeds the train net's inputs; a net with data layers (or no inputs)
    feeds itself.  Test nets come from the solver file (``test_net`` files
    or the train net at TEST, each with its ``test_iter``): one with data
    layers feeds itself, else ``test_data_fn`` feeds it, or zeros (the
    reference tests on whatever its blobs hold, zeros at first)."""
    from .proto import caffe_pb, prototxt
    from .training.solver import Solver

    msg = prototxt.parse_file(solver_file, "SolverParameter")
    sp = caffe_pb.view(msg, "SolverParameter")
    net_src = sp.net if sp.has("net") else sp.train_net
    net = _CoreNet(net_src, phase=TRAIN, device=device())
    if data_fn is None:
        if net.data_layers or not net.input_names:
            def data_fn(it):
                return {}
        else:
            def data_fn(it):
                raise RuntimeError("provide data_fn to feed the net inputs")
    test_nets = []
    if sp.has("test_interval") and int(sp.test_interval) > 0:
        iters = [int(v) for v in sp.test_iter] or [50]
        sources = list(sp.test_net) or ([net_src] if not sp.has("test_net") else [])
        for i, src in enumerate(sources):
            tnet = _CoreNet(src, phase=TEST, device=device())
            if tnet.data_layers or not tnet.input_names:
                fn = None
            elif test_data_fn is not None:
                fn = test_data_fn
            else:
                def fn(it, _n=tnet):
                    return {name: np.zeros(_n.blob_shapes[name], np.float32)
                            for name in _n.input_names}
            test_nets.append((tnet, fn, iters[min(i, len(iters) - 1)]))
    return _PySolver(Solver(msg, net, data_fn, test_nets=test_nets))


AdamSolver = NesterovSolver = AdaGradSolver = RMSPropSolver = AdaDeltaSolver = SGDSolver


def get_solver(solver_file: str, data_fn=None, test_data_fn=None):
    """caffe.get_solver (the solver type read from the file)."""
    return SGDSolver(solver_file, data_fn, test_data_fn)
