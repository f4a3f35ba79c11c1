"""Serving bundles: the estimator's device program exported ahead of time.

Counterpart of ``caffe_rtpose_tpu/serving.py``.  The reference's deployment
artifact is a pair (deploy prototxt + .caffemodel), and every process that
serves it builds the Net graph at startup (warmup(),
examples/rtpose/rtpose.cpp:173-237).  A bundle is the ahead-of-time form:
the realtime device program (u8 canvases -> CNN -> fused upsample + peak
mask -> compaction, refinement, PAF pair scoring -> packed rows) as a
``torch.export`` program, next to the weights and the host metadata that
drive it.  A serving process loads it and runs without the prototxt
parser, the graph builder or the weight codec.

Bundle layout (a directory)::

    meta.json           host metadata (shapes, scales, descriptor, ...)
    weights.npz         "<layer>::<i>" -> f32 array, the JAX bundle's layout
                        (weights HWIO)
    program.pt2         the per-pass program (batch frames, possibly pair-capped)
    program_nocap.pt2   the single-frame overflow program at max_peaks (only
                        when pair_cap caps the first)

The hand-written kernels are ``torch.library`` operators
(``crt::conv1_block``, K4, and ``crt::peak_mask_fused``, K1), so each is one
node of the exported graph and the loaded program launches it; an operator
dispatches on its tensor's device, so a bundle exported on the CPU and
loaded on the card runs the kernels.  The NMS and PAF thresholds are inputs
of the program (a new threshold needs no new bundle), and so are the
weights: ``program.pt2`` holds the graph and its small constants (index and
interpolation tables), never the weights.  :class:`ExportedPose` derives the
operands the program runs on (the bf16 copies of the convolutions and K4's
packed weights) from ``weights.npz`` once at load, with the code ``Net``
uses (``core.net.derive_operands``).

:class:`ExportedPose` keeps the host surface of ``PoseEstimator``
(make_input / run_device / fetch / fetch_batch / estimate / the pair_cap
overflow refetch / warm_overflow), and on the card runs each program as a
CUDA graph like the live estimator, so ``pipeline.runner`` and user code
treat the two alike.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Tuple, Union

import numpy as np
import torch

from .core.net import derive_operands, param_tensor, params_from_jax
from .ops import conv1_cuda, nms_cuda  # noqa: F401  (registers the crt:: operators)
from .pose.estimator import DeviceProgram, PoseEstimator
from .utils.device import resolve_device

FORMAT_VERSION = "torch-1"
META = "meta.json"
WEIGHTS = "weights.npz"
PROGRAM = "program.pt2"
PROGRAM_NOCAP = "program_nocap.pt2"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _programs(est: PoseEstimator) -> Dict[str, Tuple[int, int]]:
    """File -> (pair capacity, frames a pass) of the programs a bundle of
    ``est`` holds."""
    progs = {PROGRAM: (est.eff_peaks, est.batch)}
    if est.eff_peaks < est.max_peaks:
        progs[PROGRAM_NOCAP] = (est.max_peaks, 1)
    return progs


def export_estimator(est: PoseEstimator, out_dir: str) -> str:
    """Write ``est``'s realtime program(s), weights and metadata into
    ``out_dir``.  The programs are exported on ``est.device``; each is run
    once eagerly first, so every cached constant it reads is a real tensor
    that the program lifts (``utils.device.device_const``).

    Refuses (``ValueError``) the heatmap branch, as JAX does, and an
    estimator whose hand kernels are switched off (``peak_kernel=False``, or
    bf16 with ``conv1_kernel=False``): a bundle records the kernels as
    operators, which run the kernel on the card and the plain version on
    the CPU."""
    if not est._packed:
        raise ValueError("export targets the production packed program; build the estimator "
                         "with keep_heatmap=False from a net with a resize layer")
    if isinstance(est, ExportedPose):
        raise ValueError("a bundle cannot be exported again; export the PoseEstimator")
    bf16 = est.net.dtype == torch.bfloat16
    if not est.peak_kernel or (bf16 and not est.net.conv1_kernel):
        raise ValueError("a bundle records the hand kernels as operators: build the estimator "
                         "with peak_kernel=True (and conv1_kernel=True in bf16)")
    os.makedirs(out_dir, exist_ok=True)
    weights = est._program_weights()
    p = est.params_connect
    thr = [torch.tensor(float(v), dtype=torch.float32, device=est.device)
           for v in (p.nms_threshold, p.inter_threshold)]
    in_dtype = torch.uint8 if est.input_u8 else torch.float32
    for name, (eff, frames) in _programs(est).items():
        x = torch.zeros((frames, *est.input_shape()), dtype=in_dtype, device=est.device)
        prog = DeviceProgram(est, eff)
        with torch.no_grad():
            prog(x, *thr, weights)
            ep = torch.export.export(prog, (x, *thr, weights), strict=False)
        ep._example_inputs = None  # they hold the weights, which weights.npz carries
        torch.export.save(ep, os.path.join(out_dir, name))

    flat = {}
    for layer, blobs in est.net.export_weights().items():
        for i, a in enumerate(blobs):
            # the JAX layout: weights HWIO
            flat[f"{layer}::{i}"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a
    np.savez(os.path.join(out_dir, WEIGHTS), **flat)

    meta = {
        "format_version": FORMAT_VERSION,
        "net_resolution": [est.net_w, est.net_h],
        "num_scales": est.num_scales,
        "start_scale": est.start_scale,
        "scale_gap": est.scale_gap,
        "batch": est.batch,
        "num_parts": est.num_parts,
        "max_peaks": est.max_peaks,
        "eff_peaks": est.eff_peaks,
        "packed": True,
        "input_u8": bool(est.input_u8),
        "pack_u8": bool(est.pack_u8),
        "device_rescale": bool(est.device_rescale),
        "dtype": "bfloat16" if bf16 else "float32",
        "platforms": [est.device.type],
        "descriptor": est.descriptor.name,
        # the port's own keys
        "device": str(est.device),
        "conv1_blocks": {k: list(v) for k, v in est.net.kernel_blocks().items()},
        "programs": {k: list(v) for k, v in _programs(est).items()},
    }
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return out_dir


def load_program(path: str, export_device: str, device: torch.device) -> torch.nn.Module:
    """A saved program as a callable module on ``device``: moved there
    (``torch.export.passes.move_to_device_pass``) when it was exported on
    another device."""
    ep = torch.export.load(path)
    if torch.device(export_device) != device:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, str(device))
    return ep.module()


class _NetShim:
    """The two ``Net`` attributes a bundle keeps: the f32 parameters as
    loaded (numpy, ``{layer: [OIHW weight, bias]}``) and the compute dtype."""

    def __init__(self, params, dtype):
        self.params = params
        self.dtype = dtype


class ExportedPose(PoseEstimator):
    """A ``PoseEstimator`` restored from a bundle: the same host API
    driving the loaded programs.  No prototxt, caffemodel or ``Net`` is
    built at load time.

    ``device``: where the programs run (default the card, where each is
    captured as a CUDA graph at its first call, as the live estimator's
    are; ``"cpu"`` runs the operators' plain versions eagerly).  A pass the
    bundle holds no program for (another batch, another pair capacity)
    raises ``NotImplementedError``: a bundle cannot trace a new program."""

    def __init__(self, bundle_dir: str, warm_overflow: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        # no Net is built: the host state comes from the bundle, through
        # the methods PoseEstimator.__init__ sets it with
        with open(os.path.join(bundle_dir, META)) as f:
            meta = json.load(f)
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"bundle format {meta.get('format_version')!r} is not "
                             f"{FORMAT_VERSION!r}, the one this package reads")
        self.bundle_dir = bundle_dir
        self.meta = meta
        eff, max_peaks = meta["eff_peaks"], meta["max_peaks"]
        self._init_options(device, tuple(meta["net_resolution"]), meta["num_scales"],
                           meta["start_scale"], meta["scale_gap"], keep_heatmap=False,
                           input_u8=meta["input_u8"], pack_u8=meta["pack_u8"],
                           device_rescale=meta["device_rescale"], batch=meta["batch"],
                           pair_cap=eff if eff < max_peaks else None, peak_kernel=True,
                           cuda_graph=None)
        self._init_parts(meta["num_parts"], max_peaks)
        if self.descriptor.name != meta["descriptor"]:
            raise ValueError(f"bundle descriptor {meta['descriptor']!r} does not match "
                             f"{self.num_parts} parts")

        with np.load(os.path.join(bundle_dir, WEIGHTS)) as z:
            grouped: Dict[str, Dict[int, np.ndarray]] = {}
            for key in z.files:
                layer, i = key.rsplit("::", 1)
                grouped.setdefault(layer, {})[int(i)] = z[key]
        params = params_from_jax({k: [d[i] for i in sorted(d)] for k, d in grouped.items()})
        dtype = DTYPES[meta["dtype"]]
        self.net = _NetShim(params, dtype)
        self._weights = self._derive_weights(self.device)

        self._programs = self._load_programs(self.device)
        self._init_runtime(warm_overflow)

    def _derive_weights(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The programs' operands on ``device`` from the f32 parameters, made
        as ``Net`` makes its own."""
        params = {k: [param_tensor(a, device) for a in blobs] for k, blobs in self.net.params.items()}
        return derive_operands(params, self.net.dtype, self.meta["conv1_blocks"])

    def _load_programs(self, device: torch.device) -> Dict[Tuple[int, int], torch.nn.Module]:
        """(pair capacity, frames a pass) -> the loaded program on ``device``."""
        return {tuple(key): load_program(os.path.join(self.bundle_dir, name),
                                         self.meta["device"], device)
                for name, key in self.meta["programs"].items()}

    @property
    def platforms(self):
        return list(self.meta["platforms"])

    def _program_fn(self, eff_peaks: int, frames: int):
        prog = self._programs.get((eff_peaks, frames))
        if prog is None:
            raise NotImplementedError(
                f"the bundle holds no program for {frames} frame(s) at pair capacity "
                f"{eff_peaks} (it holds {sorted(self._programs)}); a bundle cannot trace a "
                "new one: export the estimator with those options")
        weights = self._weights
        return lambda x, n, i: {"packed": prog(x, n, i, weights)}

    def replicate(self, device: Union[str, torch.device]) -> "ExportedPose":
        """The bundle's programs and operands on another device, with their
        own graphs (``parallel.inference.DevicePool``)."""
        dev = resolve_device(device)
        rep = copy.copy(self)
        rep.device = dev
        rep._weights = {k: v.to(dev) for k, v in self._weights.items()}
        rep._programs = self._load_programs(dev)
        rep._init_runtime(False)
        return rep
