"""PoseEstimator: the inference paths in PyTorch.

Counterpart of ``caffe_rtpose_tpu/pose/estimator.py``.  One device pass per
batch of frames, in one of two branches:

* realtime (default): u8 upload (whole canvases, or with ``pack_u8`` only
  each scale's live region) and on-device normalize -> the deploy CNN up to
  the low-res ``concat_stage7``, all ``batch x num_scales`` canvases in one
  call (in bf16 its conv1 block through the hand-written CUDA kernel
  ``conv1_cuda.conv1_block``) -> one post segment over all frames of the
  pass, the port of the JAX package's ``jax.vmap``: the fused upsample +
  peak mask (the hand-written CUDA kernel ``nms_cuda.peak_mask_fused`` on
  the card, one launch a pass) -> raster-order compaction -> 7x7 refinement
  and PAF pair scoring, both read from the low-res maps -> one byte-packed
  output row per frame (f32 peaks | f16 scores | u8 counts);
* ``keep_heatmap=True``: f32 Caffe-layout input -> the same CNN -> the
  full-res upsample of all channels written out, with the part channels'
  peak keys (the hand-written CUDA kernel ``nms_cuda.upsample_peak_keys``)
  -> compaction and refinement gathered from the full-res maps
  (``nms.peaks_from_keys``) -> pair scoring on them (``connect.score_pairs``)
  -> peaks, pair scores, pair counts and the (C, H, W) heatmap, unpacked.
  This is the JAX branch that runs the ImResize and Nms layers; the heatmap
  feeds the render views of ``pose/render.py``.

A deploy net without a ``resize`` ImResize layer runs as JAX runs it: the
net's own Nms layer on its first canvas (the threshold a runtime knob),
then pair scoring on the blob that layer reads (``connect.score_pairs``),
at batch 1 with unpacked outputs, as the heatmap branch returns them.

In bf16 the low-res maps are cast to f32 once, before the post segment, as
every consumer of them in the JAX package does.  Only the greedy assembly
runs on the host.

On CUDA each device program is captured once as a CUDA graph and replayed
per call (:class:`_Program`): the port of ``jax.jit``, which makes the pass
one asynchronous call as the JAX package's is, instead of ~300 launches
from Python.
"""

from __future__ import annotations

import copy
import sys
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.net import Net
from ..ops import conv1_cuda, nms_cuda
from ..ops.nms import block_keys, compact_keys, peaks_from_keys, refine_from_low
from ..utils.device import disable_tf32, resolve_device
from . import connect as C
from . import preprocess
from .descriptor import ConnectParams, ModelDescriptor, for_num_parts


@dataclass
class PoseResult:
    joints: np.ndarray  # (num_people, num_parts, 3) in display coords
    num_people: int
    peaks: np.ndarray  # (num_parts, max_peaks+1, 3) net coords
    heatmap: Optional[np.ndarray] = None  # (C, H, W) resized maps with keep_heatmap


class PoseEstimator:
    """Build from a deploy graph (a prototxt path, prototxt text or a
    NetParameter dict; phase TEST) and weights (a ``.caffemodel`` path or
    ``{layer: [OIHW, bias]}`` numpy), as the JAX estimator is built.

    Mirrors warmup() (rtpose.cpp:173-237): reshape input to
    (num_scales, 3, net_h, net_w), inject start_scale/scale_gap into the
    ImResize layer, and select the model descriptor from the Nms layer's
    num_parts.

    On CUDA the estimator turns TF32 off for cuDNN convolutions and for
    matmuls (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``, process-wide), because the
    JAX reference computes every matmul at ``Precision.HIGHEST`` and the
    outputs are held to it at f32 tolerances.

    ``dtype``: float32 (the parity mode) or bfloat16 (the JAX tools'
    default): bf16 activations and conv operands, f32 sums (``core/net.py``).

    ``peak_kernel``: run the upsample + peak stage in the hand-written CUDA
    kernel of the branch (default on CUDA) or its plain PyTorch version.  On
    the CPU the plain version always runs.  ``conv1_kernel``: in bf16, run
    the conv1 block through its hand-written kernel (default on CUDA) or
    layer by layer (``Net``).

    ``batch``: frames per device pass; the input gains a leading batch axis,
    ``run_device`` returns a (batch, n) packed buffer and ``fetch_batch``
    unpacks it.  ``pack_u8``: upload only each scale's live region (one flat
    u8 buffer, ``preprocess.packed_regions``); default on for u8 input at
    more than one scale, as in JAX.  Bit-identical to the canvas upload.

    ``keep_heatmap``: the heatmap branch (module docstring).  As in JAX it
    forces ``input_u8`` off, ignores ``pair_cap`` (outputs are unpacked at
    full ``max_peaks``) and refuses ``batch > 1`` (``ValueError``).

    ``device_rescale`` (u8 input only, else ``ValueError``): upload only the
    largest scale's live region and derive the smaller scales on the device
    with the ``INTER_AREA`` matrices of ``preprocess.area_axis_matrix``, as
    JAX does; an opt-in divergence whose pixels differ from the reference.

    ``cuda_graph``: capture each device program (per pass shape and
    ``pair_cap``, and the heatmap branch) as a CUDA graph at its first call
    and replay it after (default on CUDA; off runs the same program
    eagerly).  The CPU has no graphs.  A graph keeps the tensors it
    captured, and ``Net.load_weights`` remakes the bf16 and packed copies:
    load weights before the first call (the constructor loads ``weights``
    before any capture).  ``warm_overflow``: capture the uncapped
    single-frame program in a background thread now, so the first crowded
    frame does not wait for a capture (a no-op without graphs).
    """

    def __init__(
        self,
        proto: Union[str, Mapping[str, Any]],
        weights: Union[None, str, Mapping[str, Sequence[np.ndarray]]] = None,
        net_resolution: Tuple[int, int] = (656, 368),  # (W, H), multiples of 16
        num_scales: int = 1,
        start_scale: float = 1.0,
        scale_gap: float = 0.3,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        keep_heatmap: bool = False,
        input_u8: bool = False,
        pair_cap: Optional[int] = None,
        batch: int = 1,
        pack_u8: Optional[bool] = None,
        device_rescale: bool = False,
        warm_overflow: bool = False,
        device: Union[str, torch.device] = "cuda",
        peak_kernel: Optional[bool] = None,
        conv1_kernel: Optional[bool] = None,
        cuda_graph: Optional[bool] = None,
    ):
        """``pair_cap``: transfer pair scores only for the first K peaks per
        part (raster order — identical to the reference for frames with
        <= K peaks/part).  Slot 0 of each part keeps the raw count, so a
        frame with more peaks is detected and refetched uncapped."""
        self._init_options(device, net_resolution, num_scales, start_scale, scale_gap,
                           keep_heatmap, input_u8, pack_u8, device_rescale, batch, pair_cap,
                           peak_kernel, cuda_graph)
        self.net = Net(
            proto,
            phase="TEST",
            input_shapes={"image": (num_scales, 3, self.net_h, self.net_w)},
            overrides={"resize": {"imresize_param.start_scale": start_scale,
                                  "imresize_param.scale_gap": scale_gap}},
            device=self.device,
            dtype=dtype,
            seed=seed,
            conv1_kernel=conv1_kernel,
        )
        if weights is not None:
            self.net.load_weights(weights)

        nms = self.net.post_layers.get("nms")
        if nms is None:
            raise ValueError("deploy net has no 'nms' layer")
        resize = self.net.post_layers.get("resize")
        self._init_parts(int(nms.param.get("num_parts", 15)), int(nms.param.get("max_peaks", 20)))
        if resize is None:
            # JAX estimator.py:331-345: the net's own Nms, then score_pairs
            if self.batch > 1:
                raise ValueError("batch > 1 requires the optimized packed path (a resize layer)")
            self._packed, self._direct = False, True
            self.heatmap_blob, self._nms_top = nms.bottoms[0], nms.tops[0]
            self.lowres_blob = None
            self.target_hw = tuple(self.net.blob_shapes[self.heatmap_blob][2:])
            self._layers = self.net.prune_for([self.heatmap_blob, self._nms_top])
            self._init_runtime(warm_overflow)
            return

        self.lowres_blob = resize.bottoms[0]
        _, _, h, w = self.net.blob_shapes[self.lowres_blob]
        factor = float(resize.param.get("factor", 0.0))
        if factor > 0:
            self.target_hw = (int(h * factor), int(w * factor))
        else:
            self.target_hw = (int(resize.param.get("target_spatial_height", 368)),
                              int(resize.param.get("target_spatial_width", 368)))
        self._layers = self.net.prune_for([self.lowres_blob])
        self._init_runtime(warm_overflow)

    def _init_options(self, device, net_resolution, num_scales, start_scale, scale_gap,
                      keep_heatmap, input_u8, pack_u8, device_rescale, batch, pair_cap,
                      peak_kernel, cuda_graph) -> None:
        """The host state that follows from the constructor's options alone
        (no net): the device and its tf32 switches, the geometry, the input
        layout and its device constants.  A bundle (``serving.ExportedPose``)
        restores its estimator through this too."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.peak_kernel = (self.device.type == "cuda") if peak_kernel is None else bool(peak_kernel)
        self.cuda_graph = (self.device.type == "cuda") if cuda_graph is None else bool(cuda_graph)
        if self.cuda_graph and self.device.type != "cuda":
            raise ValueError("cuda_graph needs a CUDA device")
        net_w, net_h = net_resolution
        self.net_w, self.net_h = net_w, net_h
        self.num_scales = num_scales
        self.start_scale = start_scale
        self.scale_gap = scale_gap
        self.keep_heatmap = bool(keep_heatmap)
        self.input_u8 = bool(input_u8) and not self.keep_heatmap
        self.device_rescale = bool(device_rescale)
        if self.device_rescale and not self.input_u8:
            raise ValueError("device_rescale requires input_u8")
        if pack_u8 is None:
            pack_u8 = self.input_u8 and num_scales > 1
        self.pack_u8 = bool(pack_u8) and self.input_u8 and not self.device_rescale
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError("batch must be a positive frame count")
        if self.batch > 1 and self.keep_heatmap:
            raise ValueError("batch > 1 requires the packed path (keep_heatmap=False)")
        if pair_cap is not None and int(pair_cap) < 1:
            raise ValueError("pair_cap must be a positive peak count")
        self._pair_cap = pair_cap

        self._mask: Optional[torch.Tensor] = None
        if self.pack_u8 or self.device_rescale:
            self._regions, self._packed_bytes = preprocess.packed_regions(
                net_w, net_h, num_scales, start_scale, scale_gap)
        if self.device_rescale:
            # per smaller scale: Wy (th_n, th_0) and Wx (tw_n, tw_0)
            th0, tw0 = self._regions[0][:2]
            self._rescale = [
                tuple(torch.from_numpy(preprocess.area_axis_matrix(n, n0)).to(self.device)
                      for n, n0 in ((rh, th0), (rw, tw0)))
                for rh, rw, _, _, _ in self._regions[1:]]
        elif self.input_u8 and not self.pack_u8:
            mask = np.zeros((num_scales, net_h, net_w, 1), np.float32)
            for i, (y0, y1, x0, x1) in enumerate(
                    preprocess.region_boxes(net_w, net_h, num_scales, start_scale, scale_gap)):
                mask[i, y0:y1, x0:x1] = 1.0
            self._mask = torch.from_numpy(mask).to(self.device)
        self._packed = not self.keep_heatmap  # one byte-packed row a frame
        self._direct = False  # a net without resize: its own Nms (module docstring)
        self._weights: Optional[Dict[str, torch.Tensor]] = None  # a replica's operands
        self._overflow_lock = threading.Lock()
        self._overflow_refetches = 0

    def _init_parts(self, num_parts: int, max_peaks: int) -> None:
        """The nms layer's part and peak counts, the pair capacity they
        bound, and the model descriptor they name."""
        self.num_parts = num_parts
        self.max_peaks = max_peaks
        self.eff_peaks = (min(int(self._pair_cap), self.max_peaks)
                          if self._pair_cap else self.max_peaks)
        self.descriptor: ModelDescriptor = for_num_parts(self.num_parts)
        self.params_connect: ConnectParams = self.descriptor.defaults

    def _init_runtime(self, warm_overflow: bool) -> None:
        """The state of running programs on ``self.device``: captured graphs,
        the overflow counter, the background capture of the uncapped
        program."""
        # captured programs by (branch, pair capacity, frames a pass); one
        # lock covers capture, replay and the copies around it, and one
        # memory pool serves them all
        self._graphs: Dict[tuple, _Program] = {}
        self._graph_lock = threading.Lock()
        self._graph_pool = None
        if self.cuda_graph:
            with torch.cuda.device(self.device):
                self._graph_pool = torch.cuda.graph_pool_handle()
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_error: Optional[BaseException] = None
        if (warm_overflow and self.cuda_graph and self._packed
                and self.eff_peaks < self.max_peaks):
            # capture the uncapped program now, so the first crowded frame
            # costs one extra pass and not a capture mid-stream (JAX
            # compiles it in the background for the same reason)
            self._warm_thread = threading.Thread(target=self._warm_nocap, name="warm_overflow",
                                                 daemon=True)
            self._warm_thread.start()

    def _warm_nocap(self) -> None:
        try:
            x = np.zeros((1, *self.input_shape()), self.input_dtype)
            self._run(x, None, None, eff_peaks=self.max_peaks)
        except Exception as e:  # raised again by the first refetch_full
            self._warm_error = e

    # ------------------------------------------------------------- device

    def _canvases(self, x: torch.Tensor) -> torch.Tensor:
        """(F, *input_shape) uploaded frames -> the (F*S, 3, H, W) net input
        in the net's dtype, a channels_last view where the input is u8."""
        S, H, W = self.num_scales, self.net_h, self.net_w
        f = x.shape[0]
        if self.device_rescale:
            # one uploaded live region -> every scale's canvas.  Normalize
            # first: the INTER_AREA rows sum to 1, so the resize commutes
            # with u8/256 - 0.5 and the padding stays exactly 0 (JAX
            # estimator.py:240-255)
            th0, tw0 = self._regions[0][:2]
            base = x.to(torch.float32).reshape(f, th0, tw0, 3) / 256.0 - 0.5
            xf = torch.zeros((f, S, H, W, 3), dtype=torch.float32, device=x.device)
            for i, (rh, rw, padh, padw, _) in enumerate(self._regions):
                seg = base if i == 0 else torch.einsum("ah,fhwc,bw->fabc", self._rescale[i - 1][0],
                                                       base, self._rescale[i - 1][1])
                xf[:, i, padh : padh + rh, padw : padw + rw] = seg
        elif self.pack_u8:
            # flat live regions -> normalized padded canvases: u8/256 - 0.5
            # inside each region, 0 padding (JAX estimator.py:256-268)
            xf = torch.zeros((f, S, H, W, 3), dtype=torch.float32, device=x.device)
            for i, (rh, rw, padh, padw, off) in enumerate(self._regions):
                seg = x[:, off : off + rh * rw * 3].to(torch.float32).reshape(f, rh, rw, 3)
                xf[:, i, padh : padh + rh, padw : padw + rw] = seg / 256.0 - 0.5
        elif self.input_u8:
            # exact process_and_pad_image normalize: u8/256 - 0.5 in the
            # image region, 0 in the padding (rtpose.cpp:258-263)
            xf = (x.to(torch.float32) / 256.0 - 0.5) * self._mask
        else:
            return x.reshape(f * S, 3, H, W).to(self.net.dtype)
        # normalized in f32, then cast; the (.., H, W, 3) canvases permute to
        # channels_last NCHW for free
        return xf.to(self.net.dtype).reshape(f * S, H, W, 3).permute(0, 3, 1, 2)

    def _lowres(self, x: torch.Tensor,
                weights: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """(F*S, 3, H, W) net input -> the low-res ``concat_stage7`` maps as
        (F, S, h, w, C) f32 NHWC (a view of the channels_last blob in f32;
        cast once in bf16), on ``weights`` (``Net.operands``; default the
        net's own)."""
        low = self.net({"image": x}, outputs=[self.lowres_blob], layers=self._layers,
                       operands=weights)
        low = low[self.lowres_blob].permute(0, 2, 3, 1).to(torch.float32)
        return low.reshape(-1, self.num_scales, *low.shape[1:])

    def _heatmap_program(self, x: torch.Tensor, nms_threshold, inter_threshold,
                         weights: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One uploaded frame (1, S, 3, H, W) -> :meth:`_heatmap_post` of
        its low-res maps."""
        return self._heatmap_post(self._lowres(self._canvases(x), weights)[0], nms_threshold,
                                  inter_threshold)

    def _direct_program(self, x: torch.Tensor, nms_threshold, inter_threshold,
                        weights: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A net without a resize layer: one uploaded frame -> its Nms
        layer's peaks on the first canvas and the pairs scored on the blob
        that layer reads (JAX estimator.py:331-345)."""
        blobs = self.net({"image": self._canvases(x)}, outputs=[self.heatmap_blob, self._nms_top],
                         layers=self._layers, operands=weights,
                         knobs={"nms_threshold": nms_threshold})
        peaks = blobs[self._nms_top][0]
        heat = blobs[self.heatmap_blob][0].to(torch.float32)
        pair_score, pair_count = C.score_pairs(heat, peaks, self.descriptor, inter_threshold)
        out = {"peaks": peaks, "pair_score": pair_score, "pair_count": pair_count}
        if self.keep_heatmap:
            out["heatmap"] = heat
        return out

    def _heatmap_post(self, low: torch.Tensor, nms_threshold,
                      inter_threshold) -> Dict[str, torch.Tensor]:
        """One frame's (S, h, w, C) f32 low-res maps through the full-res
        maps -> peaks, pair scores, pair counts and the (C, th, tw) heatmap."""
        fn = (nms_cuda.upsample_peak_keys if self.peak_kernel
              else nms_cuda.upsample_peak_keys_reference)
        heat, keys = fn(low, self.target_hw, self.start_scale, self.scale_gap, nms_threshold,
                        key_channels=self.num_parts)
        # all channels: refinement windows past a part channel's bottom edge
        # read the next channel, as the reference's flat buffer does
        peaks = peaks_from_keys(heat, keys, self.max_peaks, ordered=True)
        pair_score, pair_count = C.score_pairs(heat, peaks, self.descriptor, inter_threshold)
        return {"peaks": peaks, "pair_score": pair_score, "pair_count": pair_count,
                "heatmap": heat}

    def _post(self, low: torch.Tensor, nms_threshold, inter_threshold,
              eff_peaks: int) -> torch.Tensor:
        """F frames' (F, S, h, w, C) f32 low-res maps -> their (F, n) packed
        u8 rows, each laid out as one frame's row."""
        P, max_peaks = self.num_parts, self.max_peaks
        th, tw = self.target_hw
        start, gap = self.start_scale, self.scale_gap
        f = low.shape[0]
        mask_fn = nms_cuda.peak_mask_fused if self.peak_kernel else nms_cuda.peak_mask_fused_reference
        pmask = mask_fn(low[..., :P], (th, tw), start, gap, nms_threshold)  # (F, P, th, tw)
        kb = block_keys(pmask, th, tw)
        pos, valid, counts = compact_keys(kb, th * tw, max_peaks)
        # P+1 channels: the extra (background) channel feeds the reference's
        # past-the-channel refinement reads for peaks near the bottom edge,
        # within each frame
        peaks = refine_from_low(low[..., : P + 1], pos, valid, counts, (th, tw),
                                max_peaks, start, gap)
        if eff_peaks < max_peaks:
            # first-K truncation in raster order; slot 0 keeps the RAW count
            # so the host detects overflow and refetches uncapped
            peaks = peaks[:, :, : eff_peaks + 1].contiguous()
        pair_score, pair_count = C.score_pairs_lowres(
            low, peaks, self.descriptor, (th, tw), start, gap, inter_threshold)
        return torch.cat([
            peaks.reshape(f, -1).view(torch.uint8),
            pair_score.to(torch.float16).reshape(f, -1).view(torch.uint8),
            pair_count.to(torch.uint8).reshape(f, -1),
        ], dim=1)

    def _device_program(self, x: torch.Tensor, nms_threshold, inter_threshold, eff_peaks: int,
                        weights: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """F uploaded frames -> (F, n) packed u8 rows: one CNN call for all
        F*S canvases, then one post segment for all F frames.  The
        thresholds are floats or 0-d f32 tensors on the device (a graph's
        inputs); ``weights`` the net's operands."""
        return self._post(self._lowres(self._canvases(x), weights), nms_threshold,
                          inter_threshold, eff_peaks)

    def _program_weights(self) -> Dict[str, torch.Tensor]:
        """The device program's weight operands on ``self.device``: the
        net's (``Net.operands``), or a replica's copies."""
        return self.net.operands() if self._weights is None else self._weights

    def _program_key(self, eff_peaks: int, frames: int) -> tuple:
        """The key of the device program for a pass of ``frames`` frames at
        pair capacity ``eff_peaks`` (one captured graph per key)."""
        if self._direct:
            return ("direct",)
        return ("heatmap",) if self.keep_heatmap else ("packed", eff_peaks, frames)

    def _program_fn(self, eff_peaks: int, frames: int):
        """That program as fn(x, nms, inter) -> device outputs."""
        weights = self._program_weights()
        if self._direct:
            return lambda x, n, i: self._direct_program(x, n, i, weights)
        if self.keep_heatmap:
            return lambda x, n, i: self._heatmap_program(x, n, i, weights)
        prog = DeviceProgram(self, eff_peaks)
        return lambda x, n, i: {"packed": prog(x, n, i, weights)}

    def _run(self, frames: np.ndarray, nms_threshold, inter_threshold,
             eff_peaks: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """(F, *input_shape) host frames -> device outputs, not synchronized:
        a graph's replay, or the same program run eagerly (the thresholds
        then as cached device scalars)."""
        p = self.params_connect
        nms_thr = float(p.nms_threshold if nms_threshold is None else nms_threshold)
        inter_thr = float(p.inter_threshold if inter_threshold is None else inter_threshold)
        frames = np.ascontiguousarray(frames)
        eff = self.eff_peaks if eff_peaks is None else int(eff_peaks)
        if not self.cuda_graph:
            with torch.inference_mode():
                return self._program_fn(eff, frames.shape[0])(
                    torch.from_numpy(frames).to(self.device),
                    nms_cuda.threshold_scalar(nms_thr, self.device),
                    nms_cuda.threshold_scalar(inter_thr, self.device))
        key = self._program_key(eff, frames.shape[0])
        with self._graph_lock, torch.cuda.device(self.device), torch.inference_mode():
            prog = self._graphs.get(key)
            if prog is None:
                prog = self._graphs[key] = _Program(key, self._program_fn(eff, frames.shape[0]),
                                                    frames, nms_thr, inter_thr, self.device,
                                                    self._graph_pool)
            return prog.replay(frames, nms_thr, inter_thr)

    def replicate(self, device: Union[str, torch.device]) -> "PoseEstimator":
        """This estimator on another device (``parallel.inference.DevicePool``):
        the same host state and net, copies of the program's weight operands
        and constants on ``device``, its own graphs.  The operands are copied
        as they are, never remade."""
        dev = resolve_device(device)
        rep = copy.copy(self)
        rep.device = dev
        rep._weights = {k: v.to(dev) for k, v in self._program_weights().items()}
        if self._mask is not None:
            rep._mask = self._mask.to(dev)
        if self.device_rescale:
            rep._rescale = [tuple(m.to(dev) for m in pair) for pair in self._rescale]
        rep._init_runtime(False)
        return rep

    def run_device(self, net_input: np.ndarray, nms_threshold=None,
                   inter_threshold=None) -> Dict[str, torch.Tensor]:
        """net_input in :meth:`input_shape`/:attr:`input_dtype`, with a
        leading ``batch`` axis when ``batch > 1`` -> device outputs, not
        synchronized: {"packed": (n,) u8 tensor, or (batch, n)}, or with
        ``keep_heatmap`` {"peaks", "pair_score", "pair_count", "heatmap"}."""
        arr = np.asarray(net_input)
        shape = self.input_shape() if self.batch == 1 else (self.batch, *self.input_shape())
        if arr.shape != shape or arr.dtype != self.input_dtype:
            raise ValueError(f"net_input {arr.shape} {arr.dtype}: expected "
                             f"{shape} {np.dtype(self.input_dtype)}")
        out = self._run(arr if self.batch > 1 else arr[None], nms_threshold, inter_threshold)
        if self.batch == 1 and self._packed:
            out["packed"] = out["packed"][0]
        return out

    def unpack(self, packed: np.ndarray, eff: Optional[int] = None):
        """Split the single byte-packed buffer into (peaks, score, count).

        ``eff``: the peak capacity the producing pass ran with (defaults to
        the capped production pass; the overflow refetch passes max_peaks)."""
        P, M, L = self.num_parts, (eff or self.eff_peaks), self.descriptor.num_limbs
        n_peaks = P * (M + 1) * 3 * 4
        n_score = L * M * M * 2
        buf = packed.tobytes()
        peaks = np.frombuffer(buf, np.float32, P * (M + 1) * 3, 0).reshape(P, M + 1, 3)
        score = np.frombuffer(buf, np.float16, L * M * M, n_peaks).astype(np.float32).reshape(L, M, M)
        count = np.frombuffer(buf, np.uint8, L * M * M, n_peaks + n_score).astype(np.int32).reshape(L, M, M)
        return peaks, score, count

    def fetch(self, out) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device outputs of one frame -> host (peaks, pair_score, pair_count)."""
        if not self._packed:
            return tuple(out[k].cpu().numpy() for k in ("peaks", "pair_score", "pair_count"))
        if out["packed"].dim() != 1:
            raise ValueError("a batched pass: use fetch_batch")
        return self.unpack(out["packed"].cpu().numpy())

    def fetch_batch(self, out) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Batched device outputs -> one (peaks, pair_score, pair_count) per
        frame of the batch, from one device-to-host copy."""
        if not self._packed:
            raise ValueError("fetch_batch requires the packed path")
        rows = out["packed"].cpu().numpy()
        return [self.unpack(r) for r in (rows[None] if rows.ndim == 1 else rows)]

    # ---------------------------------------------- pair_cap overflow path

    def overflowed(self, peaks: np.ndarray) -> bool:
        """True when a part produced more peaks than the pair_cap pass
        transferred (slot 0 carries the RAW count; rows stop at eff_peaks).
        Such a frame must be refetched uncapped.  Never on the heatmap
        branch, which is uncapped."""
        return (self._packed and self.eff_peaks < self.max_peaks
                and float(np.max(peaks[:, 0, 0])) > self.eff_peaks)

    def refetch_full(self, net_input: np.ndarray, nms_threshold=None,
                     inter_threshold=None):
        """Overflow slow path: rerun ONE frame with the cap disabled and
        return (peaks, pair_score, pair_count) at full max_peaks.  Logged —
        capping must never be silent."""
        if self._warm_thread is not None:
            self._warm_thread.join()
            if self._warm_error is not None:
                raise RuntimeError("warm_overflow: capturing the uncapped program failed") \
                    from self._warm_error
        with self._overflow_lock:
            self._overflow_refetches += 1
            n = self._overflow_refetches
        print(f"caffe_rtpose_tpu_torch: pair_cap={self.eff_peaks} overflow -> "
              f"refetching frame at max_peaks={self.max_peaks} (#{n})", file=sys.stderr)
        out = self._run(np.asarray(net_input)[None], nms_threshold, inter_threshold,
                        eff_peaks=self.max_peaks)
        return self.unpack(out["packed"][0].cpu().numpy(), eff=self.max_peaks)

    def replayed_launches(self) -> Dict[str, int]:
        """Hand-kernel launches this estimator's graph replays made so far,
        by kernel name: each program's replays times its kernel nodes.  A
        replay makes no wrapper call, so the wrappers' counters miss these."""
        with self._graph_lock:
            progs = list(self._graphs.values())
        return {k: sum(p.replays * p.nodes[k] for p in progs) for k in kernel_calls()}

    # --------------------------------------------------------------- host

    def input_shape(self) -> Tuple[int, ...]:
        """Host-side transfer shape for ONE frame (no batch axis)."""
        if self.device_rescale:
            th0, tw0 = self._regions[0][:2]
            return (th0 * tw0 * 3,)
        if self.pack_u8:
            return (self._packed_bytes,)
        if self.input_u8:
            return (self.num_scales, self.net_h, self.net_w, 3)
        return (self.num_scales, 3, self.net_h, self.net_w)

    @property
    def input_dtype(self):
        return np.uint8 if self.input_u8 else np.float32

    def make_input(self, display_bgr: np.ndarray) -> np.ndarray:
        """Display-res BGR frame -> this estimator's transfer format."""
        if self.device_rescale:
            return preprocess.make_net_input_u8_base(display_bgr, self.net_w, self.net_h,
                                                     self.start_scale)
        make = (preprocess.make_net_input_u8_packed if self.pack_u8
                else preprocess.make_net_input_u8 if self.input_u8
                else preprocess.make_net_input)
        return make(display_bgr, self.net_w, self.net_h, self.num_scales,
                    self.start_scale, self.scale_gap)

    def estimate_from_net_input(
        self,
        net_input: np.ndarray,
        scale_xy: Tuple[float, float] = (1.0, 1.0),
        nms_threshold=None,
        params_connect: Optional[ConnectParams] = None,
    ) -> PoseResult:
        pc = params_connect or self.params_connect
        if self.batch > 1:
            # a batch-sized pass: pad the one frame to a full batch
            x = np.broadcast_to(np.asarray(net_input), (self.batch, *np.shape(net_input)))
            out = self.run_device(x, nms_threshold=nms_threshold,
                                  inter_threshold=pc.inter_threshold)
            peaks, pair_score, pair_count = self.fetch_batch(out)[0]
        else:
            out = self.run_device(net_input, nms_threshold=nms_threshold,
                                  inter_threshold=pc.inter_threshold)
            peaks, pair_score, pair_count = self.fetch(out)
        if self.overflowed(peaks):
            peaks, pair_score, pair_count = self.refetch_full(
                net_input, nms_threshold=nms_threshold,
                inter_threshold=pc.inter_threshold)
        res = C.assemble_fast(peaks, pair_score, pair_count, self.descriptor, pc, scale_xy)
        hm = out["heatmap"].cpu().numpy() if self.keep_heatmap else None
        return PoseResult(joints=res.joints, num_people=res.num_people, peaks=peaks, heatmap=hm)

    def estimate(
        self,
        frame_bgr: np.ndarray,
        disp_w: Optional[int] = None,
        disp_h: Optional[int] = None,
        **kw,
    ) -> Tuple[PoseResult, preprocess.PreprocessedFrame]:
        """Full path from a BGR frame: preprocess -> device -> assemble.
        Joint coords are scaled net->display (rtpose.cpp:1058-1060)."""
        pf = preprocess.preprocess_frame(
            frame_bgr, self.net_w, self.net_h,
            disp_w=disp_w, disp_h=disp_h,
            num_scales=self.num_scales, start_scale=self.start_scale, scale_gap=self.scale_gap,
            u8=("base" if self.device_rescale
                else "packed" if self.pack_u8 else self.input_u8),
        )
        dw = disp_w if disp_w is not None else pf.display.shape[1]
        dh = disp_h if disp_h is not None else pf.display.shape[0]
        scale_xy = (dw / float(self.net_w), dh / float(self.net_h))
        result = self.estimate_from_net_input(pf.net_input, scale_xy=scale_xy, **kw)
        return result, pf


class DeviceProgram(torch.nn.Module):
    """The realtime device program of an estimator as a module, the unit
    ``torch.export`` traces (``serving.py``) and the live estimator runs:
    (F, *input_shape) uploaded frames, the NMS and PAF thresholds as 0-d f32
    tensors (inputs, never constants: a new threshold needs no new program)
    and the net's weight operands (``Net.operands``: inputs, so a program
    holds no copy of the weights) -> (F, n) packed u8 rows at pair capacity
    ``eff_peaks``.  Runs ``_canvases -> _lowres -> _post`` without
    ``inference_mode``, which ``torch.export`` cannot trace; callers enter it
    (or ``no_grad`` to export)."""

    def __init__(self, est: "PoseEstimator", eff_peaks: int):
        super().__init__()
        self._est = est  # not a module: its net's parameters are not this module's
        self.eff_peaks = int(eff_peaks)

    def forward(self, x: torch.Tensor, nms_threshold: torch.Tensor,
                inter_threshold: torch.Tensor, weights: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._est._device_program(x, nms_threshold, inter_threshold, self.eff_peaks,
                                         weights)


def kernel_calls() -> Dict[str, int]:
    """The hand kernels' wrapper counters, by the kernel's name on the card."""
    return {"peak_mask_kernel": nms_cuda.launches,
            "upsample_peak_keys_kernel": nms_cuda.upsample_launches,
            "conv1_block_kernel": conv1_cuda.launches}


class _Program:
    """One device program captured as a CUDA graph: static inputs (the
    frames and the two thresholds as 0-d f32 device scalars), the graph and
    its static outputs.

    Capture runs the program once eagerly on a side stream first (builds
    the kernels, uploads their tables and the program's constants, lets
    cuDNN pick its algorithms), then records it with
    ``capture_error_mode="thread_local"``, so other threads may fetch and
    synchronize meanwhile.  A failed capture raises.  :meth:`replay` copies
    the frames in through a ring of pinned buffers (a buffer is reused only
    after its copy has landed), writes the thresholds, replays and returns
    clones of the outputs, so a later replay never overwrites outputs a
    caller has not fetched yet.  The owner serializes calls.  ``nodes``: the
    hand-kernel launches one replay makes (the wrapper calls of the capture;
    no other thread may call a wrapper meanwhile); ``replays``: the replays
    so far."""

    SLOTS = 4

    def __init__(self, key: tuple, fn, frames: np.ndarray, nms_thr: float, inter_thr: float,
                 device: torch.device, pool):
        host = torch.from_numpy(frames)
        self.x = torch.empty(host.shape, dtype=host.dtype, device=device)
        self.nms = torch.zeros((), dtype=torch.float32, device=device)
        self.inter = torch.zeros((), dtype=torch.float32, device=device)
        self._staging = [(torch.empty(host.shape, dtype=host.dtype).pin_memory(),
                          torch.cuda.Event()) for _ in range(self.SLOTS)]
        self._slot = 0
        self._load(frames, nms_thr, inter_thr)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(self.x, self.nms, self.inter)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = kernel_calls()
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.out = fn(self.x, self.nms, self.inter)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the {key} program failed") from e
        # a wrapper call under capture records one kernel node, and every
        # replay launches each node once
        self.nodes = {k: n - before[k] for k, n in kernel_calls().items()}
        self.replays = 0

    def _load(self, frames: np.ndarray, nms_thr: float, inter_thr: float) -> None:
        buf, landed = self._staging[self._slot]
        self._slot = (self._slot + 1) % self.SLOTS
        landed.synchronize()
        np.copyto(buf.numpy(), frames)
        self.x.copy_(buf, non_blocking=True)
        landed.record()
        self.nms.fill_(nms_thr)
        self.inter.fill_(inter_thr)

    def replay(self, frames: np.ndarray, nms_thr: float, inter_thr: float) -> Dict[str, torch.Tensor]:
        self._load(frames, nms_thr, inter_thr)
        self.graph.replay()
        self.replays += 1
        return {k: v.clone() for k, v in self.out.items()}
