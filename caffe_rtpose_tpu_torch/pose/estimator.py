"""PoseEstimator: the inference paths in PyTorch.

Counterpart of ``caffe_rtpose_tpu/pose/estimator.py``.  One device pass per
frame, in one of two branches:

* realtime (default): u8 upload and on-device normalize -> the deploy CNN up
  to the low-res ``concat_stage7`` -> the fused upsample + peak mask (the
  hand-written CUDA kernel ``nms_cuda.peak_mask_fused`` on the card) ->
  raster-order compaction -> 7x7 refinement and PAF pair scoring, both read
  from the low-res maps -> one byte-packed output buffer (f32 peaks | f16
  scores | u8 counts);
* ``keep_heatmap=True``: f32 Caffe-layout input -> the same CNN -> the
  full-res upsample of all channels written out, with the part channels'
  peak keys (the hand-written CUDA kernel ``nms_cuda.upsample_peak_keys``)
  -> compaction and refinement gathered from the full-res maps
  (``nms.peaks_from_keys``) -> pair scoring on them (``connect.score_pairs``)
  -> peaks, pair scores, pair counts and the (C, H, W) heatmap, unpacked.
  This is the JAX branch that runs the ImResize and Nms layers; the heatmap
  feeds the render views of ``pose/render.py``.

Only the greedy assembly runs on the host.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.net import Net
from ..ops import nms_cuda
from ..ops.nms import block_keys, compact_keys, peaks_from_keys, refine_from_low
from ..utils.device import resolve_device
from . import connect as C
from .descriptor import ConnectParams, ModelDescriptor, for_num_parts


@dataclass
class PoseResult:
    joints: np.ndarray  # (num_people, num_parts, 3) in display coords
    num_people: int
    peaks: np.ndarray  # (num_parts, max_peaks+1, 3) net coords
    heatmap: Optional[np.ndarray] = None  # (C, H, W) resized maps with keep_heatmap


class PoseEstimator:
    """Build from a deploy NetParameter dict and ``{layer: [OIHW, bias]}``
    numpy weights.

    Mirrors warmup() (rtpose.cpp:173-237): reshape input to
    (num_scales, 3, net_h, net_w), inject start_scale/scale_gap into the
    ImResize layer, and select the model descriptor from the Nms layer's
    num_parts.

    On CUDA the estimator turns TF32 off for cuDNN convolutions and for
    matmuls (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``, process-wide), because the
    JAX reference computes every matmul at ``Precision.HIGHEST`` and the
    outputs are held to it at f32 tolerances.

    ``peak_kernel``: run the upsample + peak stage in the hand-written CUDA
    kernel of the branch (default on CUDA) or its plain PyTorch version.  On
    the CPU the plain version always runs.

    ``keep_heatmap``: the heatmap branch (module docstring).  As in JAX it
    forces ``input_u8`` off, ignores ``pair_cap`` (outputs are unpacked at
    full ``max_peaks``) and refuses ``batch > 1``.

    Not ported yet, and refused with ``NotImplementedError`` rather than
    ignored: ``pack_u8=True``, ``device_rescale``, ``batch > 1``, dtypes
    other than float32, ``warm_overflow`` and file paths for
    ``proto``/``weights``.  ``pack_u8=None`` means False here (the JAX
    estimator defaults to True for multi-scale u8 input).
    """

    def __init__(
        self,
        proto: Mapping[str, Any],
        weights: Optional[Mapping[str, Sequence[np.ndarray]]] = None,
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
    ):
        """``pair_cap``: transfer pair scores only for the first K peaks per
        part (raster order — identical to the reference for frames with
        <= K peaks/part).  Slot 0 of each part keeps the raw count, so a
        frame with more peaks is detected and refetched uncapped."""
        for flag, name in ((pack_u8, "pack_u8"), (device_rescale, "device_rescale"),
                           (warm_overflow, "warm_overflow")):
            if flag:
                raise NotImplementedError(f"{name} is not ported yet")
        if int(batch) != 1:
            raise NotImplementedError("batch > 1 is not ported yet")
        if dtype != torch.float32:
            raise NotImplementedError("only float32 is ported")
        if not isinstance(proto, Mapping):
            raise NotImplementedError("proto must be a NetParameter dict (file paths are not ported)")
        if weights is not None and not isinstance(weights, Mapping):
            raise NotImplementedError("weights must be a {layer: [arrays]} dict (file paths are not ported)")

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.peak_kernel = (self.device.type == "cuda") if peak_kernel is None else bool(peak_kernel)
        net_w, net_h = net_resolution
        self.net_w, self.net_h = net_w, net_h
        self.num_scales = num_scales
        self.start_scale = start_scale
        self.scale_gap = scale_gap
        self.keep_heatmap = bool(keep_heatmap)
        self.input_u8 = bool(input_u8) and not self.keep_heatmap
        self._pair_cap = pair_cap

        self.net = Net(
            proto,
            input_shapes={"image": (num_scales, 3, net_h, net_w)},
            overrides={"resize": {"imresize_param.start_scale": start_scale,
                                  "imresize_param.scale_gap": scale_gap}},
            device=self.device,
            dtype=dtype,
            seed=seed,
        )
        if weights is not None:
            self.net.load_weights(weights)

        nms = self.net.post_layers.get("nms")
        if nms is None:
            raise ValueError("deploy net has no 'nms' layer")
        resize = self.net.post_layers.get("resize")
        if resize is None:
            raise NotImplementedError("nets without a 'resize' ImResize layer are not ported")
        self.num_parts = int(nms.param.get("num_parts", 15))
        self.max_peaks = int(nms.param.get("max_peaks", 20))
        if self._pair_cap is not None and int(self._pair_cap) < 1:
            raise ValueError("pair_cap must be a positive peak count")
        self.eff_peaks = (min(int(self._pair_cap), self.max_peaks)
                          if self._pair_cap else self.max_peaks)
        self.descriptor: ModelDescriptor = for_num_parts(self.num_parts)
        self.params_connect: ConnectParams = self.descriptor.defaults

        self.lowres_blob = resize.bottoms[0]
        _, _, h, w = self.net.blob_shapes[self.lowres_blob]
        factor = float(resize.param.get("factor", 0.0))
        if factor > 0:
            self.target_hw = (int(h * factor), int(w * factor))
        else:
            self.target_hw = (int(resize.param.get("target_spatial_height", 368)),
                              int(resize.param.get("target_spatial_width", 368)))
        self._layers = self.net.prune_for([self.lowres_blob])
        self._mask: Optional[torch.Tensor] = None
        if self.input_u8:
            from .preprocess import region_boxes

            mask = np.zeros((num_scales, net_h, net_w, 1), np.float32)
            for i, (y0, y1, x0, x1) in enumerate(
                    region_boxes(net_w, net_h, num_scales, start_scale, scale_gap)):
                mask[i, y0:y1, x0:x1] = 1.0
            self._mask = torch.from_numpy(mask).to(self.device)
        self._overflow_lock = threading.Lock()
        self._overflow_refetches = 0

    # ------------------------------------------------------------- device

    def _lowres(self, x: torch.Tensor) -> torch.Tensor:
        """(S, 3, H, W) net input -> the low-res ``concat_stage7`` maps as an
        (S, h, w, C) NHWC view of the channels_last blob."""
        low = self.net({"image": x}, outputs=[self.lowres_blob], layers=self._layers)
        return low[self.lowres_blob].permute(0, 2, 3, 1)

    @torch.inference_mode()
    def _heatmap_program(self, image: torch.Tensor, nms_threshold: float,
                         inter_threshold: float) -> Dict[str, torch.Tensor]:
        """One frame on the device through the full-res maps -> peaks, pair
        scores, pair counts and the (C, th, tw) heatmap."""
        low = self._lowres(image)
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

    @torch.inference_mode()
    def _device_program(self, image: torch.Tensor, nms_threshold: float,
                        inter_threshold: float, eff_peaks: int) -> torch.Tensor:
        """One frame on the device -> the packed u8 output buffer."""
        if self.input_u8:
            # exact process_and_pad_image normalize: u8/256 - 0.5 in the
            # image region, 0 in the padding (rtpose.cpp:258-263); the
            # (S, H, W, 3) canvases permute to channels_last NCHW for free
            xf = image.to(torch.float32) / 256.0 - 0.5
            x = (xf * self._mask).permute(0, 3, 1, 2)
        else:
            x = image
        low = self._lowres(x)
        P, max_peaks = self.num_parts, self.max_peaks
        th, tw = self.target_hw
        start, gap = self.start_scale, self.scale_gap
        mask_fn = nms_cuda.peak_mask_fused if self.peak_kernel else nms_cuda.peak_mask_fused_reference
        pmask = mask_fn(low[..., :P], (th, tw), start, gap, nms_threshold)
        kb = block_keys(pmask, th, tw)
        pos, valid, counts = compact_keys(kb, th * tw, max_peaks)
        # P+1 channels: the extra (background) channel feeds the reference's
        # past-the-channel refinement reads for peaks near the bottom edge
        peaks = refine_from_low(low[..., : P + 1], pos, valid, counts, (th, tw),
                                max_peaks, start, gap)
        if eff_peaks < max_peaks:
            # first-K truncation in raster order; slot 0 keeps the RAW count
            # so the host detects overflow and refetches uncapped
            peaks = peaks[:, : eff_peaks + 1].contiguous()
        pair_score, pair_count = C.score_pairs_lowres(
            low, peaks, self.descriptor, (th, tw), start, gap, inter_threshold)
        return torch.cat([
            peaks.reshape(-1).view(torch.uint8),
            pair_score.to(torch.float16).reshape(-1).view(torch.uint8),
            pair_count.to(torch.uint8).reshape(-1),
        ])

    def run_device(self, net_input: np.ndarray, nms_threshold=None, inter_threshold=None,
                   _eff_peaks: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """net_input in :meth:`input_shape`/:attr:`input_dtype` -> device
        outputs, not synchronized: {"packed": u8 tensor}, or with
        ``keep_heatmap`` {"peaks", "pair_score", "pair_count", "heatmap"}."""
        arr = np.ascontiguousarray(net_input)
        if arr.shape != self.input_shape() or arr.dtype != self.input_dtype:
            raise ValueError(f"net_input {arr.shape} {arr.dtype}: expected "
                             f"{self.input_shape()} {np.dtype(self.input_dtype)}")
        p = self.params_connect
        nms_thr = float(p.nms_threshold if nms_threshold is None else nms_threshold)
        inter_thr = float(p.inter_threshold if inter_threshold is None else inter_threshold)
        x = torch.from_numpy(arr).to(self.device)
        if self.keep_heatmap:
            return self._heatmap_program(x, nms_thr, inter_thr)
        eff = self.eff_peaks if _eff_peaks is None else int(_eff_peaks)
        return {"packed": self._device_program(x, nms_thr, inter_thr, eff)}

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
        """Device outputs -> host (peaks, pair_score, pair_count)."""
        if self.keep_heatmap:
            return tuple(out[k].cpu().numpy() for k in ("peaks", "pair_score", "pair_count"))
        return self.unpack(out["packed"].cpu().numpy())

    # ---------------------------------------------- pair_cap overflow path

    def overflowed(self, peaks: np.ndarray) -> bool:
        """True when a part produced more peaks than the pair_cap pass
        transferred (slot 0 carries the RAW count; rows stop at eff_peaks).
        Such a frame must be refetched uncapped.  Never on the heatmap
        branch, which is uncapped."""
        return (not self.keep_heatmap and self.eff_peaks < self.max_peaks
                and float(np.max(peaks[:, 0, 0])) > self.eff_peaks)

    def refetch_full(self, net_input: np.ndarray, nms_threshold=None,
                     inter_threshold=None):
        """Overflow slow path: rerun ONE frame with the cap disabled and
        return (peaks, pair_score, pair_count) at full max_peaks.  Logged —
        capping must never be silent."""
        with self._overflow_lock:
            self._overflow_refetches += 1
            n = self._overflow_refetches
        print(f"caffe_rtpose_tpu_torch: pair_cap={self.eff_peaks} overflow -> "
              f"refetching frame at max_peaks={self.max_peaks} (#{n})", file=sys.stderr)
        out = self.run_device(net_input, nms_threshold, inter_threshold,
                              _eff_peaks=self.max_peaks)
        return self.unpack(out["packed"].cpu().numpy(), eff=self.max_peaks)

    # --------------------------------------------------------------- host

    def input_shape(self) -> Tuple[int, ...]:
        """Host-side transfer shape for ONE frame."""
        if self.input_u8:
            return (self.num_scales, self.net_h, self.net_w, 3)
        return (self.num_scales, 3, self.net_h, self.net_w)

    @property
    def input_dtype(self):
        return np.uint8 if self.input_u8 else np.float32

    def make_input(self, display_bgr: np.ndarray) -> np.ndarray:
        """Display-res BGR frame -> this estimator's transfer format (needs
        OpenCV for the per-scale resize)."""
        from .preprocess import make_net_input, make_net_input_u8

        make = make_net_input_u8 if self.input_u8 else make_net_input
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
