"""PoseEstimator: the inference paths in PyTorch.

Counterpart of ``caffe_rtpose_tpu/pose/estimator.py``.  One device pass per
batch of frames, in one of two branches:

* realtime (default): u8 upload (whole canvases, or with ``pack_u8`` only
  each scale's live region) and on-device normalize -> the deploy CNN up to
  the low-res ``concat_stage7``, all ``batch x num_scales`` canvases in one
  call (in bf16 its conv1 block through the hand-written CUDA kernel
  ``conv1_cuda.conv1_block``) -> per frame: the fused upsample + peak mask
  (the hand-written CUDA kernel ``nms_cuda.peak_mask_fused`` on the card) ->
  raster-order compaction -> 7x7 refinement and PAF pair scoring, both read
  from the low-res maps -> one byte-packed output row per frame (f32 peaks |
  f16 scores | u8 counts);
* ``keep_heatmap=True``: f32 Caffe-layout input -> the same CNN -> the
  full-res upsample of all channels written out, with the part channels'
  peak keys (the hand-written CUDA kernel ``nms_cuda.upsample_peak_keys``)
  -> compaction and refinement gathered from the full-res maps
  (``nms.peaks_from_keys``) -> pair scoring on them (``connect.score_pairs``)
  -> peaks, pair scores, pair counts and the (C, H, W) heatmap, unpacked.
  This is the JAX branch that runs the ImResize and Nms layers; the heatmap
  feeds the render views of ``pose/render.py``.

In bf16 the low-res maps are cast to f32 once, before the post segment, as
every consumer of them in the JAX package does.  Only the greedy assembly
runs on the host.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.net import Net
from ..ops import nms_cuda
from ..ops.nms import block_keys, compact_keys, peaks_from_keys, refine_from_low
from ..utils.device import resolve_device
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

    Not ported yet, and refused with ``NotImplementedError`` rather than
    ignored: ``device_rescale``, ``warm_overflow`` and file paths for
    ``proto``/``weights``.
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
        conv1_kernel: Optional[bool] = None,
    ):
        """``pair_cap``: transfer pair scores only for the first K peaks per
        part (raster order — identical to the reference for frames with
        <= K peaks/part).  Slot 0 of each part keeps the raw count, so a
        frame with more peaks is detected and refetched uncapped."""
        for flag, name in ((device_rescale, "device_rescale"), (warm_overflow, "warm_overflow")):
            if flag:
                raise NotImplementedError(f"{name} is not ported yet")
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
        if pack_u8 is None:
            pack_u8 = self.input_u8 and num_scales > 1
        self.pack_u8 = bool(pack_u8) and self.input_u8
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError("batch must be a positive frame count")
        if self.batch > 1 and self.keep_heatmap:
            raise ValueError("batch > 1 requires the packed path (keep_heatmap=False)")
        self._pair_cap = pair_cap

        self.net = Net(
            proto,
            input_shapes={"image": (num_scales, 3, net_h, net_w)},
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
        if self.pack_u8:
            self._regions, self._packed_bytes = preprocess.packed_regions(
                net_w, net_h, num_scales, start_scale, scale_gap)
        elif self.input_u8:
            mask = np.zeros((num_scales, net_h, net_w, 1), np.float32)
            for i, (y0, y1, x0, x1) in enumerate(
                    preprocess.region_boxes(net_w, net_h, num_scales, start_scale, scale_gap)):
                mask[i, y0:y1, x0:x1] = 1.0
            self._mask = torch.from_numpy(mask).to(self.device)
        self._overflow_lock = threading.Lock()
        self._overflow_refetches = 0

    # ------------------------------------------------------------- device

    def _canvases(self, x: torch.Tensor) -> torch.Tensor:
        """(F, *input_shape) uploaded frames -> the (F*S, 3, H, W) net input
        in the net's dtype, a channels_last view where the input is u8."""
        S, H, W = self.num_scales, self.net_h, self.net_w
        f = x.shape[0]
        if self.pack_u8:
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

    def _lowres(self, x: torch.Tensor) -> torch.Tensor:
        """(F*S, 3, H, W) net input -> the low-res ``concat_stage7`` maps as
        (F, S, h, w, C) f32 NHWC (a view of the channels_last blob in f32;
        cast once in bf16)."""
        low = self.net({"image": x}, outputs=[self.lowres_blob], layers=self._layers)
        low = low[self.lowres_blob].permute(0, 2, 3, 1).to(torch.float32)
        return low.reshape(-1, self.num_scales, *low.shape[1:])

    @torch.inference_mode()
    def _heatmap_program(self, x: torch.Tensor, nms_threshold: float,
                         inter_threshold: float) -> Dict[str, torch.Tensor]:
        """One uploaded frame (1, S, 3, H, W) -> :meth:`_heatmap_post` of
        its low-res maps."""
        return self._heatmap_post(self._lowres(self._canvases(x))[0], nms_threshold,
                                  inter_threshold)

    def _heatmap_post(self, low: torch.Tensor, nms_threshold: float,
                      inter_threshold: float) -> Dict[str, torch.Tensor]:
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

    def _post(self, low: torch.Tensor, nms_threshold: float, inter_threshold: float,
              eff_peaks: int) -> torch.Tensor:
        """One frame's (S, h, w, C) f32 low-res maps -> its packed u8 row."""
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

    @torch.inference_mode()
    def _device_program(self, x: torch.Tensor, nms_threshold: float,
                        inter_threshold: float, eff_peaks: int) -> torch.Tensor:
        """F uploaded frames -> (F, n) packed u8 rows: one CNN call for all
        F*S canvases, then the post segment frame by frame."""
        low = self._lowres(self._canvases(x))
        return torch.stack([self._post(l, nms_threshold, inter_threshold, eff_peaks)
                            for l in low])

    def _run(self, frames: np.ndarray, nms_threshold, inter_threshold,
             eff_peaks: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """(F, *input_shape) host frames -> device outputs, not synchronized."""
        p = self.params_connect
        nms_thr = float(p.nms_threshold if nms_threshold is None else nms_threshold)
        inter_thr = float(p.inter_threshold if inter_threshold is None else inter_threshold)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        if self.keep_heatmap:
            return self._heatmap_program(x, nms_thr, inter_thr)
        eff = self.eff_peaks if eff_peaks is None else int(eff_peaks)
        return {"packed": self._device_program(x, nms_thr, inter_thr, eff)}

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
        if self.batch == 1 and not self.keep_heatmap:
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
        if self.keep_heatmap:
            return tuple(out[k].cpu().numpy() for k in ("peaks", "pair_score", "pair_count"))
        if out["packed"].dim() != 1:
            raise ValueError("a batched pass: use fetch_batch")
        return self.unpack(out["packed"].cpu().numpy())

    def fetch_batch(self, out) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Batched device outputs -> one (peaks, pair_score, pair_count) per
        frame of the batch, from one device-to-host copy."""
        if self.keep_heatmap:
            raise ValueError("fetch_batch requires the packed path")
        rows = out["packed"].cpu().numpy()
        return [self.unpack(r) for r in (rows[None] if rows.ndim == 1 else rows)]

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
        out = self._run(np.asarray(net_input)[None], nms_threshold, inter_threshold,
                        eff_peaks=self.max_peaks)
        return self.unpack(out["packed"][0].cpu().numpy(), eff=self.max_peaks)

    # --------------------------------------------------------------- host

    def input_shape(self) -> Tuple[int, ...]:
        """Host-side transfer shape for ONE frame (no batch axis)."""
        if self.pack_u8:
            return (self._packed_bytes,)
        if self.input_u8:
            return (self.num_scales, self.net_h, self.net_w, 3)
        return (self.num_scales, 3, self.net_h, self.net_w)

    @property
    def input_dtype(self):
        return np.uint8 if self.input_u8 else np.float32

    def make_input(self, display_bgr: np.ndarray) -> np.ndarray:
        """Display-res BGR frame -> this estimator's transfer format (needs
        OpenCV for the per-scale resize)."""
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
