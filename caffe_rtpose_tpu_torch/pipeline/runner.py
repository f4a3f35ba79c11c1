"""The realtime pipeline: frame sources -> preprocess -> device dispatch ->
fetch/assemble pool -> reorder -> display/JSON/frame outputs.

The port of ``caffe_rtpose_tpu/pipeline/runner.py``.  Thread architecture
mirrors rtcpm() (reference rtpose.cpp:1459-1549):

  producer ──input_q──> dispatcher ──inflight_q──> fetcher pool
      ──output_q──> reorder (OrderedBuffer) ──ordered_q──> writer/display

with the reference's drop policy (queue latency > 0.1 s unless
no_frame_drops, rtpose.cpp:1112-1124), per-30-frame FPS/latency reporting
(rtpose.cpp:1421-1441), and byte-identical JSON output (rtpose.cpp:1383-1416).

One dispatcher keeps the card fed because a device pass is one replay of
a captured CUDA graph (``PoseEstimator(cuda_graph=True)``, the default on
CUDA): the dispatcher's host work per pass is a copy into pinned memory and
a few calls, while the fetchers copy results out and assemble.

OpenCV (``cv2``) is optional here: the camera, the display window and
videos the port's readers refuse use it, and a pipeline that asks for one
of them without ``cv2`` raises at construction with the option's name.
JPEG, PNG and BMP directories (each file decoded by its signature, PNM
too), Motion-JPEG and MPEG-4 Part 2 videos in AVI, MP4 and QuickTime and
printf image sequences (``video.py``, frames and pixels as
``cv2.VideoCapture`` gives them), ``write_frames`` (JPEG at quality 98 by
the port's codec, ``jpeg.py``: the bytes ``cv2.imwrite`` writes) with its
text overlay (OpenCV 5's ``putText``, ``utils/text.py``), JSON output and
the headless run need no ``cv2`` (``image_io.py``,
``pose/preprocess.py``).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..pose import connect as C
from ..pose.estimator import PoseEstimator
from ..pose.preprocess import warp_to_display
from ..utils.text import FONT_HERSHEY_SIMPLEX, put_text_u8
from .image_io import read_image
from .jpeg import encode_jpeg
from .queues import BlockingQueue, OrderedBuffer
from .video import UnsupportedVideo, open_reader


def _cv2(option: str):
    """``cv2``, or a RuntimeError naming the option that needs it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{option} needs OpenCV (cv2), which is not installed") from e
    return cv2


class _Cv2Capture:
    """``cv2.VideoCapture`` behind the methods of the port's video readers."""

    def __init__(self, cv2, source, what: str):
        self._cv2, self._cap = cv2, cv2.VideoCapture(source)
        if not self._cap.isOpened():
            raise RuntimeError(f"Couldn't open {what}")
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 0.0

    def set(self, prop: str, value) -> bool:
        return self._cap.set(getattr(self._cv2, prop), value)

    def set_pos(self, frame: int) -> bool:
        return self.set("CAP_PROP_POS_FRAMES", frame)

    def read(self):
        return self._cap.read()

    def release(self) -> None:
        self._cap.release()


def open_video(path: str):
    """The ``--video`` source: through the port's readers where they take it
    (``video.open_reader``: a printf image sequence such as ``f_%03d.jpg``
    of JPEG, PNG, BMP or PNM files, or one such image; AVI, then
    MP4/QuickTime, then Matroska/WebM of Motion-JPEG, MPEG-4 Part 2 or
    H.264 Constrained Baseline, Main or High profile), cv2 or not; any other
    video or sequence through ``cv2.VideoCapture`` (behind the same
    methods), or without ``cv2`` a RuntimeError naming ``--video``, the
    file and why (its container and fourcc and any refused feature, or the
    sequence's first file and its format)."""
    try:
        return open_reader(path)
    except OSError as e:
        raise RuntimeError(f"Couldn't open video {path}") from e
    except UnsupportedVideo as e:
        try:
            import cv2
        except ImportError:
            raise RuntimeError(f"--video {e}, which is not installed") from e
        return _Cv2Capture(cv2, path, "video " + path)


@dataclass
class Frame:
    """Per-frame payload (reference include/caffe/cpm/frame.h)."""

    index: int
    video_frame_number: int
    scale: float
    ori_width: int
    ori_height: int
    display: Optional[np.ndarray] = None  # (H, W, 3) u8 BGR
    net_input: Optional[np.ndarray] = None  # the estimator's transfer format
    joints: Optional[np.ndarray] = None  # (people, parts, 3) display coords
    num_people: int = 0
    heatmap: Optional[np.ndarray] = None  # (C, H, W) resized maps (part view)
    # pipeline timestamps (frame.h:10-17)
    commit_time: float = 0.0
    preprocessed_time: float = 0.0
    gpu_fetched_time: float = 0.0
    postprocessed_time: float = 0.0
    buffered_time: float = 0.0
    displayed_time: float = 0.0
    source_path: Optional[str] = None


@dataclass
class PipelineConfig:
    """Flags mirroring rtpose.cpp:50-72."""

    video: str = ""
    camera: int = 0
    image_dir: str = ""
    resolution: Tuple[int, int] = (1280, 720)  # display W, H
    net_resolution: Tuple[int, int] = (656, 368)
    camera_resolution: Tuple[int, int] = (1280, 720)
    start_frame: int = 0
    num_devices: int = 1
    start_device: int = 0
    start_scale: float = 1.0
    scale_gap: float = 0.3
    num_scales: int = 1
    no_frame_drops: bool = False
    write_frames: str = ""
    write_json: str = ""
    no_display: bool = True
    part_to_show: int = 0
    fullscreen: bool = False
    no_text: bool = False
    frame_limit: Optional[int] = None  # extension: bound processed frames
    # extension: start with a non-default NMS threshold (the reference only
    # reaches other values through the -/= keyboard tuning, rtpose.cpp:1617)
    nms_threshold: Optional[float] = None
    # drop policy: "reference" = drop only frames already older than the
    # 0.1 s line at dispatch (rtpose.cpp:1112-1124); "predictive"
    # (extension) = additionally shed-to-newest — when the device-service
    # EMA predicts a frame would FINISH past the 0.1 s line and a fresher
    # frame is already waiting, drop it before wasting service on it
    drop_policy: str = "reference"
    fetchers: int = 4
    queue_depth: int = 8
    dispatchers: int = 1  # upload/dispatch threads
    # extension: bound the batch-fill wait — once a batch has at least one
    # frame, dispatch it after this many ms even if not full (padded), so
    # batching never adds more than this to per-frame latency when the
    # input runs slower than batch_size/frame_interval
    batch_wait_ms: Optional[float] = None


@dataclass
class UIState:
    """Runtime-tunable demo state (reference ``global.uistate`` +
    threshold globals; accessed unlocked there too, rtpose.cpp:319,441)."""

    quit: bool = False
    paused: bool = False
    fullscreen: bool = False
    googly_eyes: bool = False
    part_to_show: int = 0
    is_shift_down: bool = False
    current_frame: int = 0
    seek_to_frame: bool = False
    nms_threshold: float = 0.05
    inter_threshold: float = 0.05
    min_subset_score: float = 0.4
    min_subset_cnt: int = 3
    inter_min_above_threshold: int = 9


KEY2PART = "0123456789qwertyuiopas"


def handle_key(ui: UIState, c: int, has_video: bool) -> bool:
    """Keyboard UI (handleKey, rtpose.cpp:1551-1671).  Returns False on
    quit (ESC)."""
    if c >= 65505:  # bare shift modifier scan code: remember, no action
        ui.is_shift_down = True
        return True
    ch = chr(c) if 0 <= c < 256 else ""
    # shifted letters arrive as uppercase from waitKey; fold to lowercase
    # and treat the case as the shift state (the reference's is_shift_down
    # tracking never actually fires for letters, rtpose.cpp:1554-1560)
    if ch.isalpha() and ch.isupper():
        ui.is_shift_down = True
        ch = ch.lower()
    elif ch:
        ui.is_shift_down = False
    if c == 27:  # ESC
        ui.quit = True
        return False
    if ch == "g":
        ui.googly_eyes = not ui.googly_eyes
    if ch in ("l", "k", " "):
        if has_video and ch in ("l", "k"):
            delta = 2 if ui.is_shift_down else 30  # shift = fine seek
            ui.current_frame += delta if ch == "l" else -delta
            ui.seek_to_frame = True
        if ch == " ":
            ui.paused = not ui.paused
    if ch == "f":
        ui.fullscreen = not ui.fullscreen
    ind = KEY2PART.find(ch) if ch else -1
    if 0 <= ind <= 42:
        ui.part_to_show = ind
    if ch == "-":
        ui.nms_threshold -= 0.005
    if ch == "=":
        ui.nms_threshold += 0.005
    if ch == "_":
        ui.min_subset_score -= 0.005
    if ch == "+":
        ui.min_subset_score += 0.005
    if ch == "[":
        ui.inter_threshold -= 0.005
    if ch == "]":
        ui.inter_threshold += 0.005
    if ch == "{":
        ui.inter_min_above_threshold -= 1
    if ch == "}":
        ui.inter_min_above_threshold += 1
    if ch == ";":
        ui.min_subset_cnt -= 1
    if ch == "'":
        ui.min_subset_cnt += 1
    if ch in (",", "."):
        ui.part_to_show += 1 if ch == "." else -1
        if ui.part_to_show < 0:
            ui.part_to_show = 42
        if ui.part_to_show > 55:
            ui.part_to_show = 0
    return True


def list_image_dir(path: str) -> List[str]:
    """Sorted jpg/png/bmp listing (readImageDirIfFlagEnabled, rtpose.cpp:1737)."""
    files = [
        f for f in glob.glob(os.path.join(path, "*"))
        if os.path.splitext(f)[1].lower() in (".jpg", ".png", ".bmp")
    ]
    return sorted(files)


def frame_source(cfg: PipelineConfig, ui: Optional[UIState] = None,
                 video=None) -> Iterator[Tuple[int, np.ndarray, Optional[str]]]:
    """Yields (video_frame_number, bgr_frame, source_path).  When a UIState
    is given, honors pause and l/k seeking (getFrameFromCam, rtpose.cpp:431-461).
    ``video``: the ``--video`` file already opened by :func:`open_video`."""
    if cfg.image_dir:
        for i, p in enumerate(list_image_dir(cfg.image_dir)):
            yield i, read_image(p), p
        return
    if cfg.video:
        cap = video if video is not None else open_video(cfg.video)
        if cfg.start_frame:
            cap.set_pos(cfg.start_frame)
    else:
        cap = _Cv2Capture(_cv2("--camera"), cfg.camera, "camera %d" % cfg.camera)
        cap.set("CAP_PROP_FRAME_WIDTH", cfg.camera_resolution[0])
        cap.set("CAP_PROP_FRAME_HEIGHT", cfg.camera_resolution[1])
    # realtime pacing to the clip's native FPS (rtpose.cpp:448-461);
    # disabled for offline runs (--no_frame_drops = process every frame
    # as fast as possible)
    target_dt = 0.0
    if cfg.video and not cfg.no_frame_drops:
        target_dt = 1.0 / cap.fps if cap.fps > 0 else 0.0
    try:
        last_t = time.time()
        idx = cfg.start_frame
        while True:
            if ui is not None:
                if ui.quit:
                    break
                if cfg.video and ui.seek_to_frame:
                    idx = max(0, ui.current_frame)
                    cap.set_pos(idx)
                    ui.seek_to_frame = False
                while ui.paused and not ui.quit:
                    time.sleep(0.05)
            ok, img = cap.read()
            if not ok:
                break
            if target_dt:
                now = time.time()
                if now - last_t < target_dt:
                    time.sleep(target_dt - (now - last_t))
                last_t = time.time()
            yield idx, img, None
            idx += 1
            if ui is not None and not ui.seek_to_frame:
                ui.current_frame = idx
    finally:  # also when the consumer stops early
        cap.release()


def write_json_file(path: str, joints: np.ndarray, num_people: int, scale: float, num_parts: int) -> None:
    """Byte-layout-identical JSON writer (displayFrame, rtpose.cpp:1383-1416):
    x,y are rescaled to original coords by 1/frame.scale."""

    def fmt(v: float) -> str:
        # C++ default ostream float formatting: 6 significant digits
        return f"{v:g}"

    inv = 1.0 / scale
    with open(path, "w") as fs:
        fs.write("{\n")
        fs.write('"version":0.1,\n')
        fs.write('"bodies":[\n')
        for ip in range(num_people):
            fs.write('{\n"joints":[')
            vals = []
            for ij in range(num_parts):
                vals.append(fmt(inv * joints[ip, ij, 0]))
                vals.append(fmt(inv * joints[ip, ij, 1]))
                vals.append(fmt(joints[ip, ij, 2]))
            fs.write(",".join(vals))
            fs.write("]\n}")
            fs.write(",\n" if ip < num_people - 1 else "")
        fs.write("]\n}\n")


class RtPosePipeline:
    """End-to-end realtime runner over one device, or over ``num_devices``
    cards from ``start_device`` through ``parallel.inference.DevicePool``
    (round-robin dispatch, one replica of the program per card)."""

    def __init__(self, estimator: PoseEstimator, cfg: PipelineConfig):
        # the video opened and what needs OpenCV named before any thread starts
        self.video = open_video(cfg.video) if cfg.video else None
        if not cfg.no_display:
            _cv2("the display window (--no_display not set)")
        self.est = estimator
        self.cfg = cfg
        if cfg.num_devices > 1:
            from ..parallel.inference import DevicePool

            self.pool = DevicePool(estimator, cfg.num_devices, start_device=cfg.start_device)
        else:
            self.pool = estimator  # the same run_device/fetch interface
        self.quit = threading.Event()
        self.stats: List[Dict[str, float]] = []
        self.processed = 0
        self.dropped = 0  # frames discarded by the 0.1 s drop policy
        self._dropped_lock = threading.Lock()
        self._service_ema: Optional[float] = None  # predictive-shed input
        # optional injected source of (frame_number, bgr, path) tuples —
        # feeds synthetic frames through the production pipeline
        # (preprocess included) without video IO
        self.frame_iter: Optional[Iterator[Tuple[int, np.ndarray, Optional[str]]]] = None
        self._disp_lock = threading.Lock()
        self._disp_live = 0
        self._win_fullscreen = False
        self._warned_no_heatmap = False
        self._emit_times: List[float] = []
        self._errors: List[BaseException] = []
        pc = estimator.params_connect
        self.ui = UIState(
            part_to_show=cfg.part_to_show,
            fullscreen=cfg.fullscreen,
            nms_threshold=(pc.nms_threshold if cfg.nms_threshold is None
                           else cfg.nms_threshold),
            inter_threshold=pc.inter_threshold,
            min_subset_score=pc.min_subset_score,
            min_subset_cnt=pc.min_subset_cnt,
            inter_min_above_threshold=pc.inter_min_above_threshold,
        )
        for d in (cfg.write_frames, cfg.write_json):
            if d and not os.path.isdir(d):
                os.makedirs(d, exist_ok=True)

    # ------------------------------------------------------------ threads

    def _producer(self, input_q: BlockingQueue):
        cfg = self.cfg
        dw, dh = cfg.resolution
        count = 0
        try:
            source = (self.frame_iter if self.frame_iter is not None
                      else frame_source(cfg, self.ui, self.video))
            for vfn, img, path in source:
                if self.quit.is_set():
                    break
                if cfg.frame_limit is not None and count >= cfg.frame_limit:
                    break
                display, scale = warp_to_display(img, dw, dh)
                # transfer format is the estimator's choice (f32 canvases, u8
                # canvases, or the scale-sublinear packed u8 buffer); its
                # scale config matches cfg by construction (tools/rtpose.py)
                net_in = self.est.make_input(display)
                count += 1
                f = Frame(
                    # the reference Frame stores scale as a float (frame.h:24),
                    # and the JSON writer divides by THAT narrowed value
                    # (rtpose.cpp:1384) — keep the f32 rounding for byte parity
                    index=count, video_frame_number=vfn,
                    scale=float(np.float32(scale)),
                    ori_width=img.shape[1], ori_height=img.shape[0],
                    display=display, net_input=net_in, source_path=path,
                )
                f.commit_time = f.preprocessed_time = time.time()
                input_q.put(f)
        except Exception as e:  # noqa: BLE001 — re-raised by run()
            self._fail(e)
        finally:
            input_q.put(None)

    def _fail(self, e: BaseException) -> None:
        """Record a worker's exception for run() and stop the source."""
        self._errors.append(e)
        self.quit.set()

    def _dispatcher(self, input_q: BlockingQueue, inflight_q: BlockingQueue, reorder: OrderedBuffer):
        """Pop frames, group into estimator-batch-sized device passes.

        When the estimator was built with ``batch > 1``, each pass carries
        a stack of frames; a trailing partial batch is padded by repeating
        the last frame and the padding is discarded at fetch.
        """
        cfg = self.cfg
        B = max(1, getattr(self.est, "batch", 1))
        wait_s = (cfg.batch_wait_ms / 1e3
                  if cfg.batch_wait_ms is not None else None)
        while True:
            batch: List[Frame] = []
            done = False
            while len(batch) < B:
                if batch and wait_s is not None:
                    try:
                        f = input_q.get(timeout=wait_s)
                    except queue.Empty:
                        break  # dispatch the partial batch now
                else:
                    f = input_q.get()
                if f is None:
                    done = True
                    break
                # drop policy (rtpose.cpp:1112-1124)
                if not cfg.no_frame_drops:
                    age = time.time() - f.commit_time
                    drop = age > 0.1
                    if not drop and cfg.drop_policy == "predictive":
                        ema = self._service_ema
                        # has_real_item: the end-of-stream sentinel is not a
                        # fresher frame — never shed the final frame
                        drop = (ema is not None and age + ema > 0.1
                                and input_q.has_real_item())
                    if drop:
                        reorder.push_dropped(f.index)
                        with self._dropped_lock:  # N dispatchers share it
                            self.dropped += 1
                        continue
                batch.append(f)
            if batch and not self._errors:
                # per-frame threshold injection (NmsLayer::SetThreshold +
                # connect globals, rtpose.cpp:1145 + handleKey tuning)
                if B == 1:
                    x = batch[0].net_input
                else:
                    pad = [batch[-1].net_input] * (B - len(batch))
                    x = np.stack([f.net_input for f in batch] + pad)
                t_disp = time.time()
                try:
                    out = self.pool.run_device(
                        x,
                        nms_threshold=self.ui.nms_threshold,
                        inter_threshold=self.ui.inter_threshold,
                    )
                except Exception as e:  # noqa: BLE001 — re-raised by run()
                    self._fail(e)
                else:
                    inflight_q.put((batch, out, t_disp))
            if done:
                # wake sibling dispatchers, then signal the fetchers once
                # the last dispatcher drains (they share one counter)
                with self._disp_lock:
                    self._disp_live -= 1
                    last = self._disp_live == 0
                if not last:
                    input_q.put(None)
                else:
                    for _ in range(cfg.fetchers):
                        inflight_q.put(None)
                return

    def _fetcher(self, inflight_q: BlockingQueue, output_q: BlockingQueue):
        est = self.est
        dw, dh = self.cfg.resolution
        scale_xy = (dw / float(est.net_w), dh / float(est.net_h))
        B = max(1, getattr(est, "batch", 1))
        while True:
            item = inflight_q.get()
            if item is None:
                output_q.put(None)
                return
            if self._errors:
                continue  # drain: a failed run emits nothing more
            frames, out, t_disp = item
            try:
                self._fetch_one(est, frames, out, t_disp, B, scale_xy, output_q)
            except Exception as e:  # noqa: BLE001 — re-raised by run()
                self._fail(e)

    def _fetch_one(self, est, frames, out, t_disp, B, scale_xy, output_q):
        ui = self.ui
        pc = dataclasses.replace(
            est.params_connect,
            inter_threshold=ui.inter_threshold,
            min_subset_score=ui.min_subset_score,
            min_subset_cnt=ui.min_subset_cnt,
            inter_min_above_threshold=ui.inter_min_above_threshold,
        )
        if B == 1:
            results = [(frames[0], est.fetch(out))]
        else:
            rows = est.fetch_batch(out)  # one device-to-host copy for the batch
            results = list(zip(frames, rows))  # zip drops padding rows
        # device-service EMA for the predictive shed policy: dispatch to
        # fetch-complete, measured BEFORE assembly/output_q.put so writer
        # backpressure can't inflate the estimate and over-shed frames;
        # GIL makes the write atomic
        service = time.time() - t_disp
        ema = self._service_ema
        self._service_ema = (service if ema is None
                             else 0.7 * ema + 0.3 * service)
        heatmap = out["heatmap"].cpu().numpy() if est.keep_heatmap else None
        for f, (peaks, ps, cnt) in results:
            if est.overflowed(peaks):
                # a part exceeded the pair_cap transfer: refetch this
                # frame uncapped (logged by the estimator) so the
                # default CLI path never silently truncates peaks
                peaks, ps, cnt = est.refetch_full(
                    f.net_input,
                    nms_threshold=ui.nms_threshold,
                    inter_threshold=ui.inter_threshold,
                )
            res = C.assemble_fast(peaks, ps, cnt, est.descriptor, pc, scale_xy)
            f.joints = res.joints
            f.num_people = res.num_people
            f.heatmap = heatmap
            f.gpu_fetched_time = f.postprocessed_time = time.time()
            output_q.put(f)

    def _writer(self, output_q: BlockingQueue, reorder: OrderedBuffer):
        cfg = self.cfg
        ended = 0
        while ended < cfg.fetchers:
            f = output_q.get()
            if f is None:
                ended += 1
                continue
            if self._errors:
                continue
            try:
                for ready in reorder.push(f.index, f):
                    self._emit(ready)
            except Exception as e:  # noqa: BLE001 — re-raised by run()
                self._fail(e)
        if not self._errors:
            try:
                for ready in reorder.flush():
                    self._emit(ready)
            except Exception as e:  # noqa: BLE001 — re-raised by run()
                self._fail(e)

    def _overlay_text(self, canvas: np.ndarray, f: Frame) -> np.ndarray:
        """FPS / people-count / part-name overlay (displayFrame,
        rtpose.cpp:1317-1362), drawn as OpenCV 5's putText draws it
        (``utils/text.put_text_u8``), never through cv2."""
        canvas = np.ascontiguousarray(canvas)
        w = canvas.shape[1]
        if len(self._emit_times) >= 2:
            span = self._emit_times[-1] - self._emit_times[0]
            fps = (len(self._emit_times) - 1) / max(span, 1e-6)
        else:
            fps = 0.0
        if self.cfg.write_frames:
            label = f"{self.cfg.num_devices * 1.0 / max(fps, 1e-6):4.2f} s/gpu"
        else:
            label = f"{fps:4.1f} fps"
        put_text_u8(canvas, label, (25, 35), FONT_HERSHEY_SIMPLEX,
                    0.75, (255, 150, 150), 1)
        people = f"{f.num_people:4d}"
        put_text_u8(canvas, people, (w - 98, 37), FONT_HERSHEY_SIMPLEX,
                    0.75, (0, 0, 0), 2)
        put_text_u8(canvas, people, (w - 100, 35), FONT_HERSHEY_SIMPLEX,
                    0.75, (150, 150, 255), 2)
        p2s = self.ui.part_to_show
        if p2s != 0:
            desc = self.est.descriptor
            if p2s - 1 <= desc.num_parts:
                name = desc.part_names[p2s - 1]
            else:
                aff = (p2s - 1 - desc.num_parts - 1) * 2
                if aff == 0:
                    name = "PAFs"
                else:
                    idx = min(aff - 2 + 1 + desc.num_parts,
                              len(desc.part_names) - 1)
                    name = desc.part_names[idx].split("(")[0]
            put_text_u8(canvas, f"{name:>10s}", (w - 174, 56),
                        FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
        return canvas

    def _emit(self, f: Frame):
        cfg = self.cfg
        f.buffered_time = time.time()
        canvas = f.display
        if cfg.write_frames or not cfg.no_display:
            canvas = self._render(f)
            self._emit_times.append(time.time())
            if len(self._emit_times) > 30:
                self._emit_times.pop(0)
            if not cfg.no_text:
                canvas = self._overlay_text(canvas, f)
        if cfg.write_frames:
            name = (
                f"frame{f.video_frame_number:06d}.jpg"
                if not cfg.image_dir or f.source_path is None
                else os.path.splitext(os.path.basename(f.source_path))[0] + ".jpg"
            )
            with open(os.path.join(cfg.write_frames, name), "wb") as fo:
                fo.write(encode_jpeg(canvas, 98))
        if cfg.write_json:
            name = (
                f"frame{f.video_frame_number:06d}.json"
                if not cfg.image_dir or f.source_path is None
                else os.path.splitext(os.path.basename(f.source_path))[0] + ".json"
            )
            write_json_file(os.path.join(cfg.write_json, name), f.joints,
                            f.num_people, f.scale, self.est.num_parts)
        if not cfg.no_display:
            cv2 = _cv2("the display window (--no_display not set)")
            win = "caffe_rtpose_tpu"
            if self.ui.fullscreen != self._win_fullscreen:
                cv2.namedWindow(win, cv2.WINDOW_NORMAL)
                cv2.setWindowProperty(
                    win, cv2.WND_PROP_FULLSCREEN,
                    cv2.WINDOW_FULLSCREEN if self.ui.fullscreen else cv2.WINDOW_NORMAL)
                if not self.ui.fullscreen:
                    cv2.resizeWindow(win, *cfg.resolution)
                self._win_fullscreen = self.ui.fullscreen
            cv2.imshow(win, canvas)
            c = cv2.waitKey(1)
            if c >= 0 and not handle_key(self.ui, c, bool(cfg.video)):
                self.quit.set()
            while self.ui.paused and not self.ui.quit:
                # key polling lives here (the only waitKey site); the video
                # source also sleeps while paused and resumes on unpause
                c = cv2.waitKey(50)
                if c >= 0 and not handle_key(self.ui, c, bool(cfg.video)):
                    self.quit.set()
        f.displayed_time = time.time()
        self.processed += 1
        self.stats.append({
            "preprocess": f.preprocessed_time - f.commit_time,
            "gpu_and_assemble": f.gpu_fetched_time - f.preprocessed_time,
            "buffered": f.buffered_time - f.postprocessed_time,
            "output": f.displayed_time - f.buffered_time,
            "e2e": f.displayed_time - f.commit_time,
        })
        if self.processed % 30 == 0:
            self._report()

    def _render(self, f: Frame) -> np.ndarray:
        """Skeleton / heatmap / PAF overlay onto the display frame, on the
        estimator's device, dispatched exactly like the reference's render()
        (examples/rtpose/rtpose.cpp:271-301):

        COCO (18 parts): part_to_show 0 -> pose (googly mode included in
        the kernel, renderFunctions.cu:588); 1..18 -> single heatmap
        channel p2s-1; 19 -> all-parts overlay (heatmap2); 20 -> all 19
        PAF pairs accumulated from channel 19; 21+ -> single PAF pairs
        (channels 19, 21, ...).  MPI (15 parts): 0 -> pose, >0 -> heatmap
        channel p2s-1 (render_mpi_parts:357-380; no PAF views).
        """
        import torch

        from ..pose.descriptor import RENDER_MAX_PEOPLE
        from ..pose.render import (render_all_parts, render_heatmap, render_paf,
                                   render_pose, render_pose_mpi)

        dev = self.est.device
        P = self.est.num_parts
        googly = bool(self.ui.googly_eyes) and P == 18
        maxp = RENDER_MAX_PEOPLE
        poses = np.zeros((maxp, P, 3), np.float32)
        n = min(f.num_people, maxp)
        if n:
            poses[:n] = f.joints[:n]
        poses_t = torch.from_numpy(poses).to(dev)

        def pose_view():
            if P == 15:
                return render_pose_mpi(canvas, poses_t, n)
            return render_pose(canvas, poses_t, n, num_parts=P, googly_eyes=googly)

        with torch.inference_mode():
            canvas = torch.from_numpy(f.display.astype(np.float32)).to(dev)
            p2s = self.ui.part_to_show
            if p2s > 0 and f.heatmap is None and not self._warned_no_heatmap:
                self._warned_no_heatmap = True
                print("note: heatmap part views need the full-res maps; restart "
                      "with --part_to_show > 0 to enable them", flush=True)
            if p2s > 0 and f.heatmap is not None:
                maps = torch.from_numpy(f.heatmap).to(dev)
                if P == 15 or p2s <= P:
                    out = render_heatmap(canvas, maps, p2s - 1, num_parts=P)
                elif p2s == P + 1:  # 19: all-parts (rtpose.cpp:281 -> heatmap2)
                    out = render_all_parts(canvas, maps, num_parts=P)
                elif p2s == P + 2:  # 20: accumulated PAFs (rtpose.cpp:288-295)
                    out = render_paf(canvas, maps, P + 1, num_parts_accum=P + 1)
                else:  # 21+: single PAF pairs from channel 19
                    paf_idx = P + 1 + 2 * (p2s - P - 3)
                    if paf_idx + 1 < maps.shape[0]:
                        out = render_paf(canvas, maps, paf_idx)
                    else:  # past the last PAF pair: fall back to the pose view
                        out = pose_view()
            else:
                out = pose_view()
            return out.clamp(0, 255).to(torch.uint8).cpu().numpy()

    def _report(self):
        window = self.stats[-30:]
        avg = {k: float(np.mean([s[k] for s in window])) for k in window[0]}
        total = avg.pop("e2e", sum(avg.values()))
        print(
            f"Frames processed {self.processed} | "
            + " | ".join(f"{k} {v*1000:.1f}ms" for k, v in avg.items())
            + f" | total {total*1000:.1f}ms"
        )

    # --------------------------------------------------------------- run

    def run(self) -> int:
        cfg = self.cfg
        if self.frame_iter is None and not cfg.image_dir and not cfg.video:
            _cv2("--camera")
        # warm up (build the kernels, capture the graph) before any frame
        # enters the pipeline, like the reference's warmup() dry-run
        # Forward (rtpose.cpp:233-236) — otherwise the first capture trips
        # the 0.1 s drop policy
        B = max(1, getattr(self.est, "batch", 1))
        shape = self.est.input_shape()
        if B > 1:
            shape = (B,) + shape
        dummy = np.zeros(shape, self.est.input_dtype)
        fetch1 = self.est.fetch_batch if B > 1 else self.est.fetch
        if cfg.num_devices > 1:
            for i in range(cfg.num_devices):  # one pass a card: each captures its graph
                fetch1(self.pool.run_device(dummy, device_index=i))
        else:
            fetch1(self.pool.run_device(dummy))
        input_q = BlockingQueue(maxsize=max(10, B * cfg.dispatchers))  # backpressure (rtpose.cpp:424-430)
        inflight_q = BlockingQueue(maxsize=cfg.queue_depth)
        output_q = BlockingQueue()
        reorder = OrderedBuffer()

        self._disp_live = max(1, cfg.dispatchers)
        threads = [
            threading.Thread(target=self._producer, args=(input_q,), name="producer"),
        ] + [
            threading.Thread(target=self._dispatcher, args=(input_q, inflight_q, reorder), name=f"dispatch{i}")
            for i in range(max(1, cfg.dispatchers))
        ]
        threads += [
            threading.Thread(target=self._fetcher, args=(inflight_q, output_q), name=f"fetch{i}")
            for i in range(cfg.fetchers)
        ]
        writer = threading.Thread(target=self._writer, args=(output_q, reorder), name="writer")
        t0 = time.time()
        for t in threads:
            t.start()
        writer.start()
        for t in threads:
            t.join()
        writer.join()
        if self._errors:
            raise RuntimeError("the pipeline stopped on an error") from self._errors[0]
        dt = time.time() - t0
        self.wall_s = dt  # excludes warmup/capture (t0 is post-warmup)
        self.fps = self.processed / dt if dt > 0 else 0.0
        if self.processed:
            print(f"Processed {self.processed} frames in {dt:.2f}s ({self.fps:.2f} FPS)")
        return self.processed
