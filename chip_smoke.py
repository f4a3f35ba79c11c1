#!/usr/bin/env python3
"""Smoke test of the PyTorch port (caffe_rtpose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. device    - the card's name and power limit (nvidia-smi), torch/CUDA
               versions and the nvcc path; refuses to run without CUDA.
2. build     - builds the CUDA kernels from csrc/ with nvcc.
   jpeg      - the port's host JPEG codec (csrc/jpeg_codec.cpp) built with
               g++: the sha256 of its q95 encode of three seeded frames
               (tests/jpeg_frames.py) and of their decodes equal to the
               digests tests/test_torch_jpeg.py holds against cv2; decode
               and encode host ms (median of 20) of a 1280x720 and a 640x480
               q95 4:2:0 frame.
   imgproc   - OpenCV's u8 image operations in numpy (utils/imgproc.py), cv2
               blocked: the sha256 of BGR->Lab and Lab->BGR over the whole
               2^24 cube, of the CLAHE, cv2.line and INTER_LINEAR case sets,
               of the synthetic source's first images and of do_clahe's step
               on two frames equal to the digests tests/test_torch_imgproc.py
               holds against cv2 (tests/imgproc_cases.py); host ms of
               transformer.clahe at 368x368 and 1280x720, the cube each
               way, SyntheticPoseSource[i] at 368, and one
               pose_batches_jointfeed batch (10 at crop 368) with do_clahe
               on and off; the hand kernels' counters read 0 after it.
   text      - rtpose's text overlay without OpenCV (utils/text.py, cv2
               blocked): the font's parse ms, the glyph rasteriser's g++
               build (csrc/glyph_raster.cpp), the sha256 of every putText
               case group (tests/text_cases.py) equal to the digests
               tests/test_torch_text.py holds against cv2.putText, and the
               pipeline's _overlay_text on a 1280x720 frame: first call and
               the median ms of 50; the hand kernels' counters read 0.
   video     - the port's video readers (pipeline/video.py, bmff.py,
               mpeg4.py), cv2 blocked: every crafted Motion-JPEG AVI of
               tests/avi_cases.py written around the port's q95 JPEGs, then
               the clips of tests/mp4_cases.py that cv2's writers wrote
               (MPEG-4 Part 2 in MP4, QuickTime, XVID and DIVX AVI;
               Motion-JPEG in QuickTime; tests/data) and its crafted MP4
               layouts, read through runner.frame_source: frame count, fps,
               the frames read from the start, after each start_frame and
               after each ui seek, and the sha256 of the decoded frames
               equal to the results tests/test_torch_video.py and
               tests/test_torch_mp4.py pin against the JAX package's reader
               (cv2.VideoCapture, FFMPEG; Motion-JPEG frames in FFmpeg's
               arithmetic, each frame identified by equality); then each
               printf image sequence of tests/sequence_cases.py (PNG,
               JPEG, BMP, PPM, PGM; %d, %0Nd, %%; first numbers 0-4, a
               gap, 40 frames, one image) against the pins
               tests/test_torch_sequence.py holds (FFMPEG's image2); the
               MPEG-4 decoder's g++ build time (csrc/mpeg4_video.cpp);
               then each H.264 stream of tests/h264_cases.py (written
               from seeds there: Constrained Baseline, Main and High
               profile, CAVLC and CABAC, weighted P, B slices (spatial and
               temporal direct, explicit and implicit weighted
               bi-prediction, reference B pictures, open GOPs), the 8x8
               transform, Intra8x8, scaling matrices and two chroma QP
               offsets, MP4 with and without ctts and elst, QuickTime,
               AVI, avc3, POC types 0 and 2, both ranges, cropped sizes,
               output delay, streams that start on a non-IDR picture) and
               its committed 1280x720 clips tests/data/h264_720p.mp4
               (CAVLC), h264_cabac_720p.mp4 (the same frames in CABAC),
               h264_b_720p.mp4 (I P B B in CABAC) and h264_high_720p.mp4
               (I P B B in CABAC under High profile, the 8x8 transform
               on) against the pins tests/test_torch_h264.py and
               tests/test_torch_h264_high.py hold (cv2's frames, bit for
               bit), each refused stream raising UnsupportedVideo naming
               its feature; the H.264 decoder's g++ build time
               (csrc/h264_video.cpp) and host ms a frame of each 720p
               clip's container read and H.264 decode apart (median of
               24, the clips in turns);
               host ms (median of 20, in turns) of a 1280x720 q95 4:2:0
               frame through the Motion-JPEG decoder (FFmpeg's arithmetic)
               and through decode_jpeg (libjpeg's); the hand kernels'
               counters read 0.
   formats   - BMP and PNM without OpenCV (pipeline/image_io.py, cv2
               blocked): the sha256 of read_image's colour and gray arrays
               of every crafted BMP layout and PNM file of
               tests/image_cases.py, and of the Datum bytes
               (image_to_datum "bmp", "pbm", "pgm", "ppm", "pnm") and
               decodes (datum_to_image) of its images, equal to the
               digests tests/test_torch_image_io.py holds against
               cv2.imread/imencode/imdecode; the hand kernels' counters
               read 0.
3. kernels   - each hand-written kernel against its plain PyTorch version on
               the card, at the estimators' shapes (COCO 1 and 3 scales, MPI,
               small and ragged), at the estimator's input (the 18-channel
               slice view of a 57-channel NHWC map, at 1 and 3 scales), with
               a channel stride other than 1 and with 16-byte window loads:
               * peak_mask_fused: masks equal except at near-ties;
               * upsample_peak_keys (57 channels, keys for 18; MPI 44 and
                 15): heat within 1e-5*max(1,|U|), keys equal except at
                 near-ties; its keys' mask bit for bit K1's on the same
                 low[..., :kc] at COCO 1 and 3 scales, MPI and ragged; a
                 101x134 target takes its direct store path (a row of 134
                 f32 is no multiple of 16 bytes), every other case its TMA
                 bulk stores.
               A near-tie is a pixel where |U-thr| or |U-max8| <=
               1e-5*max(1,|U|), with U the plain version's upsample there.
               K1 also with a frame axis: 8 frames of the estimator's
               (F*S, 57, h, w) channels_last blob sliced to 18 channels, in
               one launch, against the plain version frame by frame.
               Timed at the main path's shapes (K1 on the slice view at 1 and
               3 scales and on 8 frames, K3 at COCO 1 and 3 scales and MPI):
               kernel_ms, the kernel's own device
               time from torch.profiler by kernel name over 20 launches,
               measured after the last slice phase (a profiling window
               slows the host's launches for the rest of the process);
               call_ms, one wrapper call between CUDA events (medians of 20,
               in the order plain, kernel, kernel, plain); bound_ms, the
               larger of the bytes the function must move over 3.35 TB/s and
               its f32 operations over 67 TFLOP/s; bound_share =
               bound_ms / kernel_ms.
   Then, with the 1-scale slice's calibrated weights (below):
   graph     - each device program as a captured CUDA graph (the
               estimators' default on CUDA) against the same program run
               eagerly on the same estimator, at two NMS thresholds set
               between replays: f32 1 scale, bf16 batch 8, the f32 heatmap
               branch; outputs within 1e-4 (and whether bit-identical),
               a lower threshold finds more peaks, device and end-to-end
               ms/frame of both; kernels per replay from torch.profiler
               (checked against 1 K1 / 1 K1 + 1 K4 / 1 K3: the bf16 batch-8
               pass runs one post segment over its 8 frames), measured after
               the pipeline and cli phases.
   preprocess- host ms of the OpenCV-free preprocess: 1280x720 -> 656x368,
               and 1920x1080 warped to 1280x720 first.
   pipeline  - the main path: RtPosePipeline at bf16 batch 8, no frame
               drops, 16 synthetic 1280x720 frames (8 through frame_iter, 8
               as PNG files the script encodes with zlib, the same 8 as q95
               JPEG files, cv2 blocked), each frame's JSON equal to
               estimate() on the same frame (a JPEG's as read_image reads
               it); the kernel
               wrappers' counters zeroed before its estimator exists and
               read after (the eager pass and the capture; the card runs
               the replays); then 64 frames through frame_iter, as PNG
               files and as JPEG files, for FPS and per-stage ms, and the
               producer thread's work a frame (read, warp_to_display,
               make_input) timed alone for each source.
   files     - the model files of the main path: the COCO deploy prototxt
               (proto.prototxt.dump_file) and the calibrated weights as a
               caffemodel (Net.save_caffemodel, ~209 MB), in a temporary
               directory; the bf16 batch-8 u8 estimator built from those
               paths, its packed outputs bit-identical to the one built
               from the dicts on 16 frames; the time to write and to load
               the files (host parse alone, and the estimator's build).
   hdf5      - the port's HDF5 codec (utils/hdf5_fmt.py, utils/hdf5.py), h5py
               blocked: every file libhdf5 wrote in tests/hdf5_fixtures/
               read equal to its pinned digests, each refused feature
               named; save_hdf5 of the COCO deploy net with those weights
               and load_hdf5 into a fresh net on the card, every blob equal
               to the caffemodel's bit for bit (write, read and load MB/s);
               the tools phase's 512 PNGs through convert_imageset at
               227x227 into a gzip .h5 pack and into a kvdb, the two means
               equal, HDF5Data's host ms a batch of 256, CaffeNet's TRAIN
               net fed by HDF5Data 3 SGD steps with losses equal to a
               MemoryData net's on the same arrays; HDF5Output of fc7 and
               prob over 8 CaffeNet deploy forwards on the card, read back
               equal; detect into an .h5 equal to api.Detector's; a
               store2hdf5-style matcaffe script (h5create with Inf and
               ChunkSize, h5write at a start, h5read, h5info, h5disp).
               The HDF5 solverstates: the train phase's resume.
   cli       - tools.rtpose.main with those --caffeproto and --caffemodel
               files on 8 PNG frames (the calibration canvases, displayed
               at their 656x368), exit 0, no fallback warning, one JSON
               file a frame, the overflow refetch count printed; then the
               same on those canvases upscaled to 1280x720 (resize_area),
               which the CLI downscales to the net; then those 1280x720
               frames as q95 JPEGs with --write_frames --no_text, cv2
               blocked: every JSON equal to estimate() on read_image of its
               JPEG, every frame written the bytes encode_jpeg gives at q98
               for its canvas and decoding within JPEG_Q98_PSNR of it, the
               hand-kernel launches equal to the PNG run's; the same JPEG
               run on the 656x368 canvases; and the 1280x720 JPEG run
               once more without --no_text, cv2 blocked: the text overlay
               drawn on every frame, the same checks and launches.  Then
               rtpose --video on those 8 JPEGs wrapped into a Motion-JPEG
               AVI (tests/avi_cases.write_avi, OpenCV's writer's layout, 25
               fps) and as a printf sequence (seq/f_%03d.jpg),
               --no_frame_drops --write_json, cv2 blocked, in turns with the
               same JPEGs as a directory (dir, video, sequence, twice):
               every JSON frameNNNNNN.json of the video and sequence runs
               equal to estimate() on the port's Motion-JPEG decode
               (FFmpeg's arithmetic) of its frame, the hand-kernel
               launches equal to the directory run's (K1 4, K4 4), FPS
               beside the directory's; --start_frame 3 writes
               frame000003-7, equal to the first run's, for the AVI and the
               sequence; the host ms a frame of the container read
               (AviReader.packet) and of the decode apart.  Then rtpose
               --video on the committed MPEG-4 clip tests/data/
               mp4v_720p.mp4 (8 1280x720 frames, cv2's mp4v writer), in
               turns with the port's decodes of its frames as q95 JPEGs in
               a directory and in an AVI (dir, avi, mp4, dir, avi, mp4):
               the decoded frames' digest equal to cv2's (pinned), every
               mp4 JSON equal to estimate() on the port's decode of its
               frame, launches equal to the directory run's (K1 4, K4 4),
               --start_frame 3 (a P-frame) equal to the first run's, FPS
               of each, and the host ms a frame of the container read and
               of the MPEG-4 decode apart.  Then rtpose --video on the
               committed H.264 clips tests/data/h264_720p.mp4,
               h264_cabac_720p.mp4 (the same 8 1280x720 frames coded by
               tests/h264_cases.encode_clip in CAVLC and in CABAC: an IDR
               picture, then P pictures), h264_b_720p.mp4 (the same
               frames as I P B B in CABAC) and h264_high_720p.mp4 (I P B
               B in CABAC under High profile: Intra8x8 and the 8x8
               transform), in turns with the MPEG-4 clip and a q95
               Motion-JPEG AVI of the H.264 decode (h264, cabac, b, high,
               mp4, avi, twice): the decoded frames' digests equal to
               cv2's (pinned), every h264, b and high JSON equal to
               estimate() on the port's decode of its frame and every
               cabac JSON to the h264 run's, launches equal to the other
               runs' (K1 4, K4 4), --start_frame 3 on each clip equal to
               the first run's, FPS of each.
   serving   - serving bundles (serving.py): the bf16 batch-8 estimator
               built from those files, exported (time, file sizes), loaded
               cold as an ExportedPose (time) with the kernel counters zeroed
               just before and read after its passes (the bundle's main
               path): packed rows bit-identical to the live estimator on 16
               frames, the overflow refetch through program_nocap identical
               (noise frames at threshold -1), one K1 and one K4 node a
               replay, device and end-to-end ms/frame of live and bundle in
               turns (live bundle bundle live).  Then a 2-stage bf16 bundle
               exported on the CPU and loaded on the card (its operators
               launch K1 and K4; bit-identical to a live estimator on the
               card), a 3-scale f32 bundle (K1 at three scales, the TPU's
               K2; bit-identical), and rtpose --bundle in a new process on
               the cli phase's frames, its JSON equal to the live CLI's.
   pool      - parallel.inference.DevicePool over every card against the
               estimator, and a replica on the estimator's own card (its own
               graphs) against it.
   eval      - eval run-list over the cli phase's PNG frames with its model
               files (bf16), and joint-diff against the cli phase's JSON:
               PARITY OK with the joints compared; the same over the JPEG
               cli run's 656x368 frames, joints compared.
   train     - (after every other phase) CPM training, f32 with TF32 off:
               make_label_fn on the card
               against transformer.generate_label_map on the host (batch
               10, 46x46, 12 people, 114 channels; weight, PAF and
               background channels exact, gaussians within 1e-6), on an
               augmented synthetic batch and on 12 overlapping people; a
               2-stage train net at crop 184, batch 2, 3 SGD steps on the
               card and on the host CPU from the same fan-in weights and
               batches (losses within 1e-5 relative, weights within 1e-4
               and biases and momentum within 5e-3 of each blob's largest
               magnitude, or, above that, within the largest gap between
               the host's own f32 with and without oneDNN and f64 on the
               same batches); scripts/bench_train.py's configuration (6
               stages, batch 10, crop 368, u8 crops and joints from the
               host, labels on the card, SGD 2e-5 fixed, momentum 0.9,
               weight decay 5e-4) in the shapes sync, ring and staged: 2
               warm steps, then 10 timed (iters/s, imgs/s, device ms a step
               between CUDA events, host augmentation ms a batch, peak
               memory), every loss finite, the hand kernels' counters zero
               (training launches none of K1-K4); one augmented batch with
               do_clahe on (cv2 blocked) and one SGD step of the 2-stage net
               on it, card against CPU (loss within 1e-5 relative); a
               snapshot restored into
               a fresh solver whose next step equals the continuing one's
               (within 1e-5), and a deploy PoseEstimator from the snapshot's
               caffemodel (every convolution by layer name) on one frame,
               in BINARYPROTO and again in HDF5 (h5py blocked);
               caffe train (3 iterations, --fused_labels) and caffe time
               --phase TRAIN in new processes.  Then two steps under
               torch.profiler: the kernels a step by device time and the
               busy share of the step.
   framework - the Caffe framework surface, the hand kernels'
               counters zeroed before and read after (it launches none of
               K1-K4): (a) every registered layer type but HDF5Data and
               HDF5Output (the hdf5 phase runs them) as the CPU tests' small nets
               (tests/test_torch_layers_*.py; the data layers over sources
               written here), the card's forward within 1e-5*max(1,|y|) of
               the CPU's and its input and parameter gradients within 1e-4
               of each blob's largest, integer tops exact; Dropout's kept
               share over 1M elements within 2 % of 1-p and its scale,
               STOCHASTIC pooling's draws each in its window; (b) caffe
               train on CaffeNet's train_val (Data layers, TRAIN/TEST
               rules, a mean file, crop 227, mirror) over a kvdb of 512
               seeded 3x256x256 Datums, batch 256, SGD 0.01/0.9/5e-4, 20
               iterations, a test pass (2 x 256) every 10 and after the
               last, the snapshot: iters/s, imgs/s, Solver.step between CUDA
               events, the Data layer's host ms a batch, the test outputs,
               peak memory; (c) a narrow CaffeNet (widths cut, crop 67,
               batch 4, no Dropout) 3 SGD steps on the card and the CPU
               (losses within 1e-5 relative, parameters within 1e-4 of each
               blob's largest); (d) caffe test on the snapshot in a new
               process, equal to (b)'s last test pass within 1e-5; (e)
               api.Net on CaffeNet's deploy form at batch 10 and on the COCO
               pose deploy graph bit for bit against Net.forward, classify
               (10 crops) on 4 PNGs with rows summing to 1; (f) ROADMAP C2:
               api.Net.backward of the COCO deploy net at 656x368 (TEST
               phase) against an f64 run of the same call, every input and
               parameter diff within 2e-3 relative L2, the same under the
               pre-C2 rule (cuDNN's f32 backward) for the record, and a
               no-grad forward bit for bit under both rules; then two of
               (b)'s steps under torch.profiler.
   train bf16- (after train) bench_train.py's configuration in bf16 mixed
               precision (seed 0 init, the same solver, labels on the
               card), the counters zeroed before and read after (none of
               K1-K4 launches; a TRAIN net never takes K4): one step's
               gradients of f32 and bf16, remat "none" and "convs", from one
               batch: each bf16 blob within relative L2 0.3 of f32 (JAX's
               bound, tests/test_training.py:585-590; blobs under a 1e-5
               norm skipped, the largest ratio printed), remat "convs"
               within 1e-6 (f32) and 2^-8 (bf16) relative L2 of "none" a
               blob; then for each remat: Solver.step between CUDA events on
               a batch already on the card (2 warm, 10 timed, peak memory),
               the ring shape (iters/s, host augmentation ms), two steps
               under torch.profiler (busy ms, kernels a step); every loss
               and parameter finite, parameters and history f32.
   tools     - (after framework, on its snapshot and log) the Caffe tool
               chain at CaffeNet's full width, the counters zeroed before
               and read after: convert_imageset over 512 seeded 256x256
               PNGs into a raw kvdb (its records equal to the images) and
               --encoded in a new process with cv2 blocked (which decodes
               both DBs to equal pixels, keys and labels);
               compute_image_mean of both to .binaryproto, equal to the
               images' mean; extract_features of fc7 and prob over 2 x 256
               images of the train_val TEST net (that DB and mean, the
               snapshot, a Softmax prob) on the card, bit for bit against
               api.Net's forward, and on the CPU within 1e-5*max(1,|y|);
               detect with CaffeNet deploy over a 64-window CSV, its rows
               equal to api.Detector's; summarize --shapes and draw_net on
               the train_val and the COCO deploy prototxt; parse_log and
               extract_series on framework (b)'s caffe train log; each
               shim once.
   matcaffe  - (last) the shipped M-files through the port's MATLAB engine
               after caffe.set_mode_gpu(): the +test classes test_net,
               test_solver and test_io on the card; caffe.Net (Net.m) on
               CaffeNet's deploy prototxt with the snapshot at batch 10,
               crop 227, its forward bit for bit against api.Net's; then
               run_tests.m, which sets the CPU mode first.
   parallel  - (last) parallel/ over ranks sharing the card over gloo
               (parallel.dp.spawn; every collective through pinned host
               buffers), one process group a world size running all of its
               checks: 2 ranks: a DP step of the 6-stage COCO train net
               (global batch 10, crop 368, f32) against the one-rank step
               (loss rtol 1e-5, parameter sums rtol 1e-4 atol 1e-5), the
               step's ms and its gradient all-reduce's; spatial_estimator_fn
               and tp_estimator_fn at 656x368 (1 scale, f32, the calibrated
               weights, 4 frames) against the one-device estimator (peaks
               rtol/atol 1e-4, scores 2e-2, pair counts exact), ms a frame
               of each, K1 launched once a pass on each rank. 4 ranks:
               dp_tp_estimator_fn (2x2, 2-frame batches), a dp x sp step of
               the train net (2x2; loss within 1e-3, sampled parameters
               rtol 2e-3 atol 2e-5). 5 ranks: pipeline_refine of the five
               refinement stages at 46x82, width 128, M=6 (rtol/atol 2e-4)
               and make_pp_train_step (loss rtol 1e-5, weights rtol 1e-4
               atol 1e-6). Then caffe train --gpu 0,0 (one iteration of
               the train net, synthetic data) against --gpu 0, and the
               multihost dry run (2 processes against 1, crop 64, batch
               8), and which collectives gloo takes natively on CUDA
               tensors (the port stages them all through host buffers).
               The refusals lifted since: 2 ranks: CaffeNet's TRAIN net
               (batch 256, crop 227, f32, seed-0 weights, Dropout on) over
               1x2 spatial ranks against the one-rank step (loss within
               1e-3, every parameter rtol 2e-3 atol 2e-5), then 3 steps
               with the replicated tail (fc6-fc8) bit-identical across the
               ranks; CaffeNet's deploy net channel-sharded (tp, batch 10,
               crop 227, group-2 convs) against one device (rtol/atol
               2e-4); spatial_estimator_fn and tp_estimator_fn with
               keep_heatmap (the heatmap estimator, f32 canvases of the
               same 4 frames) against the one-device heatmap estimator,
               heatmaps rtol/atol 2e-4 on each rank, K3 once a frame on
               each rank and K1 never. 4 ranks: the dp x sp step with the
               fused label transform (labels rasterized on each rank)
               against the one-rank fused step. Then caffe train --gpu 0,0
               --spatial 2 on a CaffeNet solver against --gpu 0 (the
               multihost digest rule). Peak GiB by rank, seconds of each
               group and check.
4. slice     - the full-width COCO estimator (656x368, 1 scale, u8 input,
               pair_cap=32, f32) over 8 synthetic frames through
               estimate_from_net_input (graph replays), with the peak-mask
               kernel's launches counted by torch.profiler around that run
               (the wrapper counts only the eager pass and the capture);
               its packed outputs against the same estimator with the
               plain peak mask; device and end-to-end ms/frame.  Then once
               more at 3 scales.
5. heatmap   - the full-width COCO estimator with keep_heatmap=True (656x368,
               1 scale, f32 input: the 1-scale slice's first 4 canvases,
               normalised and masked on the host, with its weights) through
               estimate_from_net_input, with the upsample kernel's launches
               counted by the profiler around that run (the peak-mask
               kernel must not launch); its outputs against the same estimator with the
               plain version, and against the packed realtime estimator
               (u8 input, no pair_cap) on the same frames.  Device and
               end-to-end ms/frame, and the heatmap fetch's ms alone.
6. render    - the views the rtpose demo dispatches (pose, part 1, all
               parts, accumulated PAFs, one PAF pair) from the heatmap run's
               last frame, on the card, on a 656x368 canvas: shape, finite
               values and ms of each.
7. conv1     - the fused conv1 block kernel (bf16) against its plain version
               at COCO 656x368 with B*S = 1, 3 and 8 and at (2, 64, 96) and
               (3, 48, 64), within two bf16 ulps (2^-7 relative, 2^-13
               absolute), on channels_last input and bit for bit the same
               on NCHW input, and against the cuDNN bf16 chain (largest
               difference printed); at B*S = 1, 3 and 8: kernel_ms and
               call_ms as above, the plain version and the cuDNN bf16 chain
               (library_ms) between CUDA events, bound_ms from its FLOPs
               over the 989 TFLOP/s bf16 peak.  The build phase shows the
               kernel's wgmma (HGMMA) instructions in the library's SASS,
               and K3's TMA bulk stores (UTMASTG).
8. bf16      - bench.py's configuration: bf16, u8, 1 scale, pair_cap=32,
               batch=8, 16 frames through run_device + fetch_batch (with the
               overflow refetch) and through estimate_from_net_input, with
               the conv1 kernel's and the peak-mask kernel's launches (one
               each per device pass: the post segment runs over the batch)
               counted by the profiler around each run, and the peak of
               torch.cuda.max_memory_allocated over those passes.
               Against the same estimator with conv1_kernel=False and
               peak_kernel=False, and against the f32 estimator on the same
               frames: the low-res maps' relative L2 distances, and the
               share of the other side's peaks reproduced within the
               project's joint budget (a peak within 1 px and 0.01 score,
               or none where the other side's score is within 0.01 of the
               threshold), which must reach MATCH_FLOOR.  Device ms/frame (whole pass and CNN
               alone) and end-to-end ms/frame.  Then the 3-scale quality
               mode with pack_u8 in bf16 (launch counts; packed outputs
               bit-identical to the canvas upload) and the heatmap branch in
               bf16 (upsample and conv1 kernel launch counts; against its
               plain twin).

Weights are seeded numpy at fan-in scale.  In each realtime slice run the
part-heatmap head's bias is set from that run's frames so that 0.05% of the
scale-averaged full-res part-map pixels clear the NMS threshold, as a
trained model's maps give a few peaks per person (random maps would put
hundreds of peaks in every part).

The bf16 phases reuse the 1-scale f32 slice's weights and frames.

The train, framework, train bf16, tools, matcaffe and parallel phases print
their JSON lines ({"train": ...}, {"framework": ...}, {"train_bf16": ...},
{"tools": ...}, {"matcaffe": ...}, {"parallel": ...}) before them.
The last three lines are: a JSON object with one entry per TPU kernel (K1
and its 3-scale form K2 listed apart), the card's name and power limit as
nvidia-smi prints them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
import tempfile
import time

import numpy as np

TOL_NEAR_TIE = 1e-5
TOL_FLOAT = 1e-4
TOL_HEAT = 1e-5  # relative to max(1, |U|): two f32 sums of the same taps
TOL_BRANCH_PEAKS = 1e-3  # heatmap vs packed branch, as tests/test_optimized_path.py
TOL_BRANCH_SCORES = 5e-3
HEAT_FRAC = 5e-4  # share of full-res part-map pixels above the NMS threshold
HEATMAP_FRAMES = 4
TOL_CONV1_REL = 2.0 ** -7  # two bf16 ulps, as tests/test_torch_conv1.py
TOL_CONV1_ABS = 2.0 ** -13
BF16_FRAMES = 16
BF16_BATCH = 8  # bench.py's batch
PIPELINE_TIMED_FRAMES = 64
MATCH_PX = 1.0  # the project's joint budget: 1 px, 0.01 confidence
MATCH_SCORE = 0.01
# share of the other side's peaks reproduced within that budget (match_share);
# measured 0.860 against f32 and 0.897 against the plain path at COCO 656x368
# (H100 80GB HBM3, 700.00 W), and never set under 0.80
MATCH_FLOOR = 0.80
L2_RATIO = 1.5  # kernel-path vs plain-path distance, against bf16 vs f32
CONV1_CASES = [("coco_b1", 1, 368, 656), ("coco_b3", 3, 368, 656), ("coco_b8", 8, 368, 656),
               ("small_b2", 2, 64, 96), ("small_b3", 3, 48, 64)]  # name, B*S, H, W
CONV1_TIMED = ("coco_b1", "coco_b3", "coco_b8")
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM, bf16 tensor cores, f32 outside them
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
PROFILE_REPS = 20
PROFILE_WINDOWS = 8  # profiler windows kernel_ms tries before it fails
NO_LIBRARY = ("no PyTorch call computes Caffe's ImResize (Catmull-Rom a=-0.5 with per-scale "
              "sub-region pads; F.interpolate's bicubic is a=-0.75) with the peak test")


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 20):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, kernel: str, reps: int = PROFILE_REPS):
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, over ``reps`` calls of ``fn`` (torch.profiler, CUPTI): the
    kernel alone, without the wrapper's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # CUPTI may drop the first launch of a window: average over what it saw;
    # late in a process it has also lost whole windows (three in a row on an
    # H100), so up to PROFILE_WINDOWS windows
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total_us += device_us(evt)
                count += evt.count
        if count >= reps // 2 and total_us > 0:
            return total_us / count / 1000.0
        print(f"[profile] the profiler saw {count} launches of {kernel} for {reps} calls")
    raise AssertionError(f"the profiler saw {count} launches of {kernel} ({total_us} us) for "
                         f"{reps} calls, in each of {PROFILE_WINDOWS} windows")


KERNEL_NAMES = ("peak_mask_kernel", "upsample_peak_keys_kernel", "conv1_block_kernel")


def device_us(evt) -> float:
    """A profiler event's device time in us (the attribute's name changed
    across torch versions)."""
    t = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if t is None else t


def device_kernels(fn, by_name=None):
    """``fn()`` under torch.profiler -> (its result, {hand kernel: launches
    the card ran}, every kernel the card ran, their summed device ms).  A replayed CUDA graph makes
    no Python call, so the wrappers' counters see only the eager pass and
    the capture; the card's trace counts the replays.  ``by_name``, a dict,
    receives {kernel name: [launches, device ms]}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # CUPTI may drop a window's first launch: let it be this one
        torch.cuda.synchronize()
        res = fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    counts, total, busy_us = dict.fromkeys(KERNEL_NAMES, 0), 0, 0.0
    for evt in prof.key_averages():
        name = evt.key
        if (evt.device_type != DeviceType.CUDA or "Memcpy" in name or "Memset" in name
                or "spin_kernel" in name):
            continue  # runtime calls, copies, the filler
        total += evt.count
        busy_us += device_us(evt)
        if by_name is not None:
            row = by_name.setdefault(name, [0, 0.0])
            row[0] += evt.count
            row[1] += device_us(evt) / 1000.0
        for k in KERNEL_NAMES:
            if k in name:
                counts[k] += evt.count
    return res, counts, total, busy_us / 1000.0


# CUPTI loses a kernel record now and then under graph replay: two replays
# of one bf16 batch-8 program summed to an odd kernel count (7,919 and 7,945
# on an H100 80GB HBM3 at 700 W), and one window saw 127 of 128 peak-mask
# launches.  The graphs' own count (replays times the kernel nodes each
# capture recorded) is exact and checked exactly; the card's trace must
# confirm it to within one record in CUPTI_SLACK, and at least one.
CUPTI_SLACK = 100


def replay_kernels(fn, *ests, by_name=None):
    """``fn()`` under torch.profiler, every program it runs on ``ests``
    captured before -> (its result, {hand kernel: launches the estimators'
    replays made}, {hand kernel: launches the profiler saw}, every kernel
    the card ran, their summed device ms); ``by_name`` as device_kernels'."""
    from caffe_rtpose_tpu_torch.pose.estimator import kernel_calls

    calls0, rep0 = kernel_calls(), [e.replayed_launches() for e in ests]
    res, seen, total, busy = device_kernels(fn, by_name)
    calls = kernel_calls()
    check(calls == calls0, f"wrapper calls in a replay window: {calls0} -> {calls} (an eager pass "
          f"or a capture)")
    replayed = {k: sum(e.replayed_launches()[k] - r[k] for e, r in zip(ests, rep0))
                for k in KERNEL_NAMES}
    return res, replayed, seen, total, busy


def check_launches(tag, replayed, seen, expect):
    """Each hand kernel's replayed launches equal ``expect`` (0 where it is
    missing), and the profiler saw them, within CUPTI_SLACK."""
    for k in KERNEL_NAMES:
        n, s, want = replayed[k], seen[k], expect.get(k, 0)
        check(n == want, f"{tag} {k}: the graphs launched it {n} times, expected {want}")
        low = max(1, want - max(1, want // CUPTI_SLACK)) if want else 0
        check(low <= s <= want, f"{tag} {k}: the profiler saw {s} of its {want} launches")


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over their peak rate."""
    ms_bytes, ms_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / peak_ops * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def upsample_work(s, h, w, c, th, tw):
    """Bytes and f32 operations of the scale-averaged separable upsample of
    c channels: the map read once; per scale a vertical pass (th x w x 4
    FMA) and a horizontal one (th x tw x 4 FMA) a channel; the scale sum
    and 1/S."""
    return s * h * w * c * 4, c * (s * 8 * th * (w + tw) + s * th * tw)


def k1_bound(s, h, w, c, th, tw):
    """K1: the upsample, the strict 8-neighbour test (10 operations a
    pixel) and the bool mask written once."""
    b, ops = upsample_work(s, h, w, c, th, tw)
    return bound(b + c * th * tw, ops + 10 * c * th * tw, F32_FLOPS)


def k3_bound(s, h, w, c, kc, th, tw):
    """K3: the upsample of c channels written as f32 heat, the peak test on
    kc of them and their int32 pair keys written once."""
    b, ops = upsample_work(s, h, w, c, th, tw)
    return bound(b + c * th * tw * 4 + kc * th * (tw // 2) * 4, ops + 10 * kc * th * tw,
                 F32_FLOPS)


def k4_bound(b, h, w):
    """K4: conv1_1 (27 taps) and conv1_2 (576) as 2-FLOP MACs at the bf16
    tensor-core peak; the bf16 input and output and the weights once."""
    flops = 2 * b * h * w * 64 * (27 + 576)
    n_bytes = b * 3 * h * w * 2 + b * 64 * (h // 2) * (w // 2) * 2 + (27 + 576) * 64 * 2 + 2 * 64 * 4
    return bound(n_bytes, flops, BF16_FLOPS)


# (row, fn, kernel name) whose kernel_ms main() measures after the slices:
# a torch.profiler window slows the host's launches for the rest of the
# process, and the bf16 pass is bound by them
PENDING_PROFILES = []


def timing_row(shape, fn, kernel, c_ms, p_ms, bound_ms, bound_by, library_ms):
    """A kernel's timing at one shape; kernel_ms and bound_share are filled
    in by profile_pending()."""
    row = dict(shape=shape, kernel_ms=None, call_ms=c_ms, plain_ms=p_ms, bound_ms=bound_ms,
               bound_by=bound_by, bound_share=None, library_ms=library_ms)
    PENDING_PROFILES.append((row, fn, kernel))
    return row


def profile_pending():
    """kernel_ms of every timed shape (torch.profiler), once no other phase
    is left to run."""
    for row, fn, kernel in PENDING_PROFILES:
        row["kernel_ms"] = kernel_ms(fn, kernel)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        print(f"[profile] {kernel} at {row['shape']}: kernel alone {row['kernel_ms']:.5f} ms "
              f"({PROFILE_REPS} launches; call {row['call_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms); bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
              f"{row['bound_share']:.3f} of it")
    PENDING_PROFILES.clear()


def near_tie_violations(got, ref, heat, thr):
    """(number of differing pixels, number of those that are no near-tie)."""
    import torch
    import torch.nn.functional as F

    diff = got != ref
    n_diff = int(diff.sum())
    if n_diff == 0:
        return 0, 0
    pad = F.pad(heat, (1, 1, 1, 1), value=-float("inf"))
    shifts = [pad[:, 1 + dy : 1 + dy + heat.shape[1], 1 + dx : 1 + dx + heat.shape[2]]
              for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    max8 = torch.stack(shifts).amax(0)
    tol = TOL_NEAR_TIE * torch.clamp_min(heat.abs(), 1.0)
    tie = ((heat - thr).abs() <= tol) | ((heat - max8).abs() <= tol)
    return n_diff, int((diff & ~tie).sum())


def keys_to_mask(keys, th, tw):
    """(K, th*(tw//2)) pair-layout peak keys -> (K, th, tw) bool mask."""
    import torch

    hw = th * tw
    mask = torch.zeros(keys.shape[0] * hw, dtype=torch.bool, device=keys.device)
    nz = keys > 0
    chan = torch.arange(keys.shape[0], device=keys.device)[:, None].expand_as(keys)[nz]
    mask[chan * hw + (hw - keys[nz].long())] = True
    return mask.reshape(keys.shape[0], th, tw)


def time_pair(plain, kernel):
    """Medians of 20 in the order plain, kernel, kernel, plain -> the four."""
    ms_p = cuda_ms(plain)
    ms_k = cuda_ms(kernel)
    ms_k2 = cuda_ms(kernel)
    ms_p2 = cuda_ms(plain)
    return ms_p, ms_k, ms_k2, ms_p2


def phase_device():
    import torch

    from caffe_rtpose_tpu_torch.utils.device import device_query

    info = device_query()
    for k, v in info.items():
        print(f"[device] {k}: {v}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    return info


SASS_OPS = ("HGMMA", "UTMASTG")  # wgmma; TMA tensor stores (cp.async.bulk.tensor to global)


def sass_counts(lib_path: str):
    """{kernel name: {SASS_OPS op: instructions}} in the library's SASS, or
    None without cuobjdump."""
    import os
    import subprocess

    from caffe_rtpose_tpu_torch.utils.device import nvcc_path

    nvcc = nvcc_path()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None
    if not tool or not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?(conv1_block|upsample_peak_keys|peak_mask)_kernel", line)
        if m:
            kernel = m.group(1) + "_kernel"
            counts[kernel] = dict.fromkeys(SASS_OPS, 0)
        elif kernel:
            for op in SASS_OPS:
                counts[kernel][op] += op in line
    return counts


def phase_build():
    from caffe_rtpose_tpu_torch import _build
    from caffe_rtpose_tpu_torch.ops import nms_cuda

    t0 = time.perf_counter()
    lib = _build.load_kernels()
    secs = time.perf_counter() - t0
    print(f"[build] kernels ready in {secs:.2f} s")
    kernel = "?"
    log = _build.build_log.get("crt_kernels", "")
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(conv1_block|upsample_peak_keys|peak_mask)_kernel", line)
            kernel = m.group(0) if m else "?"
        elif "registers" in line or "spill" in line or "smem" in line or "arning" in line:
            print(f"[build] {kernel}: {line.replace('ptxas info    :', '').strip()}")
    geo = nms_cuda.tile_geometry(46, 82, 368, 656, 3, 1.0, 0.3)
    print(f"[build] conv1_block: {lib.crt_conv1_smem_bytes()} B of dynamic shared memory a "
          f"block; peak_mask at COCO 3 scales: widest source window "
          f"{geo.wh}x{geo.ww}, {lib.crt_tile_smem_bytes(3, geo.wh, geo.ww)} B a block")
    check(lib.crt_tile_smem_bytes(3, geo.wh, geo.ww) == geo.smem,
          "the host's shared-memory sum disagrees with the kernel's")
    for s, gap in ((1, 0.3), (3, 0.3)):
        kg = nms_cuda.keys_geometry(46, 82, 368, 656, s, 1.0, gap)
        kb = lib.crt_keys_smem_bytes(s, kg.rows, kg.wh, kg.wp)
        print(f"[build] upsample_peak_keys at COCO {s} scale(s): {kg.rows}-row tiles, source "
              f"window {kg.wh} rows x pitch {kg.wp}, {kb} B a block of {nms_cuda.KEYS_WARPS} "
              f"warps")
        check(kb == kg.smem, "the host's K3 shared-memory sum disagrees with the kernel's")
    if log:  # built in this run: the library's path is on the nvcc line
        path = re.search(r"-o (\S+)\.\d+\.\d+\.tmp", log).group(1)
        counts = sass_counts(path)
        if counts is None:
            print("[build] cuobjdump not found: SASS not inspected")
        else:
            print(f"[build] HGMMA (wgmma) and UTMASTG (TMA store) instructions in the SASS: "
                  f"{counts}")
            check(counts.get("conv1_block_kernel", {}).get("HGMMA", 0) > 0,
                  "conv1_block_kernel has no wgmma")
            check(counts.get("upsample_peak_keys_kernel", {}).get("UTMASTG", 0) > 0,
                  "upsample_peak_keys_kernel has no TMA bulk store")
    return secs


JPEG_TIMED_REPS = 20


class no_module:
    """``sys.modules[name] = None`` for a block: an ``import name`` there
    raises ImportError (the card's machine has neither OpenCV nor h5py)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.saved = sys.modules.get(self.name, False)
        sys.modules[self.name] = None

    def __exit__(self, *exc):
        if self.saved is False:
            del sys.modules[self.name]
        else:
            sys.modules[self.name] = self.saved


def no_cv2() -> no_module:
    return no_module("cv2")


def jpeg_frames_module():
    """tests/jpeg_frames.py: the seeded frames and the digests
    tests/test_torch_jpeg.py holds against cv2 (numpy only)."""
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import jpeg_frames

    return jpeg_frames


def phase_jpeg(card):
    """The port's JPEG codec (csrc/jpeg_codec.cpp, host C++) on the card's
    host: its g++ build, the sha256 of the encode (q95) of three seeded
    frames and of their decodes against the digests pinned with cv2, and
    decode / encode ms (median of 20) of a 1280x720 and a 640x480 q95 4:2:0
    frame."""
    from caffe_rtpose_tpu_torch import _build
    from caffe_rtpose_tpu_torch.pipeline import jpeg

    tag = "[jpeg]"
    jf = jpeg_frames_module()
    with no_cv2():
        t0 = time.perf_counter()
        jpeg.load()
        build_s = time.perf_counter() - t0
        log = _build.build_log.get("jpeg_codec", "")
        built = bool(log)
        digests = {"encode": [], "decode": []}
        timed = {}
        for (h, w, seed) in jf.DIGEST_FRAMES:
            img = jf.frame(h, w, seed)
            data = jpeg.encode_jpeg(img, jf.DIGEST_QUALITY)
            digests["encode"].append(jf.sha256(data))
            digests["decode"].append(jf.sha256(jpeg.decode_jpeg(data)))
            if (h, w) in ((720, 1280), (480, 640)):
                dec, enc = [], []
                for _ in range(JPEG_TIMED_REPS):
                    t0 = time.perf_counter()
                    jpeg.decode_jpeg(data)
                    dec.append((time.perf_counter() - t0) * 1000.0)
                    t0 = time.perf_counter()
                    jpeg.encode_jpeg(img, jf.DIGEST_QUALITY)
                    enc.append((time.perf_counter() - t0) * 1000.0)
                timed[f"{w}x{h}"] = dict(decode_ms=statistics.median(dec),
                                         encode_ms=statistics.median(enc), bytes=len(data))
    ok = all(tuple(digests[k]) == tuple(jf.DIGESTS[k]) for k in digests)
    print(f"{tag} codec {'built' if built else 'loaded'} in {build_s:.2f} s "
          f"({log.strip().splitlines()[-1] if built else 'cached'}); digests of "
          f"{len(jf.DIGEST_FRAMES)} seeded frames (encode q{jf.DIGEST_QUALITY}, decode) "
          f"{'equal' if ok else 'DIFFER from'} those pinned with cv2; host ms (median of "
          f"{JPEG_TIMED_REPS}), " + "; ".join(
              f"{k} q{jf.DIGEST_QUALITY} 4:2:0 ({v['bytes']} B): decode {v['decode_ms']:.3f}, "
              f"encode {v['encode_ms']:.3f}" for k, v in timed.items()) + f"; {card}")
    check(ok, f"{tag} the card host's codec differs from cv2: {digests} against {jf.DIGESTS}")
    return dict(build_s=build_s, built=built, digests_equal=ok, host_ms=timed, card=card)


IMGPROC_REPS = 5


def imgproc_cases_module():
    """tests/imgproc_cases.py: the seeded cases and the digests
    tests/test_torch_imgproc.py holds against cv2 (numpy only)."""
    jpeg_frames_module()  # puts tests/ on the path
    import imgproc_cases

    return imgproc_cases


def host_ms(fn, reps=IMGPROC_REPS):
    """The median host ms of ``reps`` calls of ``fn``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def phase_imgproc(card):
    """OpenCV's u8 image operations in numpy (utils/imgproc.py) on the card's
    host, cv2 blocked: every digest pinned with cv2 in tests/imgproc_cases.py
    recomputed and held equal (both Lab cubes, CLAHE, cv2.line, INTER_LINEAR,
    the synthetic source, do_clahe's step), and their host ms.  They launch
    none of K1-K4: the counters are zeroed before and read after."""
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
    from caffe_rtpose_tpu_torch.training.labels_device import pose_batches_jointfeed
    from caffe_rtpose_tpu_torch.training.transformer import AugParams, clahe
    from caffe_rtpose_tpu_torch.utils import imgproc

    tag = "[imgproc]"
    cases = imgproc_cases_module()
    zero_counts()
    t_phase = time.perf_counter()
    digests, seconds = {}, {}
    with no_cv2():
        for name in ("bgr2lab", "lab2bgr"):
            t0 = time.perf_counter()
            digests[name + "_cube"] = cases.cube_digest(getattr(imgproc, name + "_u8"))
            seconds[name + "_cube"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        digests.update(cases.case_digests(imgproc))
        seconds["cases"] = time.perf_counter() - t0
        digests["synthetic"] = cases.synthetic_digest(SyntheticPoseSource)
        digests["do_clahe"] = cases.do_clahe_digest(clahe)
        ms = {f"clahe_{h}x{w}": host_ms(lambda f=cases.frame(h, w, s): clahe(f, 8, 4))
              for h, w, s in cases.DO_CLAHE_FRAMES}
        src = SyntheticPoseSource(n=16, size=368, seed=0)
        it = iter(range(16))
        ms["synthetic_368"] = host_ms(lambda: src[next(it)], reps=8)
        for on in (False, True):
            prm = AugParams(crop_size_x=368, crop_size_y=368, do_clahe=on)
            gen = pose_batches_jointfeed(src, prm, 10, max_people=12, seed=1, data_u8=True)
            ms[f"jointfeed_batch10_clahe_{'on' if on else 'off'}"] = host_ms(lambda: next(gen), reps=3)
    seconds["phase"] = time.perf_counter() - t_phase
    counts = read_counts()
    ok = digests == cases.DIGESTS
    print(f"{tag} digests of the Lab cube both ways, {sum(1 for _ in cases.clahe_cases())} CLAHE, "
          f"{sum(1 for _ in cases.line_cases())} cv2.line and {sum(1 for _ in cases.resize_cases())} "
          f"INTER_LINEAR cases, the synthetic source and do_clahe "
          f"{'equal' if ok else 'DIFFER from'} those pinned with cv2; seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + "; host ms (median): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) + f"; hand-kernel launches {counts}; {card}")
    check(ok, f"{tag} the card host's numpy differs from cv2: "
          + str({k: v for k, v in digests.items() if v != cases.DIGESTS.get(k)}))
    check(not any(counts.values()), f"{tag} launched hand kernels: {counts}")
    return dict(digests_equal=ok, seconds=seconds, host_ms=ms, hand_kernel_launches=counts, card=card)


TEXT_REPS = 50  # overlay calls timed on a 1280x720 frame


def text_cases_module():
    """tests/text_cases.py: the seeded putText cases and the digests
    tests/test_torch_text.py holds against cv2 (numpy only)."""
    jpeg_frames_module()  # puts tests/ on the path
    import text_cases

    return text_cases


def phase_text(card):
    """rtpose's text overlay without OpenCV on the card's host, cv2 blocked:
    the font parsed (utils/truetype.py), the glyph rasteriser built with g++
    (csrc/glyph_raster.cpp), every digest pinned with cv2.putText in
    tests/text_cases.py recomputed with utils/text.put_text_u8 and held
    equal, and the pipeline's own _overlay_text on a 1280x720 frame timed:
    its first call (every glyph rasterised) and the median of TEXT_REPS
    calls after it, each with another fps label and people count.  It
    launches none of K1-K4: the counters are zeroed before and read after."""
    import types

    from caffe_rtpose_tpu_torch import _build
    from caffe_rtpose_tpu_torch.pipeline import runner
    from caffe_rtpose_tpu_torch.pose.descriptor import COCO_18
    from caffe_rtpose_tpu_torch.utils import text, truetype

    tag = "[text]"
    cases = text_cases_module()
    zero_counts()
    with no_cv2():
        t0 = time.perf_counter()
        with open(truetype.RUBIK_PATH, "rb") as f:
            truetype.Font(f.read())
        parse_ms = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        text.load()
        build_s = time.perf_counter() - t0
        log = _build.build_log.get("glyph_raster", "")
        pipe = runner.RtPosePipeline.__new__(runner.RtPosePipeline)
        pipe.cfg = runner.PipelineConfig()
        pipe.ui = runner.UIState(part_to_show=1)
        pipe.est = types.SimpleNamespace(descriptor=COCO_18)
        rs = np.random.RandomState(16)
        frame = rs.randint(0, 256, (720, 1280, 3)).astype(np.uint8)
        times = []
        for i in range(TEXT_REPS + 1):
            pipe._emit_times = list(np.cumsum(rs.uniform(0.01, 0.03, 30)))
            canvas = frame.copy()
            t0 = time.perf_counter()
            pipe._overlay_text(canvas, types.SimpleNamespace(num_people=i % 23))
            times.append((time.perf_counter() - t0) * 1000.0)
        drawn = int((canvas != frame).any(-1).sum())
        t0 = time.perf_counter()
        digests = {name: cases.group_digest(text.put_text_u8, name) for name in cases.DIGESTS}
        digest_s = time.perf_counter() - t0
    counts = read_counts()
    ok = digests == cases.DIGESTS
    n_canvases = sum(len(list(cases.group_cases(n))) for n in cases.DIGESTS) * len(cases.KINDS)
    overlay_ms = statistics.median(times[1:])
    print(f"{tag} font parsed in {parse_ms:.3f} ms; rasteriser "
          f"{'built' if log else 'loaded'} in {build_s:.2f} s; digests of {n_canvases} canvases "
          f"({', '.join(cases.DIGESTS)}) {'equal' if ok else 'DIFFER from'} those pinned with "
          f"cv2.putText, in {digest_s:.2f} s; _overlay_text on 1280x720: first call "
          f"{times[0]:.3f} ms, then {overlay_ms:.4f} ms (median of {TEXT_REPS}; "
          f"{min(times[1:]):.4f}-{max(times[1:]):.4f}), {drawn} pixels drawn; hand-kernel "
          f"launches {counts}; {card}")
    check(ok, f"{tag} the card host's text differs from cv2: "
          + str({k: v for k, v in digests.items() if v != cases.DIGESTS[k]}))
    check(drawn > 0, f"{tag} the overlay drew nothing")
    check(not any(counts.values()), f"{tag} launched hand kernels: {counts}")
    return dict(digests_equal=ok, font_parse_ms=parse_ms, build_s=build_s, built=bool(log),
                overlay_first_ms=times[0], overlay_ms=overlay_ms,
                overlay_ms_range=[min(times[1:]), max(times[1:])], digest_s=digest_s,
                hand_kernel_launches=counts, card=card)


def avi_cases_module():
    """tests/avi_cases.py: the crafted Motion-JPEG AVIs and the results
    tests/test_torch_video.py pins against the JAX package's reader (numpy
    only)."""
    jpeg_frames_module()  # puts tests/ on the path
    import avi_cases

    return avi_cases


def mp4_cases_module():
    """tests/mp4_cases.py: the MPEG-4 and MP4 clips cv2's writers wrote
    (tests/data), the crafted MP4 layouts and the results
    tests/test_torch_mp4.py pins against the JAX package's reader (numpy
    only)."""
    jpeg_frames_module()  # puts tests/ on the path
    import mp4_cases

    return mp4_cases


def h264_cases_module():
    """tests/h264_cases.py: the H.264 streams written from seeds, the
    committed 720p clip and the results tests/test_torch_h264.py pins
    against the JAX package's reader (numpy only)."""
    jpeg_frames_module()  # puts tests/ on the path
    import h264_cases

    return h264_cases


def mkv_cases_module():
    """tests/mkv_cases.py: the Matroska files written around the repo's
    MPEG-4, Motion-JPEG and H.264 packets, the two cv2 wrote, and the
    results tests/test_torch_mkv.py pins against the JAX package's reader
    (numpy, struct and zlib only)."""
    jpeg_frames_module()  # puts tests/ on the path
    import mkv_cases

    return mkv_cases


def read_frames(reader):
    frames = []
    while True:
        ok, img = reader.read()
        if not ok:
            return frames
        frames.append(img)


def phase_video(card):
    """The port's video readers on the card's host, cv2 blocked: each
    Motion-JPEG AVI of tests/avi_cases.py built around encode_jpeg's q95
    frames, then each clip of tests/mp4_cases.py (MPEG-4 Part 2 in MP4,
    QuickTime and AVI, Motion-JPEG in QuickTime) and each crafted MP4 layout
    built around mp4v.mp4's samples: frame count, fps, reads, seeks and
    frame digest held to the pins taken from the JAX package's reader (the
    MPEG-4 digests are cv2's frames).  The MPEG-4 decoder's g++ build
    (csrc/mpeg4_video.cpp) is timed.  Then each H.264 stream of
    tests/h264_cases.py (Constrained Baseline, Main and High profile:
    CABAC, weighted P, streams that start on a non-IDR picture, B slices,
    the 8x8 transform and scaling matrices) and its four 720p clips (the
    same frames in CAVLC and in CABAC, I P B B in CABAC, and I P B B under
    High profile) against their pins, each refused stream by its message,
    the H.264 decoder's g++ build (csrc/h264_video.cpp) and its decode of
    each 720p clip a frame, in turns.  Then each Matroska file of
    tests/mkv_cases.py (the three codecs in every layout it pins, and the
    two cv2 wrote) against its pins, the rates without DefaultDuration,
    and each refused file by its message.  It launches none of K1-K4."""
    import os

    from caffe_rtpose_tpu_torch.pipeline import h264, mpeg4, runner, video
    from caffe_rtpose_tpu_torch.pipeline.jpeg import MjpegDecoder, decode_jpeg, encode_jpeg

    tag = "[video]"
    cases = avi_cases_module()
    m4 = mp4_cases_module()
    import sequence_cases as seq

    zero_counts()
    differ = {}
    with no_cv2(), tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as work:
        t0 = time.perf_counter()
        for name in cases.CASES:
            data, sources = cases.build(name, encode_jpeg)
            path = os.path.join(work, name + ".avi")
            with open(path, "wb") as f:
                f.write(data)
            reader = video.AviReader(path)
            frames = read_frames(reader)
            reader.release()
            refs = cases.decoded(data, MjpegDecoder(path).decode)
            got = dict(count=reader.frame_count, fps=reader.fps, sha256=cases.sha256(frames),
                       **cases.observe(runner, path, refs, cases.seeks(name), exact=True))
            pin = cases.PINNED[name]
            bad = [k for k in pin if got[k] != pin[k]]
            if bad:
                differ[name] = {k: (got[k], pin[k]) for k in bad}
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        mpeg4.load()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name in [*m4.CLIPS, *m4.CASES]:
            if name in m4.CLIPS:
                path, sources = m4.clip_path(name), m4.sources(name)
            else:
                path, sources = os.path.join(work, name + ".mp4"), m4.case_sources(name)
                with open(path, "wb") as f:
                    f.write(m4.build(name))
            reader = video.open_reader(path)
            frames = read_frames(reader)
            reader.release()
            pin = m4.PINNED[name]
            got = dict(count=reader.frame_count, fps=reader.fps, sha256=cases.sha256(frames))
            if "order" in pin:
                got.update(cases.observe(runner, path, sources, m4.SEEKS))
            bad = [k for k in pin if got[k] != pin[k]]
            if bad:
                differ[name] = {k: (got[k], pin[k]) for k in bad}
        mp4_secs = time.perf_counter() - t0
        hc = h264_cases_module()
        t0 = time.perf_counter()
        h264.load()
        h264_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clips = {"h264_720p": hc.CLIP_720P, "h264_cabac_720p": hc.CLIP_CABAC_720P,
                 "h264_b_720p": hc.CLIP_B_720P, "h264_high_720p": hc.CLIP_HIGH_720P}
        for name in [*hc.CASES, *hc.HIGH, *clips]:
            path = clips.get(name)
            if path is None:
                path = os.path.join(work, name + hc.suffix(name))
                with open(path, "wb") as f:
                    f.write(hc.build(name))
            reader = video.open_reader(path)
            frames = read_frames(reader)
            reader.release()
            pin = hc.PINNED[name]
            got = dict(count=reader.frame_count, fps=reader.fps, sha256=cases.sha256(frames))
            if "order" in pin:
                got.update(cases.observe(runner, path, frames, hc.seeks(name), exact=True))
            bad = [k for k in pin if got[k] != pin[k]]
            if bad:
                differ["h264 " + name] = {k: (got[k], pin[k]) for k in bad}
        refused = {**hc.REFUSED, **hc.HIGH_REFUSED}
        for name, (_, word) in refused.items():
            path = os.path.join(work, "refused_" + name + hc.suffix(name))
            with open(path, "wb") as f:
                f.write(hc.build(name))
            try:
                video.open_reader(path).release()
                differ["h264 refused " + name] = "opened"
            except video.UnsupportedVideo as e:
                if word not in str(e):
                    differ["h264 refused " + name] = str(e)
        h264_secs = time.perf_counter() - t0
        readers = {name: video.open_reader(path) for name, path in clips.items()}
        h264_read_ms = {name: [] for name in clips}
        h264_decode_ms = {name: [] for name in clips}
        for _ in range(3):  # the clips in turns
            for name, reader in readers.items():
                # a picture a packet (the B clip's are held back one
                # packet, num_reorder_frames 1), the last one at the end
                dec = h264.H264Decoder(reader._extra, reader._nal_length, clips[name],
                                       reader._video_delay)
                n = len(reader.frames)
                for i in range(n):
                    t0 = time.perf_counter()
                    data = reader.packet(i)
                    t1 = time.perf_counter()
                    got = dec.advance(data, i)
                    check(got or (i == 0 and dec.delay), f"{tag} {name}'s packet {i} gave no picture")
                    if got:
                        dec.picture()
                    if i == n - 1 and dec.delay:  # the picture held back, at the end
                        check(dec.drain(), f"{tag} {name} held no picture back")
                        dec.picture()
                    h264_read_ms[name].append((t1 - t0) * 1000.0)
                    h264_decode_ms[name].append((time.perf_counter() - t1) * 1000.0)
                check(not dec.drain(), f"{tag} {name} held more than one picture back")
                dec.close()
        h264_frame_bytes = {name: os.path.getsize(clips[name]) // len(reader.frames)
                            for name, reader in readers.items()}
        for reader in readers.values():
            reader.release()
        t0 = time.perf_counter()
        for name in seq.CASES:
            path, _, written = seq.write(name, os.path.join(work, "seq_" + name))
            reader = video.open_reader(path)
            frames = read_frames(reader)
            reader.release()
            pin = seq.PINNED[name]
            got = dict(count=reader.frame_count, fps=reader.fps, sha256=cases.sha256(frames),
                       **seq.observe(runner, name, path, written))
            bad = [k for k in pin if got[k] != pin[k]]
            if bad:
                differ["seq " + name] = {k: (got[k], pin[k]) for k in bad}
        seq_secs = time.perf_counter() - t0
        jf = jpeg_frames_module()
        data = encode_jpeg(jf.frame(720, 1280, 0), 95)
        ffmpeg_ms, libjpeg_ms = [], []
        dec = MjpegDecoder()
        for _ in range(JPEG_TIMED_REPS):
            for fn, out in ((dec.decode, ffmpeg_ms), (decode_jpeg, libjpeg_ms)):
                t0 = time.perf_counter()
                fn(data)
                out.append((time.perf_counter() - t0) * 1000.0)
        check(dec.arithmetic == "ffmpeg", f"{tag} a 4:2:0 frame took {dec.arithmetic}'s path")
        mk = mkv_cases_module()
        t0 = time.perf_counter()
        drift = m4.sources("mp4v_mp4")
        for name in [*mk.CASES, *mk.CLIPS]:
            if name in mk.CLIPS:
                path = mk.clip_path(name)
            else:
                path = os.path.join(work, name + ".mkv")
                with open(path, "wb") as f:
                    f.write(mk.build(name))
            reader = video.open_reader(path)
            frames = read_frames(reader)
            reader.release()
            pin = mk.PINNED[name]
            got = dict(count=reader.frame_count, fps=reader.fps, sha256=cases.sha256(frames),
                       **cases.observe(runner, path, frames if mk.exact(name) else drift,
                                       mk.SEEKS, exact=mk.exact(name)))
            bad = [k for k in pin if got[k] != pin[k]]
            if bad:
                differ["mkv " + name] = {k: (got[k], pin[k]) for k in bad}
        for name, (_, scale, count, fps) in mk.RATES.items():
            path = os.path.join(work, "rate_" + name + ".mkv")
            with open(path, "wb") as f:
                f.write(mk.build_rate(name))
            reader = video.open_reader(path)
            if (reader.frame_count, reader.fps) != (count, fps):
                differ["mkv rate " + name] = ((reader.frame_count, reader.fps), (count, fps))
            reader.release()
        for name, (_, _, word) in mk.REFUSED.items():
            path = os.path.join(work, "refused_" + name + ".mkv")
            with open(path, "wb") as f:
                f.write(mk.build(name))
            try:
                video.open_reader(path).release()
                differ["mkv refused " + name] = "opened"
            except video.UnsupportedVideo as e:
                if not all(w in str(e) for w in (word, mk.codec_id(name), "Matroska")):
                    differ["mkv refused " + name] = str(e)
        mkv_secs = time.perf_counter() - t0
    counts = read_counts()
    print(f"{tag} {len(cases.CASES)} crafted Motion-JPEG AVIs ({', '.join(cases.CASES)}), cv2 "
          f"blocked: frame count, fps, reads, start_frame and ui seeks and frame digests "
          f"{'equal' if not differ else 'DIFFER from'} those pinned from the JAX package's "
          f"reader, in {secs:.2f} s; hand-kernel launches {counts}; {card}")
    print(f"{tag} MPEG-4 decoder g++ build (csrc/mpeg4_video.cpp) {build_s:.2f} s; "
          f"{len(m4.CLIPS)} clips cv2's writers wrote ({', '.join(m4.CLIPS)}) and "
          f"{len(m4.CASES)} crafted MP4 layouts ({', '.join(m4.CASES)}), cv2 blocked: count, "
          f"fps, reads, seeks and frame digests {'equal' if not differ else 'DIFFER from'} the "
          f"pins, in {mp4_secs:.2f} s; {card}")
    decode_ms = {name: statistics.median(ms) for name, ms in h264_decode_ms.items()}
    print(f"{tag} H.264 decoder g++ build (csrc/h264_video.cpp) {h264_build_s:.2f} s; "
          f"{len(hc.CASES) + len(hc.HIGH)} streams ({', '.join([*hc.CASES, *hc.HIGH])}) and the "
          f"four 1280x720 clips, cv2 blocked: count, fps, reads, seeks and frame digests "
          f"{'equal' if not differ else 'DIFFER from'} the pins; {len(refused)} refused "
          f"streams each named ({', '.join(refused)}); in {h264_secs:.2f} s; host ms a 1280x720 "
          f"frame (median of "
          f"{len(h264_decode_ms['h264_720p'])}, the clips in turns): "
          + "; ".join(f"{name} ({h264_frame_bytes[name]} B) container read "
                      f"{statistics.median(h264_read_ms[name]):.4f}, H.264 decode and BGR "
                      f"{decode_ms[name]:.3f} (range {min(h264_decode_ms[name]):.3f}-"
                      f"{max(h264_decode_ms[name]):.3f})" for name in clips)
          + f"; CABAC/CAVLC {decode_ms['h264_cabac_720p'] / decode_ms['h264_720p']:.3f}, "
          f"B/CAVLC {decode_ms['h264_b_720p'] / decode_ms['h264_720p']:.3f}, "
          f"B/CABAC {decode_ms['h264_b_720p'] / decode_ms['h264_cabac_720p']:.3f}, "
          f"High/CABAC {decode_ms['h264_high_720p'] / decode_ms['h264_cabac_720p']:.3f}, "
          f"High/B {decode_ms['h264_high_720p'] / decode_ms['h264_b_720p']:.3f}; {card}")
    print(f"{tag} {len(seq.CASES)} printf image sequences ({', '.join(seq.CASES)}), cv2 "
          f"blocked: count, fps, reads, seeks and frame digests "
          f"{'equal' if not differ else 'DIFFER from'} the pins, in {seq_secs:.2f} s; host ms "
          f"a 1280x720 q95 4:2:0 frame ({len(data)} B; median of {JPEG_TIMED_REPS}, in turns): "
          f"Motion-JPEG decode (FFmpeg's arithmetic) {statistics.median(ffmpeg_ms):.3f}, "
          f"decode_jpeg (libjpeg's) {statistics.median(libjpeg_ms):.3f}; {card}")
    print(f"{tag} {len(mk.CASES) + len(mk.CLIPS)} Matroska files "
          f"({', '.join([*mk.CASES, *mk.CLIPS])}), cv2 blocked: count, fps, reads, seeks and "
          f"frame digests {'equal' if not differ else 'DIFFER from'} the pins; {len(mk.RATES)} "
          f"rates without "
          f"DefaultDuration; {len(mk.REFUSED)} refused files each named "
          f"({', '.join(mk.REFUSED)}); in {mkv_secs:.2f} s; {card}")
    check(not differ, f"{tag} the readers differ from the pins: {differ}")
    check(not any(counts.values()), f"{tag} launched hand kernels: {counts}")
    return dict(cases=len(cases.CASES), mp4_files=len(m4.CLIPS) + len(m4.CASES),
                sequences=len(seq.CASES), pins_equal=not differ, seconds=secs,
                mp4_seconds=mp4_secs, sequence_seconds=seq_secs, mpeg4_build_s=build_s,
                h264_streams=len(hc.CASES) + len(hc.HIGH) + len(clips),
                h264_refused=len(refused),
                h264_seconds=h264_secs, h264_build_s=h264_build_s,
                h264_read_ms={k: statistics.median(v) for k, v in h264_read_ms.items()},
                h264_decode_ms=decode_ms,
                h264_decode_ms_range={k: [min(v), max(v)] for k, v in h264_decode_ms.items()},
                h264_frame_bytes=h264_frame_bytes,
                mkv_files=len(mk.CASES) + len(mk.CLIPS), mkv_refused=len(mk.REFUSED),
                mkv_seconds=mkv_secs,
                mjpeg_ffmpeg_ms=statistics.median(ffmpeg_ms),
                mjpeg_ffmpeg_ms_range=[min(ffmpeg_ms), max(ffmpeg_ms)],
                decode_jpeg_ms=statistics.median(libjpeg_ms),
                decode_jpeg_ms_range=[min(libjpeg_ms), max(libjpeg_ms)],
                mjpeg_frame_bytes=len(data), hand_kernel_launches=counts, card=card)


def phase_formats(card):
    """BMP and PNM without OpenCV, cv2 blocked: read_image of every crafted
    file of tests/image_cases.py (colour and gray; a file cv2 reads nothing
    of must raise) and the Datums of its images (image_to_datum's bytes,
    datum_to_image's array) held to the digests pinned from cv2."""
    import os

    from caffe_rtpose_tpu_torch.pipeline.image_io import read_image
    from caffe_rtpose_tpu_torch.proto import datum

    tag = "[formats]"
    jpeg_frames_module()  # puts tests/ on the path
    import image_cases as ic

    zero_counts()
    differ = {}
    t0 = time.perf_counter()
    with no_cv2(), tempfile.TemporaryDirectory(prefix="chip_smoke_formats_") as work:
        files = ic.decode_files()
        for name, data in files.items():
            path = os.path.join(work, name)
            with open(path, "wb") as f:
                f.write(data)
            got = []
            for gray in (False, True):
                try:
                    got.append(ic.sha256(read_image(path, gray=gray)))
                except ValueError:
                    got.append(None)
            if tuple(got) != ic.PINNED[name]:
                differ[name] = (got, ic.PINNED[name])
        images = ic.encode_images()
        for name, ext in ic.encode_cases():
            d = datum.image_to_datum(images[name], 0, ext[1:])
            img = datum.datum_to_image(d)
            got = (ic.sha256(d["data"]), ic.sha256(img[..., 0] if d["channels"] == 1 else img))
            if got != ic.PINNED[name + ext]:
                differ[name + ext] = (got, ic.PINNED[name + ext])
    secs = time.perf_counter() - t0
    counts = read_counts()
    print(f"{tag} {len(files)} crafted BMP and PNM files (colour and gray reads) and "
          f"{len(ic.encode_cases())} BMP/PNM Datums (bytes and decodes), cv2 blocked: digests "
          f"{'equal' if not differ else 'DIFFER from'} those pinned from cv2, in {secs:.2f} s; "
          f"hand-kernel launches {counts}; {card}")
    check(not differ, f"{tag} differ from the pins: {differ}")
    check(not any(counts.values()), f"{tag} launched hand kernels: {counts}")
    return dict(files=len(files), datums=len(ic.encode_cases()), pins_equal=not differ,
                seconds=secs, hand_kernel_launches=counts, card=card)


def phase_train_clahe(device="cuda"):
    """do_clahe on the card's machine: one augmented batch (cv2 blocked) and
    one SGD step of the 2-stage train net on it, card against CPU."""
    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource, pose_batches
    from caffe_rtpose_tpu_torch.training.solver import Solver
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    tag = "[train clahe]"
    crop, bsz = 184, 2
    src = SyntheticPoseSource(n=8, size=crop + 52, seed=3)
    with no_cv2():
        t0 = time.perf_counter()
        batch = next(pose_batches(src, AugParams(crop_size_x=crop, crop_size_y=crop, do_clahe=True),
                                  bsz, seed=4))
        batch_ms = (time.perf_counter() - t0) * 1000.0
    plain = next(pose_batches(src, AugParams(crop_size_x=crop, crop_size_y=crop), bsz, seed=4))
    changed = float((batch["data"] != plain["data"]).mean())
    proto = make_pose_train_net(batch=bsz, crop=crop, stages=2)
    losses, weights = {}, None
    for dev in (device, "cpu"):
        net = Net(proto, phase="TRAIN", device=dev)
        weights = weights or fan_in_weights(net, 11)
        net.load_weights(weights)
        losses[dev] = Solver(SMALL_SOLVER, net, lambda it: batch).step(1)
    rel = abs(losses[device] - losses["cpu"]) / abs(losses["cpu"])
    print(f"{tag} a do_clahe batch ({bsz} at crop {crop}) in {batch_ms:.1f} ms with cv2 blocked, "
          f"{changed:.3f} of its data values other than without CLAHE; one step's loss card "
          f"{losses[device]} cpu {losses['cpu']}: relative gap {rel:.3g} (limit {TOL_TRAIN_LOSS})")
    check(np.isfinite(losses[device]), f"{tag} non-finite loss")
    check(changed > 0.1, f"{tag} CLAHE changed {changed} of the batch")
    check(rel <= TOL_TRAIN_LOSS, f"{tag} losses differ by {rel}")
    return dict(batch_ms=batch_ms, changed_share=changed, loss_card=losses[device],
                loss_cpu=losses["cpu"], loss_rel=rel)


def lowres_input(rs, s, h, w, c, layout, device):
    """(S, h, w, C) f32 in [-1, 1) in one of the layouts the kernels meet:
    contiguous NHWC, the estimator's ``low[..., :C]`` slice of a 57-channel
    NHWC map, or channel-major storage (channel stride h*w)."""
    import torch

    if layout == "view57":
        full = rs.rand(s, h, w, 57).astype(np.float32) * 2 - 1
        return torch.from_numpy(full).to(device)[..., :c]
    if layout == "chan_major":
        return torch.from_numpy(rs.rand(s, c, h, w).astype(np.float32) * 2 - 1).to(
            device).permute(0, 2, 3, 1)
    return torch.from_numpy(rs.rand(s, h, w, c).astype(np.float32) * 2 - 1).to(device)


def phase_kernels(device="cuda"):
    import torch

    from caffe_rtpose_tpu_torch.ops import nms_cuda
    from caffe_rtpose_tpu_torch.ops.imresize import imresize_average

    dev = torch.device(device)
    cases = [  # name, S, start, gap, h, w, factor, C, layout
        ("coco_1scale", 1, 1.0, 0.3, 46, 82, 8, 18, "nhwc"),
        ("coco_3scale_gap0.15", 3, 1.0, 0.15, 46, 82, 8, 18, "nhwc"),
        ("coco_3scale_gap0.3", 3, 1.0, 0.3, 46, 82, 8, 18, "nhwc"),
        ("mpi_3scale", 3, 0.9, 0.1, 46, 82, 8, 15, "nhwc"),
        ("small", 1, 1.0, 0.3, 12, 16, 8, 6, "nhwc"),
        ("small_3scale", 3, 0.9, 0.1, 12, 16, 8, 6, "nhwc"),
        ("ragged", 1, 1.0, 0.3, 13, 17, 8, 5, "nhwc"),
        ("ragged_3scale", 3, 0.9, 0.1, 13, 17, 8, 5, "nhwc"),
        ("coco_1scale_view57", 1, 1.0, 0.3, 46, 82, 8, 18, "view57"),
        ("coco_3scale_view57", 3, 1.0, 0.3, 46, 82, 8, 18, "view57"),
        ("coco_1scale_chan_major", 1, 1.0, 0.3, 46, 82, 8, 18, "chan_major"),
        ("coco_1scale_vec4", 1, 1.0, 0.3, 46, 82, 8, 20, "nhwc"),
    ]
    thr = 0.05
    timing = []
    for i, (name, s, start, gap, h, w, f, c, layout) in enumerate(cases):
        rs = np.random.RandomState(100 + i)
        low = lowres_input(rs, s, h, w, c, layout, dev)
        th, tw = h * f, w * f
        got = nms_cuda.peak_mask_fused(low, (th, tw), start, gap, thr)
        torch.cuda.synchronize()
        ref = nms_cuda.peak_mask_fused_reference(low, (th, tw), start, gap, thr)
        heat = imresize_average(low, th, tw, start, gap)[0].permute(2, 0, 1)
        check(got.dtype == torch.bool and got.shape == ref.shape, f"{name}: mask dtype/shape")
        n_diff, n_bad = near_tie_violations(got, ref, heat, thr)
        print(f"[kernels] {name}: S={s} {h}x{w}->{th}x{tw} C={c} {layout} (strides "
              f"{tuple(low.stride())}, 16-byte loads {nms_cuda.vec4_loads(low)}): "
              f"{int(ref.sum())} peaks, {n_diff} pixels differ, {n_bad} of them no near-tie")
        check(n_bad == 0, f"peak mask kernel disagrees with the plain version at {name}")
        check(int(ref.sum()) > 0, f"{name}: no peaks, the comparison is vacuous")
        if name in ("coco_1scale_view57", "coco_3scale_view57"):  # the estimator's input
            args = (low, (th, tw), start, gap, thr)
            ms_p, ms_k, ms_k2, ms_p2 = time_pair(
                lambda: nms_cuda.peak_mask_fused_reference(*args),
                lambda: nms_cuda.peak_mask_fused(*args))
            b_ms, b_by = k1_bound(s, h, w, c, th, tw)
            print(f"[kernels] {name} call median of 20 (plain, kernel, kernel, plain): "
                  f"{ms_p:.4f} {ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f} ms; bound {b_ms:.5f} ms "
                  f"({b_by})")
            row = timing_row(f"S={s} {h}x{w}x{c} (slice of 57) -> {th}x{tw}",
                             lambda args=args: nms_cuda.peak_mask_fused(*args), "peak_mask_kernel",
                             min(ms_k, ms_k2), min(ms_p, ms_p2), b_ms, b_by, None)
            row["max_abs_err"] = float((got.to(torch.int8) - ref.to(torch.int8)).abs().max())
            timing.append(row)
    timing.append(peak_mask_frames(dev, thr))
    return timing


K1_FRAMES = 8  # the bf16 batch-8 pass: one launch over its frames


def peak_mask_frames(dev, thr, frames=K1_FRAMES, s=1, h=46, w=82, c=18, f=8):
    """K1 with a frame axis at the main path's shape: ``frames`` frames of the
    (F*S, 57, h, w) channels_last blob seen as (F, S, h, w, 57) and sliced to
    the c part channels, as the estimator hands them over; one launch,
    against the plain version (frame by frame); timed."""
    import torch

    from caffe_rtpose_tpu_torch.ops import nms_cuda
    from caffe_rtpose_tpu_torch.ops.imresize import imresize_average

    rs = np.random.RandomState(150)
    blob = torch.from_numpy(rs.rand(frames * s, 57, h, w).astype(np.float32) * 2 - 1).to(dev)
    blob = blob.contiguous(memory_format=torch.channels_last)
    low = blob.permute(0, 2, 3, 1).reshape(frames, s, h, w, 57)[..., :c]
    th, tw = h * f, w * f
    before = nms_cuda.launches
    got = nms_cuda.peak_mask_fused(low, (th, tw), 1.0, 0.3, thr)
    torch.cuda.synchronize()
    check(nms_cuda.launches == before + 1, "[kernels] frames: one launch for all frames")
    ref = nms_cuda.peak_mask_fused_reference(low, (th, tw), 1.0, 0.3, thr)
    check(got.dtype == torch.bool and got.shape == ref.shape == (frames, c, th, tw),
          "[kernels] frames: mask dtype/shape")
    heat = torch.stack([imresize_average(x, th, tw, 1.0, 0.3)[0].permute(2, 0, 1) for x in low])
    n_diff, n_bad = near_tie_violations(got.reshape(-1, th, tw), ref.reshape(-1, th, tw),
                                        heat.reshape(-1, th, tw), thr)
    alone = all(torch.equal(got[i], nms_cuda.peak_mask_fused(low[i], (th, tw), 1.0, 0.3, thr))
                for i in range(frames))
    print(f"[kernels] frames: F={frames} S={s} {h}x{w}->{th}x{tw} C={c} channels_last slice of "
          f"57 (strides {tuple(low.stride())}, 16-byte loads {nms_cuda.vec4_loads(low)}): "
          f"{int(ref.sum())} peaks, {n_diff} pixels differ, {n_bad} of them no near-tie; each "
          f"frame bit-identical to the kernel on that frame alone: {alone}")
    check(n_bad == 0, "peak mask kernel disagrees with the plain version on 8 frames")
    check(alone, "a frame of the batch differs from the kernel on that frame alone")
    check(int(ref.sum()) > 0, "frames: no peaks, the comparison is vacuous")
    args = (low, (th, tw), 1.0, 0.3, thr)
    ms_p, ms_k, ms_k2, ms_p2 = time_pair(lambda: nms_cuda.peak_mask_fused_reference(*args),
                                         lambda: nms_cuda.peak_mask_fused(*args))
    b_ms, b_by = k1_bound(s, h, w, frames * c, th, tw)  # F times the one-frame work
    print(f"[kernels] frames call median of 20 (plain, kernel, kernel, plain): {ms_p:.4f} "
          f"{ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
    row = timing_row(f"F={frames} S={s} {h}x{w}x{c} (channels_last slice of 57) -> {th}x{tw}",
                     lambda: nms_cuda.peak_mask_fused(*args), "peak_mask_kernel",
                     min(ms_k, ms_k2), min(ms_p, ms_p2), b_ms, b_by, None)
    row["max_abs_err"] = float((got.to(torch.int8) - ref.to(torch.int8)).abs().max())
    return row


K3_TIMED = ("coco_1scale", "coco_3scale_gap0.3", "mpi_3scale")  # coco_1scale: the main row
K3_MASK_EQ_K1 = ("coco_1scale", "coco_3scale_gap0.3", "mpi_3scale", "ragged")


def phase_upsample_keys(device="cuda"):
    import torch

    from caffe_rtpose_tpu_torch.ops import nms_cuda

    dev = torch.device(device)
    cases = [  # name, S, start, gap, h, w, factor or (th, tw), C, key channels, layout
        ("coco_1scale", 1, 1.0, 0.3, 46, 82, 8, 57, 18, "nhwc"),
        ("coco_3scale_gap0.3", 3, 1.0, 0.3, 46, 82, 8, 57, 18, "nhwc"),
        ("mpi_3scale", 3, 0.9, 0.1, 46, 82, 8, 44, 15, "nhwc"),
        ("small", 1, 1.0, 0.3, 12, 16, 8, 7, 7, "nhwc"),
        ("small_3scale", 3, 0.9, 0.1, 12, 16, 8, 7, 7, "nhwc"),
        ("ragged", 1, 1.0, 0.3, 13, 17, 8, 8, 5, "nhwc"),
        ("ragged_3scale", 3, 0.9, 0.1, 13, 17, 8, 8, 5, "nhwc"),
        ("coco_1scale_view57", 1, 1.0, 0.3, 46, 82, 8, 18, 18, "view57"),
        ("coco_1scale_chan_major", 1, 1.0, 0.3, 46, 82, 8, 19, 18, "chan_major"),
        ("ragged_direct_store", 3, 0.9, 0.1, 13, 17, (101, 134), 8, 5, "nhwc"),
    ]
    thr = 0.05
    timing = []
    for i, (name, s, start, gap, h, w, f, c, kc, layout) in enumerate(cases):
        rs = np.random.RandomState(200 + i)
        low = lowres_input(rs, s, h, w, c, layout, dev)
        th, tw = (h * f, w * f) if isinstance(f, int) else f
        path = nms_cuda.keys_store_path(th, tw)
        check(path == ("direct" if name == "ragged_direct_store" else "tma"),
              f"{name}: store path {path}")
        heat, keys = nms_cuda.upsample_peak_keys(low, (th, tw), start, gap, thr, key_channels=kc)
        torch.cuda.synchronize()
        r_heat, r_keys = nms_cuda.upsample_peak_keys_reference(low, (th, tw), start, gap, thr, kc)
        check(heat.shape == r_heat.shape == (c, th, tw) and keys.shape == r_keys.shape
              == (kc, th * (tw // 2)) and keys.dtype == torch.int32, f"{name}: output shapes")
        err = (heat - r_heat).abs()
        max_err = float(err.max())
        heat_ok = bool((err <= TOL_HEAT * r_heat.abs().clamp_min(1.0)).all())
        got_m, ref_m = keys_to_mask(keys, th, tw), keys_to_mask(r_keys, th, tw)
        n_diff, n_bad = near_tie_violations(got_m, ref_m, r_heat[:kc], thr)
        n_slots = int((keys != r_keys).sum())
        k1_eq = ""
        if name in K3_MASK_EQ_K1:  # the same U, so the same peaks as K1
            k1_mask = nms_cuda.peak_mask_fused(low[..., :kc], (th, tw), start, gap, thr)
            torch.cuda.synchronize()
            same = bool(torch.equal(got_m, k1_mask))
            k1_eq = f"; mask bit for bit K1's: {same}"
            check(same, f"upsample kernel's peaks differ from the peak-mask kernel's at {name}")
        print(f"[kernels] upsample_peak_keys {name}: S={s} {h}x{w}->{th}x{tw} C={c} keys for "
              f"{kc} {layout} ({path} stores): max |heat - plain| {max_err:.3g}, "
              f"{int(ref_m.sum())} peaks, {n_slots} key slots and {n_diff} peak pixels differ, "
              f"{n_bad} of them no near-tie{k1_eq}")
        check(heat_ok, f"upsample kernel's heat disagrees with the plain version at {name}")
        check(n_bad == 0, f"upsample kernel's keys disagree with the plain version at {name}")
        check(int(ref_m.sum()) > 0, f"{name}: no peaks, the comparison is vacuous")
        if name in K3_TIMED:  # the heatmap path's input, at 1 and 3 scales
            args = (low, (th, tw), start, gap, thr, kc)
            ms_p, ms_k, ms_k2, ms_p2 = time_pair(
                lambda: nms_cuda.upsample_peak_keys_reference(*args),
                lambda: nms_cuda.upsample_peak_keys(*args))
            b_ms, b_by = k3_bound(s, h, w, c, kc, th, tw)
            print(f"[kernels] upsample_peak_keys {name} call median of 20 (plain, kernel, "
                  f"kernel, plain): {ms_p:.4f} {ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f} ms; bound "
                  f"{b_ms:.5f} ms ({b_by})")
            row = timing_row(f"S={s} {h}x{w}x{c} -> {th}x{tw}, keys for {kc}",
                             lambda args=args: nms_cuda.upsample_peak_keys(*args),
                             "upsample_peak_keys_kernel", min(ms_k, ms_k2), min(ms_p, ms_p2),
                             b_ms, b_by, None)
            row["max_abs_err"] = max_err
            timing.append(row)
    return timing


def fan_in_weights(net, seed: int):
    rs = np.random.RandomState(seed)
    weights = {}
    for name in sorted(net.convs.keys()):
        cout, cin, kh, kw = net.convs[name].weight.shape
        w = rs.randn(cout, cin, kh, kw).astype(np.float32) * np.sqrt(2.0 / (cin * kh * kw))
        weights[name] = [w, np.zeros(cout, np.float32)]
    return weights


def calibrate_heat_head(est, weights, frames, frac: float):
    """Shift the part-heatmap head's bias so that ``frac`` of each part's
    pixels of the scale-averaged full-res map, over all ``frames``, clear the
    NMS threshold.  Every bicubic row sums to 1, so a bias shift b moves that
    map by exactly b."""
    import torch

    from caffe_rtpose_tpu_torch.ops.imresize import imresize_average

    head = est.net.post_layers["resize"].bottoms[0]
    concat = next(l for l in est.net.layers if l.tops == [head])
    heat_layer = concat.bottoms[0]  # heatmaps first (deploy file order)
    P = est.num_parts
    th, tw = est.target_hw
    maps = []
    for canvas in frames:
        x = torch.from_numpy(canvas).to(est.device).float() / 256.0 - 0.5
        x = (x * est._mask).permute(0, 3, 1, 2)  # as the estimator normalizes u8 input
        with torch.inference_mode():
            low = est.net({"image": x}, outputs=[heat_layer])[heat_layer][:, :P].float()
            u = imresize_average(low.permute(0, 2, 3, 1), th, tw, est.start_scale, est.scale_gap)
        maps.append(u.reshape(-1, P))
    u = torch.cat(maps)
    q = u.kthvalue(int(u.shape[0] * (1.0 - frac)), dim=0).values
    bias = weights[heat_layer][1].copy()
    bias[:P] += est.params_connect.nms_threshold - q.cpu().numpy()
    weights[heat_layer] = [weights[heat_layer][0], bias]
    return weights


def canvases(rs, n, shape):
    """Synthetic u8 frames: smooth colour gradients plus noise."""
    s, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        base = np.stack([(np.sin(xx / rs.uniform(20, 80) + rs.uniform(0, 6)) * 0.5 + 0.5)
                         * (np.cos(yy / rs.uniform(20, 80)) * 0.5 + 0.5) for _ in range(3)], -1)
        img = np.clip(base * 200 + rs.rand(h, w, 3) * 55, 0, 255).astype(np.uint8)
        out.append(np.broadcast_to(img, (s, h, w, 3)).copy())
    return out


def slice_config(num_scales: int, device: str, net_resolution):
    import torch

    return dict(net_resolution=net_resolution, num_scales=num_scales, input_u8=True,
                pair_cap=32, pack_u8=False, dtype=torch.float32, device=device)


def calibrated_weights(num_scales: int, n_frames: int, device="cuda",
                       net_resolution=(656, 368), stages=6):
    """Seeded fan-in weights with the part head calibrated on n_frames
    synthetic u8 canvases -> (weights, canvases)."""
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    est = PoseEstimator(make_pose_deploy_net("COCO", stages=stages),
                        **slice_config(num_scales, device, net_resolution))
    frames = canvases(np.random.RandomState(0), n_frames, est.input_shape())
    weights = fan_in_weights(est.net, 0)
    est.net.load_weights(weights)
    return calibrate_heat_head(est, weights, frames, HEAT_FRAC), frames


def phase_slice(num_scales: int, n_frames: int, device="cuda", net_resolution=(656, 368),
                stages=6, weights=None, frames=None):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    cfg = slice_config(num_scales, device, net_resolution)
    proto = make_pose_deploy_net("COCO", stages=stages)
    if weights is None:
        weights, frames = calibrated_weights(num_scales, n_frames, device, net_resolution, stages)
    est = PoseEstimator(proto, weights=weights, peak_kernel=True, **cfg)
    twin = PoseEstimator(proto, weights=weights, peak_kernel=False, **cfg)
    tag = f"[slice {num_scales}-scale]"

    nms_cuda.launches = 0
    est.estimate_from_net_input(frames[0])  # builds the kernels, captures the graph
    torch.cuda.synchronize()
    calls = nms_cuda.launches  # the eager pass and the capture
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(f) for f in frames]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    check(calls >= 1, f"{tag} the peak-mask wrapper never launched")
    refetch0 = est._overflow_refetches
    _, replayed, seen, _, _ = replay_kernels(
        lambda: [est.estimate_from_net_input(f) for f in frames], est)
    passes = n_frames + est._overflow_refetches - refetch0
    check_launches(tag, replayed, seen, {"peak_mask_kernel": passes})
    launches, seen1 = replayed["peak_mask_kernel"], seen["peak_mask_kernel"]

    dev_ms = cuda_ms(lambda: est.run_device(frames[1 % n_frames]), reps=n_frames)
    total_peaks = 0
    max_err = 0.0
    for f, res in zip(frames, results):
        pk, sc, ct = est.fetch(est.run_device(f))
        pt, st, cnt_t = twin.fetch(twin.run_device(f))
        check(pk.shape == (18, 33, 3) and sc.shape == ct.shape == (19, 32, 32), f"{tag} shapes")
        check(pt.shape == pk.shape and st.shape == sc.shape, f"{tag} plain-path shapes")
        np.testing.assert_array_equal(pk[:, 0, 0], pt[:, 0, 0], err_msg=f"{tag} peak counts")
        np.testing.assert_array_equal(ct, cnt_t, err_msg=f"{tag} pair counts")
        np.testing.assert_allclose(pk, pt, rtol=0, atol=TOL_FLOAT, err_msg=f"{tag} peaks")
        np.testing.assert_allclose(sc, st, rtol=0, atol=TOL_FLOAT, err_msg=f"{tag} pair scores")
        max_err = max(max_err, float(np.nanmax(np.abs(pk - pt))), float(np.abs(sc - st).max()))
        n = np.minimum(res.peaks[:, 0, 0].astype(int), res.peaks.shape[1] - 1)
        for p in range(18):
            check(np.isfinite(res.peaks[p, 1 : n[p] + 1]).all(), f"{tag} non-finite peak")
        check(np.isfinite(res.joints).all(), f"{tag} non-finite joints")
        total_peaks += int(res.peaks[:, 0, 0].sum())
    people = [r.num_people for r in results]
    print(f"{tag} {n_frames} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame (host clock), peak-mask launches {launches} "
          f"for {passes} replayed passes ({seen1} in the profiler; wrapper calls {calls} for "
          f"the eager pass and the capture), peaks {total_peaks}, people {people}, "
          f"max |kernel path - plain path| {max_err:.3g}")
    check(total_peaks > 0, f"{tag} no peaks at all")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, launches=calls, device_launches=launches,
                peaks=total_peaks, people=people, weights=weights, frames=frames)


def real_pairs(desc, peaks):
    """(L, M, M) bool: the pairs of real peaks ([:na, :nb] of each limb)."""
    m = peaks.shape[1] - 1
    n = np.minimum(peaks[:, 0, 0].astype(int), m)
    out = np.zeros((desc.num_limbs, m, m), bool)
    for k in range(desc.num_limbs):
        a, b = desc.limb(k)
        out[k, : n[a], : n[b]] = True
    return out


def pair_dots(heat, peaks, desc, k, i, j):
    """The 10 sample dots of candidate pair (i, j) of limb k on the full-res
    maps, computed as connect.score_pairs does (C rounding, clamps)."""
    _, h, w = heat.shape
    a, b = desc.limb(k)
    cx, cy = desc.paf_channels(k)
    ax, ay = peaks[a, i + 1, :2]
    dx, dy = peaks[b, j + 1, :2] - peaks[a, i + 1, :2]
    norm = np.sqrt(dx * dx + dy * dy)
    vx, vy = (dx / norm, dy / norm) if norm >= 1e-6 else (0.0, 0.0)
    lm = np.arange(10, dtype=np.float32)
    sx = np.clip(np.floor(ax + lm * dx / 10 + 0.5).astype(int), 0, w - 1)
    sy = np.clip(np.floor(ay + lm * dy / 10 + 0.5).astype(int), 0, h - 1)
    return vx * heat[cx, sy, sx] + vy * heat[cy, sy, sx]


def count_near_ties(tag, c1, c2, real, heat, peaks, desc, thr):
    """Pair counts over the real peaks may differ only where one of the
    pair's 10 samples has a dot within TOL_NEAR_TIE of inter_threshold (the
    two sides sample heat maps that differ by f32 rounding).  Returns the
    number of differing counts; raises if one of them is no such near-tie."""
    diff = np.argwhere((c1 != c2) & real)
    for k, i, j in diff:
        dots = pair_dots(heat, peaks, desc, k, i, j)
        check(np.abs(dots - thr).min() <= TOL_NEAR_TIE,
              f"{tag} pair count of limb {k} ({i}, {j}) differs, no near-tie")
    return len(diff)


def phase_heatmap(weights, canvases_u8, device="cuda", net_resolution=(656, 368), stages=6):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import region_boxes

    tag = "[heatmap]"
    res = net_resolution
    cfg = dict(net_resolution=res, num_scales=1, dtype=torch.float32, device=device)
    proto = make_pose_deploy_net("COCO", stages=stages)
    est = PoseEstimator(proto, weights=weights, keep_heatmap=True, peak_kernel=True, **cfg)
    twin = PoseEstimator(proto, weights=weights, keep_heatmap=True, peak_kernel=False, **cfg)
    packed = PoseEstimator(proto, weights=weights, input_u8=True, peak_kernel=True, **cfg)
    # the realtime estimator's normalisation, on the host: u8/256 - 0.5 in
    # the image region, 0 in the padding
    mask = np.zeros((1, res[1], res[0], 1), np.float32)
    for y0, y1, x0, x1 in region_boxes(res[0], res[1], 1, 1.0, 0.3):
        mask[0, y0:y1, x0:x1] = 1.0
    inputs = [np.ascontiguousarray(((u8.astype(np.float32) / 256.0 - 0.5) * mask)
                                   .transpose(0, 3, 1, 2)) for u8 in canvases_u8]
    check(est.input_shape() == inputs[0].shape and not est.input_u8, f"{tag} input format")

    nms_cuda.launches = 0
    nms_cuda.upsample_launches = 0
    est.estimate_from_net_input(inputs[0])  # builds the kernels, captures the graph
    torch.cuda.synchronize()
    calls, mask_calls = nms_cuda.upsample_launches, nms_cuda.launches
    check(calls >= 1 and mask_calls == 0, f"{tag} wrapper calls: upsample {calls}, peak mask "
          f"{mask_calls}")
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(x) for x in inputs]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / len(inputs)
    _, replayed, seen, _, _ = replay_kernels(
        lambda: [est.estimate_from_net_input(x) for x in inputs], est)
    check_launches(tag, replayed, seen, {"upsample_peak_keys_kernel": len(inputs)})
    launches, mask_launches = replayed["upsample_peak_keys_kernel"], replayed["peak_mask_kernel"]

    dev_ms = cuda_ms(lambda: est.run_device(inputs[1]), reps=len(inputs))
    fetch = []
    for x in inputs:
        out = est.run_device(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["heatmap"].cpu()
        fetch.append((time.perf_counter() - t1) * 1000.0)
    fetch_ms = statistics.median(fetch)

    desc, thr = est.descriptor, est.params_connect.inter_threshold
    max_err, max_heat_err, n_ties_plain, n_ties_packed, total_peaks = 0.0, 0.0, 0, 0, 0
    for u8, x, r in zip(canvases_u8, inputs, results):
        o_k, o_p = est.run_device(x), twin.run_device(x)
        (pk, sk, ck), (pp, sp, cp) = est.fetch(o_k), twin.fetch(o_p)
        hk, hp = o_k["heatmap"].cpu().numpy(), o_p["heatmap"].cpu().numpy()
        check(pk.shape == (18, 65, 3) and sk.shape == ck.shape == (19, 64, 64)
              and hk.shape == (57, *est.target_hw), f"{tag} shapes")
        check(r.heatmap is not None and r.heatmap.shape == hk.shape, f"{tag} PoseResult.heatmap")
        check(np.isfinite(hk).all() and np.isfinite(r.heatmap).all(), f"{tag} non-finite heat")
        herr = np.abs(hk - hp)
        check((herr <= TOL_HEAT * np.maximum(1.0, np.abs(hp))).all(), f"{tag} heat vs plain")
        max_heat_err = max(max_heat_err, float(herr.max()))
        real = real_pairs(desc, pp)
        # kernel vs plain version of the same branch
        np.testing.assert_array_equal(pk[:, 0, 0], pp[:, 0, 0], err_msg=f"{tag} peak counts")
        np.testing.assert_allclose(pk, pp, rtol=0, atol=TOL_FLOAT, err_msg=f"{tag} peaks")
        np.testing.assert_allclose(sk[real], sp[real], rtol=TOL_FLOAT, atol=TOL_FLOAT,
                                   err_msg=f"{tag} pair scores")
        n_ties_plain += count_near_ties(f"{tag} vs plain:", ck, cp, real, hp, pp, desc, thr)
        max_err = max(max_err, float(np.nanmax(np.abs(pk - pp))),
                      float(np.abs(sk[real] - sp[real]).max(initial=0.0)))
        # against the packed realtime branch on the same frame
        p1, s1, c1 = packed.fetch(packed.run_device(u8))
        np.testing.assert_array_equal(p1[:, 0, 0], pk[:, 0, 0], err_msg=f"{tag} packed counts")
        np.testing.assert_allclose(p1, pk, rtol=0, atol=TOL_BRANCH_PEAKS,
                                   err_msg=f"{tag} packed peaks")
        real = real_pairs(desc, pk)
        np.testing.assert_allclose(s1[real], sk[real], rtol=TOL_BRANCH_SCORES,
                                   atol=TOL_BRANCH_SCORES, err_msg=f"{tag} packed scores")
        n_ties_packed += count_near_ties(f"{tag} vs packed:", c1, ck, real, hk, pk, desc, thr)
        check(np.isfinite(r.joints).all(), f"{tag} non-finite joints")
        total_peaks += int(r.peaks[:, 0, 0].sum())
    people = [r.num_people for r in results]
    print(f"{tag} {len(inputs)} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame (host clock, heatmap fetch included), heatmap "
          f"fetch {fetch_ms:.3f} ms (median), upsample launches {launches} for {len(inputs)} "
          f"passes, peak-mask launches {mask_launches}, peaks {total_peaks}, people {people}, "
          f"max |kernel - plain| heat {max_heat_err:.3g}, peaks/scores {max_err:.3g}; pair "
          f"counts differing at near-ties: {n_ties_plain} vs plain, {n_ties_packed} vs packed")
    check(total_peaks > 0, f"{tag} no peaks at all")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, fetch_ms=fetch_ms, launches=calls,
                device_launches=launches, peaks=total_peaks, people=people,
                canvas=canvases_u8[-1][0],
                result=results[-1])


def phase_render(canvas_u8, result, device="cuda"):
    """The views runner._render dispatches for COCO, from one frame."""
    import torch

    from caffe_rtpose_tpu_torch.pose import render as R
    from caffe_rtpose_tpu_torch.pose.descriptor import RENDER_MAX_PEOPLE

    P = 18
    canvas = torch.from_numpy(canvas_u8.astype(np.float32)).to(device)
    maps = torch.from_numpy(result.heatmap).to(device)
    poses = np.zeros((RENDER_MAX_PEOPLE, P, 3), np.float32)
    n = min(result.num_people, RENDER_MAX_PEOPLE)
    poses[:n] = result.joints[:n]
    poses = torch.from_numpy(poses).to(device)
    views = {
        "pose (0)": lambda: R.render_pose(canvas, poses, n, num_parts=P),
        "part 1": lambda: R.render_heatmap(canvas, maps, 0, num_parts=P),
        "all parts (19)": lambda: R.render_all_parts(canvas, maps, num_parts=P),
        "accumulated PAFs (20)": lambda: R.render_paf(canvas, maps, P + 1, num_parts_accum=P + 1),
        "PAF pair (21)": lambda: R.render_paf(canvas, maps, P + 1),
    }
    times = {}
    for name, fn in views.items():
        out = fn()
        torch.cuda.synchronize()
        check(out.shape == canvas.shape and out.device == canvas.device, f"[render] {name} shape")
        check(bool(torch.isfinite(out).all()), f"[render] {name} non-finite")
        times[name] = cuda_ms(fn, reps=10)
    print(f"[render] {canvas.shape[1]}x{canvas.shape[0]} canvas, {n} people, ms (CUDA events, median of 10): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return times


def conv1_inputs(b, h, w, seed, device):
    """(B, 3, H, W) bf16 channels_last input and packed conv1 weights, in the
    draws of tests/test_torch_conv1.py."""
    import torch

    from caffe_rtpose_tpu_torch.ops.conv1_cuda import Conv1Weights

    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.rand(b, 3, h, w).astype(np.float32) - 0.5).to(device, torch.bfloat16)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    cw = Conv1Weights.pack(t(rs.randn(64, 3, 3, 3) * 0.1), t(rs.randn(64) * 0.1),
                           t(rs.randn(64, 64, 3, 3) * 0.05), t(rs.randn(64) * 0.1))
    return x.contiguous(memory_format=torch.channels_last), cw


def cudnn_chain(cw):
    """The unfused bf16 chain as the net runs it layer by layer (bf16
    operands made once), as a function of x."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    w1, b1, w2, b2 = (t.to(bf) for t in (cw.w1, cw.b1, cw.w2, cw.b2))
    w1, w2 = (w.contiguous(memory_format=torch.channels_last) for w in (w1, w2))

    def run(x):
        h = F.conv2d(x, w1, b1, padding=1).relu_()
        return F.max_pool2d(F.conv2d(h, w2, b2, padding=1).relu_(), 2, 2)

    return run


def phase_conv1(device="cuda"):
    import torch

    from caffe_rtpose_tpu_torch.ops import conv1_cuda

    timing = []
    for i, (name, b, h, w) in enumerate(CONV1_CASES):
        x, cw = conv1_inputs(b, h, w, 300 + i, device)
        chain = cudnn_chain(cw)
        got = conv1_cuda.conv1_block(x, cw)
        torch.cuda.synchronize()
        ref = conv1_cuda.conv1_block_reference(x, cw)
        check(tuple(got.shape) == (b, 64, h // 2, w // 2) and got.dtype == torch.bfloat16
              and got.is_contiguous(memory_format=torch.channels_last), f"[conv1] {name}: output")
        a, r = got.float(), ref.float()
        err = (a - r).abs()
        tol = torch.clamp_min(torch.maximum(a.abs(), r.abs()) * TOL_CONV1_REL, TOL_CONV1_ABS)
        n_bad = int((err > tol).sum())
        err_c = float((a - chain(x).float()).abs().max())
        frac = float((r > 0).float().mean())
        print(f"[conv1] {name}: ({b}, 3, {h}, {w}) -> ({b}, 64, {h // 2}, {w // 2}): max |kernel - "
              f"plain| {float(err.max()):.4g}, {n_bad} beyond two bf16 ulps; max |kernel - cuDNN "
              f"bf16 chain| {err_c:.4g}; {frac:.3f} of outputs > 0")
        check(n_bad == 0, f"[conv1] kernel disagrees with the plain version at {name}")
        check(frac > 0.2, f"[conv1] {name}: too few non-zero outputs, the comparison is vacuous")
        # the same input in NCHW: the same sums, read through other strides
        check(torch.equal(conv1_cuda.conv1_block(x.contiguous(), cw), got),
              f"[conv1] {name}: NCHW input gives another result than channels_last")
        if name in CONV1_TIMED:
            ms_p, ms_k, ms_k2, ms_p2 = time_pair(lambda: conv1_cuda.conv1_block_reference(x, cw),
                                                 lambda: conv1_cuda.conv1_block(x, cw))
            ms_c = cuda_ms(lambda: chain(x))
            b_ms, b_by = k4_bound(b, h, w)
            print(f"[conv1] {name} call median of 20 (plain, kernel, kernel, plain; cuDNN bf16 "
                  f"chain): {ms_p:.4f} {ms_k:.4f} {ms_k2:.4f} {ms_p2:.4f}; {ms_c:.4f} ms; bound "
                  f"{b_ms:.5f} ms ({b_by}, {2 * b * h * w * 64 * (27 + 576) / 1e9:.2f} GFLOP)")
            row = timing_row(f"B*S={b} 3x{h}x{w}", lambda x=x, cw=cw: conv1_cuda.conv1_block(x, cw),
                             "conv1_block_kernel", min(ms_k, ms_k2), min(ms_p, ms_p2), b_ms, b_by,
                             ms_c)
            row["max_abs_err"] = float(err.max())
            timing.append(row)
    return timing


def match_share(ref_peaks, peaks, thr):
    """How many of the peaks in ``ref_peaks`` (a list of (P, M+1, 3) arrays)
    ``peaks`` reproduces within the joint budget: a peak of the same part
    within MATCH_PX and MATCH_SCORE, or none where the reference peak's
    score is within MATCH_SCORE of the threshold ``thr`` (a change within
    the budget may take it under).  Returns (share, reference peaks, share
    within MATCH_PX alone, peaks counted by the threshold rule, share
    without that rule)."""
    hit = hit_px = near = total = 0
    for a, b in zip(ref_peaks, peaks):
        for p in range(a.shape[0]):
            na = min(int(a[p, 0, 0]), a.shape[1] - 1)
            nb = min(int(b[p, 0, 0]), b.shape[1] - 1)
            if na == 0:
                continue
            pa, pb = a[p, 1 : na + 1], b[p, 1 : nb + 1]
            total += na
            d = np.hypot(pa[:, None, 0] - pb[None, :, 0], pa[:, None, 1] - pb[None, :, 1])
            ok = ((d <= MATCH_PX) & (np.abs(pa[:, None, 2] - pb[None, :, 2]) <= MATCH_SCORE)).any(1)
            low = ~ok & (pa[:, 2] <= thr + MATCH_SCORE)
            hit += int(ok.sum())
            near += int(low.sum())
            hit_px += int((d <= MATCH_PX).any(1).sum())
    f = (lambda n: n / total) if total else (lambda n: 0.0)  # noqa: E731
    return f(hit + near), total, f(hit_px), near, f(hit)


def run_batched(est, batches):
    """The batched realtime loop: run_device + fetch_batch per batch, the
    uncapped refetch for an overflowed frame, host assembly -> per frame
    (peaks, num_people, joints)."""
    from caffe_rtpose_tpu_torch.pose import connect as C

    out = []
    for xs in batches:
        for x, (pk, sc, ct) in zip(xs, est.fetch_batch(est.run_device(xs))):
            if est.overflowed(pk):
                pk, sc, ct = est.refetch_full(x)
            r = C.assemble_fast(pk, sc, ct, est.descriptor, est.params_connect)
            out.append((pk, r.num_people, r.joints))
    return out


def lowres_maps(est, x_host):
    """The estimator's (F, S, h, w, C) f32 low-res maps of uploaded frames."""
    import torch

    with torch.inference_mode():
        return est._lowres(est._canvases(torch.from_numpy(x_host).to(est.device)))


def rel_l2(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_bf16(weights, device="cuda", net_resolution=(656, 368), stages=6,
               n_frames=BF16_FRAMES, batch=BF16_BATCH):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import conv1_cuda, nms_cuda
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    tag = f"[bf16 batch {batch}]"
    proto = make_pose_deploy_net("COCO", stages=stages)
    cfg = dict(net_resolution=net_resolution, num_scales=1, input_u8=True, pair_cap=32,
               device=device)
    f32 = PoseEstimator(proto, weights=weights, **cfg)
    # the first 8 are the f32 slice's frames, on which its weights were set
    frames = canvases(np.random.RandomState(0), n_frames, f32.input_shape())
    est = PoseEstimator(proto, weights=weights, dtype=torch.bfloat16, batch=batch, **cfg)
    twin = PoseEstimator(proto, weights=weights, dtype=torch.bfloat16, batch=batch,
                         conv1_kernel=False, peak_kernel=False, **cfg)
    check(est.net.conv1_kernel and est.peak_kernel and list(est.net.conv1_blocks) == ["conv1_1"]
          and not twin.net.conv1_kernel, f"{tag} kernel switches")
    batches = [np.stack(frames[i : i + batch]) for i in range(0, n_frames, batch)]

    conv1_cuda.launches = nms_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    est.fetch_batch(est.run_device(batches[0]))  # builds the kernels, captures the graph
    torch.cuda.synchronize()
    calls4, calls1 = conv1_cuda.launches, nms_cuda.launches
    check(calls4 >= 1 and calls1 >= 1, f"{tag} wrapper calls: conv1 {calls4}, peak mask {calls1}")
    t0 = time.perf_counter()
    results = run_batched(est, batches)
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    peak_mem = torch.cuda.max_memory_allocated()
    refetch0 = est._overflow_refetches
    _, counts, seen, per_pass, _ = replay_kernels(lambda: run_batched(est, batches), est)
    k4, k1 = counts["conv1_block_kernel"], counts["peak_mask_kernel"]
    refetches = est._overflow_refetches - refetch0
    passes = len(batches) + refetches
    check_launches(f"{tag} run_device + fetch_batch:", counts, seen,
                   {"conv1_block_kernel": passes, "peak_mask_kernel": passes})

    t0 = time.perf_counter()
    single = [est.estimate_from_net_input(f) for f in frames]
    e2e_one_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    refetch0 = est._overflow_refetches
    _, counts1, seen1, _, _ = replay_kernels(
        lambda: [est.estimate_from_net_input(f) for f in frames], est)
    refetches1 = est._overflow_refetches - refetch0
    k4_one, k1_one = counts1["conv1_block_kernel"], counts1["peak_mask_kernel"]
    check_launches(f"{tag} estimate_from_net_input:", counts1, seen1,
                   {"conv1_block_kernel": n_frames + refetches1,
                    "peak_mask_kernel": n_frames + refetches1})
    same = sum(np.array_equal(a.peaks, b[0], equal_nan=True) for a, b in zip(single, results))

    xd = torch.from_numpy(batches[0]).to(device)
    dev_ms = cuda_ms(lambda: est.run_device(batches[0]), reps=10) / batch
    cnn_ms = cuda_ms(lambda: est._lowres(est._canvases(xd)), reps=10) / batch
    x1 = torch.from_numpy(batches[0][:1]).to(device)
    cnn_f32_ms = cuda_ms(lambda: f32._lowres(f32._canvases(x1)), reps=10)
    dev_f32_ms = cuda_ms(lambda: f32.run_device(frames[0]), reps=10)

    twin_res = run_batched(twin, batches)
    f32_peaks = [f32.estimate_from_net_input(f).peaks for f in frames]
    peaks = [r[0] for r in results]
    thr = est.params_connect.nms_threshold
    share_twin, n_twin, px_twin, near_twin, strict_twin = match_share(
        [r[0] for r in twin_res], peaks, thr)
    share_f32, n_f32, px_f32, near_f32, strict_f32 = match_share(f32_peaks, peaks, thr)
    low_k = torch.cat([lowres_maps(est, b) for b in batches])
    low_p = torch.cat([lowres_maps(twin, b) for b in batches])
    low_f = torch.cat([lowres_maps(f32, f[None]) for f in frames])
    d_twin, d_f32, d_twin_f32 = rel_l2(low_k, low_p), rel_l2(low_k, low_f), rel_l2(low_p, low_f)
    total = 0
    for pk, people, joints in results:
        n = np.minimum(pk[:, 0, 0].astype(int), pk.shape[1] - 1)
        for p in range(pk.shape[0]):
            check(np.isfinite(pk[p, 1 : n[p] + 1]).all(), f"{tag} non-finite peak")
        check(np.isfinite(joints).all(), f"{tag} non-finite joints")
        total += int(pk[:, 0, 0].sum())
    people = [r[1] for r in results]
    print(f"{tag} {n_frames} frames: device {dev_ms:.3f} ms/frame (CUDA events, median of a "
          f"batch pass / {batch}), CNN alone {cnn_ms:.3f} ms/frame (f32 CNN {cnn_f32_ms:.3f} ms, "
          f"f32 pass {dev_f32_ms:.3f} ms/frame), end-to-end {e2e_ms:.3f} ms/frame through "
          f"run_device + fetch_batch, {e2e_one_ms:.3f} ms/frame through estimate_from_net_input "
          f"(one padded batch a frame); conv1 launches {k4} for {passes} passes and {k4_one} "
          f"for {n_frames + refetches1}; peak-mask launches {k1} and {k1_one} (the graphs' "
          f"count; the profiler saw conv1 {seen['conv1_block_kernel']} and "
          f"{seen1['conv1_block_kernel']}, peak-mask {seen['peak_mask_kernel']} and "
          f"{seen1['peak_mask_kernel']}); overflow "
          f"refetches {refetches} and {refetches1}; frames with identical peaks on both "
          f"paths {same}/{n_frames}; peaks {total}, people {people}; every kernel of a pass "
          f"{per_pass / passes:.0f}; torch.cuda.max_memory_allocated over the first passes "
          f"{peak_mem / 2**30:.3f} GiB")
    print(f"{tag} low-res maps, relative L2: kernel path vs plain path {d_twin:.4g}, kernel path "
          f"vs f32 {d_f32:.4g}, plain path vs f32 {d_twin_f32:.4g}; peaks within {MATCH_PX:g} "
          f"px / {MATCH_SCORE:g}: {share_twin:.4f} of the plain path's {n_twin}, "
          f"{share_f32:.4f} of the f32 estimator's {n_f32} (within {MATCH_PX:g} px alone: "
          f"{px_twin:.4f}, {px_f32:.4f}); counted as matched for lying within {MATCH_SCORE:g} "
          f"of the threshold: {near_twin} and {near_f32}; the strict shares without them: "
          f"{strict_twin:.4f}, {strict_f32:.4f}")
    check(total > 0, f"{tag} no peaks at all")
    check(d_twin <= L2_RATIO * d_twin_f32, f"{tag} kernel path too far from the plain path")
    check(share_twin >= MATCH_FLOOR, f"{tag} {share_twin:.4f} of the plain path's peaks matched")
    check(share_f32 >= MATCH_FLOOR, f"{tag} {share_f32:.4f} of the f32 peaks matched")
    return dict(device_ms=dev_ms, cnn_ms=cnn_ms, cnn_f32_ms=cnn_f32_ms, f32_device_ms=dev_f32_ms,
                e2e_ms=e2e_ms, e2e_single_ms=e2e_one_ms, launches=calls4,
                peak_mask_launches=calls1, device_launches=k4, peak_mask_device_launches=k1,
                kernels_per_pass=per_pass / passes, max_memory_allocated=peak_mem,
                peaks=total, people=people, share_plain=share_twin, share_f32=share_f32,
                share_f32_strict=strict_f32, l2_plain=d_twin, l2_f32=d_f32, weights=weights,
                frames=frames)


def packed_frames(canvases_u8, regions):
    """(S, H, W, 3) canvases -> the flat live-region buffers of pack_u8."""
    return [np.concatenate([c[i, ph : ph + rh, pw : pw + rw].reshape(-1)
                            for i, (rh, rw, ph, pw, _) in enumerate(regions)])
            for c in canvases_u8]


def phase_bf16_3scale(weights, device="cuda", net_resolution=(656, 368), stages=6, n_frames=4):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import region_boxes

    tag = "[bf16 3-scale pack_u8]"
    proto = make_pose_deploy_net("COCO", stages=stages)
    cfg = dict(net_resolution=net_resolution, num_scales=3, input_u8=True, pair_cap=32,
               dtype=torch.bfloat16, device=device)
    est = PoseEstimator(proto, weights=weights, **cfg)
    canvas = PoseEstimator(proto, weights=weights, pack_u8=False, **cfg)
    check(est.pack_u8 and not canvas.pack_u8, f"{tag} pack_u8 is the 3-scale u8 default")
    canv = canvases(np.random.RandomState(3), n_frames, canvas.input_shape())
    for c in canv:  # zero padding outside each scale's live region, as make_net_input_u8
        keep = np.zeros(c.shape[:3] + (1,), bool)
        for i, (y0, y1, x0, x1) in enumerate(region_boxes(*net_resolution, 3, 1.0, 0.3)):
            keep[i, y0:y1, x0:x1] = True
        c *= keep
    frames = packed_frames(canv, est._regions)
    check(frames[0].shape == est.input_shape(), f"{tag} packed input shape")
    weights = calibrate_heat_head(canvas, dict(weights), canv, HEAT_FRAC)
    est.net.load_weights(weights)
    canvas.net.load_weights(weights)

    est.estimate_from_net_input(frames[0])  # builds the kernels, captures the graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(f) for f in frames]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / n_frames
    refetch0 = est._overflow_refetches
    _, counts, seen, _, _ = replay_kernels(
        lambda: [est.estimate_from_net_input(f) for f in frames], est)
    passes = n_frames + est._overflow_refetches - refetch0
    k4, k1 = counts["conv1_block_kernel"], counts["peak_mask_kernel"]
    check_launches(tag, counts, seen, {"conv1_block_kernel": passes, "peak_mask_kernel": passes})
    dev_ms = cuda_ms(lambda: est.run_device(frames[1 % n_frames]), reps=n_frames)
    for f, c in zip(frames, canv):
        check(torch.equal(est.run_device(f)["packed"], canvas.run_device(c)["packed"]),
              f"{tag} packed upload differs from the canvas upload")
    total = sum(int(r.peaks[:, 0, 0].sum()) for r in results)
    check(all(np.isfinite(r.joints).all() for r in results), f"{tag} non-finite joints")
    print(f"{tag} {n_frames} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame, conv1 launches {k4} and peak-mask launches {k1} "
          f"for {passes} passes, packed outputs bit-identical to the canvas upload, "
          f"upload {frames[0].nbytes} B vs {canv[0].nbytes} B, peaks {total}, "
          f"people {[r.num_people for r in results]}")
    check(total > 0, f"{tag} no peaks at all")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, launches=k4, peaks=total,
                people=[r.num_people for r in results])


def phase_bf16_heatmap(weights, canvases_u8, device="cuda", net_resolution=(656, 368), stages=6):
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import region_boxes

    tag = "[bf16 heatmap]"
    res = net_resolution
    cfg = dict(net_resolution=res, num_scales=1, dtype=torch.bfloat16, keep_heatmap=True,
               device=device)
    proto = make_pose_deploy_net("COCO", stages=stages)
    est = PoseEstimator(proto, weights=weights, **cfg)
    twin = PoseEstimator(proto, weights=weights, conv1_kernel=False, peak_kernel=False, **cfg)
    mask = np.zeros((1, res[1], res[0], 1), np.float32)
    for y0, y1, x0, x1 in region_boxes(res[0], res[1], 1, 1.0, 0.3):
        mask[0, y0:y1, x0:x1] = 1.0
    inputs = [np.ascontiguousarray(((u8.astype(np.float32) / 256.0 - 0.5) * mask)
                                   .transpose(0, 3, 1, 2)) for u8 in canvases_u8]
    est.estimate_from_net_input(inputs[0])  # builds the kernels, captures the graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [est.estimate_from_net_input(x) for x in inputs]
    e2e_ms = (time.perf_counter() - t0) * 1000.0 / len(inputs)
    _, counts, seen, _, _ = replay_kernels(
        lambda: [est.estimate_from_net_input(x) for x in inputs], est)
    k4, k3, k1 = (counts[k] for k in KERNEL_NAMES[::-1])
    check_launches(tag, counts, seen, {"conv1_block_kernel": len(inputs),
                                       "upsample_peak_keys_kernel": len(inputs)})
    dev_ms = cuda_ms(lambda: est.run_device(inputs[1 % len(inputs)]), reps=len(inputs))
    plain = [twin.estimate_from_net_input(x) for x in inputs]
    share, n_ref, _, _, _ = match_share([r.peaks for r in plain], [r.peaks for r in results],
                                        est.params_connect.nms_threshold)
    heat_d = max(float(np.abs(a.heatmap - b.heatmap).max()) for a, b in zip(results, plain))
    heat_amp = max(float(np.abs(b.heatmap).max()) for b in plain)
    for r in results:
        check(r.heatmap.shape == (57, *est.target_hw) and np.isfinite(r.heatmap).all()
              and np.isfinite(r.joints).all(), f"{tag} heatmap / joints")
    total = sum(int(r.peaks[:, 0, 0].sum()) for r in results)
    print(f"{tag} {len(inputs)} frames: device {dev_ms:.3f} ms/frame (CUDA events, median), "
          f"end-to-end {e2e_ms:.3f} ms/frame (heatmap fetch included), conv1 launches {k4}, "
          f"upsample launches {k3}, peak-mask launches {k1}; against the plain twin: max "
          f"|heat diff| {heat_d:.4g} (maps up to {heat_amp:.4g}), {share:.4f} of its {n_ref} "
          f"peaks matched within {MATCH_PX:g} px / {MATCH_SCORE:g}; peaks {total}, "
          f"people {[r.num_people for r in results]}")
    check(total > 0, f"{tag} no peaks at all")
    check(share >= MATCH_FLOOR, f"{tag} {share:.4f} of the plain twin's peaks matched")
    return dict(device_ms=dev_ms, e2e_ms=e2e_ms, launches=k4, upsample_launches=k3,
                peaks=total, people=[r.num_people for r in results], share_plain=share)


GRAPH_THRESHOLDS = (0.05, 0.03)  # the default, then one the demo's -/= keys reach
OVERFLOW_THRESHOLD = -1.0  # every local maximum a peak: more than pair_cap in a part


def outputs_equal(a, b):
    """(bit-identical, max |a - b| over the float outputs) of two device
    output dicts."""
    import torch

    same, err = True, 0.0
    for k in a:
        same &= torch.equal(a[k], b[k])
        if a[k].is_floating_point():
            d = (a[k] - b[k]).abs().nan_to_num(0.0)
            err = max(err, float(d.max()))
    return same, err


def phase_graph(weights, frames_u8, device="cuda", net_resolution=(656, 368), stages=6,
                batch=BF16_BATCH):
    """Each device program as a CUDA graph against the same program run
    eagerly on the same estimator, at two thresholds set between replays;
    device and end-to-end ms/frame of both.  Returns the rows and the
    estimators for phase_graph_launches."""
    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import region_boxes

    proto = make_pose_deploy_net("COCO", stages=stages)
    res = net_resolution
    base = dict(net_resolution=res, num_scales=1, device=device)
    mask = np.zeros((1, res[1], res[0], 1), np.float32)
    for y0, y1, x0, x1 in region_boxes(res[0], res[1], 1, 1.0, 0.3):
        mask[0, y0:y1, x0:x1] = 1.0
    f32_in = np.ascontiguousarray(((frames_u8[0].astype(np.float32) / 256.0 - 0.5) * mask)
                                  .transpose(0, 3, 1, 2))
    configs = [
        ("f32 1-scale", dict(input_u8=True, pair_cap=32), frames_u8[0], 1,
         {"peak_mask_kernel": 1, "conv1_block_kernel": 0, "upsample_peak_keys_kernel": 0}),
        (f"bf16 batch {batch}", dict(input_u8=True, pair_cap=32, dtype=torch.bfloat16, batch=batch),
         np.stack(frames_u8[:batch]), batch,
         {"peak_mask_kernel": 1, "conv1_block_kernel": 1, "upsample_peak_keys_kernel": 0}),
        ("f32 heatmap", dict(keep_heatmap=True), f32_in, 1,
         {"peak_mask_kernel": 0, "conv1_block_kernel": 0, "upsample_peak_keys_kernel": 1}),
    ]
    out, graphs = {}, []
    for name, kw, x, frames, expect in configs:
        tag = f"[graph {name}]"
        est = PoseEstimator(proto, weights=weights, **base, **kw)
        check(est.cuda_graph, f"{tag} graphs are the default on CUDA")
        runs = {}
        for thr in GRAPH_THRESHOLDS:  # graph, eager, graph, eager: the threshold moves between replays
            for mode in (True, False):
                est.cuda_graph = mode
                runs[(thr, mode)] = est.run_device(x, nms_threshold=thr)
        est.cuda_graph = True
        again = est.run_device(x, nms_threshold=GRAPH_THRESHOLDS[0])
        torch.cuda.synchronize()
        same, err = zip(*(outputs_equal(runs[(t, True)], runs[(t, False)])
                          for t in GRAPH_THRESHOLDS))
        for t, e in zip(GRAPH_THRESHOLDS, err):
            check(e <= TOL_FLOAT, f"{tag} graph and eager differ by {e} at threshold {t}")
        first_same, _ = outputs_equal(again, runs[(GRAPH_THRESHOLDS[0], True)])
        check(first_same, f"{tag} a replay at the first threshold changed after the second")
        fetch = est.fetch_batch if est.batch > 1 else est.fetch
        rows = lambda o: est.fetch_batch(o) if est.batch > 1 else [est.fetch(o)]  # noqa: E731
        counts = [sum(int(pk[:, 0, 0].sum()) for pk, _, _ in rows(runs[(t, True)]))
                  for t in GRAPH_THRESHOLDS]
        check(counts[1] > counts[0], f"{tag} peaks at thresholds {GRAPH_THRESHOLDS}: {counts}; the "
              f"lower threshold must find more")
        times = {}
        for mode in (True, False, False, True):  # graph, eager, eager, graph
            est.cuda_graph = mode
            ms = cuda_ms(lambda: est.run_device(x), reps=10) / frames
            t0 = time.perf_counter()
            for _ in range(5):
                fetch(est.run_device(x))
            e2e = (time.perf_counter() - t0) * 1000.0 / (5 * frames)
            times.setdefault(mode, []).append((ms, e2e))
        est.cuda_graph = True
        g, e = times[True], times[False]
        print(f"{tag} graph vs eager outputs at thresholds {GRAPH_THRESHOLDS}: bit-identical "
              f"{list(same)}, max |diff| {max(err):.3g}; peaks {counts}; device ms/frame graph "
              f"{g[0][0]:.3f} {g[1][0]:.3f}, eager {e[0][0]:.3f} {e[1][0]:.3f} (CUDA events, "
              f"median of 10, order graph eager eager graph); end-to-end ms/frame (run_device + "
              f"fetch, host clock, 5 passes) graph {g[0][1]:.3f} {g[1][1]:.3f}, eager "
              f"{e[0][1]:.3f} {e[1][1]:.3f}")
        out[name] = dict(bit_identical=all(same), max_abs_diff=max(err), peaks=counts,
                         graph_device_ms=min(t[0] for t in g), eager_device_ms=min(t[0] for t in e),
                         graph_e2e_ms=min(t[1] for t in g), eager_e2e_ms=min(t[1] for t in e))
        graphs.append((tag, est, x, expect, out[name]))
    return out, graphs


def phase_graph_launches(graphs, reps=4, top=12):
    """Kernels per replay of each graph phase program, from the graphs' count
    and torch.profiler (after every timed phase: a profiling window slows
    later launches), and the ``top`` kernels by device time."""
    for tag, est, x, expect, row in graphs:
        by_name = {}
        _, launches, seen, total, busy = replay_kernels(
            lambda: [est.run_device(x) for _ in range(reps)], est, by_name=by_name)
        check_launches(tag, launches, seen, {k: v * reps for k, v in expect.items()})
        per_replay = {k: v / reps for k, v in launches.items()}
        frames = est.batch
        print(f"{tag} kernels per replay ({reps} replays): {per_replay}, the profiler saw "
              f"{seen}; every kernel of a pass: {total / reps:.0f}, their device time "
              f"{busy / reps / frames:.3f} ms/frame against {row['graph_device_ms']:.3f} ms/frame "
              f"of the pass")
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
        print(f"{tag} top {top} kernels by device time, per frame (launches a replay, ms): "
              + "; ".join(f"{n[:90]}: {c / reps:g}, {ms / reps / frames:.4f}"
                          for n, (c, ms) in ranked))
        row.update(launches_per_replay=per_replay, kernels_per_pass=total / reps,
                   kernel_busy_ms_per_frame=busy / reps / frames,
                   top_kernels_ms_per_frame={n[:90]: ms / reps / frames for n, (_, ms) in ranked})


def frames_720p(rs, n):
    """Synthetic 1280x720 BGR frames in the style of canvases()."""
    return [c[0] for c in canvases(rs, n, (1, 720, 1280, 3))]


def write_png(path, bgr):
    """An 8-bit RGB PNG with filter 0 rows, encoded with zlib alone."""
    import struct
    import zlib

    h, w, _ = bgr.shape
    raw = b"".join(b"\x00" + bgr[y, :, ::-1].tobytes() for y in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def phase_preprocess(rs):
    """Host ms of the OpenCV-free preprocess: a 1280x720 frame to the u8
    656x368 canvas (the default display, so no warp), and a 1920x1080 frame
    warped to 1280x720 first."""
    from caffe_rtpose_tpu_torch.pose import preprocess as P

    f720, f1080 = frames_720p(rs, 1)[0], np.ascontiguousarray(
        (rs.rand(1080, 1920, 3) * 255).astype(np.uint8))
    times = {}
    for name, fn in (("1280x720 -> 656x368", lambda: P.preprocess_frame(
                         f720, 656, 368, 1280, 720, u8=True)),
                     ("1920x1080 -> warp 1280x720 -> 656x368", lambda: P.preprocess_frame(
                         f1080, 656, 368, 1280, 720, u8=True)),
                     ("warp alone 1920x1080 -> 1280x720", lambda: P.warp_to_display(
                         f1080, 1280, 720))):
        fn()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1000.0)
        times[name] = statistics.median(ts)
    print("[preprocess] host ms (median of 5): " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    return times


def phase_pipeline(weights, device="cuda", net_resolution=(656, 368), stages=6,
                   n_frames=16, batch=BF16_BATCH):
    """RtPosePipeline at bf16 batch 8 with no frame drops: half the frames
    through frame_iter, half as PNG files and the same half as JPEG files
    (q95, the port's codec, cv2 blocked); each frame's JSON against
    estimate() on the same frame (for a JPEG, on read_image of its file).
    Then PIPELINE_TIMED_FRAMES frames timed three ways, through frame_iter,
    as PNG files and as JPEG files, and the producer thread's work a frame
    (read, warp_to_display, make_input) timed alone for each source.
    The main path: the counters are zeroed before its estimator exists and
    read after."""
    import os
    import shutil
    import tempfile

    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.ops import conv1_cuda, nms_cuda
    from caffe_rtpose_tpu_torch.pipeline.image_io import read_image
    from caffe_rtpose_tpu_torch.pipeline.jpeg import encode_jpeg
    from caffe_rtpose_tpu_torch.pipeline.runner import (PipelineConfig, RtPosePipeline,
                                                        list_image_dir, write_json_file)
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.pose.preprocess import warp_to_display

    tag = f"[pipeline bf16 batch {batch}]"
    frames = frames_720p(np.random.RandomState(5), n_frames)
    half = n_frames // 2
    work = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    dirs = {name: os.path.join(work, name) for name in ("png", "jpg", "timed_png", "timed_jpg")}
    for d in dirs.values():
        os.makedirs(d)
    for i, f in enumerate(frames):
        write_png(os.path.join(dirs["timed_png"], f"img{i:03d}.png"), f)
        with open(os.path.join(dirs["timed_jpg"], f"img{i:03d}.jpg"), "wb") as fo:
            fo.write(encode_jpeg(f, 95))
    for ext in ("png", "jpg"):
        for i in range(half, n_frames):
            shutil.copy(os.path.join(dirs[f"timed_{ext}"], f"img{i:03d}.{ext}"),
                        os.path.join(dirs[ext], f"img{i - half:03d}.{ext}"))
        # the timed directories repeat the n_frames frames, as the timed
        # frame_iter run does
        for i in range(n_frames, PIPELINE_TIMED_FRAMES):
            shutil.copy(os.path.join(dirs[f"timed_{ext}"], f"img{i % n_frames:03d}.{ext}"),
                        os.path.join(dirs[f"timed_{ext}"], f"img{i:03d}.{ext}"))
    png_dir, jpg_dir = dirs["png"], dirs["jpg"]

    conv1_cuda.launches = nms_cuda.launches = nms_cuda.upsample_launches = 0
    proto = make_pose_deploy_net("COCO", stages=stages)
    est = PoseEstimator(proto, weights=weights, net_resolution=net_resolution, num_scales=1,
                        input_u8=True, pair_cap=32, dtype=torch.bfloat16, batch=batch,
                        device=device)
    est.estimate(frames[0], 1280, 720)  # captures the graph, builds the host assembly
    runs = {}
    timed = [frames[i % n_frames] for i in range(PIPELINE_TIMED_FRAMES)]
    for name, source in (("frame_iter", frames[:half]), ("png", png_dir), ("jpg", jpg_dir),
                         ("timed", timed), ("timed_png", dirs["timed_png"]),
                         ("timed_jpg", dirs["timed_jpg"])):
        from_dir = isinstance(source, str)
        cfg = PipelineConfig(resolution=(1280, 720), net_resolution=net_resolution,
                             no_display=True, no_frame_drops=True,
                             write_json=os.path.join(work, f"json_{name}"),
                             image_dir=source if from_dir else "")
        with no_cv2():
            pipe = RtPosePipeline(est, cfg)
            if not from_dir:
                pipe.frame_iter = ((i, f, None) for i, f in enumerate(source))
            n = pipe.run()
        want = len(timed) if name.startswith("timed") else half
        check(n == want, f"{tag} {name}: {n} frames processed of {want}")
        stages_ms = {k: 1000.0 * float(np.mean([s[k] for s in pipe.stats])) for k in pipe.stats[0]}
        runs[name] = dict(frames=n, fps=pipe.fps, stages_ms=stages_ms)
    launches = dict(conv1_block=conv1_cuda.launches, peak_mask_fused=nms_cuda.launches,
                    upsample_peak_keys=nms_cuda.upsample_launches)
    replayed = est.replayed_launches()
    replayed = dict(conv1_block=replayed["conv1_block_kernel"],
                    peak_mask_fused=replayed["peak_mask_kernel"],
                    upsample_peak_keys=replayed["upsample_peak_keys_kernel"])
    n_run = half * 3 + 3 * len(timed) + 1
    # one conv1 block and one peak mask a batch pass; an overflow refetch is
    # a one-frame pass of both
    check(launches["conv1_block"] >= 1 and launches["peak_mask_fused"] >= 1
          and replayed["conv1_block"] >= n_run / batch
          and replayed["peak_mask_fused"] == replayed["conv1_block"],
          f"{tag} kernel launches on the main path: wrapper calls {launches}, replayed "
          f"{replayed} for {n_run} frames")
    # every frame's JSON against estimate() on the same frame, in order
    names = ([f"json_frame_iter/frame{i:06d}.json" for i in range(half)]
             + [f"json_png/img{i:03d}.json" for i in range(n_frames - half)]
             + [f"json_jpg/img{i:03d}.json" for i in range(n_frames - half)])
    jpgs = [read_image(os.path.join(jpg_dir, f"img{i:03d}.jpg")) for i in range(n_frames - half)]
    n_people = []
    for f, name in zip(frames + jpgs, names):
        res, pf = est.estimate(f, 1280, 720)
        ref = os.path.join(work, "ref.json")
        write_json_file(ref, res.joints, res.num_people, float(np.float32(pf.scale)), est.num_parts)
        with open(os.path.join(work, name)) as a, open(ref) as b:
            check(a.read() == b.read(), f"{tag} {name} differs from estimate() on its frame")
        n_people.append(res.num_people)
    # the producer thread's work a frame, alone (no other thread running):
    # read (PNG or JPEG), warp_to_display, make_input
    producer_ms = {}
    for name in ("timed", "timed_png", "timed_jpg"):
        paths = list_image_dir(dirs[name]) if name in dirs else [None] * len(timed)
        ms, read_ms = [], []
        for f, path in zip(timed, paths):
            t0 = time.perf_counter()
            img = f if path is None else read_image(path)
            t1 = time.perf_counter()
            display, _ = warp_to_display(img, 1280, 720)
            est.make_input(display)
            ms.append(1000.0 * (time.perf_counter() - t0))
            read_ms.append(1000.0 * (t1 - t0))
        producer_ms[name] = dict(mean=float(np.mean(ms)), median=float(np.median(ms)),
                                 read_mean=float(np.mean(read_ms)))
    print(f"{tag} {n_frames} 1280x720 frames ({half} through frame_iter, {n_frames - half} as "
          f"PNG files, the same {n_frames - half} as q95 JPEG files; then {len(timed)} through "
          f"frame_iter, as PNG files and as q95 JPEG files, timed): " + "; ".join(
              f"{k} ({v['frames']} frames): {v['fps']:.2f} FPS, stage ms " + ", ".join(
                  f"{s} {m:.2f}" for s, m in v["stages_ms"].items()) for k, v in runs.items())
          + f"; every JSON equals estimate() on its frame; people {n_people}; wrapper launches "
          f"{launches} (the eager pass and the capture), launches by the graphs' replays "
          f"{replayed}")
    print(f"{tag} producer work a frame alone over {len(timed)} frames (read, warp_to_display, "
          f"make_input): " + "; ".join(
              f"{k}: mean {v['mean']:.2f} ms (median {v['median']:.2f}, of which read "
              f"{v['read_mean']:.2f}), at most {1000.0 / v['mean']:.1f} FPS"
              for k, v in producer_ms.items()))
    shutil.rmtree(work, ignore_errors=True)
    return dict(runs=runs, launches=launches, replayed_launches=replayed, people=n_people,
                producer_ms=producer_ms)


def phase_files(weights, work, device="cuda", net_resolution=(656, 368), stages=6,
                n_frames=BF16_FRAMES, batch=BF16_BATCH):
    """The main path's model files, written into ``work``: the deploy
    prototxt and the weights as a caffemodel; the bf16 batch-8 estimator
    built from the files against the one built from the dicts."""
    import os

    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.proto import caffemodel, prototxt

    tag = "[files]"
    proto = make_pose_deploy_net("COCO", stages=stages)
    proto_path = os.path.join(work, "pose_deploy_linevec.prototxt")
    model_path = os.path.join(work, "pose_iter_synthetic.caffemodel")
    cfg = dict(net_resolution=net_resolution, num_scales=1, input_u8=True, pair_cap=32,
               dtype=torch.bfloat16, batch=batch, device=device)
    by_dict = PoseEstimator(proto, weights=weights, **cfg)
    t0 = time.perf_counter()
    prototxt.dump_file(proto, proto_path)
    by_dict.net.save_caffemodel(model_path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read = caffemodel.load_weights(model_path)
    parse_s = time.perf_counter() - t0
    n_params = sum(a.size for blobs in read.values() for a in blobs)
    check(read.keys() == weights.keys() and all(
        np.array_equal(a, np.asarray(b, np.float32)) for k in weights
        for a, b in zip(read[k], weights[k])),
        f"{tag} the caffemodel does not hold the weights written")
    del read
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    by_file = PoseEstimator(proto_path, weights=model_path, **cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    frames = canvases(np.random.RandomState(0), n_frames, by_dict.input_shape())
    batches = [np.stack(frames[i : i + batch]) for i in range(0, n_frames, batch)]
    same = [torch.equal(by_file.run_device(x)["packed"], by_dict.run_device(x)["packed"])
            for x in batches]
    torch.cuda.synchronize()
    size = os.path.getsize(model_path)
    print(f"{tag} wrote {proto_path} ({os.path.getsize(proto_path)} B) and {model_path} "
          f"({size / 1e6:.1f} MB, {n_params} parameters) in {write_s:.2f} s; parsed the "
          f"caffemodel in {parse_s:.2f} s; built the bf16 batch-{batch} estimator from the files "
          f"(prototxt, caffemodel, weights to the card) in {build_s:.2f} s; packed outputs "
          f"bit-identical to the dict-built estimator on {sum(same)}/{len(same)} passes of "
          f"{batch} frames")
    check(all(same), f"{tag} the estimator from the files differs from the one from the dicts")
    return dict(proto=proto_path, model=model_path, bytes=size, parameters=int(n_params),
                write_s=write_s, parse_s=parse_s, build_s=build_s, bit_identical=all(same))


# ------------------------------------------------------------------- hdf5

HDF5_OUTPUT_FORWARDS = 8
HDF5_DATA_STEPS = 3
HDF5_DETECT_WINDOWS = 16
# a store2hdf5-style script (matlab/hdf5creation): an unlimited last MATLAB
# dimension with ChunkSize, batches written at a start that grows the
# dataset (the second first, so the first reads as the fill value until it
# is written), then h5read of all and of a hyperslab, h5info and h5disp
STORE2HDF5_SCRIPT = """filename = 'store.h5';
chunksz = 8;
data = reshape(single(1:(227 * 227 * 3 * 32)), 227, 227, 3, 32) / 7;
labels = reshape(single(1:64), 2, 32);
h5create(filename, '/data', [227 227 3 Inf], 'Datatype', 'single', 'ChunkSize', [227 227 3 chunksz]);
h5create(filename, '/label', [2 Inf], 'Datatype', 'single', 'ChunkSize', [2 chunksz]);
for batchno = [2 1 4 3]
  last = (batchno - 1) * chunksz;
  h5write(filename, '/data', data(:, :, :, last + 1:last + chunksz), [1 1 1 last + 1], [227 227 3 chunksz]);
  h5write(filename, '/label', labels(:, last + 1:last + chunksz), [1 last + 1], [2 chunksz]);
  if batchno == 2
    early = h5read(filename, '/label');
  end
end
info = h5info(filename);
back = h5read(filename, '/data');
part = h5read(filename, '/label', [1 5], [2 8]);
h5disp(filename);
"""


def hdf5_fixtures_module():
    """tests/hdf5_fixtures.py: libhdf5's files and their digests (numpy only)."""
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import hdf5_fixtures

    return hdf5_fixtures


def hdf5_libhdf5_files(card):
    """Every file libhdf5 wrote in tests/hdf5_fixtures/: each array equal to
    its sha256, shape and dtype, each group's members in order; each
    refused feature raises ValueError naming it."""
    import os

    from caffe_rtpose_tpu_torch.utils import hdf5

    tag = "[hdf5 libhdf5 files]"
    hf = hdf5_fixtures_module()
    digests = hf.load_digests()
    t0 = time.perf_counter()
    arrays = refused = 0
    for name, want in sorted(digests.items()):
        path = os.path.join(hf.DIR, name)
        if "refused" in want:
            try:
                hf.contents(hdf5, path, lambda d: d._obj.addr)
                raise AssertionError(f"{tag} {name} was read, not refused")
            except ValueError as e:
                check(want["refused"] in str(e), f"{tag} {name}: {e}")
            refused += 1
            continue
        got = hf.contents(hdf5, path, lambda d: d._obj.addr)
        bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        check(not bad, f"{tag} {name} differs from its digests at {bad[:5]}")
        arrays += sum("sha256" in v for v in want.values())
    secs = time.perf_counter() - t0
    print(f"{tag} {len(digests) - refused} files, {arrays} arrays equal to their digests "
          f"(values, shapes, dtypes, members in order); {refused} refused features each "
          f"named; {secs:.2f} s; {card}")
    return dict(files=len(digests) - refused, arrays=arrays, refused=refused, seconds=secs)


def hdf5_weights(files, work, card, device="cuda"):
    """save_hdf5 of the COCO deploy net with the files phase's weights and
    load_hdf5 into a fresh net on the card: every blob equal to the
    caffemodel's, bit for bit; host seconds and MB/s of each."""
    import os

    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.proto import caffemodel
    from caffe_rtpose_tpu_torch.utils import hdf5

    tag = "[hdf5 weights]"
    path = os.path.join(work, "pose_iter_synthetic.caffemodel.h5")
    ref = caffemodel.load_weights(files["model"])
    mb = sum(a.nbytes for blobs in ref.values() for a in blobs) / 1e6
    net = Net(files["proto"], device=device)
    net.load_weights(ref)
    t0 = time.perf_counter()
    net.save_hdf5(path)
    write_s = time.perf_counter() - t0
    del net
    t0 = time.perf_counter()
    with hdf5.File(path, "r") as f:
        read = {name: [np.asarray(g[str(i)]) for i in range(len(g))]
                for name, g in f["data"].items()}
    read_s = time.perf_counter() - t0
    fresh = Net(files["proto"], device=device, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load_hdf5(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = fresh.export_weights()
    same = [k for k in ref if k in loaded and k in read and len(ref[k]) == len(loaded[k]) and all(
        a.tobytes() == b.tobytes() == c.tobytes()
        for a, b, c in zip(ref[k], loaded[k], read[k]))]
    size = os.path.getsize(path)
    print(f"{tag} COCO deploy net, {len(ref)} layers, {mb:.1f} MB of blobs: save_hdf5 "
          f"{write_s:.3f} s ({mb / write_s:.0f} MB/s, file {size / 1e6:.1f} MB); read "
          f"{read_s:.3f} s ({mb / read_s:.0f} MB/s); load_hdf5 into a fresh net on the card "
          f"{load_s:.3f} s ({mb / load_s:.0f} MB/s); {len(same)}/{len(ref)} layers bit-identical "
          f"to the caffemodel's; {card}")
    check(len(same) == len(ref) == len(loaded), f"{tag} {len(same)} of {len(ref)} layers equal")
    return dict(mb=mb, file_mb=size / 1e6, write_s=write_s, read_s=read_s, load_s=load_s,
                write_mb_s=mb / write_s, read_mb_s=mb / read_s, load_mb_s=mb / load_s,
                layers_equal=len(same))


def caffenet_fed_by(layer):
    """CaffeNet's TRAIN net (batch 256, crop 227) fed by a data layer."""
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet

    proto = make_caffenet(batch=FW_BATCH, crop=FW_CROP)
    del proto["input"], proto["input_shape"]
    proto["layer"] = [layer] + proto["layer"]
    return proto


def hdf5_caffenet(work, card, device="cuda"):
    """The tools phase's 512 PNGs through convert_imageset at 227x227 into a
    gzip .h5 pack and into a kvdb: compute_image_mean equal over both; the
    host ms of an HDF5Data batch of 256; CaffeNet's TRAIN net fed by
    HDF5Data over the pack, HDF5_DATA_STEPS SGD steps, losses equal to a
    MemoryData net's on the same arrays (same seed)."""
    import contextlib
    import io
    import os

    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.tools.aux_tools import compute_image_mean
    from caffe_rtpose_tpu_torch.tools.aux_tools import main as aux
    from caffe_rtpose_tpu_torch.training.datasets import HDF5Source
    from caffe_rtpose_tpu_torch.training.solver import Solver
    from caffe_rtpose_tpu_torch.utils import hdf5

    tag = "[hdf5 caffenet]"
    t0 = time.perf_counter()
    root, lst, _ = write_tool_images(work, np.random.RandomState(30))
    images_s = time.perf_counter() - t0
    pack, kvdb = os.path.join(work, "caffenet_pack.h5"), os.path.join(work, "caffenet_227_db")
    size = ["--resize_height", str(FW_CROP), "--resize_width", str(FW_CROP)]
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        check(aux(["convert_imageset", lst, root, pack, *size]) == 0, f"{tag} pack: exit")
        pack_s = time.perf_counter() - t0
        check(aux(["convert_imageset", lst, root, kvdb, *size]) == 0, f"{tag} kvdb: exit")
        t0 = time.perf_counter()
        mean_pack = compute_image_mean(pack)
        mean_s = time.perf_counter() - t0
        mean_db = compute_image_mean(kvdb)
    check(np.array_equal(mean_pack, mean_db), f"{tag} the pack's mean differs from the kvdb's")
    with hdf5.File(pack, "r") as f:
        data, labels = f["data"][()], f["label"][()]
        chunks = f["data"].chunks
    with open(lst) as fl:
        want = [int(line.split()[1]) for line in fl]
    check(data.shape == (TOOL_IMAGES, 3, FW_CROP, FW_CROP) and data.dtype == np.uint8
          and labels.tolist() == want, f"{tag} the pack holds {data.shape} {data.dtype}")
    source = os.path.join(work, "caffenet_pack.txt")
    with open(source, "w") as fl:
        fl.write(pack + "\n")
    gen = HDF5Source(source).batches(FW_BATCH)
    batch_ms = []
    for _ in range(TOOL_IMAGES // FW_BATCH):
        t0 = time.perf_counter()
        next(gen)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    gen.close()
    layers = {
        "HDF5Data": {"name": "data", "type": "HDF5Data", "top": ["data", "label"],
                     "hdf5_data_param": {"source": source, "batch_size": FW_BATCH}},
        "MemoryData": {"name": "data", "type": "MemoryData", "top": ["data", "label"],
                       "memory_data_param": {"batch_size": FW_BATCH, "channels": 3,
                                             "height": FW_CROP, "width": FW_CROP}}}
    losses = {}
    for kind, layer in layers.items():
        net = Net(caffenet_fed_by(layer), phase="TRAIN", device=device, seed=0)
        if kind == "MemoryData":
            net.set_input_arrays(data.astype(np.float32), labels.astype(np.float32))
        solver = Solver(FW_SOLVER, net, lambda _: {})
        losses[kind] = [float(solver.step(1)) for _ in range(HDF5_DATA_STEPS)]
        del solver, net
        torch.cuda.empty_cache()
    equal = losses["HDF5Data"] == losses["MemoryData"]
    print(f"{tag} {TOOL_IMAGES} PNGs ({images_s:.1f} s to write) -> convert_imageset "
          f"{FW_CROP}x{FW_CROP} gzip pack in {pack_s:.2f} s ({os.path.getsize(pack) / 1e6:.1f} MB, "
          f"chunks {chunks}); compute_image_mean over it {mean_s:.2f} s, equal to the kvdb "
          f"route's; HDF5Data host ms a batch of {FW_BATCH}: {['%.1f' % x for x in batch_ms]} "
          f"(the Data layer's: 617.5, PERF.md section 5); CaffeNet {HDF5_DATA_STEPS} SGD steps "
          f"fed by HDF5Data {losses['HDF5Data']} and by MemoryData {losses['MemoryData']}: "
          f"{'equal' if equal else 'DIFFERENT'}; {card}")
    check(equal and all(np.isfinite(losses["HDF5Data"])), f"{tag} losses {losses}")
    return dict(images_write_s=images_s, pack_s=pack_s, pack_mb=os.path.getsize(pack) / 1e6,
                chunks=list(chunks), mean_s=mean_s,
                batch_ms=batch_ms, losses=losses, losses_equal=equal), root


def hdf5_output(work, card, device="cuda"):
    """HDF5Output on CaffeNet's deploy net (batch 10): fc7 and prob appended
    HDF5_OUTPUT_FORWARDS times on the card, read back equal to the
    forwards' outputs."""
    import os

    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_deploy
    from caffe_rtpose_tpu_torch.utils import hdf5

    tag = "[hdf5 output]"
    path = os.path.join(work, "caffenet_outputs.h5")
    proto = make_caffenet_deploy(batch=10, crop=FW_CROP)
    proto["layer"].append({"name": "out", "type": "HDF5Output", "bottom": ["fc7", "prob"],
                           "hdf5_output_param": {"file_name": path}})
    net = Net(proto, device=device, seed=0)
    rs = np.random.RandomState(41)
    want, ms = {"fc7": [], "prob": []}, []
    for _ in range(HDF5_OUTPUT_FORWARDS):
        x = torch.from_numpy((rs.rand(10, 3, FW_CROP, FW_CROP) * 255 - 128).astype(np.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.forward({"data": x.to(device)}, outputs=["fc7", "prob"])
        ms.append((time.perf_counter() - t0) * 1e3)
        for k in want:
            want[k].append(out[k].float().cpu().numpy())
    with hdf5.File(path, "r") as f:
        got = {k: f[k][()] for k in want}
        chunks = {k: f[k].chunks for k in want}
    equal = all(np.array_equal(got[k], np.concatenate(want[k])) for k in want)
    print(f"{tag} CaffeNet deploy (batch 10) on the card, fc7 and prob appended by "
          f"{HDF5_OUTPUT_FORWARDS} forwards: {[list(v.shape) for v in got.values()]}, chunks "
          f"{chunks}, {os.path.getsize(path) / 1e6:.2f} MB; equal to the forwards' outputs: "
          f"{equal}; ms a forward with its append {['%.1f' % x for x in ms]}; {card}")
    check(equal, f"{tag} the file differs from the forwards' outputs")
    return dict(forwards=HDF5_OUTPUT_FORWARDS, ms=ms, equal=equal,
                file_mb=os.path.getsize(path) / 1e6)


def hdf5_detect(work, root, card, device="cuda"):
    """detect with CaffeNet deploy (seeded weights) over HDF5_DETECT_WINDOWS
    windows of the PNGs into an .h5: predictions, windows and filenames
    equal to api.Detector's on the card."""
    import contextlib
    import io
    import os

    from caffe_rtpose_tpu_torch import api
    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_deploy
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.tools import detect
    from caffe_rtpose_tpu_torch.utils import hdf5

    tag = "[hdf5 detect]"
    deploy, weights = os.path.join(work, "h5_deploy.prototxt"), os.path.join(work, "h5.caffemodel")
    prototxt.dump_file(make_caffenet_deploy(batch=10, crop=FW_CROP), deploy)
    Net(deploy, device=device, seed=0).save_caffemodel(weights)
    rs = np.random.RandomState(13)
    windows = []
    for i in range(HDF5_DETECT_WINDOWS):
        y0, x0 = rs.randint(0, TOOL_SIZE - 64, 2)
        h, w = rs.randint(48, 160, 2)
        windows.append((os.path.join(root, f"im{i // 4:04d}.png"),
                        [int(y0), int(x0), int(min(TOOL_SIZE, y0 + h)),
                         int(min(TOOL_SIZE, x0 + w))]))
    win, out = os.path.join(work, "h5_windows.csv"), os.path.join(work, "detections.h5")
    with open(win, "w") as f:
        f.write("filename, xmin, ymin, xmax, ymax\n")
        for p, (y0, x0, y1, x1) in windows:
            f.write(f"{p}, {x0}, {y0}, {x1}, {y1}\n")
    with contextlib.redirect_stdout(io.StringIO()):
        check(detect.main([win, out, "--model_def", deploy, "--pretrained_model", weights,
                           "--crop_mode", "list", "--device", device]) == 0, f"{tag} exit")
    with hdf5.File(out, "r") as f:
        got = {k: f[k][()] for k in f}
    api.set_mode_gpu()
    grouped = {}
    for p, wnd in windows:
        grouped.setdefault(p, []).append(wnd)
    # detect's defaults: raw scale 255, BGR, 16 pixels of context
    ref = api.Detector(deploy, weights, raw_scale=255.0, channel_swap=(2, 1, 0),
                       context_pad=16).detect_windows(list(grouped.items()))
    same = (sorted(got) == ["filename", "prediction", "xmax", "xmin", "ymax", "ymin"]
            and got["filename"].tolist() == [d["filename"].encode() for d in ref]
            and all(got[k].tolist() == [d["window"][i] for d in ref]
                    for i, k in enumerate(("ymin", "xmin", "ymax", "xmax")))
            and np.array_equal(got["prediction"], np.stack([d["prediction"] for d in ref])))
    print(f"{tag} CaffeNet deploy over {len(ref)} windows into {os.path.basename(out)}: "
          f"prediction {got['prediction'].shape}, variable-length filenames; equal to "
          f"api.Detector's: {same}; {card}")
    check(same, f"{tag} the .h5 differs from api.Detector's detections")
    return dict(windows=len(ref), equal=same)


def hdf5_matcaffe(work, card):
    """STORE2HDF5_SCRIPT through the port's MATLAB engine: the file, h5read
    (all, a hyperslab, rows not yet written), h5info and h5disp against
    what the script wrote."""
    import os

    from caffe_rtpose_tpu_torch import matlab_engine as me
    from caffe_rtpose_tpu_torch.utils import hdf5

    tag = "[hdf5 matcaffe]"
    d = os.path.join(work, "store2hdf5")
    os.makedirs(d)
    script = os.path.join(d, "store.m")
    with open(script, "w") as f:
        f.write(STORE2HDF5_SCRIPT)
    eng = me.MatlabEngine(os.path.join(os.path.dirname(os.path.abspath(__file__)), "matlab"))
    cwd, before = os.getcwd(), len(me.engine_stdout())
    t0 = time.perf_counter()
    try:
        os.chdir(d)
        env = eng.run_script(script)
    finally:
        os.chdir(cwd)
    secs = time.perf_counter() - t0
    text = me.engine_stdout()[before:]
    n = 227 * 227 * 3 * 32
    data = (np.arange(1, n + 1, dtype=np.float64).astype(np.float32) / np.float32(7)
            ).reshape((227, 227, 3, 32), order="F")
    labels = np.arange(1, 65, dtype=np.float32).reshape((2, 32), order="F")
    early = labels.copy()
    early[:, :8] = 0
    early[:, 16:] = 0
    early = early[:, :16]
    with hdf5.File(os.path.join(d, "store.h5"), "r") as f:
        disk = {k: f[k][()] for k in ("data", "label")}
        shapes = {k: (f[k].shape, f[k].maxshape, f[k].chunks) for k in ("data", "label")}
    info = [(str(x.fields["Name"]), me.to_python(x.fields["Dataspace"].fields["Size"]).tolist())
            for x in env["info"].fields["Datasets"].items]
    checks = dict(
        file=np.array_equal(disk["data"], data.transpose(3, 2, 1, 0))
        and np.array_equal(disk["label"], labels.T)
        and shapes == {"data": ((32, 3, 227, 227), (None, 3, 227, 227), (8, 3, 227, 227)),
                       "label": ((32, 2), (None, 2), (8, 2))},
        h5read=np.array_equal(me.to_python(env["back"]), data)
        and np.array_equal(me.to_python(env["part"]), labels[:, 4:12]),
        unwritten=np.array_equal(me.to_python(env["early"]), early),
        h5info=[(n, list(map(float, np.ravel(sz)))) for n, sz in info]
        == [("/data", [227.0, 227.0, 3.0, 32.0]), ("/label", [2.0, 32.0])],
        h5disp=text == "HDF5 store.h5\nDataset 'data'  Size: 227x227x3x32\n"
                       "Dataset 'label'  Size: 2x32\n")
    print(f"{tag} store2hdf5-style script ([227 227 3 Inf], ChunkSize [227 227 3 8], 4 "
          f"batches at start, {data.nbytes / 1e6:.1f} MB) in {secs:.2f} s: {checks}; {card}")
    check(all(checks.values()), f"{tag} {checks}; h5disp printed {text!r}")
    return dict(seconds=secs, **checks)


def phase_hdf5(files, work, card, device="cuda"):
    """The port's HDF5 codec (utils/hdf5_fmt.py) on the card's machine,
    h5py blocked: libhdf5's files, the COCO weights, CaffeNet fed by
    HDF5Data over a gzip pack, HDF5Output, detect's .h5 and matcaffe's
    h5 builtins (the HDF5 solverstates: the train phase's resume)."""
    tag = "[hdf5]"
    zero_counts()
    t0 = time.perf_counter()
    with no_module("h5py"):
        fixtures = hdf5_libhdf5_files(card)
        weights = hdf5_weights(files, work, card, device)
        caffenet, root = hdf5_caffenet(work, card, device)
        output = hdf5_output(work, card, device)
        detected = hdf5_detect(work, root, card, device)
        matcaffe = hdf5_matcaffe(work, card)
        check(sys.modules.get("h5py") is None, f"{tag} h5py was imported")
    seconds = time.perf_counter() - t0
    counts = read_counts()
    print(f"{tag} {seconds:.1f} s in all, h5py blocked; hand kernel launches {counts}; {card}")
    check(not any(counts.values()), f"{tag} launched hand kernels: {counts}")
    return dict(libhdf5_files=fixtures, weights=weights, caffenet=caffenet, output=output,
                detect=detected, matcaffe=matcaffe, seconds=seconds,
                hand_kernel_launches=counts, card=card)


def phase_cli(files, images, extra=(), jpeg=False, with_text=False):
    """tools.rtpose.main with the ``files`` phase's prototxt and caffemodel
    on ``images`` as PNG frames, displayed at their own size (``extra``:
    more flags); the kernel counters zeroed just before and read just after.
    With ``jpeg``: the frames as q95 JPEG files (the port's encoder), cv2
    blocked, plus --write_frames, with --no_text unless ``with_text``; every
    frame's JSON equal to estimate() on read_image of its JPEG, and every
    frame written the bytes encode_jpeg gives at q98 for the canvas the
    pipeline rendered (with ``with_text``, after the overlay drew on it), which
    it decodes to within JPEG_Q98_PSNR."""
    import contextlib
    import io
    import os
    import tempfile

    from caffe_rtpose_tpu_torch.pipeline import runner
    from caffe_rtpose_tpu_torch.pipeline.jpeg import encode_jpeg
    from caffe_rtpose_tpu_torch.tools import rtpose

    tag = ("[cli jpeg text]" if with_text else "[cli jpeg]") if jpeg else "[cli]"
    ext = "jpg" if jpeg else "png"
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    img_dir, out_dir = os.path.join(work, "img"), os.path.join(work, "json")
    frames_dir = os.path.join(work, "frames")
    os.makedirs(img_dir)
    for i, f in enumerate(images):
        if jpeg:
            with open(os.path.join(img_dir, f"f{i:02d}.jpg"), "wb") as fo:
                fo.write(encode_jpeg(f, 95))
        else:
            write_png(os.path.join(img_dir, f"f{i:02d}.png"), f)
    n_frames = len(images)
    h, w = images[0].shape[:2]
    flags = [*extra, *(("--write_frames", frames_dir) if jpeg else ()),
             *(("--no_text",) if jpeg and not with_text else ())]
    canvases_seen = []
    encode = runner.encode_jpeg
    overlay = runner.RtPosePipeline._overlay_text
    before_overlay = []  # each canvas as rendered, before the overlay drew on it

    def recording(canvas, quality):
        canvases_seen.append((np.array(canvas), quality))
        return encode(canvas, quality)

    def counted(self, canvas, f):
        before_overlay.append(np.array(canvas))
        return overlay(self, canvas, f)

    buf, err = io.StringIO(), io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    runner.encode_jpeg = recording
    runner.RtPosePipeline._overlay_text = counted
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err), no_cv2():
            rc = rtpose.main(["--caffeproto", files["proto"], "--caffemodel", files["model"],
                              "--image_dir", img_dir, "--write_json", out_dir,
                              "--resolution", f"{w}x{h}", "--frame_limit", str(n_frames),
                              "--no_display", "--no_frame_drops", *flags])
    finally:
        runner.encode_jpeg = encode
        runner.RtPosePipeline._overlay_text = overlay
    secs = time.perf_counter() - t0
    launches = read_counts()
    text = buf.getvalue()
    m = re.search(r"(\d+) overflow refetches", text)
    out_files = sorted(os.listdir(out_dir))
    people = 0
    for f in out_files:
        with open(os.path.join(out_dir, f)) as fh:
            people += fh.read().count('"joints"')
    print(f"{tag} rtpose --caffeproto {files['proto']} --caffemodel {files['model']} on "
          f"{n_frames} {w}x{h} {ext.upper()} frames{' ' + ' '.join(flags) if flags else ''}: "
          f"exit {rc}, {len(out_files)} JSON files, {people} people, {secs:.1f} s, hand-kernel "
          f"wrapper launches {launches}; "
          + " | ".join(line for line in (text + err.getvalue()).splitlines() if line.strip()))
    check(rc == 0 and len(out_files) == n_frames, f"{tag} exit {rc}, {len(out_files)} files")
    check("not found" not in err.getvalue(), f"{tag} the CLI fell back: {err.getvalue()}")
    check(m is not None, f"{tag} no overflow refetch count printed")
    check(launches["conv1_block"] > 0 and launches["peak_mask_fused"] > 0,
          f"{tag} a hand kernel of the path never launched: {launches}")
    result = dict(exit=rc, files=len(out_files), people=people, refetches=int(m.group(1)),
                  seconds=secs, image_dir=img_dir, json_dir=out_dir, resolution=f"{w}x{h}",
                  format=ext, launches=launches)
    # the pixels the overlay drew on each frame (it draws before the encode)
    overlays = [int((c != b).any(-1).sum()) for b, (c, _) in zip(before_overlay, canvases_seen)]
    check(len(before_overlay) == (n_frames if with_text else 0) and all(overlays),
          f"{tag} the text overlay drew on {len(before_overlay)} frames ({overlays} pixels each)")
    if jpeg:
        result["written"] = cli_jpeg_checks(tag, files, img_dir, out_dir, frames_dir,
                                            canvases_seen, n_frames, w, h, extra, with_text)
        result["overlay_pixels"] = overlays
    return result


JPEG_Q98_PSNR = 35.0  # dB, a written q98 4:2:0 frame against its canvas


def cli_jpeg_checks(tag, files, img_dir, out_dir, frames_dir, canvases_seen, n_frames, w, h,
                    extra=(), text=False):
    """The JPEG cli run's JSON against estimate() on each JPEG as read_image
    reads it (an estimator in the CLI's configuration: ``extra``'s
    --device and --net_resolution, else the CLI's defaults), and its written
    frames against the canvases rendered."""
    import os

    import torch

    from caffe_rtpose_tpu_torch.pipeline.image_io import read_image
    from caffe_rtpose_tpu_torch.pipeline.jpeg import decode_jpeg, encode_jpeg
    from caffe_rtpose_tpu_torch.pipeline.runner import write_json_file
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    def flag(name, default):
        return extra[extra.index(name) + 1] if name in extra else default

    net_w, net_h = (int(v) for v in flag("--net_resolution", "656x368").split("x"))
    est = PoseEstimator(files["proto"], weights=files["model"], net_resolution=(net_w, net_h),
                        input_u8=True, pair_cap=32, dtype=torch.bfloat16,
                        device=flag("--device", "cuda"))
    ref = os.path.join(os.path.dirname(out_dir), "ref.json")
    for i in range(n_frames):
        res, pf = est.estimate(read_image(os.path.join(img_dir, f"f{i:02d}.jpg")), w, h)
        write_json_file(ref, res.joints, res.num_people, float(np.float32(pf.scale)),
                        est.num_parts)
        with open(os.path.join(out_dir, f"f{i:02d}.json")) as a, open(ref) as b:
            check(a.read() == b.read(), f"{tag} f{i:02d}.json differs from estimate() on "
                                        "read_image of its JPEG")
    del est
    written = sorted(os.listdir(frames_dir))
    check(written == [f"f{i:02d}.jpg" for i in range(n_frames)]
          and len(canvases_seen) == n_frames, f"{tag} frames written: {written}")
    psnr, max_err = [], []
    for name, (canvas, quality) in zip(written, canvases_seen):
        with open(os.path.join(frames_dir, name), "rb") as f:
            data = f.read()
        check(quality == 98 and data == encode_jpeg(canvas, 98),
              f"{tag} {name} is not encode_jpeg(canvas, 98) of its canvas")
        back = decode_jpeg(data).astype(np.float64)
        d = back - canvas.astype(np.float64)
        mse = float(np.mean(d * d))
        psnr.append(float("inf") if mse == 0 else float(10.0 * np.log10(255.0 ** 2 / mse)))
        max_err.append(int(np.abs(d).max()))
    print(f"{tag} every JSON equals estimate() on read_image of its JPEG; {n_frames} frames "
          f"written (--write_frames{'' if text else ' --no_text'}), each encode_jpeg(canvas, "
          f"98) of the canvas "
          f"rendered, decoded PSNR {min(psnr):.2f}-{max(psnr):.2f} dB against it (largest "
          f"difference {max(max_err)} levels)")
    check(min(psnr) >= JPEG_Q98_PSNR, f"{tag} a written frame is {min(psnr):.2f} dB from its "
                                      f"canvas, under {JPEG_Q98_PSNR} dB")
    return dict(frames=n_frames, psnr_db=psnr, max_abs_err=max_err)


CLI_VIDEO_REPS = 3  # timed reads of the clip's frames


def rtpose_run(tag, files, source, out_dir, w, h, extra=()):
    """tools.rtpose.main on ``source`` (flags) with the files phase's model
    files, --write_json --no_display --no_frame_drops, cv2 blocked; the
    kernel counters zeroed just before and read just after."""
    import contextlib
    import io
    import os

    from caffe_rtpose_tpu_torch.tools import rtpose

    buf, err = io.StringIO(), io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err), no_cv2():
        rc = rtpose.main(["--caffeproto", files["proto"], "--caffemodel", files["model"],
                          *source, "--write_json", out_dir, "--resolution", f"{w}x{h}",
                          "--no_display", "--no_frame_drops", *extra])
    secs = time.perf_counter() - t0
    launches = read_counts()
    text = buf.getvalue()
    m = re.search(r"Processed (\d+) frames in [\d.]+s \(([\d.]+) FPS\)", text)
    out_files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    print(f"{tag} rtpose {' '.join(source + tuple(extra))}: exit {rc}, {len(out_files)} JSON "
          f"files, {secs:.1f} s, hand-kernel wrapper launches {launches}; "
          + " | ".join(line for line in (text + err.getvalue()).splitlines() if line.strip()))
    check(rc == 0 and m is not None, f"{tag} exit {rc}: {err.getvalue()}")
    check("not found" not in err.getvalue(), f"{tag} the CLI fell back: {err.getvalue()}")
    return dict(exit=rc, files=out_files, frames=int(m.group(1)), fps=float(m.group(2)),
                seconds=secs, launches=launches)


def jsons_equal_estimate(tag, files, extra, images, json_dir, names, what):
    """Each rtpose JSON ``json_dir/names[i]`` equals write_json_file of
    estimate() on ``images[i]``, by the bf16 estimator built from the model
    files at the run's --net_resolution and --device (``extra``); ``what``
    names the images in a failure."""
    import os

    import torch

    from caffe_rtpose_tpu_torch.pipeline.runner import write_json_file
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    def flag(name, default):
        return extra[extra.index(name) + 1] if name in extra else default

    est = PoseEstimator(files["proto"], weights=files["model"], input_u8=True, pair_cap=32,
                        net_resolution=tuple(int(v) for v in flag("--net_resolution",
                                                                  "656x368").split("x")),
                        dtype=torch.bfloat16, device=flag("--device", "cuda"))
    ref = os.path.join(os.path.dirname(json_dir), "ref.json")
    h, w = images[0].shape[:2]
    for img, name in zip(images, names):
        res, pf = est.estimate(img, w, h)
        write_json_file(ref, res.joints, res.num_people, float(np.float32(pf.scale)),
                        est.num_parts)
        with open(os.path.join(json_dir, name)) as a, open(ref) as b:
            check(a.read() == b.read(), f"{tag} {name} differs from estimate() on {what}")


def phase_cli_video(files, images, extra=()):
    """rtpose --video on ``images`` as q95 JPEGs (encode_jpeg) in a
    Motion-JPEG AVI and as a printf sequence (seq/f_%03d.jpg), in turns
    with the same JPEGs as a directory (dir, video, sequence, twice), then
    --start_frame 3 on the AVI and the sequence; cv2 blocked.  Every JSON of
    the video and sequence runs equal to estimate() on the Motion-JPEG
    decode (FFmpeg's arithmetic) of its frame, the --start_frame runs'
    equal to the first runs', launches equal to the directory run's; FPS of
    each run, and the host ms a frame of the container read and of the
    decode apart (median over the frames, 3 reads each).  ``extra``: more
    flags, whose --device and --net_resolution the estimate() estimator
    takes too."""
    import os

    from caffe_rtpose_tpu_torch.pipeline import video
    from caffe_rtpose_tpu_torch.pipeline.jpeg import MjpegDecoder, encode_jpeg

    tag = "[cli video]"
    cases = avi_cases_module()
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_video_")
    h, w = images[0].shape[:2]
    n = len(images)
    jpegs = [encode_jpeg(f, 95) for f in images]
    img_dir, clip = os.path.join(work, "img"), os.path.join(work, "clip.avi")
    seq = os.path.join(work, "seq", "f_%03d.jpg")
    os.makedirs(img_dir)
    os.makedirs(os.path.dirname(seq))
    for i, data in enumerate(jpegs):
        for path in (os.path.join(img_dir, f"f{i:02d}.jpg"), seq % i):
            with open(path, "wb") as f:
                f.write(data)
    with open(clip, "wb") as f:
        f.write(cases.write_avi(jpegs, w, h))
    sources = {"dir": ("--image_dir", img_dir), "video": ("--video", clip),
               "sequence": ("--video", seq)}
    runs = []
    for k, kind in enumerate(("dir", "video", "sequence") * 2):
        runs.append((kind, rtpose_run(f"{tag} {kind}", files, sources[kind],
                                      os.path.join(work, f"json{k}"), w, h, extra)))
    names = [f"frame{i:06d}.json" for i in range(n)]
    for kind, r in runs:
        check(r["files"] == (names if kind != "dir" else [f"f{i:02d}.json" for i in range(n)]),
              f"{tag} {kind} wrote {r['files']}")
        check(r["launches"] == runs[0][1]["launches"], f"{tag} {kind} launches {r['launches']} "
                                                       f"against {runs[0][1]['launches']}")
    first = runs[1][1]
    check(first["launches"]["conv1_block"] > 0 and first["launches"]["peak_mask_fused"] > 0,
          f"{tag} a hand kernel of the path never launched: {first['launches']}")
    decoded = [MjpegDecoder().decode(d) for d in jpegs]
    seeks = {}
    for k, kind in ((1, "video"), (2, "sequence")):
        seek = rtpose_run(f"{tag} {kind} start 3", files, sources[kind],
                          os.path.join(work, f"json_s3_{kind}"), w, h,
                          ("--start_frame", "3", *extra))
        check(seek["files"] == names[3:], f"{tag} {kind} --start_frame 3 wrote {seek['files']}")
        check(seek["launches"] == runs[0][1]["launches"],
              f"{tag} {kind} --start_frame 3 launches {seek['launches']}")
        for name in seek["files"]:
            with open(os.path.join(work, f"json{k}", name)) as a, \
                    open(os.path.join(work, f"json_s3_{kind}", name)) as b:
                check(a.read() == b.read(), f"{tag} {kind} --start_frame 3's {name} differs")
        jsons_equal_estimate(f"{tag} {kind}", files, extra, decoded,
                             os.path.join(work, f"json{k}"), names,
                             "the Motion-JPEG decode of its frame")
        seeks[kind] = dict(files=len(seek["files"]), launches=seek["launches"], fps=seek["fps"])
    reader = video.AviReader(clip)
    read_ms, decode_ms = [], []
    for _ in range(CLI_VIDEO_REPS):
        dec = MjpegDecoder()
        for i in range(len(reader.frames)):
            t0 = time.perf_counter()
            data = reader.packet(i)
            t1 = time.perf_counter()
            dec.decode(data)
            read_ms.append((t1 - t0) * 1000.0)
            decode_ms.append((time.perf_counter() - t1) * 1000.0)
    reader.release()
    fps = {kind: [r["fps"] for k, r in runs if k == kind] for kind in sources}
    print(f"{tag} every video and sequence JSON equals estimate() on the Motion-JPEG decode "
          f"(FFmpeg's arithmetic) of its frame; --start_frame 3 wrote 5 files equal to the "
          f"first run's on the AVI and the sequence; FPS over {n} {w}x{h} frames: video "
          f"{fps['video']}, sequence {fps['sequence']}, directory {fps['dir']} (in turns); host "
          f"ms a frame (median of {len(read_ms)}): container read "
          f"{statistics.median(read_ms):.4f}, decode {statistics.median(decode_ms):.3f} "
          f"({sum(map(len, jpegs)) // n} B a frame)")
    return dict(fps_video=fps["video"], fps_sequence=fps["sequence"], fps_dir=fps["dir"],
                launches=first["launches"], sequence_launches=runs[2][1]["launches"],
                start_frame_3=seeks["video"], sequence_start_frame_3=seeks["sequence"],
                read_ms=statistics.median(read_ms), decode_ms=statistics.median(decode_ms),
                bytes_a_frame=sum(map(len, jpegs)) / n, seconds=[r["seconds"] for _, r in runs])


def phase_cli_mp4(files, extra=()):
    """rtpose --video on the committed MPEG-4 clip tests/data/mp4v_720p.mp4
    (the 8 1280x720 frames of jpeg_frames.frame, written by cv2's mp4v
    writer), cv2 blocked, in turns with the port's decodes of those frames
    as q95 JPEGs in a directory and in a Motion-JPEG AVI (dir, avi, mp4,
    dir, avi, mp4), then --start_frame 3 (a P-frame: the seek decodes on
    from the I-frame).  The decoded frames' digest equals the pin (cv2's
    frames); every JSON of the mp4 runs equals estimate() on the port's
    decode of its frame, the --start_frame run's the first run's; launches
    equal the directory run's.  FPS of each run, and the host ms a frame of
    the container read and of the MPEG-4 decode (VOP decode and BGR
    conversion) apart, median over the frames decoded in order 3 times."""
    import os

    from caffe_rtpose_tpu_torch.pipeline import video
    from caffe_rtpose_tpu_torch.pipeline.jpeg import encode_jpeg
    from caffe_rtpose_tpu_torch.pipeline.mpeg4 import Mpeg4Decoder

    tag = "[cli mp4]"
    cases, m4 = avi_cases_module(), mp4_cases_module()
    clip = m4.clip_path("mp4v_720p")
    with no_cv2():
        reader = video.open_reader(clip)
        images = read_frames(reader)
        reader.release()
    check(cases.sha256(images) == m4.PINNED["mp4v_720p"]["sha256"],
          f"{tag} the decoded frames differ from cv2's (the pinned digest)")
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_mp4_")
    h, w = images[0].shape[:2]
    n = len(images)
    jpegs = [encode_jpeg(f, 95) for f in images]
    img_dir, avi = os.path.join(work, "img"), os.path.join(work, "clip.avi")
    os.makedirs(img_dir)
    for i, data in enumerate(jpegs):
        with open(os.path.join(img_dir, f"f{i:02d}.jpg"), "wb") as f:
            f.write(data)
    with open(avi, "wb") as f:
        f.write(cases.write_avi(jpegs, w, h))
    sources = {"dir": ("--image_dir", img_dir), "avi": ("--video", avi), "mp4": ("--video", clip)}
    runs = []
    for k, kind in enumerate(("dir", "avi", "mp4") * 2):
        runs.append((kind, rtpose_run(f"{tag} {kind}", files, sources[kind],
                                      os.path.join(work, f"json{k}"), w, h, extra)))
    seek = rtpose_run(f"{tag} start 3", files, sources["mp4"], os.path.join(work, "json_s3"),
                      w, h, ("--start_frame", "3", *extra))
    names = [f"frame{i:06d}.json" for i in range(n)]
    for kind, r in runs:
        check(r["files"] == (names if kind != "dir" else [f"f{i:02d}.json" for i in range(n)]),
              f"{tag} {kind} wrote {r['files']}")
        check(r["launches"] == runs[0][1]["launches"], f"{tag} {kind} launches {r['launches']} "
                                                       f"against {runs[0][1]['launches']}")
    first = runs[2][1]
    check(first["launches"]["conv1_block"] > 0 and first["launches"]["peak_mask_fused"] > 0,
          f"{tag} a hand kernel of the path never launched: {first['launches']}")
    check(seek["files"] == names[3:], f"{tag} --start_frame 3 wrote {seek['files']}")
    for name in seek["files"]:
        with open(os.path.join(work, "json2", name)) as a, \
                open(os.path.join(work, "json_s3", name)) as b:
            check(a.read() == b.read(), f"{tag} --start_frame 3's {name} differs")
    jsons_equal_estimate(tag, files, extra, images, os.path.join(work, "json2"), names,
                         "the port's decode of its frame")
    reader = video.open_reader(clip)
    read_ms, decode_ms = [], []
    for _ in range(CLI_VIDEO_REPS):
        dec = Mpeg4Decoder(reader._extra, reader.fourcc, clip)
        for i in range(len(reader.frames)):
            t0 = time.perf_counter()
            data = reader.packet(i)
            t1 = time.perf_counter()
            dec.decode(data)
            read_ms.append((t1 - t0) * 1000.0)
            decode_ms.append((time.perf_counter() - t1) * 1000.0)
        dec.close()
    reader.release()
    fps = {kind: [r["fps"] for k, r in runs if k == kind] for kind in ("dir", "avi", "mp4")}
    print(f"{tag} decoded frames equal cv2's (pinned digest); every mp4 JSON equals estimate() "
          f"on the port's decode of its frame; --start_frame 3 wrote {len(seek['files'])} files "
          f"equal to the first run's; FPS over {n} {w}x{h} frames: mp4 {fps['mp4']}, avi "
          f"{fps['avi']}, directory {fps['dir']} (in turns); host ms a frame (median of "
          f"{len(read_ms)}): container read {statistics.median(read_ms):.4f}, MPEG-4 decode "
          f"{statistics.median(decode_ms):.3f} (range {min(decode_ms):.3f}-{max(decode_ms):.3f}; "
          f"{os.path.getsize(clip) // n} B a frame)")
    return dict(fps_mp4=fps["mp4"], fps_avi=fps["avi"], fps_dir=fps["dir"],
                launches=first["launches"],
                start_frame_3=dict(files=len(seek["files"]), launches=seek["launches"],
                                   fps=seek["fps"]),
                read_ms=statistics.median(read_ms), decode_ms=statistics.median(decode_ms),
                decode_ms_range=[min(decode_ms), max(decode_ms)],
                bytes_a_frame=os.path.getsize(clip) / n, seconds=[r["seconds"] for _, r in runs])


def phase_cli_h264(files, card, extra=()):
    """rtpose --video on the committed H.264 clips tests/data/h264_720p.mp4
    (the 8 1280x720 frames of jpeg_frames.frame, an IDR picture and P
    pictures, CAVLC), h264_cabac_720p.mp4 (the same macroblocks coded with
    CABAC, Main profile), h264_b_720p.mp4 (the same frames as I P B B in
    CABAC, with composition offsets and an edit list) and h264_high_720p.mp4
    (I P B B in CABAC under High profile: Intra8x8 and the 8x8 transform,
    x264's default) and the High clip remuxed to Matroska at run time
    (mkv_cases.remux_mp4: its packets in V_MPEG4/ISO/AVC blocks at their
    presentation times), cv2 blocked, in turns with the MPEG-4 clip of the
    same frames and a q95 Motion-JPEG AVI of the H.264 decode (h264, cabac,
    b, high, mkv, mp4, avi, twice), then --start_frame 3 on each H.264 clip
    and the remux (a P picture: the seek decodes on from the IDR picture).
    The clips' decoded frames equal their pins (cv2's frames; the remux the
    High clip's); every JSON of the first h264, b and high runs equals
    estimate() on the port's decode of its frame, each cabac run's JSONs
    the first h264 run's, each b, high and mkv run's the first run's of its
    clip (mkv: high's) and each --start_frame run's those of the first run
    of its clip; launches equal across the runs; FPS of each, and the host
    ms a frame of the container read and of the H.264 decode of the High
    clip in MP4 and in Matroska, apart, in turns."""
    import os

    from caffe_rtpose_tpu_torch.pipeline import video
    from caffe_rtpose_tpu_torch.pipeline.jpeg import encode_jpeg

    tag = "[cli h264]"
    cases, m4, hc = avi_cases_module(), mp4_cases_module(), h264_cases_module()
    mk = mkv_cases_module()
    clip = hc.CLIP_720P
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_h264_")
    mkv = os.path.join(work, "high.mkv")
    with open(mkv, "wb") as f:
        f.write(mk.remux_mp4(hc.CLIP_HIGH_720P))
    with no_cv2():
        decoded_by_pin = {}
        for path, pin in ((clip, "h264_720p"), (hc.CLIP_CABAC_720P, "h264_720p"),
                          (hc.CLIP_B_720P, "h264_b_720p"), (mkv, "h264_high_720p"),
                          (hc.CLIP_HIGH_720P, "h264_high_720p")):
            reader = video.open_reader(path)
            decoded = read_frames(reader)
            reader.release()
            check(cases.sha256(decoded) == hc.PINNED[pin]["sha256"],
                  f"{tag} {path}'s decoded frames differ from cv2's (the pinned digest)")
            decoded_by_pin[pin] = decoded
        images = decoded_by_pin["h264_720p"]
    h, w = images[0].shape[:2]
    n = len(images)
    avi = os.path.join(work, "clip.avi")
    with open(avi, "wb") as f:
        f.write(cases.write_avi([encode_jpeg(f, 95) for f in images], w, h))
    sources = {"h264": ("--video", clip), "cabac": ("--video", hc.CLIP_CABAC_720P),
               "b": ("--video", hc.CLIP_B_720P), "high": ("--video", hc.CLIP_HIGH_720P),
               "mkv": ("--video", mkv), "mp4": ("--video", m4.clip_path("mp4v_720p")),
               "avi": ("--video", avi)}
    kinds = ("h264", "cabac", "b", "high", "mkv", "mp4", "avi")
    h264_kinds = ("h264", "cabac", "b", "high", "mkv")
    runs = []
    for k, kind in enumerate(kinds * 2):
        runs.append((kind, rtpose_run(f"{tag} {kind}", files, sources[kind],
                                      os.path.join(work, f"json{k}"), w, h, extra)))
    seeks = {kind: rtpose_run(f"{tag} {kind} start 3", files, sources[kind],
                              os.path.join(work, f"json_{kind}_s3"), w, h,
                              ("--start_frame", "3", *extra)) for kind in h264_kinds}
    names = [f"frame{i:06d}.json" for i in range(n)]
    for kind, r in runs:
        check(r["files"] == names, f"{tag} {kind} wrote {r['files']}")
        check(r["launches"] == runs[0][1]["launches"], f"{tag} {kind} launches {r['launches']} "
                                                       f"against {runs[0][1]['launches']}")
    first = runs[0][1]
    check(first["launches"]["conv1_block"] > 0 and first["launches"]["peak_mask_fused"] > 0,
          f"{tag} a hand kernel of the path never launched: {first['launches']}")
    mkv_launches = runs[kinds.index("mkv")][1]["launches"]
    # one scale: K1's launches are all at S = 1 (none of K2's)
    check(mkv_launches["conv1_block"] == mkv_launches["peak_mask_fused"] == 4
          and not mkv_launches["upsample_peak_keys"],
          f"{tag} the mkv run's launches {mkv_launches}: K1 and K4 4 each, K3 none")
    for kind, seek in seeks.items():
        check(seek["files"] == names[3:], f"{tag} {kind} --start_frame 3 wrote {seek['files']}")
        check(seek["launches"] == seeks["h264"]["launches"] and seek["launches"]["conv1_block"] > 0,
              f"{tag} {kind} --start_frame 3 launches {seek['launches']}")
    # the first run of each clip's frames (cabac's are h264's, mkv's high's)
    first_run = {kind: f"json{kinds.index(kind)}" for kind in ("b", "high")}
    first_run["mkv"] = first_run["high"]
    same = [(f"json_{kind}_s3", names[3:], first_run.get(kind, "json0")) for kind in seeks]
    same += [(f"json{k}", names, first_run.get(kind, "json0"))
             for k, (kind, _) in enumerate(runs) if kind in ("cabac", "b", "high", "mkv")
             and f"json{k}" != first_run.get(kind)]
    for folder, files_, base in same:
        for name in files_:
            with open(os.path.join(work, base, name)) as a, \
                    open(os.path.join(work, folder, name)) as b:
                check(a.read() == b.read(), f"{tag} {folder}/{name} differs from {base}/{name}")
    jsons_equal_estimate(tag, files, extra, images, os.path.join(work, "json0"), names,
                         "the port's decode of its frame")
    jsons_equal_estimate(tag, files, extra, decoded_by_pin["h264_b_720p"],
                         os.path.join(work, first_run["b"]), names,
                         "the port's decode of its frame (B clip)")
    jsons_equal_estimate(tag, files, extra, decoded_by_pin["h264_high_720p"],
                         os.path.join(work, first_run["high"]), names,
                         "the port's decode of its frame (High profile clip)")
    # the High clip's container read and decode a frame, MP4 and Matroska in turns
    read_ms = {"mp4": [], "mkv": []}
    decode_ms = {"mp4": [], "mkv": []}
    open_ms = {"mp4": [], "mkv": []}
    from caffe_rtpose_tpu_torch.pipeline.h264 import H264Decoder

    with no_cv2():
        for _ in range(CLI_VIDEO_REPS):
            for kind, path in (("mp4", hc.CLIP_HIGH_720P), ("mkv", mkv)):
                t0 = time.perf_counter()
                reader = video.open_reader(path)
                open_ms[kind].append((time.perf_counter() - t0) * 1000.0)
                dec = H264Decoder(reader._extra, reader._nal_length, path, reader._video_delay)
                for i in range(len(reader.frames)):
                    t0 = time.perf_counter()
                    data = reader.packet(i)
                    t1 = time.perf_counter()
                    if dec.advance(data, i):
                        dec.picture()
                    read_ms[kind].append((t1 - t0) * 1000.0)
                    decode_ms[kind].append((time.perf_counter() - t1) * 1000.0)
                while dec.drain():
                    dec.picture()
                dec.close()
                reader.release()
    fps = {kind: [r["fps"] for k, r in runs if k == kind] for kind in kinds}
    med = {k: (statistics.median(read_ms[k]), statistics.median(decode_ms[k]),
               statistics.median(open_ms[k])) for k in read_ms}
    print(f"{tag} the High clip as MP4 and as Matroska (remuxed, {os.path.getsize(mkv)} B "
          f"against {os.path.getsize(hc.CLIP_HIGH_720P)}), host ms a frame (median of "
          f"{len(read_ms['mkv'])}, in turns): "
          + "; ".join(f"{k} container read {med[k][0]:.4f}, H.264 decode and BGR {med[k][1]:.3f}, "
                      f"open (parse and probe) {med[k][2]:.2f} a file" for k in ("mp4", "mkv"))
          + f"; mkv launches {mkv_launches} a run; {card}")
    print(f"{tag} the five clips' decoded frames equal cv2's (pinned digests); every h264, b "
          f"and high JSON equals estimate() on the port's decode of its frame, every cabac "
          f"JSON the h264 run's, every mkv JSON the high run's; --start_frame 3 wrote "
          f"{len(seeks['h264']['files'])} files a clip equal to the first run's of the clip; "
          f"FPS over {n} {w}x{h} frames: "
          + ", ".join(f"{kind} {fps[kind]}" for kind in kinds)
          + f" (in turns; {os.path.getsize(clip) // n} B a frame of CAVLC, "
          f"{os.path.getsize(hc.CLIP_CABAC_720P) // n} of CABAC, "
          f"{os.path.getsize(hc.CLIP_B_720P) // n} of I P B B, "
          f"{os.path.getsize(hc.CLIP_HIGH_720P) // n} of High profile I P B B); launches "
          f"{first['launches']} a run; {card}")
    return dict(fps_h264=fps["h264"], fps_cabac=fps["cabac"], fps_b=fps["b"], fps_high=fps["high"],
                fps_mkv=fps["mkv"], fps_mp4=fps["mp4"], fps_avi=fps["avi"],
                launches=first["launches"], mkv_launches=mkv_launches,
                mkv_read_ms=med["mkv"][0], mkv_decode_ms=med["mkv"][1], mkv_open_ms=med["mkv"][2],
                high_mp4_read_ms=med["mp4"][0], high_mp4_decode_ms=med["mp4"][1],
                high_mp4_open_ms=med["mp4"][2],
                start_frame_3={kind: dict(files=len(r["files"]), launches=r["launches"],
                                          fps=r["fps"]) for kind, r in seeks.items()},
                bytes_a_frame=os.path.getsize(clip) / n,
                cabac_bytes_a_frame=os.path.getsize(hc.CLIP_CABAC_720P) / n,
                b_bytes_a_frame=os.path.getsize(hc.CLIP_B_720P) / n,
                high_bytes_a_frame=os.path.getsize(hc.CLIP_HIGH_720P) / n,
                seconds=[r["seconds"] for _, r in runs])


def bundle_sizes(path):
    import os

    return {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def zero_counts():
    from caffe_rtpose_tpu_torch.ops import conv1_cuda, nms_cuda

    conv1_cuda.launches = nms_cuda.launches = nms_cuda.upsample_launches = 0


def read_counts():
    from caffe_rtpose_tpu_torch.ops import conv1_cuda, nms_cuda

    return dict(conv1_block=conv1_cuda.launches, peak_mask_fused=nms_cuda.launches,
                upsample_peak_keys=nms_cuda.upsample_launches)


def program_nodes(est, key):
    """The hand-kernel nodes one replay of ``est``'s captured program
    ``key`` launches."""
    return est._graphs[key].nodes


def rows_equal(a, b):
    return all(np.array_equal(u, v, equal_nan=True) for u, v in zip(a, b))


def phase_serving(weights, files, cli, work, device="cuda", net_resolution=(656, 368),
                  stages=6, n_frames=BF16_FRAMES, batch=BF16_BATCH):
    """Serving bundles (serving.py) on the card.  The main path: the bf16
    batch-8 COCO estimator built from the model files, exported, reloaded
    cold and replayed; the kernel counters zeroed just before the bundle is
    loaded and read just after its passes.  Then a CPU-exported 2-stage
    bundle moved to the card, a 3-scale f32 bundle (K2), and rtpose
    --bundle in a fresh process against the cli phase's JSON."""
    import os
    import subprocess

    import torch

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.serving import ExportedPose, export_estimator

    tag = f"[serving bf16 batch {batch}]"
    # the kernel switches are the card's defaults; a bundle records the
    # kernels as operators
    kernels = dict(peak_kernel=True, conv1_kernel=True)
    cfg = dict(net_resolution=net_resolution, num_scales=1, input_u8=True, pair_cap=32,
               dtype=torch.bfloat16, batch=batch, device=device, **kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live = PoseEstimator(files["proto"], weights=files["model"], **cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    path = os.path.join(work, "bundle_bf16_b8")
    t0 = time.perf_counter()
    export_estimator(live, path)
    export_s = time.perf_counter() - t0
    sizes = bundle_sizes(path)
    frames = canvases(np.random.RandomState(8), n_frames, live.input_shape())
    batches = [np.stack(frames[i : i + batch]) for i in range(0, n_frames, batch)]
    live_out = [live.run_device(x)["packed"] for x in batches]

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = ExportedPose(path, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = bundle.run_device(batches[0])["packed"]  # the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    outs = [first] + [bundle.run_device(x)["packed"] for x in batches[1:]]
    torch.cuda.synchronize()
    launches, replayed = read_counts(), bundle.replayed_launches()
    nodes = program_nodes(bundle, ("packed", 32, batch))
    same = [torch.equal(a, b) for a, b in zip(live_out, outs)]
    check(all(same), f"{tag} packed rows differ from the live estimator's: {same}")
    check(nodes == {"peak_mask_kernel": 1, "upsample_peak_keys_kernel": 0,
                    "conv1_block_kernel": 1},
          f"{tag} kernel nodes of a replay {nodes}, expected one K1 and one K4")
    check(launches["peak_mask_fused"] >= 1 and launches["conv1_block"] >= 1
          and replayed["peak_mask_kernel"] == replayed["conv1_block_kernel"] == len(batches),
          f"{tag} launches {launches}, replayed {replayed} for {len(batches)} passes")
    # the overflow refetch: on noise frames at threshold -1 every local
    # maximum is a peak, more than pair_cap in a part; the bundle's
    # program_nocap against the live estimator's
    noise = (np.random.RandomState(12).rand(batch, *live.input_shape()) * 255).astype(np.uint8)
    x0, low = noise[0], OVERFLOW_THRESHOLD
    a = live.fetch_batch(live.run_device(noise, nms_threshold=low))[0]
    b = bundle.fetch_batch(bundle.run_device(noise, nms_threshold=low))[0]
    check(rows_equal(a, b), f"{tag} capped rows differ at threshold {low}")
    overflowed = live.overflowed(a[0])
    check(overflowed == bundle.overflowed(b[0]) and overflowed,
          f"{tag} overflow at threshold {low}: live {overflowed}, bundle "
          f"{bundle.overflowed(b[0])}")
    check(rows_equal(live.refetch_full(x0, nms_threshold=low),
                     bundle.refetch_full(x0, nms_threshold=low)),
          f"{tag} the overflow refetch differs from the live estimator's")
    nocap = program_nodes(bundle, ("packed", live.max_peaks, 1))
    check(nocap["peak_mask_kernel"] == 1 and nocap["conv1_block_kernel"] == 1,
          f"{tag} program_nocap kernel nodes {nocap}")
    # device and end-to-end ms/frame, live and bundle in turns
    times = {}
    for name in ("live", "bundle", "bundle", "live"):
        est = live if name == "live" else bundle
        x = batches[0]
        ms = cuda_ms(lambda: est.run_device(x), reps=10) / batch
        t0 = time.perf_counter()
        for _ in range(5):
            est.fetch_batch(est.run_device(x))
        e2e = (time.perf_counter() - t0) * 1000.0 / (5 * batch)
        times.setdefault(name, []).append((ms, e2e))
    print(f"{tag} live estimator from the model files built in {build_s:.2f} s; exported in "
          f"{export_s:.2f} s: " + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in sizes.items())
          + f"; loaded cold in {load_s:.2f} s (first pass, the capture: {capture_s:.2f} s); "
          f"packed rows bit-identical to the live estimator on {sum(same)}/{len(same)} passes; "
          f"overflow refetch at threshold {low} identical; kernel nodes a replay {nodes} "
          f"(program_nocap {nocap}); wrapper launches {launches} (the eager pass and the "
          f"capture), replayed {replayed}; device ms/frame live {times['live'][0][0]:.3f} "
          f"{times['live'][1][0]:.3f}, bundle {times['bundle'][0][0]:.3f} "
          f"{times['bundle'][1][0]:.3f} (CUDA events, median of 10, order live bundle bundle "
          f"live); end-to-end ms/frame (run_device + fetch_batch, 5 passes) live "
          f"{times['live'][0][1]:.3f} {times['live'][1][1]:.3f}, bundle "
          f"{times['bundle'][0][1]:.3f} {times['bundle'][1][1]:.3f}")
    main_row = dict(build_s=build_s, export_s=export_s, load_s=load_s, capture_s=capture_s,
                    sizes=sizes, bit_identical=all(same), nodes=nodes, launches=launches,
                    replayed=replayed,
                    live_device_ms=[t[0] for t in times["live"]],
                    bundle_device_ms=[t[0] for t in times["bundle"]],
                    live_e2e_ms=[t[1] for t in times["live"]],
                    bundle_e2e_ms=[t[1] for t in times["bundle"]],
                    graph_device_ms=min(t[0] for t in times["bundle"]))

    # a bundle exported on the CPU, moved to the card: the operators there
    # launch the kernels
    tag2 = "[serving cpu-exported]"
    small = (320, 176)
    cpu_cfg = dict(net_resolution=small, num_scales=1, input_u8=True, pair_cap=32,
                   dtype=torch.bfloat16, batch=2)
    proto2 = make_pose_deploy_net("COCO", stages=2)
    cpu_est = PoseEstimator(proto2, weights=weights, device="cpu", peak_kernel=True,
                            conv1_kernel=True, **cpu_cfg)
    path2 = os.path.join(work, "bundle_cpu")
    t0 = time.perf_counter()
    export_estimator(cpu_est, path2)
    cpu_export_s = time.perf_counter() - t0
    del cpu_est
    ref2 = PoseEstimator(proto2, weights=weights, device=device, **kernels, **cpu_cfg)
    x2 = np.stack(canvases(np.random.RandomState(9), 2, ref2.input_shape()))
    want2 = ref2.run_device(x2)["packed"]
    zero_counts()
    moved = ExportedPose(path2, device=device)
    got2 = [moved.run_device(x2)["packed"] for _ in range(3)]
    torch.cuda.synchronize()
    launches2, replayed2 = read_counts(), moved.replayed_launches()
    nodes2 = program_nodes(moved, ("packed", 32, 2))
    same2 = all(torch.equal(g, want2) for g in got2)
    print(f"{tag2} 2-stage bf16 batch-2 {small[0]}x{small[1]} bundle exported on the CPU in "
          f"{cpu_export_s:.2f} s, loaded on {moved.device}: kernel nodes a replay {nodes2}, "
          f"wrapper launches {launches2}, replayed {replayed2}; packed rows bit-identical to a "
          f"live estimator on the card: {same2}")
    check(moved.meta["platforms"] == ["cpu"], f"{tag2} platforms {moved.meta['platforms']}")
    check(nodes2["peak_mask_kernel"] == 1 and nodes2["conv1_block_kernel"] == 1
          and launches2["peak_mask_fused"] >= 1 and launches2["conv1_block"] >= 1
          and replayed2["peak_mask_kernel"] == replayed2["conv1_block_kernel"] == len(got2),
          f"{tag2} the kernels did not run: nodes {nodes2}, launches {launches2}")
    check(same2, f"{tag2} packed rows differ from the live estimator on the card")

    # a 3-scale f32 bundle: K1 at three scales (the TPU's K2)
    tag3 = "[serving 3-scale f32]"
    cfg3 = dict(net_resolution=net_resolution, num_scales=3, input_u8=True, pair_cap=32,
                dtype=torch.float32, device=device, **kernels)
    live3 = PoseEstimator(make_pose_deploy_net("COCO", stages=stages), weights=weights, **cfg3)
    path3 = os.path.join(work, "bundle_3scale")
    export_estimator(live3, path3)
    f3 = canvases(np.random.RandomState(10), 2, (3, net_resolution[1], net_resolution[0], 3))
    from caffe_rtpose_tpu_torch.pose.preprocess import make_net_input_u8_packed

    x3 = [make_net_input_u8_packed(f[0], *net_resolution, 3, 1.0, 0.3) for f in f3]
    want3 = [live3.run_device(x)["packed"] for x in x3]
    zero_counts()
    b3 = ExportedPose(path3, device=device)
    got3 = [b3.run_device(x)["packed"] for x in x3]
    torch.cuda.synchronize()
    launches3, replayed3 = read_counts(), b3.replayed_launches()
    nodes3 = program_nodes(b3, ("packed", 32, 1))
    same3 = all(torch.equal(a, b) for a, b in zip(want3, got3))
    print(f"{tag3} pack_u8 {b3.pack_u8}: kernel nodes a replay {nodes3}, wrapper launches "
          f"{launches3}, replayed {replayed3}; packed rows bit-identical to the live estimator: "
          f"{same3}; " + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in bundle_sizes(path3).items()))
    check(nodes3 == {"peak_mask_kernel": 1, "upsample_peak_keys_kernel": 0,
                     "conv1_block_kernel": 0} and launches3["peak_mask_fused"] >= 1
          and replayed3["peak_mask_kernel"] == len(got3),
          f"{tag3} kernel nodes {nodes3}, launches {launches3}")
    check(same3, f"{tag3} packed rows differ from the live estimator")

    # rtpose --bundle in a fresh process on the cli phase's frames: the JSON
    # the live CLI wrote (its configuration: bf16, batch 1, pair_cap 32)
    tag4 = "[serving cli]"
    cli_est = PoseEstimator(files["proto"], weights=files["model"], net_resolution=net_resolution,
                            num_scales=1, input_u8=True, pair_cap=32, dtype=torch.bfloat16,
                            device=device, **kernels)
    path4 = os.path.join(work, "bundle_cli")
    export_estimator(cli_est, path4)
    del cli_est
    out4 = os.path.join(work, "json_bundle")
    n_png = len(os.listdir(cli["image_dir"]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "caffe_rtpose_tpu_torch", "rtpose", "--bundle",
                          path4, "--image_dir", cli["image_dir"], "--write_json", out4,
                          "--resolution", cli["resolution"],
                          "--frame_limit", str(n_png), "--no_display", "--no_frame_drops",
                          "--device", torch.device(device).type],
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f"{tag4} rtpose --bundle exit {res.returncode}: {res.stderr}")
    names = sorted(os.listdir(cli["json_dir"]))
    check(sorted(os.listdir(out4)) == names and len(names) == n_png,
          f"{tag4} JSON files {sorted(os.listdir(out4))} vs {names}")
    differ = []
    for n in names:
        with open(os.path.join(cli["json_dir"], n)) as fa, open(os.path.join(out4, n)) as fb:
            if fa.read() != fb.read():
                differ.append(n)
    print(f"{tag4} rtpose --bundle (a new process) over {n_png} PNG frames in {cli_s:.1f} s: "
          f"JSON equal to the live CLI's on {len(names) - len(differ)}/{len(names)} files; "
          + " | ".join(line for line in res.stdout.splitlines() if line.strip()))
    check(not differ, f"{tag4} JSON differs from the live CLI's: {differ}")
    check(cli["people"] > 0, f"{tag4} the frames hold no people: nothing was compared")
    graph_row = (f"[graph bundle bf16 batch {batch}]", bundle, batches[0],
                 {"peak_mask_kernel": 1, "conv1_block_kernel": 1, "upsample_peak_keys_kernel": 0},
                 main_row)
    return dict(main=main_row,
                cpu_exported=dict(export_s=cpu_export_s, nodes=nodes2, launches=launches2,
                                  replayed=replayed2, bit_identical=same2),
                three_scale=dict(nodes=nodes3, launches=launches3, replayed=replayed3,
                                 bit_identical=same3),
                cli=dict(files=len(names), seconds=cli_s)), live, graph_row


def phase_pool(est, batch=BF16_BATCH, n_passes=4):
    """DevicePool over every card against the estimator, pass by pass; and
    a replica on the estimator's own card (its own graphs, copied operands)
    against it."""
    import torch

    from caffe_rtpose_tpu_torch.parallel.inference import DevicePool

    tag = "[pool]"
    n = torch.cuda.device_count()
    pool = DevicePool(est, n)
    frames = canvases(np.random.RandomState(11), batch * n_passes, est.input_shape())
    batches = [np.stack(frames[i : i + batch]) for i in range(0, len(frames), batch)]
    ref = [est.run_device(x)["packed"] for x in batches]
    got = [pool.run_device(x)["packed"] for x in batches]
    rep = est.replicate(est.device)
    again = [rep.run_device(x)["packed"] for x in batches]
    torch.cuda.synchronize()
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(ref, got))
    same_rep = all(torch.equal(a, b) for a, b in zip(ref, again))
    nodes = program_nodes(rep, ("packed", 32, batch))
    print(f"{tag} DevicePool over {n} card(s) ({[str(d) for d in pool.devices]}): "
          f"{len(batches)} passes equal to the estimator: {same}; a replica on {rep.device} "
          f"(its own graphs, kernel nodes {nodes}): equal {same_rep}")
    check(same and same_rep, f"{tag} the pool or the replica differs from the estimator")
    check(nodes["peak_mask_kernel"] == 1 and nodes["conv1_block_kernel"] == 1,
          f"{tag} replica kernel nodes {nodes}")
    return dict(cards=n, passes=len(batches), equal=same, replica_equal=same_rep)


def phase_eval(files, cli, work, extra=()):
    """eval run-list over a cli run's frames (PNG, or JPEG with cv2 blocked;
    the CLI's model files, bf16) and joint-diff against the JSON rtpose
    --write_json wrote there, with joints compared."""
    import contextlib
    import io
    import os

    from caffe_rtpose_tpu_torch.tools import eval_pose

    fmt = cli.get("format", "png")
    tag = f"[eval {fmt} {cli['resolution']}]"
    names = sorted(os.listdir(cli["image_dir"]))
    lst = os.path.join(work, f"image_list_{fmt}_{cli['resolution']}.txt")
    w, h = cli["resolution"].split("x")
    with open(lst, "w") as f:
        for i, n in enumerate(names):
            f.write(f"{i} {i} {n} {h} {w}\n")
    out = os.path.join(work, f"json_eval_{fmt}_{cli['resolution']}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), no_cv2():
        rc = eval_pose.main(["run-list", "--list", lst, "--image_root", cli["image_dir"],
                             "--out", out, "--caffeproto", files["proto"], "--caffemodel",
                             files["model"], "--dtype", "bfloat16", "--display",
                             cli["resolution"], *extra])
    run_s = time.perf_counter() - t0
    check(rc == 0 and len(os.listdir(out)) == len(names), f"{tag} run-list exit {rc}")
    diff = io.StringIO()
    with contextlib.redirect_stdout(diff):
        rc_diff = eval_pose.main(["joint-diff", cli["json_dir"], out])
    text = diff.getvalue()
    print(f"{tag} run-list over {len(names)} {cli['resolution']} {fmt.upper()} frames in "
          f"{run_s:.1f} s; joint-diff against "
          f"rtpose --write_json: " + " | ".join(line for line in text.splitlines() if line))
    check(rc_diff == 0 and "PARITY OK" in text, f"{tag} joint-diff: {text}")
    m = re.search(r"joints: (\d+)/(\d+) matched", text)
    check(m is not None and (int(m.group(2)) > 0) == (cli["people"] > 0) and cli["people"] > 0,
          f"{tag} no joints compared ({cli['people']} people in the CLI's JSON)")
    return dict(images=len(names), format=fmt, seconds=run_s, parity=True,
                report=[line for line in text.splitlines() if line])


# ------------------------------------------------------------------ train

TRAIN_BATCH, TRAIN_CROP = 10, 368  # scripts/bench_train.py's configuration
TRAIN_MAX_PEOPLE = 12
TRAIN_WARM_STEPS, TRAIN_TIMED_STEPS = 2, 10
TRAIN_SOLVER = "base_lr: 2e-5 lr_policy: 'fixed' momentum: 0.9 weight_decay: 5e-4"
# the card-against-CPU run starts from fan-in weights, whose outputs are O(10):
# 2e-5 diverges there in two steps, 1e-7 takes the loss 6836 -> 4234 -> 1921
SMALL_SOLVER = TRAIN_SOLVER.replace("2e-5", "1e-7")
TOL_GAUSS = 1e-6  # the gaussian channels, card against host: expf may differ by an ulp
TOL_TRAIN_LOSS = 1e-5  # card against CPU, relative
# card against CPU after 3 steps, each relative to the blob's largest magnitude:
# weights (fan-in init) to 1e-4; biases (zero init, so they hold only the
# updates) and momentum to 5e-3.  The two sides' f32 convolutions are other
# algorithms (cuDNN takes FFT engines for some NCHW layers, oneDNN on the
# host): measured weights 1.1e-5, biases 1.4e-3, momentum 1.5e-3 on an H100
# 80GB HBM3 at 700 W (NHWC, before training ran NCHW: 1.4e-6, 2.6e-4, 5.2e-4)
TOL_TRAIN_PARAM = 1e-4
TOL_TRAIN_UPDATE = 5e-3
TOL_RESUME = 1e-5  # a restored solver's step against the continuing one


def blob_errors(a, b, index=None):
    """The largest max|a - b| / max|b| over the blobs of two
    ``{layer: [blob, ...]}`` trees (tensors or arrays); ``index``: only each
    layer's blob of that index (0 weights, 1 biases)."""
    worst = 0.0
    for k in b:
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            if index is not None and i != index:
                continue
            x = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
            y = np.asarray(y.detach().cpu() if hasattr(y, "detach") else y, np.float64)
            worst = max(worst, float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)))
    return worst


def label_batch_overlapping(rs, prm, bsz, people):
    """A batch of ``people`` overlapping random people per sample (every
    visibility code) and a u8 mask grid: the last-writer case."""
    gy, gx = prm.crop_size_y // prm.stride, prm.crop_size_x // prm.stride
    joints = np.zeros((bsz, people, 18, 2), np.float32)
    vis = np.zeros((bsz, people, 18), np.int32)
    for b in range(bsz):
        centre = rs.uniform(60, prm.crop_size_x - 60, size=(18, 2))
        joints[b] = (centre + rs.randn(people, 18, 2) * 12).astype(np.float32)
        vis[b] = rs.choice([0, 1, 2, 3], size=(people, 18), p=[0.5, 0.2, 0.1, 0.2])
    grid = rs.randint(0, 256, size=(bsz, gy, gx)).astype(np.uint8)
    return joints, vis, grid


def phase_train_labels(device="cuda"):
    """make_label_fn on the card against transformer.generate_label_map on
    the host, at full width: batch 10, 46x46, 12 people, 114 channels."""
    import torch

    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
    from caffe_rtpose_tpu_torch.training.labels_device import make_label_fn, pose_batches_jointfeed
    from caffe_rtpose_tpu_torch.training.transformer import (AugParams, Meta, Person,
                                                             generate_label_map)

    tag = "[train labels]"
    prm = AugParams(crop_size_x=TRAIN_CROP, crop_size_y=TRAIN_CROP)
    np_ = prm.np
    fn = make_label_fn(prm, TRAIN_MAX_PEOPLE)
    aug = next(pose_batches_jointfeed(SyntheticPoseSource(n=64, size=TRAIN_CROP, seed=0), prm,
                                      TRAIN_BATCH, max_people=TRAIN_MAX_PEOPLE, seed=1,
                                      data_u8=True))
    cases = [("augmented synthetic batch", aug["joints"], aug["vis"], None),
             ("12 overlapping people", *label_batch_overlapping(
                 np.random.RandomState(7), prm, TRAIN_BATCH, TRAIN_MAX_PEOPLE))]
    out = {}
    for name, joints, vis, grid in cases:
        grid_hw = (TRAIN_BATCH, TRAIN_CROP // prm.stride, TRAIN_CROP // prm.stride)
        weight = (np.ones(grid_hw, np.float32) if grid is None
                  else grid.astype(np.float32) / 255.0)
        dev = fn(torch.from_numpy(joints).to(device), torch.from_numpy(vis).to(device),
                 torch.from_numpy(weight).to(device)).cpu().numpy()
        host = np.stack([generate_label_map(
            Meta(people=[Person(joints[b, p], vis[b, p]) for p in range(joints.shape[1])]),
            prm, None if grid is None else grid[b]) for b in range(TRAIN_BATCH)])
        fams = {"weights": slice(0, np_ + 1), "pafs": slice(np_ + 1, np_ + 39),
                "gaussians": slice(np_ + 39, np_ + 57), "background": slice(2 * np_ + 1, None)}
        errs = {k: float(np.abs(dev[:, s] - host[:, s]).max()) for k, s in fams.items()}
        nonzero = {k: int((host[:, s] != 0).sum()) for k, s in fams.items()}
        print(f"{tag} {name}: {dev.shape} on the card against the host: max |diff| {errs}; "
              f"nonzero host values {nonzero}")
        check(dev.shape == host.shape == (TRAIN_BATCH, 2 * (np_ + 1)) + grid_hw[1:],
              f"{tag} {name}: shape {dev.shape}")
        check(errs["weights"] == 0 and errs["pafs"] == 0 and errs["background"] == 0,
              f"{tag} {name}: weight, PAF or background channels differ: {errs}")
        check(errs["gaussians"] <= TOL_GAUSS, f"{tag} {name}: gaussians differ by {errs}")
        check(nonzero["pafs"] > 0 and nonzero["gaussians"] > 0, f"{tag} {name}: empty labels")
        out[name] = dict(max_abs_diff=errs, nonzero=nonzero)
    return out


SMALL_ARITHMETICS = ("card", "cpu", "f64_card_relus")


def relu_modules(net):
    return {l.name: net.mods[l.name] for l in net.layers if l.type == "ReLU"}


def record_relus(net, masks):
    """Make every ReLU of ``net`` write its decisions (pre-activation > 0)
    of each call into ``masks`` under its name; :func:`release_relus`
    undoes it."""
    for name, mod in relu_modules(net).items():
        def run(bots, ctx, name=name, mod=mod):
            masks[name] = (bots[0] > 0).detach()
            return type(mod).run(mod, bots, ctx)
        mod.run = run


def pin_relus(net, masks):
    """Make every ReLU of ``net`` take the decisions in ``masks`` (read at
    each call, so the caller may swap them between calls) instead of its
    input's signs."""
    import torch

    for name, mod in relu_modules(net).items():
        mod.run = lambda bots, ctx, name=name, mod=mod: (
            torch.where(masks[name].to(bots[0].device), bots[0], mod.slope * bots[0]),)


def release_relus(net):
    for mod in relu_modules(net).values():
        mod.__dict__.pop("run", None)


def small_trajectories(device="cuda", data_seed=0, steps=3):
    """``steps`` SGD steps of a 2-stage train net at crop 184, batch 2, from
    the same fan-in weights and synthetic batches: f32 on the card, f32 on
    the host CPU, and f64 on the host CPU taking the card's ReLU decisions
    step by step (ROADMAP C6: where a pre-activation lies within an f32
    rounding of 0, two arithmetics put it on either side and the
    trajectories part at that kink; with the decisions pinned, the f64 run
    is the card's trajectory computed exactly).  ``data_seed`` 0 gives the
    batches :func:`phase_train_small` checks.  Returns ``({name: solver},
    {name: losses}, {name: seconds})``."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource, pose_batches
    from caffe_rtpose_tpu_torch.training.solver import Solver
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    crop, bsz = 184, 2
    proto = make_pose_train_net(batch=bsz, crop=crop, stages=2)
    prm = AugParams(crop_size_x=crop, crop_size_y=crop)
    gen = pose_batches(SyntheticPoseSource(n=8, size=crop + 52, seed=3 + 10 * data_seed), prm,
                       bsz, seed=4 + data_seed)
    batches = [next(gen) for _ in range(steps)]
    solvers, losses, seconds, weights = {}, {}, {}, None
    decisions = []  # the card's ReLU decisions at each step
    for name in SMALL_ARITHMETICS:
        net = Net(proto, phase="TRAIN", device=device if name == "card" else "cpu")
        weights = weights or fan_in_weights(net, 11)
        net.load_weights(weights)
        masks = {}
        if name == "f64_card_relus":
            net.double()
            net.dtype = torch.float64
            net.params_changed()
            pin_relus(net, masks)
        elif name == "card":
            record_relus(net, masks)
        solvers[name] = Solver(SMALL_SOLVER, net, lambda it: batches[it])
        losses[name] = []
        t0 = time.perf_counter()
        try:
            for k in range(steps):
                if name == "f64_card_relus":
                    masks.clear()
                    masks.update(decisions[k])
                losses[name].append(solvers[name].step(1))
                if name == "card":
                    decisions.append({n: m.cpu() for n, m in masks.items()})
        finally:
            release_relus(net)
        seconds[name] = time.perf_counter() - t0
    return solvers, losses, seconds


def trajectory_gaps(solvers, losses, a, b):
    """Where the runs ``a`` and ``b`` of :func:`small_trajectories` part:
    the largest relative loss gap, and after the last step the weights',
    biases' and momentum's gaps, each relative to the blob's largest
    magnitude in ``b``."""
    return dict(loss=max(abs(x - y) / abs(y) for x, y in zip(losses[a], losses[b])),
                weights=blob_errors(solvers[a].params, solvers[b].params, index=0),
                biases=blob_errors(solvers[a].params, solvers[b].params, index=1),
                momentum=blob_errors(solvers[a].history["h0"], solvers[b].history["h0"]))


def phase_train_small(device="cuda"):
    """A 2-stage train net at crop 184, batch 2: 3 SGD steps on the card held
    to the same steps in f64 on the host CPU, the f64 run taking the card's
    ReLU decisions step by step (ROADMAP C6), at the TOL_TRAIN tolerances.
    The host CPU's f32 steps are printed beside them, for the record: they
    may take other decisions at a kink and part from both."""
    tag = "[train small]"
    solvers, losses, seconds = small_trajectories(device)
    gap = trajectory_gaps(solvers, losses, "card", "f64_card_relus")
    card_cpu = trajectory_gaps(solvers, losses, "card", "cpu")
    cpu_f64 = trajectory_gaps(solvers, losses, "cpu", "f64_card_relus")
    tol = dict(loss=TOL_TRAIN_LOSS, weights=TOL_TRAIN_PARAM, biases=TOL_TRAIN_UPDATE,
               momentum=TOL_TRAIN_UPDATE)
    fmt = lambda d: ", ".join(f"{q} {v:.3g}" for q, v in d.items())
    print(f"{tag} losses " + "; ".join(f"{k} {losses[k]}" for k in SMALL_ARITHMETICS)
          + f". Card against f64 with the card's ReLU decisions (loss: the largest relative gap; "
          f"the rest of each blob's largest magnitude): {fmt(gap)} (limits {fmt(tol)}); for the "
          f"record, card against cpu {fmt(card_cpu)}, cpu against that f64 {fmt(cpu_f64)}; "
          f"seconds " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    check(all(np.isfinite(losses["card"])), f"{tag} non-finite loss")
    for q in gap:
        check(gap[q] <= tol[q], f"{tag} {q}: the card differs from the decision-matched f64 run "
              f"by {gap[q]} (limit {tol[q]})")
    return dict(losses=losses, card_f64=gap, card_cpu=card_cpu, cpu_f64=cpu_f64,
                limits=tol, seconds=seconds)


def train_step_flops(net):
    """The operations of one train step's convolutions, 2 a multiply-add:
    the forward, the weight gradients, and the input gradients of every
    convolution but those reading a net input (the data takes none)."""
    total = 0
    for layer in net.layers:
        if layer.type != "Convolution":
            continue
        n, co, h, w = net.blob_shapes[layer.tops[0]]
        conv = net.convs[layer.name]
        macs = n * co * h * w * conv.weight.shape[1] * conv.kernel[0] * conv.kernel[1]
        total += 2 * macs * (2 if layer.bottoms[0] in net.input_names else 3)
    return total


def timed_batches(gen, host_ms):
    """``gen``'s batches, the host ms of each appended to ``host_ms``."""
    while True:
        t0 = time.perf_counter()
        batch = next(gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        yield batch


def timed_steps(solver, n):
    """``n`` solver steps, each between CUDA events -> (ms list, losses)."""
    import torch

    ms, losses = [], []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(solver.step(1))
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return ms, losses


def phase_train_bench(shape, device="cuda"):
    """bench_train.py's configuration in one pipeline shape: ``sync`` (the
    host augments inside the step), ``ring`` (a 3-deep prefetch thread),
    ``staged`` (the thread also uploads, from pinned memory on a side
    stream).  2 warm steps, then the timed ones."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
    from caffe_rtpose_tpu_torch.training.datasets import (SyntheticPoseSource, prefetch_loader,
                                                          stage_batches)
    from caffe_rtpose_tpu_torch.training.labels_device import (make_input_transform,
                                                               pose_batches_jointfeed)
    from caffe_rtpose_tpu_torch.training.solver import Solver
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    tag = f"[train {shape}]"
    prm = AugParams(crop_size_x=TRAIN_CROP, crop_size_y=TRAIN_CROP)
    net = Net(make_pose_train_net(batch=TRAIN_BATCH, crop=TRAIN_CROP), phase="TRAIN",
              device=device, seed=0)
    host_ms = []
    batches = timed_batches(pose_batches_jointfeed(SyntheticPoseSource(n=64, size=TRAIN_CROP),
                                                   prm, TRAIN_BATCH, seed=1, data_u8=True),
                            host_ms)
    if shape == "ring":
        batches = prefetch_loader(batches)
    elif shape == "staged":
        batches = stage_batches(batches, device)
    it = iter(batches)
    solver = Solver(TRAIN_SOLVER, net, lambda _: next(it),
                    input_transform=make_input_transform(prm, data_u8=True))
    losses = [solver.step(1) for _ in range(TRAIN_WARM_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_ms, more = timed_steps(solver, TRAIN_TIMED_STEPS)
    wall = time.perf_counter() - t0
    losses += more
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if hasattr(batches, "close"):
        batches.close()
    ips = TRAIN_TIMED_STEPS / wall
    flops = train_step_flops(net)
    bound_ms = flops / F32_FLOPS * 1e3
    res = dict(iters_s=ips, imgs_s=ips * TRAIN_BATCH, step_ms_median=statistics.median(step_ms),
               step_ms=step_ms, host_aug_ms_median=statistics.median(host_ms),
               host_aug_batches=len(host_ms), peak_gib=peak, tflop_a_step=flops / 1e12,
               bound_ms=bound_ms, bound_share=bound_ms / statistics.median(step_ms),
               losses=losses)
    print(f"{tag} {ips:.3f} iters/s, {ips * TRAIN_BATCH:.2f} imgs/s; device ms a step (CUDA "
          f"events) median {res['step_ms_median']:.1f}, {['%.1f' % x for x in step_ms]}; "
          f"convolutions {flops / 1e12:.3f} TFLOP a step, bound {bound_ms:.1f} ms at the f32 "
          f"peak ({res['bound_share']:.3f} of the step); host "
          f"augmentation median {res['host_aug_ms_median']:.1f} ms a batch of {TRAIN_BATCH} "
          f"({len(host_ms)} batches); peak {peak:.3f} GiB; losses {['%.4g' % x for x in losses]}")
    check(all(np.isfinite(losses)), f"{tag} non-finite loss")
    return res, solver


def saved_weights(path):
    """{layer: [blob, ...]} of a .caffemodel or a .caffemodel.h5."""
    from caffe_rtpose_tpu_torch.proto import caffemodel
    from caffe_rtpose_tpu_torch.utils import hdf5

    if not path.endswith(".h5"):
        return caffemodel.load_weights(path)
    with hdf5.File(path, "r") as f:
        return {name: [np.asarray(g[str(i)]) for i in range(len(g))]
                for name, g in f["data"].items()}


def phase_train_resume(solver, work, device="cuda"):
    """Snapshot the solver, restore a fresh one from the files, take the
    same next step on both; then a deploy estimator from the snapshot's
    caffemodel runs a frame (train and deploy weights interchange by layer
    name).  Both snapshot formats, BINARYPROTO then HDF5 (the port's HDF5
    codec, h5py blocked)."""
    import os

    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net, make_pose_train_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.proto import caffe_pb, prototxt
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
    from caffe_rtpose_tpu_torch.training.labels_device import (make_input_transform,
                                                               pose_batches_jointfeed)
    from caffe_rtpose_tpu_torch.training.solver import Solver
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    prm = AugParams(crop_size_x=TRAIN_CROP, crop_size_y=TRAIN_CROP)
    batch = next(pose_batches_jointfeed(SyntheticPoseSource(n=8, size=TRAIN_CROP, seed=5), prm,
                                        TRAIN_BATCH, seed=6, data_u8=True))
    solver.next_batch = lambda _: batch
    deploy_path = os.path.join(work, "pose_deploy_linevec.prototxt")
    prototxt.dump_file(make_pose_deploy_net("COCO"), deploy_path)
    out = {}
    for fmt in ("BINARYPROTO", "HDF5"):
        tag = f"[train resume {fmt}]"
        sp = {**solver.sp_msg, "snapshot_format": caffe_pb.SNAPSHOT_FORMAT[fmt]}
        solver.sp_msg, solver.sp = sp, caffe_pb.view(sp, "SolverParameter")
        with no_module("h5py"):
            t0 = time.perf_counter()
            model_path, state_path = solver.snapshot(os.path.join(work, "pose_train"))
            snap_s = time.perf_counter() - t0
            fresh = Solver(TRAIN_SOLVER, Net(make_pose_train_net(batch=TRAIN_BATCH,
                                                                 crop=TRAIN_CROP),
                                             phase="TRAIN", device=device, seed=1),
                           lambda _: batch, input_transform=make_input_transform(prm, data_u8=True))
            t0 = time.perf_counter()
            fresh.restore(state_path)
            restore_s = time.perf_counter() - t0
        check(fresh.it == solver.it, f"{tag} restored at iter {fresh.it}, not {solver.it}")
        l_cont, l_fresh = solver.step(1), fresh.step(1)
        loss_rel = abs(l_fresh - l_cont) / abs(l_cont)
        param_rel = blob_errors(fresh.params, solver.params)
        hist_rel = blob_errors(fresh.history["h0"], solver.history["h0"])
        print(f"{tag} snapshot {os.path.basename(model_path)} "
              f"({os.path.getsize(model_path) / 1e6:.1f} MB) + {os.path.basename(state_path)} "
              f"({os.path.getsize(state_path) / 1e6:.1f} MB) in {snap_s:.2f} s, restored in "
              f"{restore_s:.2f} s; next step continuing {l_cont:.6g}, restored {l_fresh:.6g} "
              f"(relative gap {loss_rel:.3g}); parameters {param_rel:.3g}, momentum "
              f"{hist_rel:.3g} of each blob's largest (limit {TOL_RESUME})")
        check(max(loss_rel, param_rel, hist_rel) <= TOL_RESUME, f"{tag} the restored step differs")
        del fresh
        with no_module("h5py"):
            est = PoseEstimator(deploy_path, weights=model_path, input_u8=True, device=device)
            saved = saved_weights(model_path)
        deployed = est.net.export_weights()
        same = [k for k in deployed if k in saved and all(
            np.array_equal(a, b) for a, b in zip(deployed[k], saved[k]))]
        check(len(same) == len(deployed),
              f"{tag} {len(same)} of the deploy net's {len(deployed)} convolutions hold the "
              f"snapshot's weights")
        res = est.estimate_from_net_input(canvases(np.random.RandomState(2), 1,
                                                   est.input_shape())[0])
        torch.cuda.synchronize()
        check(np.isfinite(res.peaks).all(), f"{tag} non-finite peaks")
        print(f"{tag} a deploy PoseEstimator from {os.path.basename(model_path)}: {len(same)}/"
              f"{len(deployed)} convolutions by layer name, one 656x368 frame: "
              f"{int((res.peaks[:, 0, 0] > 0).sum())} parts with peaks, {res.num_people} people")
        del est
        out[fmt] = dict(snapshot_s=snap_s, restore_s=restore_s, loss_rel=loss_rel,
                        param_rel=param_rel, momentum_rel=hist_rel, deploy_layers=len(same),
                        people=int(res.num_people), model_mb=os.path.getsize(model_path) / 1e6,
                        state_mb=os.path.getsize(state_path) / 1e6)
    return out


def phase_train_cli(work, device="cuda"):
    """``caffe train`` (3 iterations, full width, --fused_labels) and ``caffe
    time --phase TRAIN`` in new processes."""
    import os
    import subprocess

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
    from caffe_rtpose_tpu_torch.proto import prototxt

    tag = "[train cli]"
    root = os.path.dirname(os.path.abspath(__file__))
    net_path = os.path.join(work, "pose_train.prototxt")
    solver_path = os.path.join(work, "pose_solver.prototxt")
    prototxt.dump_file(make_pose_train_net(batch=TRAIN_BATCH, crop=TRAIN_CROP), net_path)
    with open(solver_path, "w") as f:
        f.write(f'net: "{net_path}"\n{TRAIN_SOLVER}\ndisplay: 1\nmax_iter: 3\n'
                "snapshot_after_train: false\n")
    runs = {}
    for name, args in (("train", ["train", "--solver", solver_path, "--data", "synthetic-pose",
                                  "--fused_labels", "--device", device]),
                       ("time", ["time", "--model", net_path, "--phase", "TRAIN",
                                 "--iterations", "2", "--device", device])):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "caffe_rtpose_tpu_torch", "caffe", *args],
                           cwd=root, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        runs[name] = (p, secs)
        check(p.returncode == 0, f"{tag} caffe {name}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                                 f"{p.stderr[-3000:]}")
    p, secs = runs["train"]
    iters = re.findall(r"^Iteration (\d+) \(([\d.e+-]+) iter/s.*loss = ([\d.e+-]+)", p.stdout, re.M)
    print(f"{tag} caffe train: exit 0 in {secs:.1f} s; " + " | ".join(
        line for line in p.stdout.splitlines() if line.startswith(("Iteration", "Optimization"))))
    check("Optimization Done" in p.stdout and len(iters) == 3,
          f"{tag} caffe train printed {len(iters)} iteration lines:\n{p.stdout[-2000:]}")
    p, t_secs = runs["time"]
    rows = re.findall(r"^\s*(\S+)\s+forward:\s+([\d.]+) ms\s+backward:\s+([\d.]+|n/a)", p.stdout, re.M)
    total = re.search(r"TOTAL \(per-layer sum\)\s+forward:\s+([\d.]+) ms\s+backward:\s+([\d.]+)",
                      p.stdout)
    n_layers = len(prototxt.parse_file(net_path)["layer"])
    top = sorted(((float(f) + (float(b) if b != "n/a" else 0.0), n) for n, f, b in rows
                  if n != "TOTAL"), reverse=True)[:8]
    print(f"{tag} caffe time --phase TRAIN: exit 0 in {t_secs:.1f} s; {len(rows)} layer rows "
          f"({n_layers} layers); per-layer sum forward {total.group(1)} ms, backward "
          f"{total.group(2)} ms; the slowest forward+backward: "
          + ", ".join(f"{n} {ms:.1f} ms" for ms, n in top))
    check(total is not None and len(rows) == n_layers, f"{tag} caffe time printed {len(rows)} rows")
    return dict(train_s=secs, train_iters=[dict(it=int(i), iters_s=float(r), loss=float(l))
                                           for i, r, l in iters],
                time_s=t_secs, time_rows=len(rows), time_forward_ms=float(total.group(1)),
                time_backward_ms=float(total.group(2)))


def phase_train(device="cuda"):
    """The training path: labels, card against CPU, bench_train.py's
    configuration in three shapes, snapshot and resume, the CLI.  The hand
    kernels' counters are zeroed before and read after the training runs:
    training launches none of K1-K4."""
    import tempfile

    zero_counts()
    labels = phase_train_labels(device)
    small = phase_train_small(device)
    clahe = phase_train_clahe(device)
    shapes, solver = {}, None
    for shape in ("sync", "ring", "staged"):
        del solver
        shapes[shape], solver = phase_train_bench(shape, device)
    counts = read_counts()
    check(not any(counts.values()), f"[train] training launched hand kernels: {counts}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        resume = phase_train_resume(solver, work, device)
        cli = phase_train_cli(work, device)
    return dict(labels=labels, small=small, clahe=clahe,
                shapes={k: {m: v for m, v in r.items() if m != "losses"} for k, r in shapes.items()},
                resume=resume, cli=cli, hand_kernel_launches=counts), solver


def phase_train_profile(solver, step_ms, steps=2, top=10, tag="[train profile]"):
    """Where a full-width step's device time goes: ``steps`` steps of the
    solver (on its last batch) under torch.profiler, the kernels by device
    ms; busy share = the kernels' device ms a step over ``step_ms``, the
    unprofiled step (a profiling window slows the host's launches, so its
    own wall time says nothing, and it runs after the other phases)."""
    import torch

    solver.step(1)
    by_name = {}
    _, _, n_kernels, busy_ms = device_kernels(lambda: solver.step(steps), by_name)
    torch.cuda.synchronize()
    busy = busy_ms / steps
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(f"{tag} {steps} steps: {n_kernels / steps:.0f} kernels a step, busy "
          f"{busy:.1f} ms a step, {busy / step_ms:.3f} of the {step_ms:.1f} ms step; top by "
          "device ms a step: " + "; ".join(
              f"{name[:70]} x{n // steps} {ms / steps:.1f} ms" for name, (n, ms) in rows[:top]))
    return dict(kernels_a_step=n_kernels / steps, busy_ms_a_step=busy,
                busy_share=busy / step_ms,
                top=[dict(name=name, launches_a_step=n / steps, ms_a_step=ms / steps)
                     for name, (n, ms) in rows[:top]])


# -------------------------------------------------------------- train bf16

# bf16 against f32 gradients, relative L2 a blob (JAX's bound and rule,
# tests/test_training.py:585-590).  The f32 step's convolutions run outside
# cuDNN (ops/nn.py::_OutsideCudnn): through cuDNN its trunk bias gradients
# sat 0.41-0.45 from an f64 run at this shape, and bf16 read 0.355 from it
# (ROADMAP C1; H100 80GB HBM3, 700 W)
TOL_BF16_GRAD = 0.3
TOL_REMAT = {"f32": 1e-6, "bf16": 2.0 ** -8}  # remat="convs" against "none", relative L2 a blob
GRAD_FLOOR = 1e-5  # a blob whose f32 gradient norm is below this has no direction to hold


def grad_tree(net):
    return {name: [p.grad.detach().float().clone() for p in ps]
            for name, ps in net.layer_blobs().items()}


def tree_rel_l2(got, ref, floor=0.0):
    """{layer[i]: |got - ref| / |ref|} over the blobs whose |ref| > floor."""
    out = {}
    for name, refs in ref.items():
        for i, (g, r) in enumerate(zip(got[name], refs)):
            nr = float(r.norm())
            if nr > floor:
                out[f"{name}[{i}]"] = float((g - r).norm()) / nr
    return out


def train_bf16_grads(batch, transform, device="cuda"):
    """One step's gradients of the full-width train net (seed 0 init) from
    one batch, f32 and bf16, remat "none" and "convs": bf16 against f32 per
    blob, and each remat pair."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net

    tag = "[train bf16 grads]"
    inputs = transform(dict(batch))
    grads, losses = {}, {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for remat in ("none", "convs"):
            net = Net(make_pose_train_net(batch=TRAIN_BATCH, crop=TRAIN_CROP), phase="TRAIN",
                      device=device, seed=0, dtype=dtype, remat=remat)
            loss, _ = net.loss(inputs)
            loss.backward()
            grads[dname, remat] = grad_tree(net)
            losses[f"{dname} {remat}"] = float(loss.detach())
            del net, loss
    torch.cuda.empty_cache()
    ref = grads["f32", "none"]
    rel = tree_rel_l2(grads["bf16", "none"], ref, GRAD_FLOOR)
    worst = max(rel, key=rel.get)
    remat = {}
    for dname in ("f32", "bf16"):
        r = tree_rel_l2(grads[dname, "convs"], grads[dname, "none"])
        same = all(torch.equal(a, b) for k in grads[dname, "none"]
                   for a, b in zip(grads[dname, "convs"][k], grads[dname, "none"][k]))
        remat[dname] = dict(max_rel_l2=max(r.values()), bit_identical=same)
    skipped = sum(len(v) for v in ref.values()) - len(rel)
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    print(f"{tag} losses {losses}; bf16 against f32, relative L2 a blob: largest "
          f"{rel[worst]:.4f} ({worst}), median {statistics.median(rel.values()):.4f} over "
          f"{len(rel)} blobs ({skipped} under the {GRAD_FLOOR} norm floor; limit {TOL_BF16_GRAD}); "
          f"top {[(k, round(v, 4)) for k, v in top]}; remat convs against none: {remat} "
          f"(limits {TOL_REMAT})")
    check(all(np.isfinite(list(losses.values()))), f"{tag} non-finite loss {losses}")
    check(all(bool(torch.isfinite(g).all()) for t in grads.values() for gs in t.values()
              for g in gs), f"{tag} non-finite gradients")
    check(rel[worst] <= TOL_BF16_GRAD, f"{tag} {worst}: bf16 gradient {rel[worst]} from f32")
    for dname, r in remat.items():
        check(r["max_rel_l2"] <= TOL_REMAT[dname], f"{tag} {dname} remat gradients differ: {r}")
    return dict(losses=losses, bf16_max=rel[worst], bf16_worst=worst,
                bf16_median=statistics.median(rel.values()), blobs=len(rel),
                below_floor=skipped, remat=remat)


def train_bf16_run(remat, device_batch, transform, device="cuda"):
    """The bf16 train net with ``remat``: ``Solver.step`` between CUDA events
    on a batch already on the card (2 warm, then the timed steps, peak
    memory over them), then in the ring shape (host augmentation in the
    3-deep prefetch thread), then two steps under torch.profiler.  Every
    loss and parameter finite, parameters and history f32."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource, prefetch_loader
    from caffe_rtpose_tpu_torch.training.labels_device import pose_batches_jointfeed
    from caffe_rtpose_tpu_torch.training.solver import Solver
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    tag = f"[train bf16 remat={remat}]"
    net = Net(make_pose_train_net(batch=TRAIN_BATCH, crop=TRAIN_CROP), phase="TRAIN",
              device=device, seed=0, dtype=torch.bfloat16, remat=remat)
    check(not net.conv1_kernel, f"{tag} a TRAIN net took the conv1 kernel")
    solver = Solver(TRAIN_SOLVER, net, lambda _: device_batch, input_transform=transform)
    losses = [solver.step(1) for _ in range(TRAIN_WARM_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, more = timed_steps(solver, TRAIN_TIMED_STEPS)
    losses += more
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prm = AugParams(crop_size_x=TRAIN_CROP, crop_size_y=TRAIN_CROP)
    host_ms = []
    ring = prefetch_loader(timed_batches(pose_batches_jointfeed(
        SyntheticPoseSource(n=64, size=TRAIN_CROP), prm, TRAIN_BATCH, seed=1, data_u8=True),
        host_ms))
    it = iter(ring)
    solver.next_batch = lambda _: next(it)
    losses += [solver.step(1) for _ in range(TRAIN_WARM_STEPS)]
    t0 = time.perf_counter()
    ring_ms, more = timed_steps(solver, TRAIN_TIMED_STEPS)
    ring_ips = TRAIN_TIMED_STEPS / (time.perf_counter() - t0)
    losses += more
    if hasattr(ring, "close"):
        ring.close()
    solver.next_batch = lambda _: device_batch
    med = statistics.median(step_ms)
    profile = phase_train_profile(solver, med, tag=f"{tag} profile")
    finite = all(bool(torch.isfinite(p).all()) for _, _, p, _, _ in net.learnable())
    flops = train_step_flops(net)
    bound_ms = flops / BF16_FLOPS * 1e3
    res = dict(step_ms_median=med, step_ms=step_ms, ring_step_ms_median=statistics.median(ring_ms),
               ring_step_ms=ring_ms, ring_iters_s=ring_ips, ring_imgs_s=ring_ips * TRAIN_BATCH,
               host_aug_ms_median=statistics.median(host_ms), peak_gib=peak,
               tflop_a_step=flops / 1e12, bound_ms=bound_ms, bound_share=bound_ms / med,
               losses=losses, params_finite=finite, profile=profile)
    print(f"{tag} Solver.step on a batch on the card (CUDA events) median {med:.2f} ms "
          f"({['%.1f' % x for x in step_ms]}), {1e3 / med:.2f} iters/s; ring: median "
          f"{res['ring_step_ms_median']:.1f} ms a step, {ring_ips:.3f} iters/s, "
          f"{ring_ips * TRAIN_BATCH:.2f} imgs/s, host augmentation median "
          f"{res['host_aug_ms_median']:.1f} ms a batch; {flops / 1e12:.3f} TFLOP a step, bound "
          f"{bound_ms:.2f} ms at the bf16 peak ({res['bound_share']:.3f} of the step); peak "
          f"{peak:.3f} GiB; losses {['%.4g' % x for x in losses]}")
    check(len(losses) >= 5 and all(np.isfinite(losses)), f"{tag} non-finite loss {losses}")
    check(finite, f"{tag} non-finite parameters")
    check(all(p.dtype == torch.float32 for _, _, p, _, _ in net.learnable())
          and all(h.dtype == torch.float32 for slot in solver.history.values()
                  for hs in slot.values() for h in hs), f"{tag} parameters or history not f32")
    return res


def phase_train_bf16(f32_step_ms=None, device="cuda"):
    """bench_train.py's configuration in bf16 mixed precision (the full
    6-stage train net at batch 10, crop 368, seed 0 init, SGD 2e-5 / 0.9 /
    5e-4, labels rasterized on the card) with remat "none" and "convs": the
    gradient gates, then each run; the hand kernels' counters zeroed before
    and read after (training launches none of K1-K4)."""
    import torch

    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
    from caffe_rtpose_tpu_torch.training.labels_device import (make_input_transform,
                                                               pose_batches_jointfeed)
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    zero_counts()
    t0 = time.perf_counter()
    prm = AugParams(crop_size_x=TRAIN_CROP, crop_size_y=TRAIN_CROP)
    transform = make_input_transform(prm, data_u8=True)
    host = next(pose_batches_jointfeed(SyntheticPoseSource(n=16, size=TRAIN_CROP, seed=3), prm,
                                       TRAIN_BATCH, seed=4, data_u8=True))
    device_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in host.items()}
    grads = train_bf16_grads(device_batch, transform, device)
    runs = {r: train_bf16_run(r, device_batch, transform, device) for r in ("none", "convs")}
    counts = read_counts()
    check(not any(counts.values()), f"[train bf16] launched hand kernels: {counts}")
    seconds = time.perf_counter() - t0
    print(f"[train bf16] {seconds:.1f} s in all; hand kernel launches {counts}; step on a batch "
          f"on the card: remat none {runs['none']['step_ms_median']:.2f} ms, convs "
          f"{runs['convs']['step_ms_median']:.2f} ms (f32 staged step in this run: "
          f"{f32_step_ms} ms); peak {runs['none']['peak_gib']:.3f} / "
          f"{runs['convs']['peak_gib']:.3f} GiB")
    return dict(grads=grads, runs={r: {k: v for k, v in res.items() if k != "losses"}
                                   for r, res in runs.items()},
                losses={r: res["losses"] for r, res in runs.items()},
                f32_staged_step_ms=f32_step_ms, hand_kernel_launches=counts, seconds=seconds)


# -------------------------------------------------------------- framework

FW_BATCH, FW_CROP, FW_SIZE, FW_RECORDS = 256, 227, 256, 512  # CaffeNet, batch 256
FW_ITERS, FW_TEST_INTERVAL, FW_TEST_ITER = 20, 10, 2
FW_SOLVER = ("base_lr: 0.01\nlr_policy: 'fixed'\nmomentum: 0.9\nweight_decay: 5e-4\n"
             "display: 10\n")
HDF5_TYPES = ("HDF5Data", "HDF5Output")  # run by the hdf5 phase, at CaffeNet's width
TOL_ZOO_FWD = 1e-5  # card against CPU: |a - b| <= 1e-5 * max(1, |b|)
TOL_ZOO_GRAD = 1e-4  # gradients: within 1e-4 of each blob's largest |b|
TOL_KEPT = 0.02  # Dropout / STOCHASTIC: kept share within 2 % of 1 - p
TOL_FW_LOSS, TOL_FW_PARAM = 1e-5, 1e-4  # the narrow CaffeNet's 3 steps, card against CPU
TOL_FW_TEST = 1e-5  # caffe test against the train run's last test pass


def zoo_cases():
    """The layer cases of the CPU test files (``tests/test_torch_layers_*``,
    each held against JAX there): one small net a case."""
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_layers_loss
    import test_torch_layers_neuron
    import test_torch_layers_recurrent
    import test_torch_layers_shape
    import test_torch_layers_vision

    return [c for m in (test_torch_layers_neuron, test_torch_layers_vision,
                        test_torch_layers_loss, test_torch_layers_shape,
                        test_torch_layers_recurrent) for c in m.CASES]


def zoo_errors(got, ref, ints=()):
    """{name: (worst |a-b| over its tolerance, exact)} of two {name: array}."""
    out = {}
    for k, b in ref.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(b, np.float64)
        check(a.shape == b.shape, f"[framework zoo] {k}: shape {a.shape} vs {b.shape}")
        if k in ints:
            out[k] = (0.0 if np.array_equal(a, b) else float("inf"), True)
        else:
            out[k] = (float((np.abs(a - b) / (TOL_ZOO_FWD * np.maximum(1.0, np.abs(b)))).max())
                      if b.size else 0.0, False)
    return out


def zoo_case_on(case, device):
    """One case on ``device`` and on the CPU from the same blobs: the tops,
    then (unless the case has no gradient) the input and parameter diffs of
    sum(top * seeded diff)."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net

    proto = {"name": case.id, "input": list(case.inputs),
             "input_shape": [{"dim": list(v.shape)} for v in case.inputs.values()],
             "layer": case.layers}
    nets = {d: Net(proto, phase=case.phase, device=d) for d in (device, "cpu")}
    rs = np.random.RandomState(17)
    weights = case.weights or {name: [(rs.randn(*b.shape) * 0.5).astype(np.float32)
                                      for b in blobs]
                               for name, blobs in nets["cpu"].layer_blobs().items()}
    tops = list(case.tops or dict.fromkeys(t for l in case.layers for t in l.get("top", [])))
    res = {}
    for d, net in nets.items():
        net.load_weights(weights)
        feed = {k: torch.from_numpy(v.copy()).to(d) for k, v in case.inputs.items()}
        with torch.no_grad():
            out = {k: v.float().cpu().numpy() for k, v in net.forward(feed, outputs=tops).items()}
        diffs = {t: np.asarray(np.random.RandomState(5).randn(*out[t].shape), np.float32)
                 for t in tops if t not in case.int_tops}
        grads = {}
        if case.grads:
            din, dparams = net.backward(feed, diffs)
            grads = {f"d{k}": v.cpu().numpy() for k, v in din.items() if k not in case.no_grad}
            grads.update({f"d{k}[{i}]": g.cpu().numpy() for k, gs in dparams.items()
                          for i, g in enumerate(gs)})
        res[d] = (out, grads)
    (out, grads), (ref, rgrads) = res[device], res["cpu"]
    fwd = zoo_errors(out, ref, case.int_tops)
    bwd = {k: float(np.abs(grads[k] - g).max() / (TOL_ZOO_GRAD * max(np.abs(g).max(), 1e-6)))
           for k, g in rgrads.items()}
    return fwd, bwd


def zoo_random(device, n=1 << 20):
    """Dropout and STOCHASTIC pooling draw on the card: Dropout's kept share
    over 1M elements within 2 % of 1 - p, each kept value x/(1 - p);
    STOCHASTIC's outputs each an element of its window."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net

    out = {}
    x = torch.rand(16, 64, 32, 32, device=device) + 0.5  # 1M elements
    for ratio in (0.5, 0.3):
        net = Net({"input": ["x"], "input_shape": [{"dim": list(x.shape)}],
                   "layer": [{"name": "d", "type": "Dropout", "bottom": ["x"], "top": ["y"],
                              "dropout_param": {"dropout_ratio": ratio}}]},
                  phase="TRAIN", device=device, seed=1)
        with torch.no_grad():
            y = net.forward({"x": x})["y"]
        kept = y != 0
        share = kept.float().mean().item()
        scale_err = float(((y[kept] * (1 - ratio) - x[kept]).abs() / x[kept]).max())
        check(abs(share - (1 - ratio)) <= TOL_KEPT * (1 - ratio),
              f"[framework zoo] Dropout {ratio}: kept share {share}")
        check(scale_err <= 1e-6, f"[framework zoo] Dropout {ratio}: scale off by {scale_err}")
        out[f"Dropout {ratio}"] = dict(kept_share=share, scale_rel_err=scale_err)
    net = Net({"input": ["x"], "input_shape": [{"dim": [16, 64, 33, 33]}],
               "layer": [{"name": "p", "type": "Pooling", "bottom": ["x"], "top": ["y"],
                          "pooling_param": {"pool": 2, "kernel_size": 3, "stride": 2}}]},
              phase="TRAIN", device=device, seed=2)
    xs = torch.rand(16, 64, 33, 33, device=device) + 0.5
    with torch.no_grad():
        y = net.forward({"x": xs})["y"]
    wins = torch.nn.functional.unfold(xs, 3, stride=2).reshape(16, 64, 9, 16, 16)
    member = (wins == y.reshape(16, 64, 1, 16, 16)).any(2).float().mean().item()
    check(member == 1.0, f"[framework zoo] STOCHASTIC: {member} of outputs in their window")
    out["STOCHASTIC"] = dict(outputs=int(y.numel()), in_window_share=member)
    return out


def write_fw_sources(work, rs):
    """The data layers' sources for the zoo: a kvdb of Datums, PNGs and
    their list, a window file, a CPM genLMDB-format DB, a mean file."""
    import os

    from caffe_rtpose_tpu_torch.core.data_layers import write_mean_binaryproto
    from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png
    from caffe_rtpose_tpu_torch.proto import datum
    from caffe_rtpose_tpu_torch.training.cpm_lmdb import write_cpm_db
    from caffe_rtpose_tpu_torch.training.transformer import Meta, Person
    from caffe_rtpose_tpu_torch.utils import db as dbmod

    d = dbmod.open_db(os.path.join(work, "zoo_db"), "w", backend="kvdb")
    txn = d.new_transaction()
    imgs = rs.randint(0, 256, (8, 3, 12, 10)).astype(np.uint8)
    for i, a in enumerate(imgs):
        txn.put(f"{i:08d}", datum.serialize_datum(datum.array_to_datum(a, i % 3)))
    txn.commit()
    d.close()
    write_mean_binaryproto(os.path.join(work, "zoo_mean.binaryproto"),
                           imgs.mean(0).astype(np.float32))
    for i in range(3):
        with open(os.path.join(work, f"zoo{i}.png"), "wb") as f:
            f.write(encode_png(rs.randint(0, 256, (40, 50, 3)).astype(np.uint8)))
    with open(os.path.join(work, "zoo_list.txt"), "w") as f:
        f.write("".join(f"zoo{i}.png {i}\n" for i in range(3)))
    with open(os.path.join(work, "zoo_win.txt"), "w") as f:
        f.write(f"# 0\n{work}/zoo0.png\n3 40 50\n2\n1 0.9 5 5 30 30\n0 0.1 0 0 10 10\n")
    recs = []
    for _ in range(2):
        j = rs.uniform(10, 80, size=(17, 2)).astype(np.float32)
        recs.append((rs.randint(0, 256, (96, 96, 3)).astype(np.uint8),
                     Meta(people=[Person(j, np.ones(17, np.int32), j.mean(0))], scale_self=1.0),
                     np.full((96, 96), 255, np.uint8)))
    write_cpm_db(recs, os.path.join(work, "zoo_cpm"))


def zoo_data_layers(device, work):
    """Each data layer feeding an AbsVal, its net on the card and on the
    CPU: the batches and the AbsVal within the forward tolerance (the same
    seeded numpy on both sides)."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net

    layers = {
        "Data": {"data_param": {"source": f"{work}/zoo_db", "batch_size": 3},
                 "transform_param": {"crop_size": 8, "mirror": True,
                                     "mean_file": f"{work}/zoo_mean.binaryproto"}},
        "ImageData": {"image_data_param": {"source": f"{work}/zoo_list.txt", "batch_size": 2,
                                           "root_folder": f"{work}/", "new_height": 24,
                                           "new_width": 30}},
        "MemoryData": {"memory_data_param": {"batch_size": 2, "channels": 2, "height": 3,
                                             "width": 4}},
        "WindowData": {"window_data_param": {"source": f"{work}/zoo_win.txt", "batch_size": 4,
                                             "crop_size": 16, "fg_fraction": 0.5,
                                             "context_pad": 2, "mirror": True}},
        "CPMData": {"data_param": {"source": f"{work}/zoo_cpm", "batch_size": 2},
                    "transform_param": {"stride": 8, "crop_size_x": 64, "crop_size_y": 64,
                                        "num_parts": 56, "np_in_lmdb": 17}},
    }
    out = {}
    arrays = np.random.RandomState(3).randn(4, 2, 3, 4).astype(np.float32)
    for t, params in layers.items():
        proto = {"layer": [{"name": "d", "type": t, "top": ["data", "label"], **params},
                           {"name": "a", "type": "AbsVal", "bottom": ["data"], "top": ["y"]}]}
        res = {}
        for d in (device, "cpu"):
            net = Net(proto, phase="TRAIN", device=d)
            if t == "MemoryData":
                net.set_input_arrays(arrays, np.arange(4, dtype=np.float32))
            with torch.no_grad():
                res[d] = {k: v.float().cpu().numpy()
                          for k, v in net.forward({}, outputs=["data", "label", "y"]).items()}
        out[t] = zoo_errors(res[device], res["cpu"])
    return out


def phase_framework_zoo(work, device="cuda"):
    """(a) Every registered type but the HDF5 ones (the hdf5 phase runs them)
    on the card against the CPU, TF32 off."""
    from caffe_rtpose_tpu_torch import api

    tag = "[framework zoo]"
    checked, worst_fwd, worst_bwd, rows = set(), 0.0, 0.0, {}
    for case in zoo_cases():
        types = {l["type"] for l in case.layers}
        if types & set(HDF5_TYPES):
            continue
        fwd, bwd = zoo_case_on(case, device)
        for k, (ratio, exact) in fwd.items():
            check(ratio <= 1.0, f"{tag} {case.id}: top {k} off by {ratio} of its tolerance"
                                f"{' (exact)' if exact else ''}")
        for k, ratio in bwd.items():
            check(ratio <= 1.0, f"{tag} {case.id}: {k} off by {ratio} of its tolerance")
        worst_fwd = max([worst_fwd] + [r for r, _ in fwd.values()])
        worst_bwd = max([worst_bwd] + list(bwd.values()))
        rows[case.id] = dict(fwd=max([r for r, _ in fwd.values()] or [0.0]),
                             grads=max(list(bwd.values()) or [0.0]))
        checked |= types
    data = zoo_data_layers(device, work)
    for t, errs in data.items():
        check(all(r <= 1.0 for r, _ in errs.values()), f"{tag} data layer {t}: {errs}")
    checked |= set(data)
    random = zoo_random(device)
    registered = set(api.layer_type_list())
    missing = registered - checked - set(HDF5_TYPES)
    check(not missing, f"{tag} registered types neither checked here nor by the hdf5 phase: "
                       f"{missing}")
    print(f"{tag} {len(checked & registered)} of {len(registered)} registered types checked on "
          f"the card against the CPU ({len(rows)} layer cases, {len(data)} data layers; not run: "
          f"{', '.join(HDF5_TYPES)}, which the hdf5 phase runs); worst forward {worst_fwd:.3g} and "
          f"gradient {worst_bwd:.3g} of their tolerances (1e-5*max(1,|y|), 1e-4 of each "
          f"blob's largest); integer tops exact; {json.dumps(random)}")
    return dict(types_checked=len(checked & registered), types_registered=len(registered),
                not_run=list(HDF5_TYPES), cases=len(rows), worst_fwd_ratio=worst_fwd,
                worst_grad_ratio=worst_bwd, random=random)


def write_caffenet_db(work):
    """512 seeded 3x256x256 u8 Datums (numpy seed 0, labels 0-999) in a kvdb
    and their mean as a .binaryproto; (seconds, MB)."""
    import os

    from caffe_rtpose_tpu_torch.core.data_layers import write_mean_binaryproto
    from caffe_rtpose_tpu_torch.proto import datum
    from caffe_rtpose_tpu_torch.utils import db as dbmod

    t0 = time.perf_counter()
    rs = np.random.RandomState(0)
    path = os.path.join(work, "caffenet_db")
    d = dbmod.open_db(path, "w", backend="kvdb")
    txn = d.new_transaction()
    total = np.zeros((3, FW_SIZE, FW_SIZE), np.float64)
    for i in range(FW_RECORDS):
        img = rs.randint(0, 256, (3, FW_SIZE, FW_SIZE)).astype(np.uint8)
        total += img
        txn.put(f"{i:08d}", datum.serialize_datum(datum.array_to_datum(img, int(rs.randint(1000)))))
    txn.commit()
    d.close()
    write_mean_binaryproto(os.path.join(work, "caffenet_mean.binaryproto"),
                           (total / FW_RECORDS).astype(np.float32))
    mb = (os.path.getsize(path) if os.path.isfile(path) else
          sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)) / 1e6
    return path, time.perf_counter() - t0, mb


def caffenet_flops(net):
    """One train step's operations, 2 a multiply-add: each convolution's and
    inner product's forward, weight gradient and (but the first layer's)
    input gradient."""
    total = 0
    for layer in net.layers:
        mod = net.mods[layer.name]
        if layer.type == "Convolution":
            n, co, h, w = net.blob_shapes[layer.tops[0]]
            macs = n * co * h * w * mod.weight.shape[1] * mod.kernel[0] * mod.kernel[1]
        elif layer.type == "InnerProduct":
            macs = mod.m * mod.k * mod.weight.shape[0]
        else:
            continue
        total += 2 * macs * (2 if layer.bottoms[0] in net.input_names else 3)
    return total


def phase_framework_train(work, device="cuda"):
    """(b) caffe train at CaffeNet's full width: the train_val with Data
    layers over the 512-record kvdb, SGD, 20 iterations, a test every 10,
    the snapshot at the end.  Solver.step is timed between CUDA events and
    the Data layer's batches on the host, in the same process."""
    import contextlib
    import io
    import os

    import torch

    from caffe_rtpose_tpu_torch.core import data_layers
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_train_val
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.tools import caffe_tool
    from caffe_rtpose_tpu_torch.training import solver as solver_mod

    tag = "[framework train]"
    db, db_s, db_mb = write_caffenet_db(work)
    mean = os.path.join(work, "caffenet_mean.binaryproto")
    tv = os.path.join(work, "caffenet_train_val.prototxt")
    prototxt.dump_file(make_caffenet_train_val(db, db, mean, batch=FW_BATCH,
                                               test_batch=FW_BATCH, crop=FW_CROP), tv)
    solver_path = os.path.join(work, "caffenet_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(f'net: "{tv}"\n{FW_SOLVER}max_iter: {FW_ITERS}\n'
                f"test_interval: {FW_TEST_INTERVAL}\ntest_iter: {FW_TEST_ITER}\n"
                f'snapshot_prefix: "{work}/caffenet"\n')
    step_ms, host_ms, solvers = [], [], []
    orig_step, orig_batches = solver_mod.Solver.step, data_layers.DataLayer.batches

    def timed_step(self, iters=1, callback=None):
        solvers[:] = [self]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = orig_step(self, iters, callback)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        return loss

    def timed_batches(self):
        gen = orig_batches(self)
        while True:
            t0 = time.perf_counter()
            batch = next(gen)
            if self.batch_size == FW_BATCH and self.tf.phase == "TRAIN":
                host_ms.append((time.perf_counter() - t0) * 1e3)
            yield batch

    solver_mod.Solver.step, data_layers.DataLayer.batches = timed_step, timed_batches
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = caffe_tool.main(["train", "--solver", solver_path, "--device", device])
    finally:
        solver_mod.Solver.step, data_layers.DataLayer.batches = orig_step, orig_batches
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    text = out.getvalue()
    check(rc == 0 and "Optimization Done" in text, f"{tag} caffe train: exit {rc}\n{text[-3000:]}")
    tests = re.findall(r"Iteration (\d+), Testing net \(#0\)\n\s+Test net output #0: accuracy = "
                       r"([\d.e+-]+)\n\s+Test net output #1: loss = ([\d.e+-]+)", text)
    losses = [float(x) for x in re.findall(r"loss = ([\d.e+-]+) \(smoothed", text)]
    check([int(i) for i, _, _ in tests] == list(range(0, FW_ITERS + 1, FW_TEST_INTERVAL)),
          f"{tag} test passes {tests}")
    check(all(np.isfinite([float(a), float(l)]).all() for _, a, l in tests),
          f"{tag} non-finite test outputs {tests}")
    snapshot = f"{work}/caffenet_iter_{FW_ITERS}.caffemodel"
    check(os.path.exists(snapshot), f"{tag} no snapshot {snapshot}")
    solver = solvers[0]
    timed = step_ms[2:]  # the first two take cuDNN's first calls
    med = statistics.median(timed)
    flops = caffenet_flops(solver.net)
    bound_ms = flops / F32_FLOPS * 1e3
    ips = len(step_ms) / (sum(step_ms) / 1e3)
    res = dict(iters=FW_ITERS, wall_s=wall, iters_s_wall=FW_ITERS / wall,
               imgs_s_wall=FW_ITERS * FW_BATCH / wall, step_ms_median=med,
               step_ms=step_ms, iters_s_steps=ips, imgs_s_steps=ips * FW_BATCH,
               host_data_ms_median=statistics.median(host_ms), host_batches=len(host_ms),
               peak_gib=peak, tflop_a_step=flops / 1e12, bound_ms=bound_ms,
               bound_share=bound_ms / med, losses=losses,
               tests=[dict(iter=int(i), accuracy=float(a), loss=float(l)) for i, a, l in tests],
               db_write_s=db_s, db_mb=db_mb, snapshot=snapshot)
    print(f"{tag} caffe train, CaffeNet batch {FW_BATCH} crop {FW_CROP}, {FW_ITERS} iterations "
          f"in {wall:.1f} s: {FW_ITERS / wall:.3f} iters/s, {FW_ITERS * FW_BATCH / wall:.1f} "
          f"imgs/s (wall, tests and snapshot included); Solver.step between CUDA events median "
          f"{med:.1f} ms ({['%.1f' % x for x in step_ms]}), {ips:.3f} iters/s over the steps; "
          f"host Data batch ({FW_BATCH} crops, mirrors, mean) median {res['host_data_ms_median']:.1f} "
          f"ms ({len(host_ms)} batches); {flops / 1e12:.3f} TFLOP a step, bound {bound_ms:.1f} "
          f"ms at the f32 peak ({res['bound_share']:.3f} of the step); peak {peak:.2f} GiB; "
          f"tests {res['tests']}; the kvdb ({db_mb:.0f} MB) written in {db_s:.1f} s")
    return res, solver, tv, mean, text


def phase_framework_small(device="cuda", steps=3):
    """(c) A narrow CaffeNet-shaped net (the same layer types but Dropout,
    widths cut, crop 67, batch 4): 3 SGD steps on the card and on the CPU
    from the same weights and batches."""
    import torch  # noqa: F401

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet
    from caffe_rtpose_tpu_torch.training.solver import Solver

    tag = "[framework small]"
    proto = make_caffenet(batch=4, crop=67, num_classes=10)
    proto["layer"] = [l for l in proto["layer"] if l["type"] != "Dropout"]
    widths = {"conv1": 16, "conv2": 16, "conv3": 24, "conv4": 24, "conv5": 16, "fc6": 64,
              "fc7": 64}
    for l in proto["layer"]:
        p = l.get("convolution_param") or l.get("inner_product_param")
        if l["name"] in widths:
            p["num_output"] = widths[l["name"]]
    rs = np.random.RandomState(21)
    batches = [{"data": (rs.rand(4, 3, 67, 67) * 255 - 128).astype(np.float32),
                "label": rs.randint(0, 10, 4).astype(np.float32)} for _ in range(steps)]
    runs = {}
    for dev in (device, "cpu"):
        net = Net(proto, phase="TRAIN", device=dev, seed=5)
        solver = Solver(FW_SOLVER, net, lambda it: batches[it])
        runs[dev] = ([solver.step(1) for _ in range(steps)], solver)
    (lc, sc), (lh, sh) = runs[device], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    param_rel = blob_errors(sc.params, sh.params)
    print(f"{tag} losses card {lc} cpu {lh}: largest relative gap {loss_rel:.3g} (limit "
          f"{TOL_FW_LOSS}); parameters {param_rel:.3g} of each blob's largest (limit "
          f"{TOL_FW_PARAM})")
    check(all(np.isfinite(lc)), f"{tag} non-finite loss")
    check(loss_rel <= TOL_FW_LOSS, f"{tag} losses differ by {loss_rel}")
    check(param_rel <= TOL_FW_PARAM, f"{tag} parameters differ by {param_rel}")
    return dict(losses_card=lc, losses_cpu=lh, loss_rel=loss_rel, param_rel=param_rel)


def phase_framework_test(tv, snapshot, last, device="cuda"):
    """(d) caffe test --model train_val --weights snapshot --iterations 2 in
    a new process: the train run's last test pass."""
    import os
    import subprocess

    tag = "[framework caffe test]"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "caffe_rtpose_tpu_torch", "caffe", "test",
                        "--model", tv, "--weights", snapshot, "--iterations", str(FW_TEST_ITER),
                        "--device", device], cwd=root, capture_output=True, text=True,
                       timeout=600)
    secs = time.perf_counter() - t0
    check(p.returncode == 0, f"{tag} exit {p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    got = {k: float(v) for k, v in re.findall(r"^(\w+) = ([\d.e+-]+)$", p.stdout, re.M)}
    gaps = {k: abs(got.get(k, float("nan")) - last[k]) / max(abs(last[k]), 1e-6)
            for k in ("loss", "accuracy")}
    print(f"{tag} exit 0 in {secs:.1f} s: {got} against the train run's last test pass "
          f"{ {k: last[k] for k in ('loss', 'accuracy')} }, relative gaps {gaps} (limit "
          f"{TOL_FW_TEST})")
    check(all(g <= TOL_FW_TEST for g in gaps.values()), f"{tag} differs: {gaps}")
    return dict(seconds=secs, got=got, gaps=gaps)


def phase_framework_facade(work, snapshot, mean, device="cuda"):
    """(e) The facade: api.Net on CaffeNet's deploy form at batch 10 against
    the core Net bit for bit; classify (10-crop) on 4 PNGs; api.Net on the
    COCO pose deploy graph at f32 against Net.forward bit for bit."""
    import os

    import torch

    from caffe_rtpose_tpu_torch import api
    from caffe_rtpose_tpu_torch.__main__ import main as tool_main
    from caffe_rtpose_tpu_torch.core.data_layers import read_mean_binaryproto
    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_deploy
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png
    from caffe_rtpose_tpu_torch.proto import prototxt

    tag = "[framework facade]"
    api.set_mode_cpu() if device == "cpu" else api.set_mode_gpu()
    deploy = os.path.join(work, "caffenet_deploy.prototxt")
    prototxt.dump_file(make_caffenet_deploy(batch=10), deploy)
    rs = np.random.RandomState(8)
    x = (rs.rand(10, 3, FW_CROP, FW_CROP) * 255 - 128).astype(np.float32)
    t0 = time.perf_counter()
    facade = api.Net(deploy, snapshot, api.TEST)
    got = facade.forward(data=x)["prob"]
    facade_s = time.perf_counter() - t0
    core = Net(deploy, device=device)
    core.load_weights(snapshot)
    with torch.no_grad():
        ref = core.forward({"data": torch.from_numpy(x).to(device)})["prob"].cpu().numpy()
    check(np.array_equal(got, ref), f"{tag} api.Net differs from Net: "
                                    f"{float(np.abs(got - ref).max())}")
    imgs = os.path.join(work, "classify")
    os.makedirs(imgs, exist_ok=True)
    for i in range(4):
        with open(os.path.join(imgs, f"im{i}.png"), "wb") as f:
            f.write(encode_png(rs.randint(0, 256, (300, 280, 3)).astype(np.uint8)))
    np.save(os.path.join(work, "mean.npy"), read_mean_binaryproto(mean).mean((1, 2)))
    t0 = time.perf_counter()
    rc = tool_main(["classify", imgs, os.path.join(work, "probs.npy"), "--model_def", deploy,
                    "--pretrained_model", snapshot, "--mean_file",
                    os.path.join(work, "mean.npy"), "--device", device])
    classify_s = time.perf_counter() - t0
    probs = np.load(os.path.join(work, "probs.npy"))
    sums = probs.sum(1)
    check(rc == 0 and probs.shape == (4, 1000) and np.allclose(sums, 1.0, atol=1e-5),
          f"{tag} classify: exit {rc}, {probs.shape}, row sums {sums}")
    pose = os.path.join(work, "pose_deploy.prototxt")
    prototxt.dump_file(make_pose_deploy_net("COCO"), pose)
    pnet = api.Net(pose, api.TEST)
    shape = pnet.blobs["image"].shape
    img = (rs.rand(*shape) - 0.5).astype(np.float32)
    t0 = time.perf_counter()
    out = pnet.forward(blobs=["concat_stage7"], image=img)
    pose_s = time.perf_counter() - t0
    check(pnet.outputs == ["joints"] and list(out) == ["joints", "concat_stage7"],
          f"{tag} pose api.Net outputs {pnet.outputs}, forward gave {list(out)}")
    low, joints = out["concat_stage7"], out["joints"]
    pcore = Net(pose, device=device)
    with torch.no_grad():
        pref = pcore.forward({"image": torch.from_numpy(img).to(device)},
                             outputs=["concat_stage7", "joints"])
    pref, jref = (pref[k].float().cpu().numpy() for k in ("concat_stage7", "joints"))
    check(np.array_equal(low, pref), f"{tag} pose api.Net differs from Net: "
                                     f"{float(np.abs(low - pref).max())}")
    check(np.array_equal(joints, jref) and joints.shape == (1, 18, 65, 3),
          f"{tag} pose api.Net joints {joints.shape} differ from Net's")
    print(f"{tag} api.Net(CaffeNet deploy, snapshot, TEST) batch 10: prob bit-identical to "
          f"Net.forward ({facade_s:.2f} s with the build); classify 10-crop on 4 PNGs: row sums "
          f"{sums.tolist()} ({classify_s:.1f} s); api.Net on the COCO deploy graph {shape}: "
          f"outputs {pnet.outputs}, joints {tuple(joints.shape)} ({int(joints[0, :, 0, 0].sum())} "
          f"peaks) and concat_stage7 {tuple(low.shape)} bit-identical to Net.forward "
          f"({pose_s:.2f} s, every blob fetched)")
    return dict(facade_s=facade_s, classify_s=classify_s, row_sums=sums.tolist(),
                pose_shape=list(shape), pose_s=pose_s)


def phase_framework(work, device="cuda"):
    """The framework path in ``work``, with the hand kernels' counters zeroed
    before and read after (it launches none of K1-K4): (a) the layer zoo, (b)
    caffe train at CaffeNet's full width with a test net, (c) card against
    CPU, (d) caffe test, (e) the facade; then two of (b)'s steps under the
    profiler.  Returns its JSON entry, (b)'s snapshot and its log."""
    zero_counts()
    t0 = time.perf_counter()
    write_fw_sources(work, np.random.RandomState(0))
    zoo = phase_framework_zoo(work, device)
    train, solver, tv, mean, log = phase_framework_train(work, device)
    small = phase_framework_small(device)
    last = train["tests"][-1]
    test = phase_framework_test(tv, train["snapshot"], last, device)
    facade = phase_framework_facade(work, train["snapshot"], mean, device)
    c2 = phase_c2(device)
    counts = read_counts()
    check(not any(counts.values()), f"[framework] launched hand kernels: {counts}")
    solver.test_nets = []  # the profile times train steps alone
    profile = phase_train_profile(solver, train["step_ms_median"], tag="[framework profile]")
    del solver
    snapshot = train.pop("snapshot")
    seconds = time.perf_counter() - t0
    print(f"[framework] {seconds:.1f} s in all; hand kernel launches {counts}")
    return dict(zoo=zoo, train=train, small=small, caffe_test=test, facade=facade, c2=c2,
                profile=profile, hand_kernel_launches=counts, seconds=seconds), snapshot, log


# ------------------------------------------------------------------ tools

TOOL_IMAGES, TOOL_SIZE, TOOL_ITERS, TOOL_WINDOWS = 512, 256, 2, 64
TOL_TOOLS_CPU = 1e-5  # extract_features on the CPU against the card: 1e-5 * max(1, |y|)
ENCODED_NO_CV2 = r"""
import sys
sys.modules["cv2"] = None
import numpy as np
from caffe_rtpose_tpu_torch.core.data_layers import datum_chw
from caffe_rtpose_tpu_torch.proto import datum
from caffe_rtpose_tpu_torch.tools.aux_tools import main
from caffe_rtpose_tpu_torch.utils.db import open_db
lst, root, raw, enc = sys.argv[1:5]
assert main(["convert_imageset", lst, root, enc, "--encoded"]) == 0

def records(path):
    with open_db(path, "r") as db:
        cur = db.new_cursor()
        cur.seek_to_first()
        while cur.valid():
            d = datum.parse_datum(cur.value())
            yield cur.key(), d.get("label", 0), bool(d.get("encoded")), datum_chw(d)
            cur.next()

n = 0
for (k, l, e, a), (k2, l2, e2, b) in zip(records(raw), records(enc)):
    assert k == k2 and l == l2 and not e and e2 and np.array_equal(a, b), k
    n += 1
print("ENCODED", n, sys.modules["cv2"] is None)
"""


def write_tool_images(work, rs):
    """TOOL_IMAGES seeded TOOL_SIZE^2 PNGs (written without OpenCV), their
    list file with labels, and their stacked CHW u8 pixels."""
    import os

    from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png

    root = os.path.join(work, "tool_images")
    os.makedirs(root, exist_ok=True)
    lines, pixels = [], np.empty((TOOL_IMAGES, 3, TOOL_SIZE, TOOL_SIZE), np.uint8)
    for i in range(TOOL_IMAGES):
        img = rs.randint(0, 256, (TOOL_SIZE, TOOL_SIZE, 3)).astype(np.uint8)
        with open(os.path.join(root, f"im{i:04d}.png"), "wb") as f:
            f.write(encode_png(img))
        pixels[i] = img.transpose(2, 0, 1)
        lines.append(f"im{i:04d}.png {int(rs.randint(1000))}\n")
    lst = os.path.join(work, "tool_list.txt")
    with open(lst, "w") as f:
        f.writelines(lines)
    return root, lst, pixels


def tools_dbs(work, root, lst, pixels):
    """convert_imageset raw and --encoded (the latter in a new process with
    cv2 blocked, which also decodes both DBs and compares them), and the
    raw DB's pixels against the images."""
    import contextlib
    import io
    import os
    import subprocess

    from caffe_rtpose_tpu_torch.core.data_layers import datum_chw
    from caffe_rtpose_tpu_torch.proto import datum
    from caffe_rtpose_tpu_torch.tools.aux_tools import main as aux
    from caffe_rtpose_tpu_torch.utils.db import open_db

    tag = "[tools convert_imageset]"
    raw, enc = os.path.join(work, "tool_db"), os.path.join(work, "tool_db_png")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        check(aux(["convert_imageset", lst, root, raw]) == 0, f"{tag} raw: non-zero exit")
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", ENCODED_NO_CV2, lst, root, raw, enc],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=600)
    enc_s = time.perf_counter() - t0
    m = re.search(r"^ENCODED (\d+) (\w+)$", p.stdout, re.M)
    check(p.returncode == 0 and m and int(m.group(1)) == TOOL_IMAGES and m.group(2) == "True",
          f"{tag} --encoded with cv2 blocked: exit {p.returncode}\n{p.stdout[-2000:]}\n"
          f"{p.stderr[-3000:]}")
    n = 0
    with open_db(raw, "r") as db:
        cur = db.new_cursor()
        cur.seek_to_first()
        while cur.valid():
            check(np.array_equal(datum_chw(datum.parse_datum(cur.value())), pixels[n]),
                  f"{tag} record {n} differs from its image")
            n += 1
            cur.next()
    check(n == TOOL_IMAGES, f"{tag} {n} raw records")
    size = {k: sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(v) for f in fs)
            if os.path.isdir(v) else os.path.getsize(v) for k, v in (("raw", raw), ("png", enc))}
    print(f"{tag} {TOOL_IMAGES} {TOOL_SIZE}x{TOOL_SIZE} PNGs: raw kvdb in {raw_s:.1f} s "
          f"({size['raw'] / 1e6:.1f} MB), --encoded in {enc_s:.1f} s ({size['png'] / 1e6:.1f} MB; "
          f"a new process with cv2 blocked built it, decoded both DBs and found equal pixels, "
          f"keys and labels); raw records equal to the images")
    return raw, enc, dict(raw_s=raw_s, encoded_s=enc_s, raw_mb=size["raw"] / 1e6,
                          encoded_mb=size["png"] / 1e6, records=n)


def tools_features(work, raw, mean_path, snapshot, device="cuda"):
    """extract_features of fc7 and prob over TOOL_ITERS batches of 256 of
    the train_val TEST net (the raw DB, the computed mean, the framework
    phase's snapshot, a Softmax ``prob`` on fc8): on the card bit for bit
    against the facade's forward, and on the CPU within TOL_TOOLS_CPU."""
    import contextlib
    import io
    import os

    import torch

    from caffe_rtpose_tpu_torch import api
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_train_val
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.tools.aux_tools import main as aux

    tag = "[tools extract_features]"
    tv = make_caffenet_train_val(raw, raw, mean_path, batch=FW_BATCH, test_batch=FW_BATCH,
                                 crop=FW_CROP)
    tv["layer"].append({"name": "prob", "type": "Softmax", "bottom": ["fc8"], "top": ["prob"],
                        "include": [{"phase": 1}]})
    path = os.path.join(work, "tool_train_val.prototxt")
    prototxt.dump_file(tv, path)
    outs, secs = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            check(aux(["extract_features", "--model", path, "--weights", snapshot, "--blobs",
                       "fc7,prob", "--data", "net", "--out", os.path.join(work, f"f_{dev}.npz"),
                       "--iterations", str(TOOL_ITERS), "--device", dev]) == 0,
                  f"{tag} {dev}: non-zero exit")
        if dev != "cpu":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        outs[dev] = dict(np.load(os.path.join(work, f"f_{dev}.npz")))
    api.set_mode_cpu() if device == "cpu" else api.set_mode_gpu()
    facade = api.Net(path, snapshot, api.TEST, fetch_all_blobs=False)
    ref = {k: [] for k in ("fc7", "prob")}
    for _ in range(TOOL_ITERS):
        out = facade.forward(blobs=["fc7", "prob"])
        for k in ref:
            ref[k].append(out[k])
    ref = {k: np.concatenate(v) for k, v in ref.items()}
    card, cpu = outs[device], outs["cpu"]
    gaps = {k: float((np.abs(cpu[k] - card[k]) / np.maximum(1.0, np.abs(card[k]))).max())
            for k in ref}
    print(f"{tag} fc7 {card['fc7'].shape} and prob {card['prob'].shape} over {TOOL_ITERS} x "
          f"{FW_BATCH}: card {secs[device]:.1f} s, CPU {secs['cpu']:.1f} s (with the build); "
          f"card bit-identical to api.Net's forward: "
          f"{all(np.array_equal(card[k], ref[k]) for k in ref)}; CPU against the card "
          f"{gaps} (limit {TOL_TOOLS_CPU} x max(1, |y|)); prob rows sum to "
          f"{float(card['prob'].sum(1).min()):.6f}-{float(card['prob'].sum(1).max()):.6f}")
    for k in ref:
        check(card[k].shape == ref[k].shape == ((TOOL_ITERS * FW_BATCH, 4096) if k == "fc7"
                                                 else (TOOL_ITERS * FW_BATCH, 1000)),
              f"{tag} {k}: shape {card[k].shape}")
        check(np.array_equal(card[k], ref[k]), f"{tag} {k}: the card differs from api.Net: "
                                               f"{float(np.abs(card[k] - ref[k]).max())}")
        check(gaps[k] <= TOL_TOOLS_CPU, f"{tag} {k}: the CPU differs by {gaps[k]}")
        check(np.isfinite(card[k]).all(), f"{tag} {k}: non-finite")
    return path, dict(card_s=secs[device], cpu_s=secs["cpu"], cpu_gap=gaps,
                      shapes={k: list(v.shape) for k, v in card.items()})


def tools_detect(work, root, mean_path, snapshot, device="cuda"):
    """detect with CaffeNet deploy (batch 10) over a TOOL_WINDOWS-window CSV
    on the first 8 images: its CSV rows against api.Detector on the same
    windows (the same %g text)."""
    import contextlib
    import csv
    import io
    import os

    from caffe_rtpose_tpu_torch import api
    from caffe_rtpose_tpu_torch.core.data_layers import read_mean_binaryproto
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_deploy
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.tools import detect

    tag = "[tools detect]"
    deploy = os.path.join(work, "tool_deploy.prototxt")
    prototxt.dump_file(make_caffenet_deploy(batch=10), deploy)
    mean = read_mean_binaryproto(mean_path).mean((1, 2))
    np.save(os.path.join(work, "tool_mean.npy"), mean)
    rs = np.random.RandomState(12)
    windows = []
    for i in range(TOOL_WINDOWS):
        y0, x0 = rs.randint(0, TOOL_SIZE - 64, 2)
        h, w = rs.randint(48, 160, 2)
        windows.append((os.path.join(root, f"im{i // 8:04d}.png"),
                        [int(y0), int(x0), int(min(TOOL_SIZE, y0 + h)), int(min(TOOL_SIZE, x0 + w))]))
    win = os.path.join(work, "windows.csv")
    with open(win, "w") as f:
        f.write("filename, xmin, ymin, xmax, ymax\n")
        for p, (y0, x0, y1, x1) in windows:
            f.write(f"{p}, {x0}, {y0}, {x1}, {y1}\n")
    out = os.path.join(work, "detections.csv")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = detect.main([win, out, "--model_def", deploy, "--pretrained_model", snapshot,
                          "--crop_mode", "list", "--mean_file",
                          os.path.join(work, "tool_mean.npy"), "--device", device])
    secs = time.perf_counter() - t0
    check(rc == 0, f"{tag} exit {rc}")
    with open(out) as f:
        rows = list(csv.reader(f))[1:]
    api.set_mode_cpu() if device == "cpu" else api.set_mode_gpu()
    grouped = {}
    for p, wnd in windows:
        grouped.setdefault(p, []).append(wnd)
    det = api.Detector(deploy, snapshot, mean=mean, raw_scale=255.0, channel_swap=(2, 1, 0),
                       context_pad=16)
    ref = det.detect_windows(list(grouped.items()))
    same = [r[0] == d["filename"] and [float(v) for v in r[1:5]] == [float(v) for v in d["window"]]
            and r[5] == " ".join("%g" % v for v in np.ravel(d["prediction"]))
            for r, d in zip(rows, ref)]
    print(f"{tag} CaffeNet deploy over {len(rows)} windows of 8 images in {secs:.1f} s (with the "
          f"build); rows equal to api.Detector's: {sum(same)}/{len(ref)}")
    check(len(rows) == len(ref) == TOOL_WINDOWS and all(same),
          f"{tag} {sum(same)} of {len(ref)} rows equal api.Detector's")
    return dict(windows=len(rows), seconds=secs, rows_equal=sum(same))


def tools_summaries(work, tv_path, device="cuda"):
    """summarize --shapes and draw_net on the CaffeNet train_val and the COCO
    deploy prototxt."""
    import contextlib
    import io
    import os

    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.tools import draw_net, summarize

    tag = "[tools summarize/draw_net]"
    coco = os.path.join(work, "tool_coco_deploy.prototxt")
    prototxt.dump_file(make_pose_deploy_net("COCO"), coco)
    res = {}
    for name, path, phase, probe in (("caffenet train_val", tv_path, "TEST",
                                      f"fc7 {FW_BATCH}x4096"),
                                     ("coco deploy", coco, "TEST", "concat_stage7 1x57x46x82")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = summarize.main(["-s", "--no-color", "-p", phase, "--device", device, path])
            dot = os.path.join(work, os.path.basename(path) + ".dot")
            rc2 = draw_net.main([path, dot, "--phase", phase])
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        n_layers = len([l for l in prototxt.parse_file(path)["layer"]])
        with open(dot) as f:
            dot_text = f.read()
        table = [l for l in text.splitlines() if l and not l.startswith(("Layer", "-"))]
        check(rc == rc2 == 0 and probe in text, f"{tag} {name}: exit {rc}/{rc2}; no {probe!r}:\n"
                                                f"{text[-1500:]}")
        check(dot_text.startswith("digraph") and dot_text.count("shape=record") >= 1,
              f"{tag} {name}: .dot {dot_text[:200]}")
        res[name] = dict(table_rows=len(table) - 1, prototxt_layers=n_layers,
                         dot_bytes=len(dot_text), seconds=secs)
        print(f"{tag} {name}: {len(table) - 1} table rows ({n_layers} layers in the file), "
              f"'{probe}' among the shapes, .dot {len(dot_text)} bytes, {secs:.1f} s")
    return res


def tools_logs(work, log):
    """parse_log and extract_series on the log caffe train printed in the
    framework phase."""
    import os

    from caffe_rtpose_tpu_torch.tools import parse_log, plot_training_log

    tag = "[tools parse_log]"
    path = os.path.join(work, "caffenet_train.log")
    with open(path, "w") as f:
        f.write(log)
    check(parse_log.main([path, work]) == 0, f"{tag} non-zero exit")
    train, test = parse_log.parse_log(path)
    series = {c: len(plot_training_log.extract_series(path, c)[0])
              for c in plot_training_log.CHARTS}
    with open(os.path.join(work, "caffenet_train.log.test")) as f:
        header = f.readline().strip()
    print(f"{tag} {len(train)} train rows, {len(test)} test rows ({header}); extract_series "
          f"points by chart {series}")
    check(len(test) == FW_ITERS // FW_TEST_INTERVAL + 1 and len(train) >= 2,
          f"{tag} {len(train)} train, {len(test)} test rows")
    check(all(n > 0 for n in series.values()), f"{tag} empty series {series}")
    return dict(train_rows=len(train), test_rows=len(test), test_header=header, series=series)


SHIM_NET = """name: "lsq"
layer { name: "d" type: "DummyData" top: "x" top: "y"
  dummy_data_param { shape { dim: 64 dim: 32 } shape { dim: 64 dim: 1 }
    data_filler { type: "gaussian" std: 1.0 } data_filler { type: "constant" value: 0.5 } } }
layer { name: "fc" type: "InnerProduct" bottom: "x" top: "p"
  inner_product_param { num_output: 1 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "EuclideanLoss" bottom: "p" bottom: "y" top: "loss" }
"""


def tools_shims(work, tv_path, snapshot, device="cuda"):
    """Each shim once, on the card: train_net and finetune_net on a small
    least-squares net, test_net on the train_val with the framework phase's
    snapshot (1 iteration), net_speed_benchmark on the small net."""
    import contextlib
    import io
    import os

    from caffe_rtpose_tpu_torch.tools import shims

    tag = "[tools shims]"
    net = os.path.join(work, "shim_net.prototxt")
    sol = os.path.join(work, "shim_solver.prototxt")
    with open(net, "w") as f:
        f.write(SHIM_NET)
    with open(sol, "w") as f:
        f.write(f'net: "{net}"\nbase_lr: 0.01\nlr_policy: "fixed"\nmomentum: 0.9\nmax_iter: 4\n'
                f'display: 2\nsnapshot_prefix: "{work}/shim"\n')
    weights = f"{work}/shim_iter_4.caffemodel"
    res = {}
    for argv in (["train_net", sol], ["finetune_net", sol, weights],
                 ["test_net", tv_path, snapshot, "1"], ["net_speed_benchmark", net, "2"]):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = shims.main([argv[0], *argv[1:], "--device", device])
        res[argv[0]] = dict(rc=rc, seconds=time.perf_counter() - t0)
        check(rc == 0 and f"{argv[0]} is deprecated" in err.getvalue(),
              f"{tag} {argv[0]}: exit {rc}\n{out.getvalue()[-1500:]}\n{err.getvalue()[-1500:]}")
        check(argv[0] != "train_net" or os.path.exists(weights), f"{tag} no {weights}")
    print(f"{tag} " + ", ".join(f"{k} exit 0 in {v['seconds']:.1f} s" for k, v in res.items()))
    return res


def phase_tools(work, snapshot, log, device="cuda"):
    """The chain a Caffe user runs on ImageNet-style data, at CaffeNet's full
    width, with the hand kernels' counters zeroed before and read after:
    convert_imageset (raw and --encoded, the latter with cv2 blocked),
    compute_image_mean, extract_features, detect, summarize and draw_net,
    parse_log and extract_series, and each shim."""
    import contextlib
    import io
    import os

    from caffe_rtpose_tpu_torch.core.data_layers import read_mean_binaryproto
    from caffe_rtpose_tpu_torch.tools.aux_tools import main as aux

    zero_counts()
    t0 = time.perf_counter()
    t = time.perf_counter()
    root, lst, pixels = write_tool_images(work, np.random.RandomState(30))
    write_s = time.perf_counter() - t
    raw, enc, dbs = tools_dbs(work, root, lst, pixels)
    means = {}
    for name, db in (("raw", raw), ("png", enc)):
        out = os.path.join(work, f"mean_{name}.binaryproto")
        with contextlib.redirect_stdout(io.StringIO()):
            check(aux(["compute_image_mean", db, "--out", out]) == 0,
                  f"[tools compute_image_mean] {name}: non-zero exit")
        means[name] = read_mean_binaryproto(out)
    direct = (pixels.astype(np.float64).sum(0) / TOOL_IMAGES).astype(np.float32)
    print(f"[tools compute_image_mean] raw and --encoded DBs: {means['raw'].shape}, equal to the "
          f"images' mean: {np.array_equal(means['raw'], direct)} and "
          f"{np.array_equal(means['png'], direct)}; channel means "
          f"{means['raw'].mean((1, 2)).tolist()}")
    check(np.array_equal(means["raw"], direct) and np.array_equal(means["png"], direct),
          "[tools compute_image_mean] the mean differs from the images'")
    mean_path = os.path.join(work, "mean_raw.binaryproto")
    tv_path, features = tools_features(work, raw, mean_path, snapshot, device)
    detections = tools_detect(work, root, mean_path, snapshot, device)
    summaries = tools_summaries(work, tv_path, device)
    logs = tools_logs(work, log)
    shim_runs = tools_shims(work, tv_path, snapshot, device)
    counts = read_counts()
    check(not any(counts.values()), f"[tools] launched hand kernels: {counts}")
    seconds = time.perf_counter() - t0
    print(f"[tools] {seconds:.1f} s in all; hand kernel launches {counts}")
    return dict(images_write_s=write_s, convert_imageset=dbs, extract_features=features,
                detect=detections, summarize_draw_net=summaries, parse_log=logs,
                shims=shim_runs, hand_kernel_launches=counts, seconds=seconds)


# --------------------------------------------------------------- matcaffe

MATCAFFE_BATCH = 10  # the reference's 10-crop classification demo


def phase_matcaffe(work, snapshot, device="cuda"):
    """matcaffe through the port's MATLAB engine after caffe.set_mode_gpu():
    the +test classes test_net, test_solver, test_io on the card; caffe.Net
    (Net.m) on CaffeNet's deploy prototxt with the snapshot at batch 10, crop
    227, its forward bit for bit against the facade's; then run_tests.m
    once, which sets the CPU mode first.  The counters zeroed before and
    read after."""
    import os

    from caffe_rtpose_tpu_torch import api
    from caffe_rtpose_tpu_torch.matlab_engine import MatCell, MatlabEngine, to_python
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_deploy
    from caffe_rtpose_tpu_torch.proto import prototxt

    tag = "[matcaffe]"
    zero_counts()
    t0 = time.perf_counter()
    eng = MatlabEngine(os.path.join(os.path.dirname(os.path.abspath(__file__)), "matlab"))
    eng.call("caffe.set_mode_gpu")
    check(api.device().type == device, f"{tag} set_mode_gpu left {api.device()}")
    tests = {}
    for name in ("test_net", "test_solver", "test_io"):
        t = time.perf_counter()
        tests[name] = dict(summary=eng._run_testcase(eng.resolve(f"caffe.test.{name}")),
                           seconds=time.perf_counter() - t)
    check(api.device().type == device, f"{tag} the test classes left {api.device()}")
    deploy = os.path.join(work, "matcaffe_deploy.prototxt")
    prototxt.dump_file(make_caffenet_deploy(batch=MATCAFFE_BATCH), deploy)
    x = (np.random.RandomState(40).rand(MATCAFFE_BATCH, 3, FW_CROP, FW_CROP) * 255 - 128
         ).astype(np.float32)
    t = time.perf_counter()
    net = eng.call("caffe.Net", deploy, snapshot, "test")
    res = eng.call_method(net, "forward", MatCell([eng.call("caffe.private.py2mat", x)]))
    got = to_python(res.items[0])
    net_s = time.perf_counter() - t
    ref = api.Net(deploy, snapshot, api.TEST).forward(data=x)["prob"]
    equal = np.array_equal(got, ref.T)
    print(f"{tag} on the card ({api.device()}): " + "; ".join(
        f"{v['summary']} in {v['seconds']:.1f} s" for v in tests.values())
        + f"; caffe.Net(CaffeNet deploy, snapshot, 'test') forward at {x.shape}: prob "
          f"{got.shape} (W x H x C x N order), bit-identical to api.Net's: {equal} "
          f"({net_s:.1f} s with the build)")
    for name, v in tests.items():
        n = re.match(rf"{name}: (\d+)/(\d+) passed", v["summary"])
        check(n and n.group(1) == n.group(2), f"{tag} {v['summary']}")
    check(got.shape == (1000, MATCAFFE_BATCH) and equal,
          f"{tag} caffe.Net's forward differs from api.Net's: {got.shape}")
    t = time.perf_counter()
    summary = eng.call("caffe.run_tests")
    run_s = time.perf_counter() - t
    mode = api._mode
    print(f"{tag} run_tests.m: {summary!r} in {run_s:.1f} s, on the {mode.upper()} (it calls "
          f"caffe.set_mode_cpu first)")
    check(mode == "cpu" and all(f"{n}: " in summary for n in tests),
          f"{tag} run_tests.m: {summary!r}, mode {mode}")
    api.set_mode_gpu()
    counts = read_counts()
    check(not any(counts.values()), f"{tag} launched hand kernels: {counts}")
    return dict(tests=tests, net_forward_equal=equal, net_shape=list(got.shape), net_s=net_s,
                run_tests=summary, run_tests_mode=mode, run_tests_s=run_s,
                hand_kernel_launches=counts, seconds=time.perf_counter() - t0)


# ------------------------------------------------------------------- C2

TOL_C2 = 2e-3  # relative L2 of each diff against the f64 run (ROADMAP C2)
C2_RES, C2_STAGES = (656, 368), 6


def backward_f64_gaps(core, inputs, diffs):
    """``Net.backward`` in f32 and again with the net in f64 (its parameters
    themselves converted): the relative L2 gap of every input and parameter
    diff, and the f32 call's ms (a second call, warm).  The f64 run takes
    the f32 forward's ReLU decisions: a pre-activation within f32 rounding
    of 0 otherwise takes the other branch in f64, and through the deploy
    net's six stages that alone moves whole gradient blobs by 3e-3 to 9e-3
    relative L2, on the host CPU as on the card (COCO 6 stages at 328x184,
    fan-in or the prototxt's weights), which is no engine's error.  With
    the decisions pinned the host CPU's f32 stays within 8e-4."""
    import torch

    masks = {}

    def sync():
        if core.device.type == "cuda":
            torch.cuda.synchronize(core.device)

    core.backward(inputs, diffs)  # warm: the engines' first call
    record_relus(core, masks)
    sync()
    t0 = time.perf_counter()
    try:
        got = core.backward(inputs, diffs)
    finally:
        release_relus(core)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    core.double()
    core.dtype = torch.float64
    for conv in core.convs.values():
        conv.compute_weights(torch.float32)  # the (now f64) parameters themselves
    pin_relus(core, masks)
    try:
        ref = core.backward(inputs, diffs)
    finally:
        release_relus(core)
        core.float()
        core.dtype = torch.float32
        core.params_changed()

    def gap(a, b):
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b) / max(torch.linalg.vector_norm(b), 1e-30))

    gaps = {f"in:{k}": gap(got[0][k], ref[0][k]) for k in got[0]}
    gaps.update({f"{k}[{i}]": gap(a, b) for k in got[1]
                 for i, (a, b) in enumerate(zip(got[1][k], ref[1][k]))})
    return gaps, ms


def gap_summary(gaps):
    worst = max(gaps, key=gaps.get)
    return dict(max=gaps[worst], worst=worst, median=statistics.median(gaps.values()),
                image=gaps["in:image"], blobs=len(gaps))


def phase_c2(device="cuda"):
    """pycaffe's ``Net.backward`` of the COCO deploy net at 656x368 (TEST
    phase, fan-in weights, one canvas, randn top diffs) against an f64 run
    of the same call (:func:`backward_f64_gaps`), every input and parameter
    diff within 2e-3 relative L2; the same under the switch's pre-C2 rule
    (keyed on the phase: cuDNN's f32 backward), for the record; and a
    no-grad forward under both rules bit for bit equal."""
    import torch

    from caffe_rtpose_tpu_torch import api
    from caffe_rtpose_tpu_torch.core import layers as L
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net

    t0 = time.perf_counter()
    api.set_mode_gpu()
    w, h = C2_RES
    net = api.Net(make_pose_deploy_net("COCO", stages=C2_STAGES, input_dim=(1, 3, h, w)),
                  phase=api.TEST)
    core = net._net
    core.load_weights(fan_in_weights(core, 5))
    rs = np.random.RandomState(5)
    x = rs.rand(1, 3, h, w).astype(np.float32) - 0.5
    top = core.output_names()[0]
    diffs = {top: rs.randn(*core.blob_shapes[top]).astype(np.float32)}
    net.forward(image=x)
    got = net.backward(**diffs)  # the facade's call
    check(got["image"].shape == x.shape and np.isfinite(got["image"]).all(),
          "[c2] api.Net.backward gave no finite image diff")
    feed = {"image": torch.from_numpy(x)}
    after, ms_after = backward_f64_gaps(core, feed, diffs)
    real = L.f32_training
    L.f32_training = lambda ctx, x, *ops: ctx.training and x.dtype == torch.float32
    try:
        before, ms_before = backward_f64_gaps(core, feed, diffs)
        with torch.no_grad():
            old = core.forward({"image": feed["image"].to(core.device)}, outputs=[top])[top]
    finally:
        L.f32_training = real
    with torch.no_grad():
        new = core.forward({"image": feed["image"].to(core.device)}, outputs=[top])[top]
    out = dict(after=gap_summary(after), before=gap_summary(before), backward_ms=ms_after,
               backward_ms_cudnn=ms_before, no_grad_forward_bit_equal=bool(torch.equal(old, new)),
               seconds=time.perf_counter() - t0)
    print(f"[c2] api.Net.backward COCO 656x368 vs f64: worst {out['after']['worst']} "
          f"{out['after']['max']:.3g} (pre-C2 rule: {out['before']['worst']} "
          f"{out['before']['max']:.3g}); {ms_after:.1f} ms ({ms_before:.1f} ms with cuDNN)")
    check(out["after"]["max"] <= TOL_C2, f"[c2] a diff is {out['after']['max']:.3g} from f64 "
          f"({out['after']['worst']})")
    check(out["no_grad_forward_bit_equal"], "[c2] the no-grad forward moved")
    return out


# --------------------------------------------------------------- parallel

PAR_TIMEOUT = 900  # a process group's limit: a hung rank fails the phase
PAR_DEVICE = "cuda:0"  # one card: every rank shares it over gloo
TRAIN_BATCH_FULL, TRAIN_CROP_FULL = 10, 368
PAR_RES, PAR_STAGES = (656, 368), 6
PP_HW, PP_MICRO = (46, 82), 6  # the refinement stages at 1/8 of 656x368
CLI_EXTRA = ()  # more caffe train flags (a rehearsal on the host: --device cpu)
CAFFENET_BATCH, CAFFENET_CROP = 256, 227  # CaffeNet's TRAIN cell (framework phase)
TP_BATCH = 10  # classify's 10-crop oversampling


def _cli_train(work, name, gpu, timeout=600, net="par_train.prototxt", extra=()):
    """``caffe train --gpu <gpu>`` in a new process: one iteration of
    ``net`` in ``work`` (default the 6-stage COCO train net at batch 10,
    crop 368, synthetic data; ``extra``: more flags), then its snapshot's
    parameter sums in f64 and the printed loss."""
    import subprocess

    from caffe_rtpose_tpu_torch.core.net import Net

    net = f"{work}/{net}"
    solver = f"{work}/{name}.prototxt"
    with open(solver, "w") as f:
        f.write(f'net: "{net}"\n{TRAIN_SOLVER}\nmax_iter: 1\ndisplay: 1\n'
                f'snapshot_prefix: "{work}/{name}"\n')
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "caffe_rtpose_tpu_torch", "caffe", "train",
                          "--solver", solver, "--gpu", gpu, *extra, *CLI_EXTRA],
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"[parallel] caffe train --gpu {gpu} failed:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    loss = float(re.search(r"Iteration 1 .*loss = ([-\d.e+]+)", res.stdout).group(1))
    snap = Net(net, phase="TRAIN", device="cpu")
    snap.load_weights(f"{work}/{name}_iter_1.caffemodel")
    sums = {k: [float(b.detach().double().sum()) for b in v]
            for k, v in snap.layer_blobs().items()}
    return dict(loss=loss, param_sums=sums, seconds=seconds, lines=[
        l for l in res.stdout.splitlines() if "training over" in l or "backend" in l])


def phase_parallel(weights, frames, work):
    """The parallel modes (module docstring) over ranks that share the card
    over gloo: one process group a world size, each running all of that
    size's checks; then caffe train --gpu 0,0 and the multihost dry run in
    new processes.  K1's launches on each sharded estimator path, by rank."""
    import gc

    import torch

    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet, make_caffenet_deploy
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
    from caffe_rtpose_tpu_torch.parallel import dp, dryrun, multihost
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
    from caffe_rtpose_tpu_torch.training.labels_device import pose_batches_jointfeed
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    est = dict(stages=PAR_STAGES, net_w=PAR_RES[0], net_h=PAR_RES[1], weights=weights,
               pair_cap=32)
    single = [f for f in frames[:4]]
    pairs = [np.stack(frames[i : i + 2]) for i in (0, 2)]  # 2-frame batches
    # the heatmap estimator's input: the same frames as f32 canvases
    heat_frames = [(f[0].astype(np.float32) / 256.0 - 0.5).transpose(2, 0, 1)[None].copy()
                   for f in single]
    caffenet = make_caffenet(batch=CAFFENET_BATCH, crop=CAFFENET_CROP)
    prm = AugParams(crop_size_x=TRAIN_CROP_FULL, crop_size_y=TRAIN_CROP_FULL)
    fused = next(pose_batches_jointfeed(SyntheticPoseSource(size=TRAIN_CROP_FULL + 52), prm,
                                        TRAIN_BATCH_FULL, data_u8=True))
    groups = {
        2: [("case_gloo_probe", {}),
            ("dryrun_cpm_train", dict(n_devices=2, crop=TRAIN_CROP_FULL,
                                      batch=TRAIN_BATCH_FULL, stages=PAR_STAGES)),
            ("case_estimator#spatial", dict(kind="spatial", n_devices=2, frames=single, **est)),
            ("case_estimator#tp", dict(kind="tp", n_devices=2, frames=single, **est)),
            ("case_estimator#spatial_heat", dict(kind="spatial", n_devices=2, frames=heat_frames,
                                                 keep_heatmap=True, **est)),
            ("case_estimator#tp_heat", dict(kind="tp", n_devices=2, frames=heat_frames,
                                            keep_heatmap=True, **est)),
            ("case_spatial_train", dict(n_devices=2, proto=caffenet)),
            ("case_tp_forward", dict(n_devices=2, proto=make_caffenet_deploy(
                batch=TP_BATCH, crop=CAFFENET_CROP),
                                     weights=None, inputs=None, outputs=["prob"]))],
        4: [("case_estimator#dp_tp", dict(kind="dp_tp", n_devices=4, frames=pairs, batch=2,
                                          **est)),
            ("dryrun_dp_sp_train", dict(n_devices=4, crop=TRAIN_CROP_FULL,
                                        batch=TRAIN_BATCH_FULL, spatial=2,
                                        stages=PAR_STAGES)),
            ("dryrun_dp_sp_train#fused", dict(
                n_devices=4, crop=TRAIN_CROP_FULL, batch=TRAIN_BATCH_FULL, spatial=2,
                stages=PAR_STAGES, batch_arrays=fused,
                transform=("make_input_transform", {"prm": prm, "data_u8": True})))],
        5: [("dryrun_pp", dict(n_devices=5, hw=PP_HW, micro=PP_MICRO)),
            ("dryrun_pp_train", dict(n_devices=5, hw=PP_HW, micro=PP_MICRO, width=128,
                                     n_paf=38, n_heat=19, feat_ch=128, fan_in=True))],
    }
    out = {"backend": dp.pick_backend([PAR_DEVICE] * 2), "groups": {}}
    by_rank = {}
    for n, cases in groups.items():
        g0 = time.perf_counter()
        res = dp.spawn(dryrun.rank_cases, n, [PAR_DEVICE] * n, args=(cases,),
                       timeout=PAR_TIMEOUT)
        out["groups"][n] = dict(seconds=time.perf_counter() - g0,
                                peak_gib_by_rank=[r["peak_gib"] for r in res])
        for name, _ in cases:
            by_rank[name] = [{k: v for k, v in r[name].items()
                              if k not in ("params", "ref_params", "packed", "new", "inputs",
                                           "outputs", "digest", "ref_digest", "out", "heat")}
                             for r in res]
        print(f"[parallel] {n} ranks: {', '.join(n for n, _ in cases)} in "
              f"{out['groups'][n]['seconds']:.1f} s", flush=True)
    k1 = {}
    for path, name in (("sp estimator", "case_estimator#spatial"),
                       ("tp estimator", "case_estimator#tp"),
                       ("dp x tp estimator", "case_estimator#dp_tp")):
        ranks = by_rank[name]
        k1[path] = [r["k1_launches"] for r in ranks]
        # one a pass on each rank (the host runs the plain version: none)
        passes = (len(pairs) if "dp" in name else len(single)) * PAR_DEVICE.startswith("cuda")
        check(all(c == passes for c in k1[path]),
              f"[parallel] {path}: K1 launches {k1[path]}, expected {passes} a rank")
        out[path] = dict(ms_per_frame=[r["ms_per_frame"] for r in ranks],
                         single_ms_per_frame=ranks[0]["single_ms_per_frame"],
                         seconds=ranks[0]["seconds"],
                         **({"weight_share": ranks[0]["weight_share"]}
                            if "weight_share" in ranks[0] else {}))
    k3 = {}
    for path, name in (("sp heatmap estimator", "case_estimator#spatial_heat"),
                       ("tp heatmap estimator", "case_estimator#tp_heat")):
        ranks = by_rank[name]
        k3[path] = [r["k3_launches"] for r in ranks]
        passes = len(heat_frames) * PAR_DEVICE.startswith("cuda")  # one a frame on each rank
        check(all(c == passes for c in k3[path]) and all(r["k1_launches"] == 0 for r in ranks),
              f"[parallel] {path}: K3 launches {k3[path]} (expected {passes} a rank), K1 "
              f"{[r['k1_launches'] for r in ranks]} (expected 0)")
        out[path] = dict(ms_per_frame=[r["ms_per_frame"] for r in ranks],
                         single_ms_per_frame=ranks[0]["single_ms_per_frame"],
                         seconds=ranks[0]["seconds"])
    sp_train = by_rank["case_spatial_train"]
    check(all(r["tail_identical"] for r in sp_train) and sp_train[0]["tail_layers"] == [
        "fc6", "fc7", "fc8"], f"[parallel] CaffeNet spatial: tail {sp_train[0]['tail_layers']}")
    out["caffenet spatial train step"] = {k: sp_train[0][k] for k in (
        "loss", "ref_loss", "step_ms", "ref_step_ms", "tail_layers", "seconds")}
    out["caffenet spatial train step"]["peak_gib_by_rank"] = [r["peak_gib"] for r in sp_train]
    tp_fwd = by_rank["case_tp_forward"]
    out["caffenet tp forward"] = {k: tp_fwd[0][k] for k in (
        "ms", "single_ms", "max_abs_err", "share", "seconds")}
    out["dp x sp fused step"] = {k: by_rank["dryrun_dp_sp_train#fused"][0][k]
                                 for k in ("loss", "ref_loss", "step_ms", "ref_step_ms",
                                           "seconds")}
    dp_step = by_rank["dryrun_cpm_train"][0]
    out["dp step"] = {k: dp_step[k] for k in ("loss", "ref_loss", "step_ms", "ref_step_ms",
                                               "allreduce_ms", "seconds")}
    out["dp x sp step"] = {k: by_rank["dryrun_dp_sp_train"][0][k]
                           for k in ("loss", "ref_loss", "step_ms", "ref_step_ms", "seconds")}
    out["pipeline_refine"] = {k: by_rank["dryrun_pp"][0][k] for k in ("ms", "seconds")}
    out["pp train step"] = {k: by_rank["dryrun_pp_train"][0][k]
                            for k in ("loss", "ref_loss", "step_ms", "seconds")}
    # caffe train --gpu 0,0 against --gpu 0 (one rank), each a new process
    prototxt.dump_file(make_pose_train_net(batch=TRAIN_BATCH_FULL, crop=TRAIN_CROP_FULL,
                                           stages=PAR_STAGES), f"{work}/par_train.prototxt")
    two = _cli_train(work, "gpu00", "0,0")
    one = _cli_train(work, "gpu0", "0")
    multihost.check_digests(two, one)
    out["caffe train --gpu 0,0"] = dict(loss=two["loss"], one_rank_loss=one["loss"],
                                        seconds=two["seconds"], one_rank_seconds=one["seconds"],
                                        lines=two["lines"])
    # caffe train --gpu 0,0 --spatial 2 on CaffeNet against --gpu 0
    prototxt.dump_file(caffenet, f"{work}/caffenet_train.prototxt")
    np.savez(f"{work}/caffenet_batch.npz", **dryrun.synthetic_batch(caffenet))
    cn = dict(net="caffenet_train.prototxt", extra=("--data", f"{work}/caffenet_batch.npz"))
    two = _cli_train(work, "cn_gpu00", "0,0", extra=cn["extra"] + ("--spatial", "2"),
                     net=cn["net"])
    one = _cli_train(work, "cn_gpu0", "0", **cn)
    multihost.check_digests(two, one)
    out["caffe train --gpu 0,0 --spatial 2 (CaffeNet)"] = dict(
        loss=two["loss"], one_rank_loss=one["loss"], seconds=two["seconds"],
        one_rank_seconds=one["seconds"], lines=two["lines"])
    m0 = time.perf_counter()
    mh = multihost.dryrun_multihost(2, device=PAR_DEVICE, timeout=600,
                                    **({} if PAR_DEVICE.startswith("cuda") else
                                       dict(crop=32, batch=4)))
    out["multihost"] = dict(loss=mh["multi"]["loss"], single_loss=mh["single"]["loss"],
                            backend=mh["multi"]["backend"], seconds=time.perf_counter() - m0)
    out["gloo_on_cuda_tensors"] = by_rank["case_gloo_probe"][0]
    out["k1_launches_by_path"] = k1
    out["k3_launches_by_path"] = k3
    out["seconds"] = time.perf_counter() - t0
    print(f"[parallel] {out['seconds']:.1f} s in all; K1 launches by rank {k1}; K3 {k3}",
          flush=True)
    return out


def main() -> int:
    import torch

    info = phase_device()
    check(info["nvidia_smi"], "nvidia-smi gave no name and power limit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    jpeg = phase_jpeg(info["nvidia_smi"])
    imgproc = phase_imgproc(info["nvidia_smi"])
    text = phase_text(info["nvidia_smi"])
    vid = phase_video(info["nvidia_smi"])
    formats = phase_formats(info["nvidia_smi"])
    t_mask = phase_kernels()
    t_up = phase_upsample_keys()
    t_conv1 = phase_conv1()
    weights, frames = calibrated_weights(1, 8)
    graph, graph_ests = phase_graph(weights, frames)
    prep = phase_preprocess(np.random.RandomState(4))
    pipeline = phase_pipeline(weights)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as work:
        files = phase_files(weights, work)
        hdf5 = phase_hdf5(files, work, info["nvidia_smi"])
        # the calibration canvases at their own size: the calibrated weights
        # find people there, so the JSON the serving and eval phases compare
        # holds joints
        cli = phase_cli(files, [f[0] for f in frames])
        # the same canvases as q95 JPEGs: the eval over them compares joints
        cli_jpeg = phase_cli(files, [f[0] for f in frames], jpeg=True)
        check(cli_jpeg["launches"] == cli["launches"],
              f"[cli jpeg] hand-kernel launches {cli_jpeg['launches']} against the PNG "
              f"run's {cli['launches']}")
        # the same canvases upscaled to 1280x720 by resize_area (INTER_AREA's
        # linear branch): the CLI then downscales them to the net and warps
        # its display at a size other than the net's
        from caffe_rtpose_tpu_torch.pose.preprocess import resize_area

        frames_720 = [resize_area(f[0], 1280, 720) for f in frames]
        cli_720p = phase_cli(files, frames_720)
        # the same frames as q95 JPEGs, with --write_frames --no_text: the
        # same program, so the same hand-kernel launches
        cli_720p_jpeg = phase_cli(files, frames_720, jpeg=True)
        check(cli_720p_jpeg["launches"] == cli_720p["launches"],
              f"[cli jpeg] hand-kernel launches {cli_720p_jpeg['launches']} against the PNG "
              f"run's {cli_720p['launches']}")
        # and once more with the text overlay drawn on every written frame
        cli_720p_text = phase_cli(files, frames_720, jpeg=True, with_text=True)
        check(cli_720p_text["launches"] == cli_720p["launches"],
              f"[cli jpeg text] hand-kernel launches {cli_720p_text['launches']} against the PNG "
              f"run's {cli_720p['launches']}")
        # those frames in a Motion-JPEG AVI and as a printf sequence through
        # rtpose --video
        cli_video = phase_cli_video(files, frames_720)
        for key in ("launches", "sequence_launches"):
            check(cli_video[key] == cli_720p["launches"],
                  f"[cli video] hand-kernel {key} {cli_video[key]} against the PNG "
                  f"run's {cli_720p['launches']}")
        # the committed MPEG-4 clip through rtpose --video
        cli_mp4 = phase_cli_mp4(files)
        check(cli_mp4["launches"] == cli_720p["launches"],
              f"[cli mp4] hand-kernel launches {cli_mp4['launches']} against the PNG "
              f"run's {cli_720p['launches']}")
        # the committed H.264 clips (and the High one remuxed to Matroska)
        # through rtpose --video
        cli_h264 = phase_cli_h264(files, info["nvidia_smi"])
        check(cli_h264["launches"] == cli_720p["launches"],
              f"[cli h264] hand-kernel launches {cli_h264['launches']} against the PNG "
              f"run's {cli_720p['launches']}")
        serving, serving_est, serving_graph = phase_serving(weights, files, cli, work)
        pool = phase_pool(serving_est)
        del serving_est
        evaluation = phase_eval(files, cli, work)
        # over the 656x368 JPEGs, where the run finds people: the 1280x720
        # JPEG run found none (PERF.md), so an eval there compares no joints
        evaluation_jpeg = phase_eval(files, cli_jpeg, work)
    graph_ests.append(serving_graph)
    del serving_graph
    phase_graph_launches(graph_ests)
    del graph_ests
    one = phase_slice(1, 8, weights=weights, frames=frames)
    three = phase_slice(3, 4)
    heat = phase_heatmap(one["weights"], one["frames"][:HEATMAP_FRAMES])
    render = phase_render(heat["canvas"], heat["result"])
    bf16 = phase_bf16(one["weights"])
    bf16_three = phase_bf16_3scale(bf16["weights"])
    bf16_heat = phase_bf16_heatmap(bf16["weights"], bf16["frames"][:HEATMAP_FRAMES])
    profile_pending()
    # training last: in a run that trained before the kernel profiles, K4
    # read 0.604 ms, against 0.459-0.460 in runs that profiled first (H100
    # 80GB HBM3, 700 W)
    train, train_solver = phase_train()
    train["profile"] = phase_train_profile(train_solver,
                                           train["shapes"]["staged"]["step_ms_median"])
    del train_solver
    train_bf16 = phase_train_bf16(train["shapes"]["staged"]["step_ms_median"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_framework_") as work:
        framework, snapshot, log = phase_framework(work)
        tools = phase_tools(work, snapshot, log)
        matcaffe = phase_matcaffe(work, snapshot)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as work:
        parallel = phase_parallel(weights, frames, work)
    keys = ("device_ms", "e2e_ms", "launches", "peaks", "people")
    for name, r in (("1-scale", one), ("3-scale", three)):
        print(json.dumps({"slice": name, **{k: r[k] for k in keys}}))
    print(json.dumps({"slice": "heatmap", "fetch_ms": heat["fetch_ms"],
                      **{k: heat[k] for k in keys}}))
    print(json.dumps({"render_ms": render}))
    print(json.dumps({"slice": "bf16 batch 8",
                      **{k: v for k, v in bf16.items() if k not in ("weights", "frames")}}))
    print(json.dumps({"slice": "bf16 3-scale pack_u8", **bf16_three}))
    print(json.dumps({"slice": "bf16 heatmap", **bf16_heat}))
    print(json.dumps({"graph": graph}))
    print(json.dumps({"preprocess_ms": prep}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"files": files}))
    print(json.dumps({"hdf5": hdf5}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"cli_720p": cli_720p}))
    print(json.dumps({"cli_jpeg": cli_jpeg}))
    print(json.dumps({"cli_720p_jpeg": cli_720p_jpeg}))
    print(json.dumps({"cli_720p_text": cli_720p_text}))
    print(json.dumps({"jpeg": jpeg}))
    print(json.dumps({"imgproc": imgproc}))
    print(json.dumps({"text": text}))
    print(json.dumps({"video": vid}))
    print(json.dumps({"formats": formats}))
    print(json.dumps({"cli_video": cli_video}))
    print(json.dumps({"cli_mp4": cli_mp4}))
    print(json.dumps({"cli_h264": cli_h264}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"pool": pool}))
    print(json.dumps({"eval": evaluation}))
    print(json.dumps({"eval_jpeg": evaluation_jpeg}))
    print(json.dumps({"train": train}))
    print(json.dumps({"framework": framework}))
    print(json.dumps({"train_bf16": train_bf16}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"matcaffe": matcaffe}))
    print(json.dumps({"parallel": parallel}))
    card = info["nvidia_smi"]
    # launches: the wrapper's calls in the main path's run (the pipeline:
    # the eager pass and the capture; the 3-scale, heatmap slices for the
    # kernels that path does not run); replayed launches: the main path's
    # graph replays; device launches a frame: the bf16 batch-8 replays
    per_frame = dict(conv1_block=bf16["device_launches"] / BF16_FRAMES,
                     peak_mask_fused=bf16["peak_mask_device_launches"] / BF16_FRAMES,
                     peak_mask_fused_3scale=0.0, upsample_peak_keys=0.0)
    mask_src, mask_pallas = "caffe_rtpose_tpu_torch/csrc/peak_mask.cu", "caffe_rtpose_tpu/ops/nms_pallas.py"
    # each path's run, with the counters zeroed just before it and read just
    # after: wrapper launches (the eager pass and the capture) and the
    # launches its graphs' replays made
    sm, sc, s3 = serving["main"], serving["cpu_exported"], serving["three_scale"]
    by_path = {
        "peak_mask_fused": {"pipeline": (pipeline["launches"]["peak_mask_fused"],
                                         pipeline["replayed_launches"]["peak_mask_fused"]),
                            "bundle bf16 batch 8": (sm["launches"]["peak_mask_fused"],
                                                    sm["replayed"]["peak_mask_kernel"]),
                            "bundle exported on the cpu": (sc["launches"]["peak_mask_fused"],
                                                           sc["replayed"]["peak_mask_kernel"]),
                            "cli jpeg": (cli_jpeg["launches"]["peak_mask_fused"], None),
                            "cli 1280x720 jpeg": (cli_720p_jpeg["launches"]["peak_mask_fused"],
                                                  None),
                            "cli 1280x720 jpeg text": (
                                cli_720p_text["launches"]["peak_mask_fused"], None),
                            "cli 1280x720 video": (cli_video["launches"]["peak_mask_fused"],
                                                   None),
                            "cli 1280x720 sequence": (
                                cli_video["sequence_launches"]["peak_mask_fused"], None),
                            "cli 1280x720 mp4": (cli_mp4["launches"]["peak_mask_fused"], None),
                            "cli 1280x720 h264": (cli_h264["launches"]["peak_mask_fused"],
                                                  None),
                            "cli 1280x720 mkv": (cli_h264["mkv_launches"]["peak_mask_fused"],
                                                 None),
                            **{f"{path} (by rank)": (v, None) for path, v in
                               parallel["k1_launches_by_path"].items()}},
        "peak_mask_fused_3scale": {"slice 3-scale": (three["launches"], None),
                                   "bundle 3-scale f32": (s3["launches"]["peak_mask_fused"],
                                                          s3["replayed"]["peak_mask_kernel"])},
        "upsample_peak_keys": {"heatmap slice": (heat["launches"], None),
                               **{f"{path} (by rank)": (v, None) for path, v in
                                  parallel["k3_launches_by_path"].items()}},
        "conv1_block": {"pipeline": (pipeline["launches"]["conv1_block"],
                                     pipeline["replayed_launches"]["conv1_block"]),
                        "bundle bf16 batch 8": (sm["launches"]["conv1_block"],
                                                sm["replayed"]["conv1_block_kernel"]),
                        "bundle exported on the cpu": (sc["launches"]["conv1_block"],
                                                       sc["replayed"]["conv1_block_kernel"]),
                        "cli jpeg": (cli_jpeg["launches"]["conv1_block"], None),
                        "cli 1280x720 jpeg": (cli_720p_jpeg["launches"]["conv1_block"], None),
                        "cli 1280x720 jpeg text": (cli_720p_text["launches"]["conv1_block"],
                                                   None),
                        "cli 1280x720 video": (cli_video["launches"]["conv1_block"], None),
                        "cli 1280x720 sequence": (cli_video["sequence_launches"]["conv1_block"],
                                                  None),
                        "cli 1280x720 mp4": (cli_mp4["launches"]["conv1_block"], None),
                        "cli 1280x720 h264": (cli_h264["launches"]["conv1_block"], None),
                        "cli 1280x720 mkv": (cli_h264["mkv_launches"]["conv1_block"], None)},
    }
    entries = [
        ("peak_mask_fused", mask_src, f"{mask_pallas}:136", pipeline["launches"]["peak_mask_fused"],
         t_mask, t_mask[-1], dict(library_note=NO_LIBRARY)),
        ("peak_mask_fused_3scale", mask_src, f"{mask_pallas}:197", three["launches"],
         t_mask, t_mask[1], dict(library_note=NO_LIBRARY)),
        ("upsample_peak_keys", "caffe_rtpose_tpu_torch/csrc/upsample_peak_keys.cu",
         f"{mask_pallas}:82", heat["launches"], t_up, t_up[0], dict(library_note=NO_LIBRARY)),
        ("conv1_block", "caffe_rtpose_tpu_torch/csrc/conv1_block.cu",
         "caffe_rtpose_tpu/ops/conv1_pallas.py:56", pipeline["launches"]["conv1_block"], t_conv1,
         t_conv1[-1], dict(library_note="cuDNN bf16 chain: conv, ReLU, conv, ReLU, max pool")),
    ]
    kernels = []
    for name, source, replaces, launches, rows, main_row, extra in entries:
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, **extra,
            "launches": launches,
            "replayed_launches": pipeline["replayed_launches"].get(name, 0),
            "launches_by_path": {**{k: v[0] for k, v in by_path[name].items()},
                                 **{path: r["hand_kernel_launches"].get(
                                     name.replace("_3scale", ""), 0) for path, r in (
                                     ("imgproc", imgproc), ("text", text), ("video", vid),
                                     ("formats", formats), ("train f32", train),
                                     ("train bf16", train_bf16), ("framework", framework),
                                     ("tools", tools), ("matcaffe", matcaffe))}},
            "replayed_launches_by_path": {k: v[1] for k, v in by_path[name].items()
                                          if v[1] is not None},
            "device_launches_per_frame": {f"bf16 batch {BF16_BATCH}": per_frame[name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
            "call_ms": main_row["call_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "bound_share": main_row["bound_share"], "library_ms": main_row["library_ms"],
            "main_shape": main_row["shape"], "card": card,
            "shapes": [{k: v for k, v in r.items() if k != "max_abs_err"} for r in rows],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    # one card drives every phase
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
