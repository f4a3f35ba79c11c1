"""The ``caffe`` tool: train / time / device_query (reference
tools/caffe.cpp:180-422), the port of ``caffe_rtpose_tpu/tools/caffe_tool.py``.

    python -m caffe_rtpose_tpu_torch caffe train --solver solver.prototxt \\
        --data synthetic-pose [--fused_labels] [--snapshot S.solverstate | --weights W.caffemodel]
    python -m caffe_rtpose_tpu_torch caffe time --model net.prototxt --phase TRAIN
    python -m caffe_rtpose_tpu_torch caffe device_query

``--data`` (the port has no in-graph data layers): ``synthetic-pose`` (the
CPM transformer over procedural figures), ``cpm-lmdb:PATH`` (a DB of the
reference's genLMDB records), ``pose-db:PATH`` (a pose kvdb), an ``.npz`` or
``.h5`` file whose keys are the net's input blobs, or (with
``--fused_labels``) a JSON pose index.  ``--fused_labels`` ships u8 images
and joint coordinates and rasterizes the labels on the device inside the
step.  Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the
same code on the host).  ``train --gpu``/``--spatial`` (several cards) and
``test`` are not ported and say so.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Iterator

import numpy as np
import torch

NOT_PORTED_TEST = ("caffe test is not ported: its nets need the framework surface's layer "
                   "types (data layers, accuracy)")
NOT_PORTED_GPU = ("caffe train --gpu/--spatial (data parallelism over several cards) is not "
                  "ported; train on one card with --device")


def _pose_source(spec: str, size: int):
    """The pose sample source named by ``--data``."""
    from ..training.datasets import JsonPoseSource, SyntheticPoseSource

    if spec == "synthetic-pose":
        return SyntheticPoseSource(size=size)
    if spec.startswith("cpm-lmdb:"):
        from ..training.cpm_lmdb import CpmDatumSource

        return CpmDatumSource(spec.split(":", 1)[1])
    if spec.startswith("pose-db:"):
        from ..training.pose_db import PoseDbSource

        return PoseDbSource(spec.split(":", 1)[1])
    if spec.endswith(".json"):
        return JsonPoseSource(spec)
    raise ValueError(f"unsupported pose data source {spec!r}")


def make_data_iter(spec: str, net) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches for the net's input blobs from ``--data``."""
    if not net.input_names:
        raise ValueError("the net declares no input blobs (in-graph data layers are not ported)")
    batch = net.blob_shapes[net.input_names[0]][0]
    if spec == "synthetic-pose" or spec.startswith(("cpm-lmdb:", "pose-db:")):
        from ..training.datasets import pose_batches, prefetch_loader
        from ..training.transformer import AugParams

        source = _pose_source(spec, 368)  # the synthetic figures at the default crop
        return prefetch_loader(pose_batches(source, AugParams(), batch))
    if spec.endswith(".npz"):
        arrs = dict(np.load(spec))

        def it_npz():
            while True:
                yield {k: arrs[k] for k in net.input_names}

        return it_npz()
    if spec.endswith((".h5", ".hdf5")):
        import h5py

        f = h5py.File(spec, "r")
        n = f[net.input_names[0]].shape[0]

        def it_h5():
            i = 0
            while True:
                # a contiguous slice, wrapped at the end: cyclic order, full batches
                head = min(batch, n - i)
                yield {k: (np.asarray(f[k][i : i + batch]) if head == batch
                           else np.concatenate([np.asarray(f[k][i:n]),
                                                np.asarray(f[k][: batch - head])]))
                       for k in net.input_names}
                i = (i + batch) % n

        return it_h5()
    raise ValueError(f"unsupported data source {spec!r}")


def _netstate_kw(args, force_level=True):
    """--level/--stage (tools/caffe.cpp:39-43).  ``force_level`` mirrors the
    Net(file, phase, level) constructor of `caffe time` (the flag overrides
    the file's level); `caffe train` lets the file's level stand unless the
    flag sets one (solver.cpp:99-103)."""
    kw = {}
    if force_level:
        kw["level"] = int(getattr(args, "level", 0))
    elif getattr(args, "level", 0):
        kw["level"] = int(args.level)
    if getattr(args, "stage", ""):
        kw["stages"] = [s for s in args.stage.split(",") if s]
    return kw


def cmd_train(args) -> int:
    from ..core.net import Net
    from ..proto import caffe_pb, prototxt
    from ..training.solver import Solver, learning_rate
    from ..utils.signals import SignalHandler, SolverAction, parse_action

    if args.gpu or int(args.spatial or 1) > 1:
        raise NotImplementedError(NOT_PORTED_GPU)
    sp_msg = prototxt.parse_file(args.solver, "SolverParameter")
    sp = caffe_pb.view(sp_msg, "SolverParameter")
    net_param = (sp_msg.get("net_param") or sp_msg.get("train_net_param")
                 or (sp.net if sp.has("net") else sp.train_net))
    # SolverParameter.train_state merges over the net's own state, the CLI
    # flags last (solver.cpp:99-103)
    kw = _netstate_kw(args, force_level=False)
    ts = sp_msg.get("train_state")
    if ts:
        kw["stages"] = list(ts.get("stage", [])) + list(kw.get("stages", []))
        if "level" not in kw and ts.get("level"):
            kw["level"] = int(ts["level"])
    net = Net(net_param, phase="TRAIN", device=args.device,
              seed=int(sp.random_seed) if sp.random_seed > 0 else 0, **kw)

    input_transform = None
    if args.fused_labels:
        from ..training.datasets import prefetch_loader
        from ..training.labels_device import make_input_transform, pose_batches_jointfeed
        from ..training.transformer import AugParams

        n, _, h, w = net.blob_shapes["data"]
        prm = AugParams(crop_size_x=w, crop_size_y=h)
        source = _pose_source(args.data, max(h, w) + 52)
        data_iter = prefetch_loader(pose_batches_jointfeed(source, prm, batch_size=n,
                                                           data_u8=True))
        input_transform = make_input_transform(prm, data_u8=True)
    else:
        data_iter = make_data_iter(args.data, net)
    solver = Solver(sp_msg, net, lambda it: next(data_iter), input_transform=input_transform)
    if args.snapshot:
        solver.restore(args.snapshot)
        print(f"Restored from {args.snapshot} at iter {solver.it}")
    elif args.weights:
        print(f"Finetuning from {args.weights} ({net.load_weights(args.weights)} layers copied)")

    handler = SignalHandler(parse_action(args.sigint_effect), parse_action(args.sighup_effect))
    max_iter = int(sp.max_iter) if sp.has("max_iter") else args.iterations
    display = int(sp.display) if sp.has("display") else 20
    t_disp, it_disp = time.time(), solver.it
    try:
        while solver.it < max_iter:
            loss = solver.step(1)
            if display and solver.it % display == 0:
                # solver.cpp:237-243's "Iteration N (R iter/s, Ts/D iters)"
                dt = max(time.time() - t_disp, 1e-9)
                di = solver.it - it_disp
                t_disp, it_disp = time.time(), solver.it
                print(f"Iteration {solver.it} ({di / dt:.4g} iter/s, {dt:.4g}s/{di} iters), "
                      f"loss = {loss:.6f} (smoothed {solver.smoothed_loss:.6f})")
                solver.display_outputs()
                print(f"Iteration {solver.it}, lr = {learning_rate(solver.sp, solver.it):g}")
            action = handler.check_for_action()
            if action == SolverAction.SNAPSHOT:
                paths = solver.snapshot(args.snapshot_prefix or sp.snapshot_prefix or "snapshot")
                print(f"Snapshotted to {paths[0]}")
            elif action == SolverAction.STOP:
                print("Optimization stopped early.")
                break
    finally:
        handler.restore()
    if sp.snapshot_after_train and (sp.snapshot_prefix or args.snapshot_prefix):
        solver.snapshot(args.snapshot_prefix or sp.snapshot_prefix)
    print(f"Optimization Done. Final loss {solver.smoothed_loss:.6f}")
    return 0


def cmd_test(args) -> int:
    raise NotImplementedError(NOT_PORTED_TEST)


def cmd_time(args) -> int:
    from ..core.net import Net
    from ..utils.profiler import print_timing, time_net

    net = Net(args.model, phase=args.phase, device=args.device, **_netstate_kw(args))
    rs = np.random.RandomState(0)
    inputs = {name: torch.from_numpy(rs.rand(*net.blob_shapes[name]).astype(np.float32))
              for name in net.input_names}
    print_timing(time_net(net, inputs, iterations=args.iterations,
                          backward=args.phase == "TRAIN"))
    return 0


def cmd_device_query(args) -> int:
    from ..utils.device import device_query

    for k, v in device_query().items():
        print(f"  {k}: {v}")
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="caffe", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train")
    t.add_argument("--solver", required=True)
    t.add_argument("--gpu", default="", help="not ported: data parallelism over several cards")
    t.add_argument("--spatial", type=int, default=1, help="not ported (with --gpu)")
    t.add_argument("--fused_labels", action="store_true",
                   help="u8 images and joints from the host, labels rasterized on the device")
    t.add_argument("--data", default="synthetic-pose")
    t.add_argument("--snapshot", default="", help="resume from a .solverstate")
    t.add_argument("--weights", default="", help="finetune from a .caffemodel")
    t.add_argument("--snapshot_prefix", default="")
    t.add_argument("--iterations", type=int, default=50, help="when the solver sets no max_iter")
    t.add_argument("--sigint_effect", default="stop", choices=["stop", "snapshot", "none"])
    t.add_argument("--sighup_effect", default="snapshot", choices=["stop", "snapshot", "none"])
    t.add_argument("--level", type=int, default=0)
    t.add_argument("--stage", default="", help="comma-separated NetState stages")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)

    te = sub.add_parser("test", help="not ported")
    te.set_defaults(fn=cmd_test)

    ti = sub.add_parser("time")
    ti.add_argument("--model", required=True)
    ti.add_argument("--iterations", type=int, default=10)
    ti.add_argument("--phase", default="TEST", choices=["TRAIN", "TEST"])
    ti.add_argument("--level", type=int, default=0)
    ti.add_argument("--stage", default="", help="comma-separated NetState stages")
    ti.add_argument("--device", default="cuda")
    ti.set_defaults(fn=cmd_time)

    d = sub.add_parser("device_query")
    d.set_defaults(fn=cmd_device_query)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
