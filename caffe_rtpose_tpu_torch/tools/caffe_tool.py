"""The ``caffe`` tool: train / test / time / device_query (reference
tools/caffe.cpp:180-422), the port of ``caffe_rtpose_tpu/tools/caffe_tool.py``.

    python -m caffe_rtpose_tpu_torch caffe train --solver solver.prototxt \\
        [--data synthetic-pose] [--fused_labels] [--snapshot S.solverstate | --weights W.caffemodel]
    python -m caffe_rtpose_tpu_torch caffe test --model train_val.prototxt \\
        --weights W.caffemodel --iterations 50
    python -m caffe_rtpose_tpu_torch caffe time --model net.prototxt --phase TRAIN
    python -m caffe_rtpose_tpu_torch caffe device_query

A net with data layers (Data, ImageData, MemoryData, HDF5Data, WindowData,
CPMData) feeds itself.  Otherwise ``--data`` feeds its inputs:
``synthetic-pose`` (the CPM transformer over procedural figures),
``cpm-lmdb:PATH`` (a DB of the reference's genLMDB records), ``pose-db:PATH``
(a pose kvdb), an ``.npz`` or ``.h5`` file whose keys are the net's input
blobs, or (with ``--fused_labels``) a JSON pose index.  ``--fused_labels``
ships u8 images and joint coordinates and rasterizes the labels on the
device inside the step.  ``train`` builds the solver's test nets from
``test_net`` or from the train net's file at TEST (with ``test_state``),
tested every ``test_interval`` iterations.  Everything runs on
``--device`` (default ``cuda``; ``cpu`` runs the same code on the host).

``train --gpu 0,1|all`` trains data-parallel over those cards (tools/
caffe.cpp:76-107; P2PSync in the reference), one rank a card, spawned by
the tool itself over ``torch.distributed`` (``parallel/dp.py``): the
prototxt batch is the GLOBAL batch, split over the ranks.  A repeated id
(``--gpu 0,0``) puts two ranks on one card over gloo; with ``--device cpu``
the ranks run on the host.  ``--spatial k`` with ``--gpu`` composes a
(n/k)-way data x k-way spatial mesh (``parallel/mesh2d.py``); alone it is
ignored with a warning, as in JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Iterator

import numpy as np
import torch

RANK_TIMEOUT = 24 * 3600.0  # a multi-rank train: its ranks are killed only when it hangs


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
    """Endless batches for the net's input blobs from ``--data``; empty ones
    for a net that feeds itself (its data layers, or no inputs at all):
    ``Net.forward`` pulls the data layers' batches."""
    if net.data_layers or not net.input_names:
        return iter(lambda: {}, None)
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
        from ..utils import hdf5

        f = hdf5.File(spec, "r")
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


def gpu_devices(spec: str, device: str):
    """``--gpu`` ids (``all``: every card) -> one device a rank: ``cuda:<id>``,
    or the host for each id when ``--device cpu``."""
    if spec == "all":
        ids = list(range(torch.cuda.device_count()))
    else:
        ids = [int(s) for s in spec.split(",") if s.strip()]
    if not ids:
        raise ValueError(f"--gpu {spec!r} names no card")
    return ["cpu"] * len(ids) if torch.device(device).type == "cpu" else [f"cuda:{i}" for i in ids]


def cmd_train(args) -> int:
    """``caffe train``: on one device, or with ``--gpu`` over several ranks
    this process spawns (module docstring); JAX's lines for the mesh."""
    spatial = int(args.spatial or 1)
    if not args.gpu:
        if spatial > 1:
            print(f"warning: --spatial {spatial} ignored — spatial sharding composes with data "
                  f"parallelism; pass --gpu all (or a device list) to build the mesh", flush=True)
        return _train(args)
    devices = gpu_devices(args.gpu, args.device)
    n = len(devices)
    if n == 1:
        if spatial > 1:
            print(f"warning: --spatial {spatial} ignored — it needs a multi-device mesh, but "
                  f"--gpu resolved to {n} device(s); training single-device", flush=True)
        args.device = devices[0]
        return _train(args)
    from ..parallel.dp import pick_backend, spawn

    if spatial > 1:
        if n % spatial:
            raise ValueError(f"--spatial {spatial} must divide the {n} devices of --gpu")
        print(f"Composed mesh training over {n} devices: {n // spatial}-way data x {spatial}-way "
              f"spatial (batch sharded AND activations H-sharded)")
    else:
        spatial = 1
        print(f"Data-parallel training over {n} devices; the prototxt batch_size is the GLOBAL "
              f"batch, sharded {n} ways (scale it by {n} for Caffe's per-GPU weak-scaling)")
    print(f"ranks on {', '.join(devices)}; backend {pick_backend(devices)}", flush=True)
    return spawn(train_rank, n, devices, args=(vars(args), spatial), timeout=RANK_TIMEOUT,
                 threads=max(1, torch.get_num_threads() // n))[0]


def train_rank(arg_dict, spatial: int) -> int:
    """One rank of ``caffe train --gpu``: the mesh over every rank, then the
    one-device train on this rank's device with the solver on the mesh.
    Rank 0 prints; the others are quiet."""
    import contextlib
    import os

    from ..parallel.dp import make_mesh, rank_device
    from ..parallel.mesh2d import make_mesh2d

    args = argparse.Namespace(**arg_dict)
    args.device = str(rank_device())
    mesh = make_mesh2d(spatial=spatial) if spatial > 1 else make_mesh()
    if mesh.rank == 0:
        return _train(args, mesh)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return _train(args, mesh)


def _train(args, mesh=None) -> int:
    from ..core.net import Net
    from ..proto import caffe_pb, prototxt
    from ..training.solver import Solver, learning_rate
    from ..utils.signals import SignalHandler, SolverAction, parse_action

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
    solver = Solver(sp_msg, net, lambda it: next(data_iter), input_transform=input_transform,
                    test_nets=_test_nets(args, sp, sp_msg, net_param), mesh=mesh)
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
            if action == SolverAction.SNAPSHOT and (mesh is None or mesh.rank == 0):
                paths = solver.snapshot(args.snapshot_prefix or sp.snapshot_prefix or "snapshot")
                print(f"Snapshotted to {paths[0]}")
            elif action == SolverAction.STOP:
                print("Optimization stopped early.")
                break
    finally:
        handler.restore()
    # Solver::Solve (solver.cpp): a snapshot unless the step loop just took
    # one, then one more test pass on the trained weights where the
    # interval falls
    snap = int(sp.snapshot) if sp.has("snapshot") else 0
    if (sp.snapshot_after_train and (sp.snapshot_prefix or args.snapshot_prefix)
            and (not snap or solver.it % snap) and (mesh is None or mesh.rank == 0)):
        solver.snapshot(args.snapshot_prefix or sp.snapshot_prefix)
    interval = int(sp.test_interval) if sp.has("test_interval") else 0
    if solver.test_nets and interval and solver.it % interval == 0:
        solver.test_all()
    print(f"Optimization Done. Final loss {solver.smoothed_loss:.6f}")
    return 0


def _test_nets(args, sp, sp_msg, net_param):
    """The solver's test nets (tools/caffe.cpp, Solver::Init): ``test_net``
    files, else the train net's file at TEST, each with its ``test_state``
    and ``test_iter``; one without data layers reads ``--data``, or is
    skipped with a warning when that cannot feed it."""
    from ..core.net import Net

    if not (sp.has("test_interval") and int(sp.test_interval) > 0):
        return []
    iters = [int(v) for v in sp.test_iter] or [50]
    sources = list(sp.test_net) or ([net_param] if not sp.has("test_net") else [])
    states = list(sp_msg.get("test_state", []))
    out = []
    for i, src in enumerate(sources):
        kw = {}
        if i < len(states):
            if states[i].get("stage"):
                kw["stages"] = list(states[i]["stage"])
            if states[i].get("level"):
                kw["level"] = int(states[i]["level"])
        tnet = Net(src, phase="TEST", device=args.device, **kw)
        fn = None
        if not tnet.data_layers and tnet.input_names:
            try:
                feed = make_data_iter(args.data, tnet)
            except ValueError:
                print(f"warning: test net #{i} skipped: no usable data source for {args.data!r}",
                      file=sys.stderr)
                continue
            fn = lambda it, _d=feed: next(_d)  # noqa: E731
        out.append((tnet, fn, iters[min(i, len(iters) - 1)]))
    return out


def cmd_test(args) -> int:
    """``caffe test``: ``--iterations`` forwards of the TEST net, each
    output blob's mean averaged over them (tools/caffe.cpp:269)."""
    from ..core.net import Net

    net = Net(args.model, phase="TEST", device=args.device, **_netstate_kw(args))
    if args.weights:
        net.load_weights(args.weights)
    data_iter = make_data_iter(args.data, net)
    totals: Dict[str, float] = {}
    with torch.no_grad():
        for _ in range(args.iterations):
            feed = {k: torch.as_tensor(np.asarray(v)).to(net.device)
                    for k, v in next(data_iter).items()}
            for k, v in net.forward(feed).items():
                totals[k] = totals.get(k, 0.0) + float(v.float().mean())
    for k, v in totals.items():
        print(f"{k} = {v / args.iterations:.6g}")  # caffe.cpp's LOG: 6 significant digits
    return 0


def cmd_time(args) -> int:
    from ..core.net import Net
    from ..utils.profiler import print_timing, time_net

    net = Net(args.model, phase=args.phase, device=args.device, **_netstate_kw(args))
    rs = np.random.RandomState(0)
    inputs = {name: torch.from_numpy(rs.rand(*net.blob_shapes[name]).astype(np.float32))
              for name in net.input_names}

    def run(label=False):
        return time_net(net, inputs, iterations=args.iterations, backward=args.phase == "TRAIN",
                        label_layers=label)

    if args.trace_dir:
        # torch.profiler's counterpart of JAX's jax.profiler.trace: the timed
        # passes, each layer's under its name, as a Chrome trace
        # (chrome://tracing, Perfetto)
        import os

        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if net.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            results = run(label=True)
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "caffe_time.trace.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}")
    else:
        results = run()
    print_timing(results)
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
    t.add_argument("--gpu", default="",
                   help="data-parallel over these cards: 0,1 or all (0,0: two ranks on one card)")
    t.add_argument("--spatial", type=int, default=1,
                   help="with --gpu: k-way spatial x (n/k)-way data mesh")
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

    te = sub.add_parser("test")
    te.add_argument("--model", required=True)
    te.add_argument("--weights", default="")
    te.add_argument("--data", default="synthetic-pose")
    te.add_argument("--iterations", type=int, default=50)
    te.add_argument("--level", type=int, default=0)
    te.add_argument("--stage", default="", help="comma-separated NetState stages")
    te.add_argument("--device", default="cuda")
    te.set_defaults(fn=cmd_test)

    ti = sub.add_parser("time")
    ti.add_argument("--model", required=True)
    ti.add_argument("--iterations", type=int, default=10)
    ti.add_argument("--phase", default="TEST", choices=["TRAIN", "TEST"])
    ti.add_argument("--trace_dir", default="",
                    help="write a torch.profiler Chrome trace of the timed passes here")
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
