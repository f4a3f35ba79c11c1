"""Multi-process data-parallel training dry run.

Counterpart of ``caffe_rtpose_tpu/parallel/multihost.py``.  Each process is
one rank of a ``torch.distributed`` job joined through a TCP store at the
coordinator (one host or several), and runs the same
``dp.make_dp_train_step`` on the full 6-stage CPM train graph: the training
code has no multi-process case of its own.  :func:`dryrun_multihost` runs N
worker processes and one, on the same global batch, and holds their
digests (the loss and each layer's parameter sums in f64 after the step) to
JAX's tolerances: loss rtol 1e-5, sums rtol 1e-4 and atol 1e-5 (the
all-reduce may add in another order).

Usage:
  worker (one a process):
    python -m caffe_rtpose_tpu_torch.parallel.multihost --worker \\
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id I \\
        --crop 64 --batch 8 --out digest.json [--device cuda:0]
  the dry run (spawns the workers and the one-process reference):
    python -m caffe_rtpose_tpu_torch.parallel.multihost --num-processes 2 [--device cpu]

Workers on one card share it over gloo (NCCL refuses two ranks on one
device); NCCL only when ``--backend nccl`` says each has its own.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Dict, Optional

import numpy as np

SOLVER = ('base_lr: 0.000040 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.0005 '
          'type: "SGD"')
N_LABEL = 2 * (38 + 19 - 1 + 1)  # the transformer's label layout: 2 * (np + 1)


def cpm_global_batch(batch: int, crop: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX's dry-run batch (Caffe layout): uniform data in [-0.5, 0.5) and
    labels in [0, 1), drawn in that order from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    grid = crop // 8
    return {"data": rs.rand(batch, 3, crop, crop).astype(np.float32) - 0.5,
            "label": rs.rand(batch, N_LABEL, grid, grid).astype(np.float32)}


def sgd_update(net):
    """JAX's dry-run update: SGD 4e-5 fixed, momentum 0.9, weight decay
    5e-4, with the net's lr and decay multipliers."""
    from ..proto import caffe_pb, prototxt
    from ..training.solver import make_update_fn

    sp = caffe_pb.view(prototxt.parse(SOLVER, "SolverParameter"), "SolverParameter")
    lr_mults, decay_mults, params = {}, {}, {}
    for name, _, prm, lr, dm in net.learnable():
        params.setdefault(name, []).append(prm)
        lr_mults.setdefault(name, []).append(lr)
        decay_mults.setdefault(name, []).append(dm)
    return params, make_update_fn("SGD", sp, lr_mults, decay_mults)


def digest(params, loss: float, n: int) -> Dict:
    return {"num_processes": n, "loss": float(loss),
            "param_sums": {k: [float(p.detach().double().sum()) for p in v]
                           for k, v in sorted(params.items())}}


def check_digests(m: Dict, s: Dict) -> None:
    """JAX's rule (``multihost.py:269-275``): loss rtol 1e-5; each layer's
    parameter sums rtol 1e-4, atol 1e-5."""
    np.testing.assert_allclose(m["loss"], s["loss"], rtol=1e-5,
                               err_msg="multi-process loss != single-process")
    for name in s["param_sums"]:
        np.testing.assert_allclose(m["param_sums"][name], s["param_sums"][name], rtol=1e-4,
                                   atol=1e-5, err_msg=f"updated params diverge at layer {name}")


def _worker(coordinator: str, num_processes: int, process_id: int, crop: int, batch: int,
            out_path: str, device: str, backend: str) -> Dict:
    """One process of the job: one DP step of the CPM train graph; process
    0 writes the digest."""
    import torch
    import torch.distributed as dist

    from ..core.net import Net
    from ..models.cpm import make_pose_train_net
    from ..training.solver import init_history
    from .dp import make_dp_train_step, make_mesh, net_loss_fn, pick_backend, shard_batch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "auto":
        backend = pick_backend([device] * num_processes)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=process_id,
                            world_size=num_processes, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(device=dev)
        # the same seed on every process: the same weights, replicated
        net = Net(make_pose_train_net(batch=batch, crop=crop, stages=6), phase="TRAIN",
                  seed=0, device=dev)
        params, update = sgd_update(net)
        step = make_dp_train_step(mesh, net_loss_fn(net), update)
        inputs = shard_batch(mesh, cpm_global_batch(batch, crop))
        loss = step(params, init_history("SGD", params), inputs, 4e-5, 0)
        out = digest(params, loss, num_processes)
        out["backend"] = backend
        if process_id == 0 and out_path:
            with open(out_path, "w") as f:
                json.dump(out, f)
        print(f"multihost worker {process_id}/{num_processes} on {dev} ({backend}): "
              f"loss={out['loss']:.6f}", flush=True)
        return out
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(num_processes: int, process_id: int, coordinator: str, crop: int, batch: int,
           out: str, device: str, threads: int):
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return subprocess.Popen(
        [sys.executable, "-m", "caffe_rtpose_tpu_torch.parallel.multihost", "--worker",
         "--coordinator", coordinator, "--num-processes", str(num_processes),
         "--process-id", str(process_id), "--crop", str(crop), "--batch", str(batch),
         "--out", out, "--device", device, "--threads", str(threads)],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryrun_multihost(num_processes: int = 2, crop: int = 64, batch: int = 8,
                     timeout: float = 900.0, device: str = "cuda:0", threads: int = 1,
                     workdir: Optional[str] = None) -> Dict:
    """N worker processes == one worker process on the same global batch
    (module docstring); ``AssertionError`` when they differ, ``RuntimeError``
    when a worker fails or outlasts ``timeout`` (it is killed).  Returns
    both digests."""
    digests = {}
    with tempfile.TemporaryDirectory(prefix="crt_multihost_", dir=workdir) as tmp:
        for label, procs in (("multi", num_processes), ("single", 1)):
            out = os.path.join(tmp, f"{label}.json")
            coord = f"127.0.0.1:{free_port()}"
            workers = [_spawn(procs, i, coord, crop, batch, out if i == 0 else "", device,
                              threads) for i in range(procs)]
            try:
                for w in workers:
                    try:
                        log, _ = w.communicate(timeout=timeout)
                    except subprocess.TimeoutExpired as e:
                        raise RuntimeError(f"{label} worker outlasted {timeout:.0f} s") from e
                    if w.returncode != 0:
                        raise RuntimeError(f"{label} worker failed:\n{log[-3000:]}")
            finally:
                for w in workers:
                    if w.poll() is None:
                        w.kill()
                        w.wait()
            with open(out) as f:
                digests[label] = json.load(f)
    m, s = digests["multi"], digests["single"]
    assert np.isfinite(m["loss"])
    check_digests(m, s)
    print(f"dryrun_multihost: {num_processes} processes, 6-stage CPM DP train step == "
          f"1 process (loss {m['loss']:.6f}, {m['backend']}) OK", flush=True)
    return digests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--backend", default="auto", choices=["auto", "gloo", "nccl"])
    ap.add_argument("--threads", type=int, default=0, help="torch threads (0: torch's own)")
    args = ap.parse_args(argv)
    if args.threads:
        import torch

        torch.set_num_threads(args.threads)
    if args.worker:
        _worker(args.coordinator, args.num_processes, args.process_id, args.crop, args.batch,
                args.out, args.device, args.backend)
        return 0
    dryrun_multihost(args.num_processes, args.crop, args.batch, device=args.device,
                     threads=args.threads or 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
