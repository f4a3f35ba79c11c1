"""Multi-rank dry run of the port's parallel modes on the flagship graphs.

Counterpart of ``caffe_rtpose_tpu/parallel/dryrun.py``.  Each ``dryrun_*``
runs on every rank of a ``torch.distributed`` job (``dp.spawn``), holds the
sharded result to the one-device one at JAX's tolerances and returns what
it measured:

1. :func:`dryrun_cpm_train`: one data-parallel step of the full 6-stage
   COCO CPM train net, against the one-rank step on the same global batch
   (JAX's multihost tolerances: loss rtol 1e-5, parameter sums rtol 1e-4,
   atol 1e-5);
2. :func:`dryrun_device_pool`: frame-parallel round robin
   (``inference.DevicePool``) against the estimator, byte for byte;
3. :func:`dryrun_spatial_estimator` and :func:`dryrun_tp_estimator`: the
   estimator H-sharded, and with channel-sharded weights (peaks rtol and
   atol 1e-4, scores 2e-2, pair counts exact: JAX ``dryrun.py:153-155``;
   scores where both sides sample the same pixels:
   :func:`assert_estimates_close`; with ``keep_heatmap`` the heatmap too,
   rtol/atol 2e-4, rank by rank on the device), with the launches of the
   peak-mask kernel K1 and the upsample-keys kernel K3 on the rank;
4. ``dryrun_dp_tp_estimator``: frames over ``data``, weights over ``model``;
5. :func:`dryrun_pp` and :func:`dryrun_pp_train`: the refinement stages
   pipelined (rtol/atol 2e-4), and a pipelined train step (loss rtol
   1e-5; weights rtol 1e-4, atol 1e-6);
6. :func:`dryrun_dp_sp_train`: a data x spatial train step (loss within
   1e-3, sampled parameters rtol 2e-3, atol 2e-5: JAX ``mesh2d.py``);
   :func:`case_spatial_train` the same rule on any net (every parameter),
   and the replicated tail's parameters equal on every spatial rank.

:func:`dryrun_flagship` spawns n ranks and runs them all:

    python -m caffe_rtpose_tpu_torch.parallel.dryrun --n 4 [--device cpu]

On one card every rank shares it over gloo.  :func:`rank_cases` runs named
cases with given weights and inputs on every rank, for the CPU tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .dp import make_mesh, rank_device

PEAK_TOL, SCORE_TOL = 1e-4, 2e-2
HEAT_TOL = 2e-4  # JAX dry_run_spatial's forward rule, on the full-res maps
MOVED_SHARE = 0.1  # pairs whose samples may land on other pixels, of the real pairs


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _launches() -> Tuple[int, int]:
    """The wrapper launch counts of K1 (peak mask) and K3 (upsample keys)."""
    from ..ops import nms_cuda

    return nms_cuda.launches, nms_cuda.upsample_launches


def _peak_gib(dev) -> Optional[float]:
    dev = torch.device(dev)
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None


def flagship_estimator(net_w: int = 128, net_h: int = 80, stages: int = 6, weights=None,
                       batch: int = 1, seed: int = 3, device=None, **kw):
    """The f32 COCO estimator the dry runs shard (JAX ``_flagship_estimator``)."""
    from ..models.cpm import make_pose_deploy_net
    from ..pose.estimator import PoseEstimator

    proto = make_pose_deploy_net("COCO", stages=stages, input_dim=(1, 3, net_h, net_w))
    return PoseEstimator(proto, weights=weights, net_resolution=(net_w, net_h), num_scales=1,
                         seed=seed, batch=batch, device=device or rank_device(), **kw)


def sample_pixels_may_differ(pa, pb, desc, margin: float = 1e-4) -> np.ndarray:
    """(L, M, M) bool: the limb pairs where a line-integral sample of the
    two peak sets may land on different pixels: the rounded sample
    positions differ, or one lies within ``margin`` px of a .5 boundary
    (tests/test_torch_estimator.py's rule)."""
    limbs = [desc.limb(k) for k in range(desc.num_limbs)]
    a, b = (np.array([l[i] for l in limbs]) for i in (0, 1))
    lm = np.arange(10) / 10.0
    out = np.zeros((len(limbs), pa.shape[1] - 1, pa.shape[1] - 1), bool)
    with np.errstate(invalid="ignore"):
        for c in (0, 1):
            pos = [p[a, 1:, None, None, c].astype(np.float64) + lm
                   * (p[b, None, 1:, None, c].astype(np.float64)
                      - p[a, 1:, None, None, c].astype(np.float64)) + 0.5 for p in (pa, pb)]
            out |= (np.isfinite(pos[0]) & np.isfinite(pos[1])
                    & (np.floor(pos[0]) != np.floor(pos[1]))).any(-1)
            for u in pos:
                out |= (np.abs(u - np.round(u)) < margin).any(-1)
    return out


def real_pairs(desc, peaks) -> np.ndarray:
    """(L, M, M) bool: the pairs of real peaks ([:na, :nb] of each limb)."""
    m = peaks.shape[1] - 1
    n = np.minimum(peaks[:, 0, 0].astype(int), m)
    out = np.zeros((desc.num_limbs, m, m), bool)
    for k in range(desc.num_limbs):
        a, b = desc.limb(k)
        out[k, : n[a], : n[b]] = True
    return out


def assert_estimates_close(got, ref, tag: str, desc) -> None:
    """JAX's dry-run rule (peaks rtol/atol 1e-4, scores 2e-2, pair counts
    exact), with scores compared where both sides sample the same pixels:
    a refined peak a few f32 ulps away moves a sample that sits on a
    pixel's .5 boundary to the next pixel, and that pair's score by one
    sample's dot (seen: 0.031 on 0.55 with channel-sharded weights, 656x368).
    The pairs left out (a sample within 1e-4 px of a boundary on either
    side: 3.2 % of one 656x368 frame's real pairs) must stay under a tenth
    of the pairs of real peaks, so that the rule still compares most."""
    np.testing.assert_allclose(got[0], ref[0], rtol=PEAK_TOL, atol=PEAK_TOL, err_msg=tag)
    np.testing.assert_array_equal(got[2], ref[2], err_msg=tag)
    moved = sample_pixels_may_differ(got[0], ref[0], desc)
    real = real_pairs(desc, ref[0])
    assert not real.any() or moved[real].mean() < MOVED_SHARE, (
        f"{tag}: {moved[real].mean():.3f} of the pairs may sample other pixels")
    close = np.abs(got[1] - ref[1]) <= SCORE_TOL + SCORE_TOL * np.abs(ref[1])
    assert (close | moved).all(), f"{tag}: pair scores differ where both sample the same pixels"


def _estimate_frames(est, frames, heat: Optional[List] = None) -> List:
    """One-device results of each frame (a batched estimator: each batch);
    the heatmap estimator's heatmaps appended to ``heat``, on the device."""
    out = []
    for xs in frames:
        # a heatmap estimator's frames with a leading axis (dp x tp): one a call
        for x in ([xs] if est.batch > 1 or np.shape(xs) == tuple(est.input_shape()) else xs):
            res = est.run_device(x, nms_threshold=_THR.get("nms"),
                                 inter_threshold=_THR.get("inter"))
            out.extend(est.fetch_batch(res) if est.batch > 1 else [est.fetch(res)])
            if heat is not None:  # a graph's replay writes the same buffer each frame
                heat.append(res["heatmap"].clone())
    return out


def _frame_outputs(est, out) -> Tuple[List, List[torch.Tensor]]:
    """A sharded function's outputs of one call -> (each frame's (peaks,
    pair score, pair count) on the host, each frame's heatmap on the device
    (none on the packed path))."""
    if not est.keep_heatmap:
        rows = out["packed"].cpu().numpy()
        return [est.unpack(r) for r in (rows if rows.ndim == 2 else rows[None])], []
    frames = out["peaks"].dim() == 4  # a leading frame axis
    keys = ("peaks", "pair_score", "pair_count")
    host = {k: out[k].cpu().numpy() for k in keys}
    if not frames:
        return [tuple(host[k] for k in keys)], [out["heatmap"]]
    return ([tuple(host[k][f] for k in keys) for f in range(len(host["peaks"]))],
            list(out["heatmap"]))


_THR: Dict[str, Optional[float]] = {}


def _sharded_run(tag, est, fn, weights, frames):
    """``fn`` over ``frames`` against the one-device estimator: the packed
    rows (with ``keep_heatmap``: each frame's outputs, and its heatmap off a
    card), the K1 and K3 launches on this rank, and ms a frame of both."""
    import torch.distributed as dist

    _estimate_frames(est, frames[:1])  # warm-up: a graph's capture, the kernels' build
    # the one-device run on one rank at a time: the ranks share a card
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r == dist.get_rank():
            heat_ref: List[torch.Tensor] = []
            single, single_ms = _timed(lambda: _estimate_frames(
                est, frames, heat_ref if est.keep_heatmap else None), est.device)
    dist.barrier()
    fn(weights, frames[0], _THR.get("nms"), _THR.get("inter"))
    before = _launches()
    outs, ms = _timed(lambda: [fn(weights, x, _THR.get("nms"), _THR.get("inter"))
                               for x in frames], est.device)
    k1, k3 = (a - b for a, b in zip(_launches(), before))
    got, heat = [], []
    for o in outs:
        g, h = _frame_outputs(est, o)
        got += g
        heat += h
    for i, (g, r) in enumerate(zip(got, single)):
        assert_estimates_close(g, r, f"{tag} frame {i}", est.descriptor)
    for i, (h, r) in enumerate(zip(heat, heat_ref)):  # on the device, rank by rank
        err = (h - r).abs() - HEAT_TOL * r.abs()
        assert float(err.max()) <= HEAT_TOL, f"{tag} frame {i}: heatmap off by {float(err.max())}"
    n_frames = len(got)
    res = {"k1_launches": k1, "k3_launches": k3, "frames": n_frames,
           "ms_per_frame": ms / n_frames, "single_ms_per_frame": single_ms / n_frames}
    if est.keep_heatmap:
        res["outputs"] = got
        if est.device.type != "cuda":  # 2.3 MB a frame at 128x80; 55 MB at 656x368
            res["heat"] = [h.cpu().numpy() for h in heat]
    else:
        res["packed"] = [o["packed"].cpu().numpy() for o in outs]
    return res


def dryrun_spatial_estimator(n_devices: int, est=None, frames=None) -> Dict:
    """The estimator H-sharded over ``n_devices`` ranks (``sp``)."""
    from .sp import spatial_estimator_fn

    est = est or flagship_estimator()
    frames = frames if frames is not None else _noise_frames(est, 2)
    mesh = make_mesh(n_devices, "spatial", est.device)
    res = _sharded_run("spatial", est, spatial_estimator_fn(mesh, est), est.net.operands(),
                       frames)
    print(f"dryrun_spatial_estimator({n_devices}): H-sharded == single-device OK", flush=True)
    return res


def dryrun_tp_estimator(n_devices: int, est=None, frames=None) -> Dict:
    """The estimator with channel-sharded weights (``tp``); also the share
    of the weight bytes this rank holds."""
    from .tp import share_bytes, shard_params_channelwise, tp_estimator_fn

    est = est or flagship_estimator()
    frames = frames if frames is not None else _noise_frames(est, 2)
    mesh = make_mesh(n_devices, "model", est.device)
    whole = est.net.operands()
    mine = shard_params_channelwise(mesh, whole)
    res = _sharded_run("tp", est, tp_estimator_fn(mesh, est), mine, frames)
    res["weight_share"] = share_bytes(mine) / share_bytes(whole)
    print(f"dryrun_tp_estimator({n_devices}): channel-sharded weights == single-device OK "
          f"({res['weight_share']:.3f} of the bytes on this rank)", flush=True)
    return res


def dryrun_dp_tp_estimator(n_devices: int, model: int = 2, est=None, frames=None) -> Dict:
    """A batch of frames over ``data`` with weights over ``model``
    (``mesh2d.dp_tp_estimator_fn``); ``est`` batched (its batch divides
    over ``data``)."""
    from .mesh2d import dp_tp_estimator_fn, make_mesh2d
    from .tp import share_bytes, shard_params_channelwise

    est = est or flagship_estimator(batch=n_devices // model)
    frames = frames if frames is not None else _noise_frames(est, 1)
    mesh = make_mesh2d(n_devices, spatial=model, axes=("data", "model"), device=est.device)
    whole = est.net.operands()
    mine = shard_params_channelwise(mesh, whole, "model")
    res = _sharded_run("dp x tp", est, dp_tp_estimator_fn(mesh, est), mine, frames)
    res["weight_share"] = share_bytes(mine) / share_bytes(whole)
    print(f"dryrun_dp_tp_estimator({n_devices}): {n_devices // model}-way data x {model}-way "
          f"model == single-device OK", flush=True)
    return res


def _noise_frames(est, n: int, seed: int = 4) -> List[np.ndarray]:
    rs = np.random.RandomState(seed)
    shape = est.input_shape() if est.batch == 1 else (est.batch, *est.input_shape())
    if est.input_u8:
        return [(rs.rand(*shape) * 255).astype(np.uint8) for _ in range(n)]
    return [rs.rand(*shape).astype(np.float32) - 0.5 for _ in range(n)]


def dryrun_device_pool(n_devices: int, est=None) -> Dict:
    """Frame-parallel round robin over the cards there are (at most
    ``n_devices``; replicas on the CPU for a CPU estimator) == the
    estimator, byte for byte; on rank 0."""
    from .inference import DevicePool

    est = est or flagship_estimator()
    cards = torch.cuda.device_count() if est.device.type == "cuda" else n_devices
    pool = DevicePool(est, num_devices=max(1, min(n_devices, cards)))
    frames = _noise_frames(est, n_devices, seed=1)
    outs = [pool.run_device(f) for f in frames]
    for f, o in zip(frames, outs):
        assert torch.equal(o["packed"].cpu(), est.run_device(f)["packed"].cpu())
    print(f"dryrun_device_pool({n_devices}): {len(frames)} frames over "
          f"{len(pool.replicas)} replicas == single-device OK", flush=True)
    return {"replicas": len(pool.replicas)}


def _train_net(crop, batch, stages, weights, dev):
    from ..core.net import Net
    from ..models.cpm import make_pose_train_net

    net = Net(make_pose_train_net(batch=batch, crop=crop, stages=stages), phase="TRAIN",
              seed=0, device=dev)
    if weights is not None:
        net.load_weights(weights)
    return net


def _params_np(params) -> Dict[str, List[np.ndarray]]:
    return {k: [p.detach().cpu().numpy().copy() for p in v] for k, v in params.items()}


def dryrun_cpm_train(n_devices: int, crop: int = 64, batch: int = 8, stages: int = 6,
                     weights=None, batch_arrays=None) -> Dict:
    """One data-parallel step of the CPM train net (6 stages: the full
    COCO graph) over ``n_devices`` ranks, against the one-rank step on the
    same global batch, computed on rank 0.  Returns the
    loss, the updated parameters (rank 0), the step's ms and the gradient
    all-reduce's ms."""
    from ..training.solver import init_history
    from .dp import all_reduce_flat, make_dp_train_step, net_loss_fn, shard_batch
    from .multihost import check_digests, cpm_global_batch, digest, sgd_update

    dev = rank_device()
    mesh = make_mesh(n_devices, "data", dev)
    glob = batch_arrays if batch_arrays is not None else cpm_global_batch(batch, crop)
    out: Dict[str, Any] = {}
    if mesh.rank == 0:
        net = _train_net(crop, batch, stages, weights, dev)
        params, update = sgd_update(net)
        step1 = _single_step(net, update)
        hist1 = init_history("SGD", params)
        out["ref_loss"], out["ref_step_ms"] = _timed(lambda: step1(params, hist1, glob, 4e-5, 0),
                                                     dev)
        out["ref_digest"] = digest(params, out["ref_loss"], 1)
        if _warm_timing(dev):
            _, out["ref_step_ms"] = _timed(lambda: step1(params, hist1, glob, 4e-5, 1), dev)
        del net, params, hist1
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    torch.distributed.barrier()  # the reference ran alone on the card
    net = _train_net(crop, batch, stages, weights, dev)
    params, update = sgd_update(net)
    step = make_dp_train_step(mesh, net_loss_fn(net), update)
    inputs = shard_batch(mesh, glob)
    history = init_history("SGD", params)
    out["loss"], out["step_ms"] = _timed(lambda: step(params, history, inputs, 4e-5, 0), dev)
    out["digest"] = digest(params, out["loss"], n_devices)
    if _warm_timing(dev):
        _, out["step_ms"] = _timed(lambda: step(params, history, inputs, 4e-5, 1), dev)
    grads = [torch.ones_like(p) for ps in params.values() for p in ps]
    _, out["allreduce_ms"] = _timed(lambda: all_reduce_flat(mesh, grads, ["data"]), dev)
    out["peak_gib"] = _peak_gib(dev)
    if "ref_digest" in out:
        check_digests(out["digest"], out["ref_digest"])
    if mesh.rank == 0 and not _warm_timing(dev):
        out["params"] = _params_np(params)
    print(f"dryrun_cpm_train({n_devices}): {stages}-stage CPM step, crop {crop}, global batch "
          f"{batch}, loss {out['loss']:.6f} OK", flush=True)
    return out


def _warm_timing(dev) -> bool:
    """On a card a step's first call pays one-time costs (the autograd
    thread's context, cuBLAS, lazily loaded kernels: seconds with five ranks
    on one card), so a dry run there times a second call."""
    return torch.device(dev).type == "cuda"


def _transform(spec):
    """``(name of a training.labels_device function, kwargs)`` -> the input
    transform it makes (None -> None)."""
    from ..training import labels_device

    return None if spec is None else getattr(labels_device, spec[0])(**spec[1])


def _single_step(net, update, transform=None):
    """The one-device step of ``dp.make_dp_train_step``'s contract (through
    ``transform`` first, as the solver's ``input_transform``)."""
    from .dp import _as_tensor

    def step(params, history, batch, lr, it):
        for ps in params.values():
            for p in ps:
                p.grad = None
        inputs = {k: _as_tensor(v, net.device) for k, v in batch.items()}
        loss = net.loss(inputs if transform is None else transform(inputs))[0]
        loss.backward()
        update(params, {k: [p.grad for p in v] for k, v in params.items()}, history, lr, it)
        return float(loss.detach())

    return step


def dryrun_dp_sp_train(n_devices: int, crop: int = 96, batch: int = 8, spatial: int = 2,
                       stages: int = 6, weights=None, batch_arrays=None, transform=None) -> Dict:
    """One data x spatial step of the CPM train net on an (n/spatial) x
    spatial mesh, against the one-device step on rank 0: loss within 1e-3
    and every 7th parameter blob (the first 8) within rtol 2e-3, atol 2e-5,
    as JAX ``mesh2d.dryrun_dp_sp_train``.  ``transform``: the input
    transform both steps run (:func:`_transform`'s spec: the fused labels,
    rasterized on each rank's whole examples before the rows split)."""
    from ..training.solver import init_history
    from .dp import net_loss_fn
    from .mesh2d import make_dp_sp_train_step, make_mesh2d
    from .multihost import cpm_global_batch, sgd_update

    dev = rank_device()
    glob = batch_arrays if batch_arrays is not None else cpm_global_batch(batch, crop, seed=7)
    tf = _transform(transform)
    mesh = make_mesh2d(n_devices, spatial=spatial, device=dev)
    out: Dict[str, Any] = {}
    ref = None
    if mesh.rank == 0:
        net = _train_net(crop, batch, stages, weights, dev)
        params, update = sgd_update(net)
        step1, hist1 = _single_step(net, update, tf), init_history("SGD", params)
        out["ref_loss"], out["ref_step_ms"] = _timed(lambda: step1(params, hist1, glob, 4e-5, 0),
                                                     dev)
        ref = _params_np(params)
        if _warm_timing(dev):
            _, out["ref_step_ms"] = _timed(lambda: step1(params, hist1, glob, 4e-5, 1), dev)
        del net, params, hist1
    torch.distributed.barrier()  # the reference ran alone on the card
    net = _train_net(crop, batch, stages, weights, dev)
    params, update = sgd_update(net)
    step = make_dp_sp_train_step(mesh, net_loss_fn(net), update, transform=tf)
    history = init_history("SGD", params)
    out["loss"], out["step_ms"] = _timed(lambda: step(params, history, glob, 4e-5, 0), dev)
    got = _params_np(params)
    if _warm_timing(dev):
        _, out["step_ms"] = _timed(lambda: step(params, history, glob, 4e-5, 1), dev)
    out["peak_gib"] = _peak_gib(dev)
    if ref is not None:
        assert abs(out["loss"] - out["ref_loss"]) <= 1e-3 * max(1.0, abs(out["ref_loss"])), (
            f"dp x sp loss {out['loss']} != single-device {out['ref_loss']}")
        flat_s = [a for v in got.values() for a in v]
        flat_r = [a for v in ref.values() for a in v]
        for a, b in list(zip(flat_s, flat_r))[::7][:8]:
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
        if not _warm_timing(dev):  # the CPU tests compare them with JAX's
            out["params"], out["ref_params"] = got, ref
    print(f"dryrun_dp_sp_train({n_devices}): {stages}-stage step on a "
          f"{n_devices // spatial}x{spatial} data x spatial mesh, loss {out['loss']:.5f} OK",
          flush=True)
    return out


def dryrun_pp_train(n_devices: int, hw: Tuple[int, int] = (6, 8), micro: int = 4,
                    width: int = 8, n_paf: int = 4, n_heat: int = 3, feat_ch: int = 8,
                    stacked=None, args=None, fan_in: bool = False) -> Dict:
    """One pipelined train step over S = min(n, 5) stages == the monolithic
    step (loss rtol 1e-5; every updated weight rtol 1e-4, atol 1e-6), as
    JAX ``pp.dryrun_pp_train``.  ``stacked``, ``args``: JAX's draws, when
    given (the CPU tests pass them).  Else JAX's draws (uniform +-0.05),
    or with ``fan_in`` uniform at He scale, which keeps five stages of
    width 128 from growing the activations ~2x a layer."""
    from .dp import Mesh
    from .pp import make_pp_train_step, make_refine_stage_net, monolithic_train_step

    if n_devices < 2:
        raise ValueError("pipeline train dryrun needs >= 2 devices")
    S = min(n_devices, 5)
    dev = rank_device()
    stage_net = make_refine_stage_net(n_paf=n_paf, n_heat=n_heat, hw=hw, feat_ch=feat_ch,
                                      width=width, device=dev)
    if stacked is None:
        rs = np.random.RandomState(23)
        def draw(shape):
            scale = (np.sqrt(6.0 / np.prod(shape[1:])) if fan_in and len(shape) == 4
                     else 0.05)
            return ((rs.rand(*shape) * 2 - 1) * scale).astype(np.float32)

        stacked = {k: [np.stack([draw(tuple(p.shape)) for _ in range(S)]) for p in v]
                   for k, v in stage_net.layer_blobs().items()}
        h, w = hw
        args = [rs.rand(micro, 1, c, h, w).astype(np.float32) - 0.5
                for c in (n_paf, n_heat, feat_ch, n_paf, n_heat)]
    mesh = Mesh({"stage": S}, dev)
    out: Dict[str, Any] = {}
    if mesh.member:
        step = make_pp_train_step(mesh, stage_net, micro)
        (loss, new), out["step_ms"] = _timed(lambda: step(stacked, *args), dev)
        if _warm_timing(dev):  # the step is a function of its inputs: the same again
            _, out["step_ms"] = _timed(lambda: step(stacked, *args), dev)
        out["loss"] = loss
        ref_loss, ref_new = monolithic_train_step(stage_net, S, device=dev)(stacked, *args)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        for k in new:
            for a, b in zip(new[k], ref_new[k]):
                np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4,
                                           atol=1e-6)
        out["ref_loss"] = ref_loss
        if mesh.rank == 0:
            out["new"] = {k: [a.cpu().numpy() for a in v] for k, v in new.items()}
        print(f"dryrun_pp_train({n_devices}): pipelined train step over {S} stages, {micro} "
              f"microbatches == monolithic (loss {loss:.6f}) OK", flush=True)
    return out


def dryrun_pp(n_devices: int, hw: Tuple[int, int] = (24, 32), micro: int = 6,
              weights=None) -> Dict:
    """The COCO refinement stages 2..S+1 (S = min(n, 5)) one a rank, M
    microbatches through the GPipe schedule == the monolithic net's stage
    S+1 outputs (rtol/atol 2e-4), as JAX ``pp.dryrun_pp``.  ``weights``:
    the full deploy net's (Caffe layout; default its seed-7 fill).  Rank 0
    also returns the stage inputs and the pipelined outputs."""
    from ..core.net import Net
    from ..models.cpm import make_pose_deploy_net
    from .dp import Mesh
    from .pp import make_refine_stage_net, pipeline_refine, stack_stage_params

    if n_devices < 2:
        raise ValueError("pipeline dryrun needs >= 2 devices")
    S = min(n_devices, 5)
    dev = rank_device()
    h, w = hw
    last = f"_stage{S + 1}"
    full = Net(make_pose_deploy_net("COCO", input_dim=(1, 3, h * 8, w * 8)), phase="TEST",
               seed=7, device=dev)
    if weights is not None:
        full.load_weights(weights)
    rs = np.random.RandomState(11)
    names = ["conv5_5_CPM_L1", "conv5_5_CPM_L2", "conv4_4_CPM", f"Mconv7{last}_L1",
             f"Mconv7{last}_L2"]
    blobs = {k: [] for k in names}
    with torch.no_grad():
        for _ in range(micro):
            img = torch.from_numpy(rs.rand(1, 3, h * 8, w * 8).astype(np.float32) - 0.5)
            o = full.forward({"image": img.to(dev)}, outputs=names)
            for k in names:
                blobs[k].append(o[k].float().cpu().numpy())
    l1, l2, ft, want1, want2 = (np.stack(blobs[k]) for k in names)
    stage_net = make_refine_stage_net(hw=hw, device=dev)
    stacked = stack_stage_params(full.export_weights(), range(2, 2 + S))
    del full
    mesh = Mesh({"stage": S}, dev)
    out: Dict[str, Any] = {}
    if mesh.member:
        (o1, o2), out["ms"] = _timed(
            lambda: pipeline_refine(mesh, stage_net, stacked, l1, l2, ft), dev)
        o1, o2 = o1.cpu().numpy(), o2.cpu().numpy()
        np.testing.assert_allclose(o1, want1, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(o2, want2, rtol=2e-4, atol=2e-4)
        if mesh.rank == 0:
            out.update(inputs=(l1, l2, ft), outputs=(o1, o2))
        print(f"dryrun_pp({n_devices}): {micro} microbatches through {S} pipelined refinement "
              f"stages == monolithic net OK", flush=True)
    return out


def flagship_rank(n_devices: int) -> Dict:
    """Every dry run on this rank (:func:`dryrun_flagship`)."""
    est = flagship_estimator()
    out = {}
    if torch.distributed.get_rank() == 0:
        out["device_pool"] = dryrun_device_pool(n_devices, est)
    out["spatial"] = dryrun_spatial_estimator(n_devices, est)
    out["tp"] = dryrun_tp_estimator(n_devices, est)
    out["pp"] = dryrun_pp(n_devices)
    out["pp_train"] = dryrun_pp_train(n_devices)
    out["cpm_train"] = dryrun_cpm_train(n_devices)
    if n_devices % 2 == 0 and n_devices >= 4:
        out["dp_tp"] = dryrun_dp_tp_estimator(n_devices)
        out["dp_sp_train"] = dryrun_dp_sp_train(n_devices, crop=96, spatial=2)
    else:
        print(f"dryrun: the composed meshes SKIPPED (need an even device count >= 4, have "
              f"{n_devices})", flush=True)
    for r in out.values():
        for k in ("params", "ref_params", "packed", "new", "inputs", "outputs"):
            r.pop(k, None)
    return out


def dryrun_flagship(n_devices: int, devices: Optional[Sequence[str]] = None,
                    timeout: float = 1800.0) -> List[Dict]:
    """Spawn ``n_devices`` ranks (default one a card, or all on ``cuda:0``
    when there is one card) and run every dry run on them."""
    from .dp import spawn

    if devices is None:
        cards = torch.cuda.device_count()
        if not cards:
            raise RuntimeError("no card: pass devices=['cpu'] * n for a run on the host")
        devices = [f"cuda:{i % cards}" for i in range(n_devices)]
    return spawn(flagship_rank, n_devices, list(devices), args=(n_devices,), timeout=timeout)


# ------------------------------------------------------------ named cases


def rank_cases(cases: Sequence[Tuple[str, Mapping[str, Any]]], mkldnn: bool = True,
               thresholds: Optional[Mapping[str, float]] = None) -> Dict[str, Any]:
    """Run named cases on this rank in order: ``(name of a function of this
    module, kwargs)``; a name may carry a ``#tag`` to run a function twice.  ``mkldnn``: oneDNN's CPU
    convolutions on or off (the CPU tests turn it off to compare with
    XLA); ``thresholds``: the estimators' ``{"nms", "inter"}``."""
    torch.backends.mkldnn.enabled = bool(mkldnn)
    _THR.clear()
    _THR.update(thresholds or {})
    dev = rank_device()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out: Dict[str, Any] = {}
    for name, kw in cases:
        t0 = time.perf_counter()
        out[name] = globals()[name.split("#")[0]](**dict(kw))
        out[name]["seconds"] = time.perf_counter() - t0
    out["peak_gib"] = _peak_gib(dev)
    return out


def case_estimator(kind: str, n_devices: int, weights, frames, stages: int = 2,
                   net_w: int = 128, net_h: int = 80, batch: int = 1, pair_cap=None,
                   keep_heatmap: bool = False) -> Dict:
    """A sharded estimator (``kind``: spatial, tp or dp_tp, the latter on a
    (n/2) x 2 mesh) on given weights and frames: of u8 input, or with
    ``keep_heatmap`` the heatmap estimator of f32 canvases (dp_tp: frames
    with a leading axis split over ``data``)."""
    est = flagship_estimator(net_w, net_h, stages, weights=weights, batch=batch,
                             input_u8=not keep_heatmap, pair_cap=pair_cap,
                             keep_heatmap=keep_heatmap)
    if kind == "spatial":
        return dryrun_spatial_estimator(n_devices, est, frames)
    if kind == "tp":
        return dryrun_tp_estimator(n_devices, est, frames)
    return dryrun_dp_tp_estimator(n_devices, 2, est, frames)


def case_halo_forward(n_devices: int, proto, weights, inputs, outputs) -> Dict:
    """``sp.make_spatial_forward`` of a net on given weights and inputs:
    the whole outputs (numpy)."""
    from ..core.net import Net
    from .sp import make_spatial_forward

    dev = rank_device()
    net = Net(proto, device=dev)
    net.load_weights(weights)
    mesh = make_mesh(n_devices, "spatial", dev)
    with torch.no_grad():
        out = make_spatial_forward(mesh, net, outputs)(
            {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()})
    return {k: v.cpu().numpy() for k, v in out.items()}


def case_gloo_probe(timeout: float = 30.0) -> Dict:
    """Which collectives gloo takes on this rank's CUDA tensors natively
    (the port routes them all through host buffers): each tried once in a
    group with a short timeout, "ok" or the error's first line.
    Point-to-point is not tried: gloo refuses a CUDA tensor there ("writev
    ... Bad address"), and the refusal can end the process from gloo's I/O
    thread instead of raising."""
    import datetime

    import torch.distributed as dist

    dev = rank_device()
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout))
    n = dist.get_world_size()
    t = torch.ones(4, device=dev)
    trials = {
        "all_reduce": lambda: dist.all_reduce(t, group=group),
        "broadcast": lambda: dist.broadcast(t, 0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(n)], t,
                                              group=group),
    }
    out = {}
    for name, fn in trials.items():
        try:
            fn()
            torch.cuda.synchronize(dev) if dev.type == "cuda" else None
            out[name] = "ok"
        except Exception as e:  # the probe's finding
            out[name] = str(e).splitlines()[0][:160]
    dist.barrier()
    return out


def case_halo_grad(n_devices: int, proto, weights, inputs, outputs, top_diffs) -> Dict:
    """The gradients of sum(output * diff) through the H-sharded forward
    (``sp._Window``'s and ``sp._Gather``'s backwards): each rank its slab,
    the parameter gradients summed over the ranks (averaged for the layers
    run whole) and the input's rows all-gathered -> ``(input diffs,
    parameter diffs)`` whole (numpy), as ``Net.backward`` gives them on one
    device."""
    from ..core.net import Net
    from .mesh2d import reduce_grads
    from .sp import RowShard

    dev = rank_device()
    net = Net(proto, device=dev)
    net.load_weights(weights)
    mesh = make_mesh(n_devices, "spatial", dev)
    shard = RowShard(mesh)
    feed = {k: v.requires_grad_(True) for k, v in shard.place(
        {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in inputs.items()}).items()}
    params = net.layer_blobs()
    for ps in params.values():
        for p in ps:
            p.requires_grad_(True)
    out = net.forward(feed, outputs=list(outputs), shard=shard)
    total = sum((shard.whole(k, out[k]).float()
                 * torch.from_numpy(np.asarray(top_diffs[k])).to(dev)).sum() for k in outputs)
    flat = [p for ps in params.values() for p in ps]
    grads = torch.autograd.grad(total, list(feed.values()) + flat)
    it = iter(g.contiguous() for g in grads[len(feed):])
    pgrads = {k: [next(it) for _ in ps] for k, ps in params.items()}
    reduce_grads(mesh, shard, pgrads, [], ["spatial"], [])
    in_diffs = {k: shard.whole(k, g).cpu().numpy()
                for k, g in zip(feed, grads[: len(feed)])}
    return {"inputs": in_diffs,
            "params": {k: [g.cpu().numpy() for g in gs] for k, gs in pgrads.items()},
            "whole_layers": sorted(shard.whole_layers)}


def case_tp_forward(n_devices: int, proto, weights, inputs, outputs) -> Dict:
    """``tp.make_tp_forward`` of a net on given weights (whole, sharded in
    the call; None: the net's seed-0 fill) and inputs (None: pixels from
    :func:`synthetic_batch`), held to the one-device forward on this rank
    at JAX's dry-run rule (rtol/atol 2e-4): the outputs, this rank's share
    of the bytes and the ms of both."""
    from ..core.net import Net
    from .tp import make_tp_forward, share_bytes, shard_params_channelwise

    dev = rank_device()
    net = Net(proto, device=dev)
    if weights is not None:
        net.load_weights(weights)
    if inputs is None:
        inputs = {"data": synthetic_batch(proto)["data"]}
    mesh = make_mesh(n_devices, "model", dev)
    whole = net.layer_blobs()
    mine = shard_params_channelwise(mesh, whole)
    fn = make_tp_forward(mesh, net, outputs)
    res: Dict[str, Any] = {"share": share_bytes(mine) / share_bytes(whole)}
    with torch.no_grad():
        feed = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
        a, b = fn(mine, feed), fn(whole, feed)
        for k in a:
            assert torch.equal(a[k], b[k]), k  # pre-sharded and whole weights run alike
        a, res["ms"] = _timed(lambda: fn(mine, feed), dev)
        local = {k: v.to(dev) for k, v in feed.items()}
        net.forward(local, outputs=list(outputs))  # warm-up
        one, res["single_ms"] = _timed(lambda: net.forward(local, outputs=list(outputs)), dev)
    res["max_abs_err"] = max(float((a[k] - one[k]).abs().max()) for k in outputs)
    for k in outputs:
        err = (a[k] - one[k]).abs() - 2e-4 * one[k].abs()
        assert float(err.max()) <= 2e-4, f"tp {k}: {float(err.max())} off one device"
    res["out"] = {k: v.cpu().numpy() for k, v in a.items()}
    return res


def synthetic_batch(proto, seed: int = 0, classes: int = 1000) -> Dict[str, np.ndarray]:
    """A classifier's global batch for its input blobs: ``label`` class ids
    in [0, ``classes``) as f32, the others pixels uniform in [-128, 128)
    (mean-subtracted images' scale)."""
    from ..core.net import _net_parameter

    npm = _net_parameter(proto)
    dims = ([[int(d) for d in sh["dim"]] for sh in npm["input_shape"]] if npm.get("input_shape")
            else np.reshape([int(d) for d in npm["input_dim"]], (-1, 4)).tolist())
    shapes = dict(zip(npm["input"], dims))
    rs = np.random.RandomState(seed)
    return {k: (rs.randint(0, classes, shapes[k]).astype(np.float32) if k == "label"
                else ((rs.rand(*shapes[k]) - 0.5) * 256.0).astype(np.float32))
            for k in shapes}


SPATIAL_STEPS, SPATIAL_LR = 3, 0.01


def case_spatial_train(n_devices: int, proto, batch=None, weights=None) -> Dict:
    """A net's train step over 1 x n spatial ranks against the one-rank
    step on the same global ``batch`` (numpy arrays; None:
    :func:`synthetic_batch`) and weights (given, else the net's seed-0
    fill), the reference run first on rank 0 alone: the loss within 1e-3
    and every parameter blob within rtol 2e-3, atol 2e-5 after one step
    (JAX ``mesh2d.dryrun_dp_sp_train``'s rule); then 2 more steps, after
    which the parameters of the layers run whole (the replicated tail) are
    bit for bit the same on every rank.  SGD at 0.01, momentum 0.9, weight
    decay 5e-4."""
    from ..core.net import Net
    from ..proto import caffe_pb, prototxt
    from ..training.solver import init_history, make_update_fn
    from .dp import net_loss_fn
    from .mesh2d import make_dp_sp_train_step, make_mesh2d

    dev = rank_device()
    lr, steps = SPATIAL_LR, SPATIAL_STEPS
    if batch is None:
        batch = synthetic_batch(proto)
    sp_view = caffe_pb.view(prototxt.parse(
        f"base_lr: {lr} lr_policy: 'fixed' momentum: 0.9 weight_decay: 5e-4",
        "SolverParameter"), "SolverParameter")

    def build():
        net = Net(proto, phase="TRAIN", device=dev)
        if weights is not None:
            net.load_weights(weights)
        lr_m, dm, params = {}, {}, {}
        for name, _, prm, lm, d in net.learnable():
            params.setdefault(name, []).append(prm)
            lr_m.setdefault(name, []).append(lm)
            dm.setdefault(name, []).append(d)
        return net, params, make_update_fn("SGD", sp_view, lr_m, dm)

    mesh = make_mesh2d(n_devices, spatial=n_devices, device=dev)
    out: Dict[str, Any] = {}
    ref = None
    if mesh.rank == 0:
        net, params, update = build()
        step1, hist1 = _single_step(net, update), init_history("SGD", params)
        out["ref_loss"], out["ref_step_ms"] = _timed(lambda: step1(params, hist1, batch, lr, 0),
                                                     dev)
        ref = _params_np(params)
        if _warm_timing(dev):
            _, out["ref_step_ms"] = _timed(lambda: step1(params, hist1, batch, lr, 1), dev)
        del net, params, hist1
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    torch.distributed.barrier()  # the reference ran alone on the card
    net, params, update = build()
    step = make_dp_sp_train_step(mesh, net_loss_fn(net), update)
    history = init_history("SGD", params)
    out["loss"], out["step_ms"] = _timed(lambda: step(params, history, batch, lr, 0), dev)
    got = _params_np(params)
    for it in range(1, steps):
        out["losses_after"] = out.get("losses_after", []) + [step(params, history, batch, lr, it)]
    if steps > 1 and _warm_timing(dev):
        _, out["step_ms"] = _timed(lambda: step(params, history, batch, lr, steps), dev)
    out["peak_gib"] = _peak_gib(dev)
    # the layers the last step ran whole: their parameters on every spatial rank
    tail = sorted(k for k in params if k in step.shard.whole_layers)
    flat = torch.cat([p.detach().reshape(-1) for k in tail for p in params[k]]) if tail else None
    if flat is not None:
        peers = mesh.all_gather(flat, "spatial")
        out["tail_identical"] = all(torch.equal(flat, p) for p in peers)
        assert out["tail_identical"], "the replicated tail's parameters differ across ranks"
    out["tail_layers"] = tail
    if ref is not None:
        assert abs(out["loss"] - out["ref_loss"]) <= 1e-3 * max(1.0, abs(out["ref_loss"])), (
            f"spatial loss {out['loss']} != one rank's {out['ref_loss']}")
        for k in ref:
            for a, b in zip(got[k], ref[k]):
                np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5, err_msg=k)
        if not _warm_timing(dev):  # the CPU tests compare them with JAX's
            out["params"], out["ref_params"] = got, ref
    print(f"case_spatial_train({n_devices}): 1x{n_devices} spatial step == one rank (loss "
          f"{out['loss']:.6f}); tail {tail} equal on every rank OK", flush=True)
    return out


def case_solver(n_devices: int, proto, weights, batches, solver: str, spatial: int = 1,
                transform=None) -> Dict:
    """``Solver(mesh=)`` over ``n_devices`` ranks (``spatial`` > 1: a data x
    spatial mesh) for ``len(batches)`` iterations on given global batches:
    the losses and the parameters after.  ``transform``: the solver's
    ``input_transform`` as ``(function name of labels_device, kwargs)``."""
    from ..core.net import Net
    from ..training.solver import Solver
    from .mesh2d import make_mesh2d

    dev = rank_device()
    net = Net(proto, phase="TRAIN", device=dev)
    net.load_weights(weights)
    mesh = (make_mesh2d(n_devices, spatial=spatial, device=dev) if spatial > 1
            else make_mesh(n_devices, "data", dev))
    s = Solver(solver, net, lambda it: batches[it], mesh=mesh,
               input_transform=_transform(transform))
    losses = [s.step(1) for _ in batches]
    return {"losses": losses, "params": _params_np(s.params)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    devices = ["cpu"] * args.n if args.device == "cpu" else None
    dryrun_flagship(args.n, devices, args.timeout)
    print(f"dryrun_flagship({args.n}): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
