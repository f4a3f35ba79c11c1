"""The port's multi-process dry run (caffe_rtpose_tpu_torch/parallel/
multihost.py) on the CPU: two worker processes joined through a TCP store
run one data-parallel step of the full 6-stage CPM train net, held to one
process on the same global batch by JAX's tolerances (loss rtol 1e-5;
each layer's parameter sums rtol 1e-4, atol 1e-5; asserted inside
``dryrun_multihost``).  Crop 32 and global batch 4 keep it to seconds (the
graph is the 6-stage one at its full widths); each worker has a 300 s limit
and is killed past it.

The card-only test spawns two ranks sharing the card (gloo) and holds the
sharded estimators to the one-device one, with the peak-mask kernel K1
launched once a frame on each rank.  Imports no jax: it runs on the card's
machine with ``python3 -m pytest --noconftest -m cuda
tests/test_torch_multihost.py``."""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.parallel import dp, dryrun, multihost

CROP, BATCH, TIMEOUT = 32, 4, 300


@pytest.fixture(scope="module")
def digests():
    return multihost.dryrun_multihost(num_processes=2, crop=CROP, batch=BATCH, timeout=TIMEOUT,
                                      device="cpu", threads=1)


def test_two_processes_match_one(digests):
    m, s = digests["multi"], digests["single"]
    assert (m["num_processes"], s["num_processes"]) == (2, 1)
    assert m["backend"] == s["backend"] == "gloo"
    np.testing.assert_allclose(m["loss"], s["loss"], rtol=1e-5)
    # every learnable blob of the 6-stage graph is in the digest
    assert len(m["param_sums"]) == len(s["param_sums"]) > 6 * 14
    for name, sums in s["param_sums"].items():
        np.testing.assert_allclose(m["param_sums"][name], sums, rtol=1e-4, atol=1e-5)


def test_global_batch_is_jax_draw_order():
    """The dry-run batch is JAX's (multihost.py: data then labels from
    RandomState(0)), in Caffe's layout."""
    b = multihost.cpm_global_batch(2, 16)
    rs = np.random.RandomState(0)
    np.testing.assert_array_equal(b["data"], rs.rand(2, 3, 16, 16).astype(np.float32) - 0.5)
    np.testing.assert_array_equal(b["label"], rs.rand(2, 114, 2, 2).astype(np.float32))


def test_a_failing_worker_raises():
    """A worker that cannot start (no such device) fails the dry run with
    its log, instead of hanging it."""
    with pytest.raises(RuntimeError, match="worker failed"):
        multihost.dryrun_multihost(num_processes=2, crop=CROP, batch=BATCH, timeout=TIMEOUT,
                                   device="meta:0")


@pytest.mark.cuda
def test_sharded_estimators_launch_k1_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = [(np.random.RandomState(s).rand(1, 80, 128, 3) * 255).astype(np.uint8)
              for s in range(3)]
    cases = [(f"case_estimator#{k}", dict(kind=k, n_devices=2, weights=None, frames=frames))
             for k in ("spatial", "tp")]
    for r in dp.spawn(dryrun.rank_cases, 2, ["cuda:0"] * 2, args=(cases, True, {"nms": 0.0}),
                      timeout=TIMEOUT):
        for k in ("spatial", "tp"):
            assert r[f"case_estimator#{k}"]["k1_launches"] == len(frames)
