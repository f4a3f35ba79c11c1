"""The PyTorch port imports without jax: neither directly nor through the
JAX package (whose ``__init__`` imports jax)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "caffe_rtpose_tpu_torch",
    "caffe_rtpose_tpu_torch._build",
    "caffe_rtpose_tpu_torch.native",
    "caffe_rtpose_tpu_torch.utils.device",
    "caffe_rtpose_tpu_torch.models.cpm",
    "caffe_rtpose_tpu_torch.pose.descriptor",
    "caffe_rtpose_tpu_torch.pose.preprocess",
    "caffe_rtpose_tpu_torch.ops.imresize",
    "caffe_rtpose_tpu_torch.ops.nn",
    "caffe_rtpose_tpu_torch.core.net",
    "caffe_rtpose_tpu_torch.ops.nms",
    "caffe_rtpose_tpu_torch.ops.nms_cuda",
    "caffe_rtpose_tpu_torch.pose.connect",
    "caffe_rtpose_tpu_torch.pose.estimator",
    "caffe_rtpose_tpu_torch.pose.render",
]


def _run(prelude: str) -> None:
    code = (prelude + "import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules or sys.modules['jax'] is None, 'jax loaded'\n"
            "assert not any(k == 'caffe_rtpose_tpu' or k.startswith('caffe_rtpose_tpu.')\n"
            "               for k in sys.modules), 'JAX package loaded'\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_slice_imports_without_jax():
    _run("")


def test_slice_imports_with_jax_blocked():
    _run("import sys\nsys.modules['jax'] = None\n")
