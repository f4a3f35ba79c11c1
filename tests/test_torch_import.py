"""The PyTorch port imports without jax: neither directly nor through the
JAX package (whose ``__init__`` imports jax); and without OpenCV or h5py,
also with all three blocked at once (the card's machine has none of them).
An HDF5 round trip through the port's codec loads no h5py, blocked or not;
CLAHE, the synthetic source and the text overlay run with all three (and
fontTools) blocked.  Only
``pipeline/runner.py`` and ``proto/datum.py`` name ``import cv2`` in their
source.  ``proto.caffe_pb2`` is left out: it runs protoc when imported."""

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
    "caffe_rtpose_tpu_torch.pipeline.image_io",
    "caffe_rtpose_tpu_torch.pipeline.queues",
    "caffe_rtpose_tpu_torch.pipeline.runner",
    "caffe_rtpose_tpu_torch.pipeline.video",
    "caffe_rtpose_tpu_torch.pipeline.bmff",
    "caffe_rtpose_tpu_torch.pipeline.mpeg4",
    "caffe_rtpose_tpu_torch.tools.rtpose",
    "caffe_rtpose_tpu_torch.__main__",
    "caffe_rtpose_tpu_torch.proto",
    "caffe_rtpose_tpu_torch.proto.wire",
    "caffe_rtpose_tpu_torch.proto.caffe_pb",
    "caffe_rtpose_tpu_torch.proto.prototxt",
    "caffe_rtpose_tpu_torch.proto.upgrade",
    "caffe_rtpose_tpu_torch.proto.caffemodel",
    "caffe_rtpose_tpu_torch.tools.upgrade_proto",
    "caffe_rtpose_tpu_torch.serving",
    "caffe_rtpose_tpu_torch.parallel",
    "caffe_rtpose_tpu_torch.parallel.inference",
    "caffe_rtpose_tpu_torch.tools.export_tool",
    "caffe_rtpose_tpu_torch.tools.eval_pose",
    "caffe_rtpose_tpu_torch.ops.losses",
    "caffe_rtpose_tpu_torch.core.filler",
    "caffe_rtpose_tpu_torch.proto.datum",
    "caffe_rtpose_tpu_torch.utils.db",
    "caffe_rtpose_tpu_torch.utils.leveldb_fmt",
    "caffe_rtpose_tpu_torch.utils.hdf5_fmt",
    "caffe_rtpose_tpu_torch.utils.hdf5",
    "caffe_rtpose_tpu_torch.utils.imgproc",
    "caffe_rtpose_tpu_torch.utils.truetype",
    "caffe_rtpose_tpu_torch.utils.text",
    "caffe_rtpose_tpu_torch.utils.signals",
    "caffe_rtpose_tpu_torch.utils.timer",
    "caffe_rtpose_tpu_torch.utils.profiler",
    "caffe_rtpose_tpu_torch.training",
    "caffe_rtpose_tpu_torch.training.joints",
    "caffe_rtpose_tpu_torch.training.transformer",
    "caffe_rtpose_tpu_torch.training.datasets",
    "caffe_rtpose_tpu_torch.training.labels_device",
    "caffe_rtpose_tpu_torch.training.solver",
    "caffe_rtpose_tpu_torch.training.cpm_lmdb",
    "caffe_rtpose_tpu_torch.training.pose_db",
    "caffe_rtpose_tpu_torch.tools.caffe_tool",
    "caffe_rtpose_tpu_torch.ops.elementwise",
    "caffe_rtpose_tpu_torch.ops.cpm_legacy",
    "caffe_rtpose_tpu_torch.core.layers",
    "caffe_rtpose_tpu_torch.core.layers_extra",
    "caffe_rtpose_tpu_torch.core.data_layers",
    "caffe_rtpose_tpu_torch.core.insert_splits",
    "caffe_rtpose_tpu_torch.core.net_spec",
    "caffe_rtpose_tpu_torch.coord_map",
    "caffe_rtpose_tpu_torch.proto.gen_proto",
    "caffe_rtpose_tpu_torch.models.caffenet",
    "caffe_rtpose_tpu_torch.api",
    "caffe_rtpose_tpu_torch.tools.classify",
    "caffe_rtpose_tpu_torch.tools.parse_log",
    "caffe_rtpose_tpu_torch.tools.plot_training_log",
    "caffe_rtpose_tpu_torch.tools.summarize",
    "caffe_rtpose_tpu_torch.tools.draw_net",
    "caffe_rtpose_tpu_torch.tools.shims",
    "caffe_rtpose_tpu_torch.tools.aux_tools",
    "caffe_rtpose_tpu_torch.tools.detect",
    "caffe_rtpose_tpu_torch.matlab_engine",
    "caffe_rtpose_tpu_torch.parallel.dp",
    "caffe_rtpose_tpu_torch.parallel.multihost",
    "caffe_rtpose_tpu_torch.parallel.sp",
    "caffe_rtpose_tpu_torch.parallel.tp",
    "caffe_rtpose_tpu_torch.parallel.mesh2d",
    "caffe_rtpose_tpu_torch.parallel.pp",
    "caffe_rtpose_tpu_torch.parallel.dryrun",
]


# a chunked gzip dataset appended in mode 'a', a string, read back
HDF5_ROUND_TRIP = (
    "import os, tempfile\n"
    "import numpy as np\n"
    "from caffe_rtpose_tpu_torch.utils import hdf5\n"
    "p = os.path.join(tempfile.mkdtemp(), 'r.h5')\n"
    "with hdf5.File(p, 'w') as f:\n"
    "    f.create_dataset('x', data=np.arange(6.0).reshape(2, 3), maxshape=(None, 3),\n"
    "                     compression='gzip')\n"
    "    f['s'] = 'text'\n"
    "with hdf5.File(p, 'a') as f:\n"
    "    f['x'].resize(4, axis=0)\n"
    "    f['x'][2:] = 1.0\n"
    "with hdf5.File(p) as f:\n"
    "    assert f['x'][()].sum() == 21.0 and f['s'][()] == b'text'\n")

# do_clahe's step and the synthetic figures: OpenCV's u8 operations in numpy
IMGPROC_RUN = (
    "import numpy as np\n"
    "from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource\n"
    "from caffe_rtpose_tpu_torch.training.transformer import clahe\n"
    "img = SyntheticPoseSource(n=2, size=200, seed=1)[1][0]\n"
    "out = clahe(img, 8, 4)\n"
    "assert out.shape == img.shape and out.dtype == np.uint8 and (out != img).any()\n")

# rtpose's text overlay, drawn as OpenCV 5 draws it, from the port's font
TEXT_RUN = (
    "import numpy as np\n"
    "from caffe_rtpose_tpu_torch.utils.text import put_text_u8\n"
    "img = np.zeros((40, 120, 3), np.uint8)\n"
    "put_text_u8(img, '12.3 fps', (5, 30), 0, 0.75, (255, 150, 150), 1)\n"
    "assert len(np.unique(img[..., 0])) > 100\n")

# the only modules of the port whose source imports OpenCV (for the camera,
# the window and videos the port's readers refuse, and Datums in the formats only
# OpenCV reads)
CV2_MODULES = {os.path.join("pipeline", "runner.py"), os.path.join("proto", "datum.py")}


def _run(prelude: str, after: str = "") -> None:
    code = (prelude + "import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules or sys.modules['jax'] is None, 'jax loaded'\n"
            "assert not any(k == 'caffe_rtpose_tpu' or k.startswith('caffe_rtpose_tpu.')\n"
            "               for k in sys.modules), 'JAX package loaded'\n"
            + after + "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_slice_imports_without_jax():
    _run("", HDF5_ROUND_TRIP + "assert 'h5py' not in sys.modules, 'h5py loaded'\n")


def test_slice_imports_with_jax_blocked():
    _run("import sys\nsys.modules['jax'] = None\n")


def test_slice_imports_without_cv2():
    """The card's machine has no OpenCV: no module imports it at import
    time (the pipeline imports it only for the options that need it)."""
    _run("import sys\nsys.modules['cv2'] = None\n")
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('cv2' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "False", res.stderr


def test_slice_imports_with_jax_and_cv2_blocked():
    _run("import sys\nsys.modules['jax'] = None\nsys.modules['cv2'] = None\n")


def test_slice_imports_with_jax_cv2_and_h5py_blocked():
    """fontTools blocked too: the text overlay reads the font itself."""
    _run("import sys\nsys.modules['jax'] = None\nsys.modules['cv2'] = None\n"
         "sys.modules['h5py'] = None\nsys.modules['fontTools'] = None\n",
         HDF5_ROUND_TRIP + "assert sys.modules['h5py'] is None, 'h5py loaded'\n" + IMGPROC_RUN
         + TEXT_RUN)


def test_only_runner_and_datum_import_cv2():
    """Read from the sources, not sys.modules: an import inside a function
    counts too."""
    pkg = os.path.join(ROOT, "caffe_rtpose_tpu_torch")
    found = set()
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path, encoding="utf-8") as fh:
                    if any(line.strip() == "import cv2" or line.strip().startswith("import cv2 ")
                           or line.strip().startswith("from cv2 ") for line in fh):
                        found.add(os.path.relpath(path, pkg))
    assert found == CV2_MODULES, found
