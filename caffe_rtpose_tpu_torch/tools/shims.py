"""Deprecated single-purpose tool shims (reference tools/train_net.cpp,
test_net.cpp, finetune_net.cpp, net_speed_benchmark.cpp — each a 7-line
"deprecated, use caffe <brew>" wrapper), the port of
``caffe_rtpose_tpu/tools/shims.py``.  Same positional CLIs, same
deprecation warning, delegating to the port's caffe tool
(``tools/caffe_tool.py``), which runs on the card; ``--device cpu`` after
the shim's name is passed on to it:

  python -m caffe_rtpose_tpu_torch.tools.shims train_net  <solver> [snapshot]
  python -m caffe_rtpose_tpu_torch.tools.shims test_net   <net> <weights> <iters>
  python -m caffe_rtpose_tpu_torch.tools.shims finetune_net <solver> <weights>
  python -m caffe_rtpose_tpu_torch.tools.shims net_speed_benchmark <net> [iters]
"""

from __future__ import annotations

import sys
from typing import List, Optional


def _deprecate(old: str, new: str):
    print(f"{old} is deprecated. Use {new} instead.", file=sys.stderr)


def train_net(argv: List[str], device: List[str] = ()) -> int:
    from .caffe_tool import main

    _deprecate("train_net", "caffe train")
    args = ["train", "--solver", argv[0]]
    if len(argv) > 1:
        args += ["--snapshot", argv[1]]
    return main(args + list(device))


def test_net(argv: List[str], device: List[str] = ()) -> int:
    from .caffe_tool import main

    _deprecate("test_net", "caffe test")
    args = ["test", "--model", argv[0], "--weights", argv[1]]
    if len(argv) > 2:
        args += ["--iterations", argv[2]]
    return main(args + list(device))


def finetune_net(argv: List[str], device: List[str] = ()) -> int:
    from .caffe_tool import main

    _deprecate("finetune_net", "caffe train")
    return main(["train", "--solver", argv[0], "--weights", argv[1], *device])


def net_speed_benchmark(argv: List[str], device: List[str] = ()) -> int:
    from .caffe_tool import main

    _deprecate("net_speed_benchmark", "caffe time")
    args = ["time", "--model", argv[0]]
    if len(argv) > 1:
        args += ["--iterations", argv[1]]
    return main(args + list(device))


SHIMS = {
    "train_net": (train_net, 1, "train_net <solver> [snapshot]"),
    "test_net": (test_net, 2, "test_net <net> <weights> [iterations]"),
    "finetune_net": (finetune_net, 2, "finetune_net <solver> <weights>"),
    "net_speed_benchmark": (net_speed_benchmark, 1,
                            "net_speed_benchmark <net> [iterations]"),
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in SHIMS:
        print(f"usage: shims {{{'|'.join(SHIMS)}}} args... [--device cuda|cpu]", file=sys.stderr)
        return 2
    fn, min_args, usage = SHIMS[argv[0]]
    args, device = argv[1:], []
    if "--device" in args:
        i = args.index("--device")
        device, args = args[i: i + 2], args[:i] + args[i + 2:]
    if len(args) < min_args or (device and len(device) < 2):
        print(f"usage: {usage} [--device cuda|cpu]", file=sys.stderr)
        return 2
    return fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
