"""Net topology drawing CLI (reference python/draw_net.py), the port of
``caffe_rtpose_tpu/tools/draw_net.py``: renders a NetParameter prototxt as
Graphviz through ``api.draw_net_dot``.  Writes .dot source directly, or
pipes through the `dot` binary for image formats when Graphviz is
installed (without it, the .dot beside the asked-for file, and says so).

    python -m caffe_rtpose_tpu_torch.tools.draw_net net.prototxt net.dot
    python -m caffe_rtpose_tpu_torch.tools.draw_net net.prototxt net.png
"""

import argparse
import shutil
import subprocess
import sys


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_net_proto_file",
                        help="Input network prototxt file")
    parser.add_argument("output_image_file",
                        help="Output image (.png/.svg/.pdf) or .dot file")
    parser.add_argument("--rankdir", default="LR",
                        help="Graph direction: LR, TB, BT")
    parser.add_argument("--phase", default="ALL",
                        help="Which phase to draw: TEST, TRAIN, or ALL")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..api import draw_net_dot
    from ..core.net import _layer_included
    from ..proto import caffe_pb, prototxt

    net = prototxt.parse_file(args.input_net_proto_file)
    if args.phase in ("TRAIN", "TEST"):
        phase_i = caffe_pb.PHASE[args.phase]
        net = dict(net)
        net["layer"] = [
            l for l in net.get("layer", [])
            if _layer_included(caffe_pb.view(l, "LayerParameter"),
                               phase_i, (), 0)]
    dot = draw_net_dot(net)
    if args.rankdir != "LR":
        dot = dot.replace("rankdir=LR", f"rankdir={args.rankdir}")

    out = args.output_image_file
    if out.endswith(".dot"):
        open(out, "w").write(dot)
    else:
        fmt = out.rsplit(".", 1)[-1]
        if shutil.which("dot") is None:
            alt = out.rsplit(".", 1)[0] + ".dot"
            open(alt, "w").write(dot)
            print(f"Graphviz `dot` not installed; wrote {alt} instead "
                  f"(render with: dot -T{fmt} {alt} -o {out})")
            return 0
        subprocess.run(["dot", f"-T{fmt}", "-o", out],
                       input=dot.encode(), check=True)
    print(f"Drawing net to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
