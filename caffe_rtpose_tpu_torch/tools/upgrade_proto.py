"""upgrade_net_proto_text / upgrade_net_proto_binary /
upgrade_solver_proto_text analogs (reference tools/upgrade_*.cpp).

The port of ``caffe_rtpose_tpu/tools/upgrade_proto.py`` on the port's own
codec (``caffe_rtpose_tpu_torch/proto``).  Run:

    python -m caffe_rtpose_tpu_torch upgrade {net_text,net_binary,solver_text} IN OUT

Reading through our codec performs the V1->V2 layer upgrade
(``caffemodel.load_net_parameter``); writing re-emits the modern format.
"""

from __future__ import annotations

import argparse
import sys

from ..proto import caffemodel, prototxt


def upgrade_net_proto_text(inp: str, out: str) -> int:
    from ..proto.upgrade import upgrade_net_as_needed

    msg = prototxt.parse_file(inp, "NetParameter")
    msg = upgrade_net_as_needed(msg, upgrade_input=True)
    prototxt.dump_file(msg, out)
    print(f"Wrote upgraded NetParameter text proto to {out}")
    return 0


def upgrade_net_proto_binary(inp: str, out: str) -> int:
    from ..proto.upgrade import upgrade_net_as_needed, upgrade_net_input

    msg = caffemodel.load_net_parameter(inp)  # runs the upgrade chain
    if msg.get("input"):
        upgrade_net_input(msg)
    caffemodel.save_net_parameter(msg, out)
    print(f"Wrote upgraded NetParameter binary proto to {out}")
    return 0


def upgrade_solver_proto_text(inp: str, out: str) -> int:
    msg = prototxt.parse_file(inp, "SolverParameter")
    # legacy solver_type enum -> modern string type (upgrade_proto.cpp
    # UpgradeSolverType)
    if "solver_type" in msg and "type" not in msg:
        names = {0: "SGD", 1: "Nesterov", 2: "AdaGrad", 3: "RMSProp", 4: "AdaDelta", 5: "Adam"}
        msg["type"] = names[msg.pop("solver_type")]
    prototxt.dump_file(msg, out, "SolverParameter")
    print(f"Wrote upgraded SolverParameter text proto to {out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="upgrade_proto", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    for name, fn in (("net_text", upgrade_net_proto_text),
                     ("net_binary", upgrade_net_proto_binary),
                     ("solver_text", upgrade_solver_proto_text)):
        s = sub.add_parser(name)
        s.add_argument("input")
        s.add_argument("output")
        s.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args.input, args.output)


if __name__ == "__main__":
    sys.exit(main())
