"""Net summarization tool — tabular at-a-glance view of a prototxt.

The port of ``caffe_rtpose_tpu/tools/summarize.py``, the counterpart of
the reference's tools/extra/summarize.py (layer table with
cyclically-colored blob names, param descriptors, disconnected-bottom
highlighting), plus one thing the reference cannot do from the prototxt
alone: ``--shapes`` builds the port's ``Net`` on ``--device`` (the card by
default, ``cpu`` on the host) and appends each layer's top shapes from its
shape inference (``Net.blob_shapes``, Caffe's N x C x H x W).

CLI: ``python -m caffe_rtpose_tpu_torch.tools.summarize [-s] [-p PHASE]
[--device cuda|cpu] net.prototxt``
"""

from __future__ import annotations

import argparse
from typing import Dict, List

# ANSI colors cycled over blob names; red background marks a bottom no
# layer/input produced (same visual convention as the reference tool)
_COLORS = ["92", "93", "94", "95", "97", "96", "42", "43;30", "100",
           "104", "103;30", "107;30"]
_DISCONNECTED = "41"


def _param_desc(lv) -> str:
    """Short per-layer param descriptor: filler types, lr/decay mults,
    shared-param names (reference format_param spirit)."""
    bits: List[str] = []
    for p in lv.raw.get("param", []):
        item = []
        if p.get("name"):
            item.append(str(p["name"]))
        lr, dc = p.get("lr_mult"), p.get("decay_mult")
        if lr is not None or dc is not None:
            item.append(f"x{lr if lr is not None else 1:g}"
                        + (f"/d{dc:g}" if dc is not None else ""))
        bits.append(" ".join(item) or "-")
    fillers = []
    for key in ("weight_filler", "bias_filler"):
        for pkey, pv in lv.raw.items():
            if not isinstance(pv, dict) or key not in pv:
                continue
            f = pv[key]
            desc = str(f.get("type", "constant"))
            for fk in ("value", "std", "min", "max"):
                if fk in f:
                    desc += f" {fk}={f[fk]:g}"
            fillers.append(desc)
    out = ", ".join(bits)
    if fillers:
        out = (out + " | " if out else "") + "; ".join(fillers)
    return out


def summarize(path: str, phase: str = "TRAIN", shapes: bool = False,
              color: bool = True, device: str = "cuda") -> str:
    """Build the summary table; returns the printable string.  ``device``:
    where ``shapes`` builds the net."""
    from ..core.net import Net
    from ..proto import prototxt

    msg = prototxt.parse_file(path, "NetParameter")
    layers = msg.get("layer", []) or msg.get("layers", [])

    produced = set(msg.get("input", []))
    color_of: Dict[str, str] = {}

    def paint(blob: str, is_bottom: bool) -> str:
        if blob not in color_of:
            color_of[blob] = _COLORS[len(color_of) % len(_COLORS)]
        c = color_of[blob]
        if is_bottom and blob not in produced:
            c = _DISCONNECTED
        return f"\x1b[{c}m{blob}\x1b[0m" if color else blob

    top_shapes: Dict[str, tuple] = {}
    if shapes:
        top_shapes = dict(Net(path, phase=phase, device=device).blob_shapes)

    class _LV:  # tiny view for _param_desc
        def __init__(self, raw):
            self.raw = raw

    rows = []
    for lv in layers:
        name = str(lv.get("name", "?"))
        typ = str(lv.get("type", "?"))
        bots = [paint(b, True) for b in lv.get("bottom", [])]
        tops = []
        for t in lv.get("top", []):
            produced.add(t)
            s = paint(t, False)
            if shapes and t in top_shapes:
                s += "\x00" + "x".join(str(d) for d in top_shapes[t])
            tops.append(s)
        rows.append((name, typ, ", ".join(bots), ", ".join(tops),
                     _param_desc(_LV(lv))))

    headers = ("Layer", "Type", "Bottoms", "Tops", "Params")
    # column widths on the VISIBLE text (strip ANSI + shape marker)
    import re
    vis = lambda s: len(re.sub("\x1b\\[[0-9;]*m", "", s.replace("\x00", " ")))  # noqa: E731
    widths = [max(len(h), *(vis(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    out.append("  ".join("-" * w for w in widths))
    for r in rows:
        cells = [c.replace("\x00", " ") + " " * (w - vis(c))
                 for c, w in zip(r, widths)]
        out.append("  ".join(cells).rstrip())
    out.append(f"{len(rows)} layers, {len(color_of)} blobs"
               + (f" (phase {phase})" if shapes else ""))
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="summarize", description="Tabular summary of a net prototxt")
    p.add_argument("prototxt")
    p.add_argument("-s", "--shapes", action="store_true",
                   help="build the graph and show top shapes (caffe NCHW)")
    p.add_argument("-p", "--phase", default="TEST", choices=["TRAIN", "TEST"])
    p.add_argument("--no-color", action="store_true")
    p.add_argument("--device", default="cuda", help="where --shapes builds the net: cuda or cpu")
    args = p.parse_args(argv)
    print(summarize(args.prototxt, phase=args.phase, shapes=args.shapes,
                    color=not args.no_color, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
