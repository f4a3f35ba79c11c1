"""Plot curves from `caffe train` logs.

A copy of ``caffe_rtpose_tpu/tools/plot_training_log.py`` (the counterpart
of the reference's tools/extra/plot_training_log.py.example): the same 8
chart types over one or more logs, parsed with ``tools/parse_log.py``.
:func:`extract_series` needs no plotting library; ``matplotlib`` is
imported only to draw, and without it the tool exits with status 2 and
says so.

CLI: ``python -m caffe_rtpose_tpu_torch.tools.plot_training_log
<chart_type 0-7> <out.png> <log> [log ...]``

    0: Test accuracy  vs. Iters     1: Test accuracy  vs. Seconds
    2: Test loss      vs. Iters     3: Test loss      vs. Seconds
    4: Train lr       vs. Iters     5: Train lr       vs. Seconds
    6: Train loss     vs. Iters     7: Train loss     vs. Seconds

"accuracy"/"loss" pick the first output column whose name contains that
substring (falling back to the first output column), so CPM nets whose
losses are named per-stage plot without renaming.
"""

from __future__ import annotations

import argparse
import os
import sys

from .parse_log import parse_log

CHARTS = {
    0: ("test", "accuracy", "NumIters", "Test accuracy vs. Iters"),
    1: ("test", "accuracy", "Seconds", "Test accuracy vs. Seconds"),
    2: ("test", "loss", "NumIters", "Test loss vs. Iters"),
    3: ("test", "loss", "Seconds", "Test loss vs. Seconds"),
    4: ("train", "lr", "NumIters", "Train learning rate vs. Iters"),
    5: ("train", "lr", "Seconds", "Train learning rate vs. Seconds"),
    6: ("train", "loss", "NumIters", "Train loss vs. Iters"),
    7: ("train", "loss", "Seconds", "Train loss vs. Seconds"),
}
_META_COLS = ("NumIters", "Seconds", "LearningRate")


def _pick_column(rows, want: str) -> str:
    if want == "lr":
        return "LearningRate"
    names = [k for k in rows[0] if k not in _META_COLS]
    if not names:
        raise ValueError(f"log has no output columns (wanted {want!r})")
    for n in names:
        if want in n.lower():
            return n
    if want == "loss":
        # losses rarely carry the word (CPM stages: loss_stage1_L1, but
        # also just "l"): any non-accuracy column is the loss
        other = [n for n in names if "accuracy" not in n.lower()]
        if other:
            return other[0]
    return names[0]


def extract_series(log_path: str, chart_type: int):
    """(x, y, series_label) for one log — importable for tests/headless."""
    phase, want, xcol, _ = CHARTS[chart_type]
    train_rows, test_rows = parse_log(log_path)
    rows = train_rows if phase == "train" else test_rows
    if not rows:
        raise ValueError(f"{log_path}: no {phase} rows parsed")
    ycol = _pick_column(rows, want)
    x = [r[xcol] for r in rows]
    y = [r[ycol] for r in rows]
    return x, y, f"{os.path.basename(log_path)}: {ycol}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="plot_training_log",
        description="Plot training curves from caffe train logs")
    p.add_argument("chart_type", type=int, choices=sorted(CHARTS))
    p.add_argument("output_png")
    p.add_argument("logs", nargs="+")
    args = p.parse_args(argv)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not available in this environment; use "
              "parse_log to produce CSVs and plot elsewhere",
              file=sys.stderr)
        return 2

    _, _, xcol, title = CHARTS[args.chart_type]
    fig, ax = plt.subplots(figsize=(8, 5))
    for log in args.logs:
        x, y, label = extract_series(log, args.chart_type)
        ax.plot(x, y, marker=".", linewidth=1.2, label=label)
    ax.set_xlabel(xcol)
    ax.set_title(title)
    ax.legend(loc="best", fontsize=8)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.output_png, dpi=110)
    print(f"Saved {args.output_png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
