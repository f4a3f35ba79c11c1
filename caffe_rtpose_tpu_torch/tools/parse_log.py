"""Parse a `caffe train` log into .train/.test CSV tables.

A copy of ``caffe_rtpose_tpu/tools/parse_log.py`` (the counterpart of the
reference's tools/extra/parse_log.py and the timestamp logic of
extract_seconds.py): scans a training log for
``Iteration N`` / ``lr = R`` / ``Train net output #k: name = value`` /
``Test net output #k: name = value`` lines and writes
``<logname>.train`` and ``<logname>.test`` CSVs with columns
``NumIters,Seconds,LearningRate,<output names...>``.

Works on logs from this framework's ``caffe train`` (plain stdout, no
timestamps — Seconds falls back to 0.0) and on reference glog logs
(``I0523 14:12:03.405829 ...`` prefixes — Seconds is elapsed time since
the first stamped line, day rollover handled like extract_seconds.py).

CLI: ``python -m caffe_rtpose_tpu_torch.tools.parse_log [--verbose]
[--delimiter D] logfile output_dir``.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from typing import Dict, List, Optional, Tuple

_RE_ITER = re.compile(r"Iteration (\d+)")
_RE_LR = re.compile(r"lr = ([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)")
_RE_TRAIN_OUT = re.compile(r"Train net output #(\d+): (\S+) = ([.\deE+-]+)")
_RE_TEST_OUT = re.compile(r"Test net output #(\d+): (\S+) = ([.\deE+-]+)")
# glog line prefix: [IWEF]MMDD HH:MM:SS.ffffff
_RE_GLOG_TIME = re.compile(
    r"^[IWEF](\d{2})(\d{2}) (\d{2}):(\d{2}):(\d{2})\.(\d{6})")


def _glog_seconds(line: str) -> Optional[float]:
    """Seconds-within-year of a glog-stamped line (month/day folded in as
    31-day months — only DIFFERENCES are meaningful, like the reference's
    datetime subtraction)."""
    m = _RE_GLOG_TIME.match(line)
    if not m:
        return None
    mo, d, h, mi, s, us = (int(g) for g in m.groups())
    return (((mo * 31 + d) * 24 + h) * 3600 + mi * 60 + s + us / 1e6)


def parse_log(path: str) -> Tuple[List[Dict], List[Dict]]:
    """Returns (train_rows, test_rows) — lists of dicts keyed
    NumIters/Seconds/LearningRate + one column per output blob name."""
    train_rows: List[Dict] = []
    test_rows: List[Dict] = []
    iteration = -1.0
    lr = float("nan")
    start: Optional[float] = None
    seconds = 0.0
    train_row: Optional[Dict] = None
    test_row: Optional[Dict] = None

    with open(path) as f:
        for line in f:
            it = _RE_ITER.search(line)
            if it:
                iteration = float(it.group(1))
            if iteration < 0:
                continue  # nothing to attach outputs to yet
            t = _glog_seconds(line)
            if t is not None:
                if start is None:
                    start = t
                if t < start:  # crossed a day/month boundary mid-log
                    t += 24 * 3600
                seconds = t - start
            m = _RE_LR.search(line)
            if m:
                lr = float(m.group(1))

            for regex, rows, row_attr in (
                (_RE_TRAIN_OUT, train_rows, "train"),
                (_RE_TEST_OUT, test_rows, "test"),
            ):
                m = regex.search(line)
                if not m:
                    continue
                name, value = m.group(2), float(m.group(3))
                row = train_row if row_attr == "train" else test_row
                if row is None or row["NumIters"] != iteration:
                    # a new iteration starts a new row — keyed on NumIters
                    # like the reference, so an unparseable output #0
                    # (nan/inf loss) can't merge the block into the
                    # previous iteration's row
                    row = {"NumIters": iteration, "Seconds": seconds,
                           "LearningRate": lr}
                    rows.append(row)
                row[name] = value
                if row_attr == "train":
                    train_row = row
                else:
                    test_row = row

    # rows written before the first `lr =` line inherit the first known
    # rate (reference fix_initial_nan_learning_rate)
    for rows in (train_rows, test_rows):
        known = next((r["LearningRate"] for r in rows
                      if r["LearningRate"] == r["LearningRate"]), None)
        if known is not None:
            for r in rows:
                if r["LearningRate"] != r["LearningRate"]:
                    r["LearningRate"] = known
    return train_rows, test_rows


def save_csv_files(log_path: str, output_dir: str, train_rows, test_rows,
                   delimiter: str = ",", verbose: bool = False) -> Tuple[str, str]:
    base = os.path.basename(log_path)
    paths = (os.path.join(output_dir, base + ".train"),
             os.path.join(output_dir, base + ".test"))
    for out_path, rows in zip(paths, (train_rows, test_rows)):
        fields = list(rows[0].keys()) if rows else [
            "NumIters", "Seconds", "LearningRate"]
        with open(out_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, delimiter=delimiter)
            w.writeheader()
            w.writerows(rows)
        if verbose:
            print(f"Wrote {len(rows)} rows to {out_path}")
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="parse_log",
        description="Parse a caffe train log into .train/.test CSVs")
    p.add_argument("logfile_path")
    p.add_argument("output_dir")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--delimiter", default=",")
    args = p.parse_args(argv)
    train_rows, test_rows = parse_log(args.logfile_path)
    save_csv_files(args.logfile_path, args.output_dir, train_rows, test_rows,
                   delimiter=args.delimiter, verbose=args.verbose)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
