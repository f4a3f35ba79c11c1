"""Evaluation harness (the port of ``caffe_rtpose_tpu/tools/eval_pose.py``):

* ``run-list``   — batch-run the COCO val image list
  (reference image_info_val2014_1k.txt: ``idx  image_id  file  h  w``)
  through the estimator, writing per-image rtpose-schema JSON; images are
  read by ``pipeline/image_io.py`` (PNG, BMP and PNM in numpy, JPEG by
  the port's codec, ``pipeline/jpeg.py``);
* ``joint-diff`` — the parity tool: compare two JSON output directories
  joint-by-joint (px deviation + confidence delta), the 1px/0.01 criterion;
* ``coco-ap``    — OKS-based keypoint AP over rtpose JSON outputs vs a
  COCO-format ground-truth annotation file (self-contained OKS/AP math, no
  pycocotools dependency).

The OKS/AP math and the parity tool are copies of the JAX tool's (numpy,
no jax); ``run-list`` runs the port's ``PoseEstimator`` on the card unless
``--device cpu``.

Run:  python -m caffe_rtpose_tpu_torch eval run-list --list L --image_root D --out OUT
      python -m caffe_rtpose_tpu_torch eval joint-diff OUT_A OUT_B
      python -m caffe_rtpose_tpu_torch eval coco-ap --gt ANN.json --pred OUT
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Tuple

import numpy as np

# COCO keypoint sigmas (OKS constants, COCO eval spec)
COCO_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
], np.float32)

# ours(18) -> coco(17) part mapping: drops the synthesized neck
OURS_TO_COCO = [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10]


def parse_image_list(path: str) -> List[Tuple[int, str, int, int]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                out.append((int(parts[1]), parts[2], int(parts[3]), int(parts[4])))
    return out


def cmd_run_list(args) -> int:
    import torch

    from ..pipeline.image_io import read_image
    from ..pipeline.runner import write_json_file
    from ..pose.estimator import PoseEstimator

    entries = parse_image_list(args.list)
    if args.limit:
        entries = entries[: args.limit]
    proto = args.caffeproto
    if not os.path.exists(proto):
        from ..models.cpm import make_pose_deploy_net

        print(f"warning: prototxt {proto!r} not found; using the built-in "
              "COCO 18-kpt deploy graph", file=sys.stderr)
        proto = make_pose_deploy_net()
    weights = args.caffemodel if args.caffemodel and os.path.exists(args.caffemodel) else None
    if weights is None:
        print(f"warning: caffemodel {args.caffemodel!r} not found; running with random "
              "weights", file=sys.stderr)
    est = PoseEstimator(
        proto,
        weights=weights,
        net_resolution=tuple(int(v) for v in args.net_resolution.split("x")),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        input_u8=True,
        device=args.device,
    )
    os.makedirs(args.out, exist_ok=True)
    done = 0
    for image_id, fname, h, w in entries:
        path = os.path.join(args.image_root, fname)
        if not os.path.exists(path):
            continue
        img = read_image(path)
        result, pf = est.estimate(img, disp_w=args.display[0], disp_h=args.display[1])
        out_path = os.path.join(args.out, os.path.splitext(fname)[0] + ".json")
        write_json_file(out_path, result.joints, result.num_people, pf.scale, est.num_parts)
        done += 1
        if done % 50 == 0:
            print(f"{done} images processed")
    print(f"Wrote {done} JSON files to {args.out}")
    return 0


def load_bodies(path: str) -> np.ndarray:
    with open(path) as f:
        data = json.load(f)
    bodies = data.get("bodies", [])
    if not bodies:
        return np.zeros((0, 0, 3), np.float32)
    joints = [np.asarray(b["joints"], np.float32).reshape(-1, 3) for b in bodies]
    return np.stack(joints)


def cmd_joint_diff(args) -> int:
    files_a = {os.path.basename(p) for p in glob.glob(os.path.join(args.dir_a, "*.json"))}
    files_b = {os.path.basename(p) for p in glob.glob(os.path.join(args.dir_b, "*.json"))}
    common = sorted(files_a & files_b)
    if not common:
        print("no common JSON files", file=sys.stderr)
        return 1
    max_px = 0.0
    max_conf = 0.0
    total_joints = matched = 0
    mismatched_people = 0
    for name in common:
        A = load_bodies(os.path.join(args.dir_a, name))
        B = load_bodies(os.path.join(args.dir_b, name))
        if A.shape[0] != B.shape[0]:
            mismatched_people += 1
            continue
        if A.shape[0] == 0:
            continue
        # greedy person matching on mean joint distance
        used = set()
        for i in range(A.shape[0]):
            dists = []
            for j in range(B.shape[0]):
                if j in used:
                    dists.append(np.inf)
                    continue
                va = A[i, :, 2] > 0
                vb = B[j, :, 2] > 0
                both = va & vb
                if not both.any():
                    dists.append(np.inf)
                    continue
                dists.append(float(np.linalg.norm(A[i, both, :2] - B[j, both, :2], axis=1).mean()))
            j = int(np.argmin(dists))
            used.add(j)
            va = A[i, :, 2] > 0
            vb = B[j, :, 2] > 0
            both = va & vb
            total_joints += int(va.sum())
            matched += int(both.sum())
            if both.any():
                px = np.linalg.norm(A[i, both, :2] - B[j, both, :2], axis=1)
                max_px = max(max_px, float(px.max()))
                max_conf = max(max_conf, float(np.abs(A[i, both, 2] - B[j, both, 2]).max()))
    print(f"files compared: {len(common)}  people-count mismatches: {mismatched_people}")
    print(f"joints: {matched}/{total_joints} matched")
    print(f"max |dx,dy|: {max_px:.3f} px   max |dconf|: {max_conf:.4f}")
    ok = max_px <= args.px_tol and max_conf <= args.conf_tol and mismatched_people == 0
    print("PARITY OK" if ok else "PARITY FAIL")
    return 0 if ok else 2


def oks(gt: np.ndarray, dt: np.ndarray, area: float,
        bbox=None) -> float:
    """Object keypoint similarity between one GT (17,3 with v flags) and one
    detection (17,3).  For GTs with NO visible keypoint (crowd /
    num_keypoints==0 ignore regions), pycocotools computeOks falls back to
    a distance-from-expanded-bbox measure over all keypoints so detections
    landing on the region can still match (and then be ignored); mirror
    that when a bbox is available."""
    vis = gt[:, 2] > 0
    if not vis.any():
        if bbox is None:
            return 0.0
        x, y, w, h = [float(v) for v in bbox]
        # expanded box [x-w, x+2w] x [y-h, y+2h] (cocoapi computeOks)
        dx = (np.maximum(0.0, (x - w) - dt[:, 0])
              + np.maximum(0.0, dt[:, 0] - (x + 2 * w)))
        dy = (np.maximum(0.0, (y - h) - dt[:, 1])
              + np.maximum(0.0, dt[:, 1] - (y + 2 * h)))
        d2 = dx ** 2 + dy ** 2
        var = (2 * COCO_SIGMAS) ** 2
        e = d2 / (2 * var * (area + np.spacing(1)))
        return float(np.mean(np.exp(-e)))
    d2 = np.sum((gt[vis, :2] - dt[vis, :2]) ** 2, axis=1)
    var = (2 * COCO_SIGMAS[vis]) ** 2
    e = d2 / (2 * var * (area + np.spacing(1)))
    return float(np.mean(np.exp(-e)))


def _dt_area(kp: np.ndarray) -> float:
    """Detection area: tight keypoint bbox, as pycocotools loadRes computes
    it for keypoint results (cocoapi COCO.loadRes)."""
    xs, ys = kp[:, 0], kp[:, 1]
    return float((xs.max() - xs.min()) * (ys.max() - ys.min()))


# COCOeval keypoint area ranges (cocoapi Params.setKpParams)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _ap_one_range(gts, dts, thresholds, area_rng, max_dets):
    """AP at one area range, COCOeval semantics: GTs outside the range (or
    with no visible keypoint) are IGNORE — detections matched to them are
    dropped from scoring, as are unmatched detections whose own keypoint
    bbox falls outside the range; top max_dets detections per image by
    score (COCO keypoints: maxDets=20)."""
    lo, hi = area_rng

    def _gt_ignore(gt):
        return (not (lo <= gt["area"] <= hi) or gt.get("ignore", False)
                or not (gt["keypoints"][:, 2] > 0).any())

    ap_per_t = []
    npos = sum(
        1
        for gt_list in gts.values()
        for gt in gt_list
        if not _gt_ignore(gt)
    )
    for t in thresholds:
        scored = []  # (score, is_tp) for non-ignored detections
        for img_id, dt_list in sorted(dts.items()):
            gt_list = gts.get(img_id, [])
            # ignored GTs sort last, matching COCOeval's gtind ordering
            order = sorted(range(len(gt_list)),
                           key=lambda i: _gt_ignore(gt_list[i]))
            taken = [False] * len(gt_list)
            dts_ranked = sorted(dt_list, key=lambda d: -d["score"])[:max_dets]
            for dt in dts_ranked:
                best, best_i, best_ignore = None, -1, False
                for i in order:
                    gt = gt_list[i]
                    # crowd GTs may absorb multiple detections
                    # (COCOeval: "if gtm>0 and not iscrowd: continue")
                    if taken[i] and not gt.get("iscrowd", False):
                        continue
                    ignore = _gt_ignore(gt)
                    # once a regular match is made, ignored GTs (sorted
                    # last) cannot steal it (COCOeval's break)
                    if best_i >= 0 and not best_ignore and ignore:
                        break
                    o = oks(gt["keypoints"], dt["keypoints"], gt["area"],
                            bbox=gt.get("bbox"))
                    if o < (t if best is None else best):
                        continue
                    best, best_i, best_ignore = o, i, ignore
                if best_i >= 0:
                    taken[best_i] = True
                    if not best_ignore:
                        scored.append((dt["score"], 1))
                    # matched to an ignored GT: dropped entirely
                else:
                    dt_a = _dt_area(dt["keypoints"])
                    if lo <= dt_a <= hi:
                        scored.append((dt["score"], 0))
                    # unmatched + outside the range: dropped
        if npos == 0:
            continue
        scored.sort(key=lambda s: -s[0])
        tps = np.cumsum([s[1] for s in scored]) if scored else np.array([])
        fps = np.cumsum([1 - s[1] for s in scored]) if scored else np.array([])
        if len(tps) == 0:
            ap_per_t.append(0.0)
            continue
        rec = tps / npos
        prec = tps / np.maximum(tps + fps, 1)
        # 101-point interpolation over the precision envelope
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = prec[rec >= r].max() if (rec >= r).any() else 0.0
            ap += p / 101
        ap_per_t.append(ap)
    return ap_per_t


def coco_keypoint_ap(gts: Dict[int, List[dict]], dts: Dict[int, List[dict]],
                     thresholds=None, max_dets: int = 20) -> Dict[str, float]:
    """Self-contained OKS AP (averaged over thresholds .5:.05:.95), COCOeval
    keypoint protocol: maxDets=20, area ranges all/medium/large, ignored-GT
    handling.  Held against the JAX tool's copy and the COCOeval oracle
    (tests/coco_eval_oracle.py) in tests/test_torch_eval_pose.py."""
    thresholds = np.asarray(thresholds if thresholds is not None
                            else np.arange(0.5, 1.0, 0.05))
    out: Dict[str, float] = {}
    for name, rng in AREA_RANGES.items():
        ap_per_t = _ap_one_range(gts, dts, thresholds, rng, max_dets)
        key = "AP" if name == "all" else f"AP_{name}"
        out[key] = float(np.mean(ap_per_t)) if ap_per_t else 0.0
        if name == "all" and ap_per_t:
            # AP50/AP75 by threshold value, not grid position (a custom
            # thresholds vector must not silently mislabel them)
            for label, tval in (("AP50", 0.5), ("AP75", 0.75)):
                (idx,) = np.where(np.isclose(thresholds, tval))
                if idx.size:
                    out[label] = float(ap_per_t[int(idx[0])])
    return out


def cmd_coco_ap(args) -> int:
    with open(args.gt) as f:
        gt_json = json.load(f)
    img_by_id = {im["id"]: im for im in gt_json.get("images", [])}
    gts: Dict[int, List[dict]] = {}
    for ann in gt_json.get("annotations", []):
        # zero-keypoint / crowd annotations are kept as IGNORE regions
        # (pycocotools _prepare: gt['ignore'] = num_keypoints==0 or iscrowd);
        # detections matched to them via the bbox-fallback OKS are dropped
        # from scoring rather than counted as false positives
        kp = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
        gts.setdefault(ann["image_id"], []).append({
            "keypoints": kp, "area": float(ann.get("area", 1.0)),
            "bbox": ann.get("bbox"),
            "iscrowd": bool(ann.get("iscrowd", 0)),
            "ignore": (ann.get("num_keypoints", 0) == 0
                       or bool(ann.get("iscrowd", 0))),
        })
    dts: Dict[int, List[dict]] = {}
    for path in glob.glob(os.path.join(args.pred, "*.json")):
        stem = os.path.splitext(os.path.basename(path))[0]
        digits = "".join(c for c in stem if c.isdigit())
        image_id = int(digits[-12:]) if digits else 0
        bodies = load_bodies(path)
        for body in bodies:
            kp17 = np.zeros((17, 3), np.float32)
            for c17, c18 in enumerate(OURS_TO_COCO):
                kp17[c17, :2] = body[c18, :2]
                kp17[c17, 2] = 1.0 if body[c18, 2] > 0 else 0.0
            score = float(body[:, 2].sum())
            dts.setdefault(image_id, []).append({"keypoints": kp17, "score": score})
    res = coco_keypoint_ap(gts, dts)
    print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eval_pose", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run-list")
    r.add_argument("--list", default="image_info_val2014_1k.txt",
                   help="image list: idx image_id file h w per line")
    r.add_argument("--image_root", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--caffeproto", default="model/coco/pose_deploy_linevec.prototxt")
    r.add_argument("--caffemodel", default="model/coco/pose_iter_440000.caffemodel")
    r.add_argument("--net_resolution", default="656x368")
    r.add_argument("--display", type=lambda s: tuple(int(v) for v in s.split("x")),
                   default=(1280, 720))
    # float32 is the parity configuration: the 1px/0.01 joint-diff criterion
    # is defined against f32 runs.  bf16 is the explicit fast path
    # (--dtype bfloat16).
    r.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    r.add_argument("--limit", type=int, default=0)
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    r.set_defaults(fn=cmd_run_list)

    d = sub.add_parser("joint-diff")
    d.add_argument("dir_a")
    d.add_argument("dir_b")
    d.add_argument("--px_tol", type=float, default=1.0)
    d.add_argument("--conf_tol", type=float, default=0.01)
    d.set_defaults(fn=cmd_joint_diff)

    a = sub.add_parser("coco-ap")
    a.add_argument("--gt", required=True, help="COCO-format annotation JSON")
    a.add_argument("--pred", required=True, help="directory of rtpose JSON outputs")
    a.set_defaults(fn=cmd_coco_ap)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
