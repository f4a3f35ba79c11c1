"""``python -m caffe_rtpose_tpu_torch <tool> ...`` — the tool dispatcher."""

import importlib
import sys

TOOLS = {
    "rtpose": ("tools.rtpose", "realtime multi-person pose demo"),
    "eval": ("tools.eval_pose", "run-list / joint-diff / coco-ap"),
    "upgrade": ("tools.upgrade_proto", "legacy prototxt/caffemodel upgrades"),
    "export": ("tools.export_tool", "serving bundles (build / check)"),
    "caffe": ("tools.caffe_tool", "train / test / time / device_query"),
    "aux": ("tools.aux_tools", "convert_imageset / compute_image_mean / "
                               "build_pose_db / db_convert / extract_features"),
    "classify": ("tools.classify", "classify images with a deploy net (10-crop)"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m caffe_rtpose_tpu_torch <tool> [args]\n\ntools:")
        for name, (_, desc) in TOOLS.items():
            print(f"  {name:<8} {desc}")
        return 0 if argv else 2
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}; one of: {', '.join(TOOLS)}", file=sys.stderr)
        return 2
    mod = importlib.import_module(f"caffe_rtpose_tpu_torch.{TOOLS[tool][0]}")
    return mod.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
