"""Model descriptors: part names, limb topology, PAF channel map, and the
per-model connection hyperparameters.

Tables transcribed from reference src/rtpose/modelDescriptorFactory.cpp:4-61
(they are COCO/MPI dataset constants, not code) and the hyperparameter blocks
in warmup() (reference examples/rtpose/rtpose.cpp:212-229).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ConnectParams:
    nms_threshold: float
    min_subset_cnt: int
    min_subset_score: float
    inter_threshold: float
    inter_min_above_threshold: int


@dataclass(frozen=True)
class ModelDescriptor:
    name: str
    part_names: Tuple[str, ...]  # includes trailing "Bkg"
    limb_sequence: Tuple[int, ...]  # flattened (A, B) part-id pairs
    map_idx: Tuple[int, ...]  # flattened PAF channel pairs per limb
    defaults: ConnectParams
    clamp_samples: bool  # COCO path clamps line-integral sample coords

    @property
    def num_parts(self) -> int:
        return len(self.part_names) - 1

    @property
    def num_limbs(self) -> int:
        return len(self.limb_sequence) // 2

    def limb(self, k: int) -> Tuple[int, int]:
        return self.limb_sequence[2 * k], self.limb_sequence[2 * k + 1]

    def paf_channels(self, k: int) -> Tuple[int, int]:
        return self.map_idx[2 * k], self.map_idx[2 * k + 1]

    def part_name(self, i: int) -> str:
        return self.part_names[i]


MPI_15 = ModelDescriptor(
    name="MPI_15",
    part_names=(
        "Head", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder",
        "LElbow", "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee",
        "LAnkle", "Chest", "Bkg",
    ),
    limb_sequence=(0, 1, 1, 2, 2, 3, 3, 4, 1, 5, 5, 6, 6, 7, 1, 14, 14, 11,
                   11, 12, 12, 13, 14, 8, 8, 9, 9, 10),
    map_idx=(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
             38, 39, 40, 41, 42, 43, 32, 33, 34, 35, 36, 37),
    defaults=ConnectParams(
        nms_threshold=0.2,
        min_subset_cnt=3,
        min_subset_score=0.4,
        inter_threshold=0.01,
        inter_min_above_threshold=8,
    ),
    clamp_samples=False,
)

COCO_18 = ModelDescriptor(
    name="COCO_18",
    part_names=(
        "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder",
        "LElbow", "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee",
        "LAnkle", "REye", "LEye", "REar", "LEar", "Bkg",
    ),
    limb_sequence=(1, 2, 1, 5, 2, 3, 3, 4, 5, 6, 6, 7, 1, 8, 8, 9, 9, 10,
                   1, 11, 11, 12, 12, 13, 1, 0, 0, 14, 14, 16, 0, 15, 15, 17,
                   2, 16, 5, 17),
    map_idx=(31, 32, 39, 40, 33, 34, 35, 36, 41, 42, 43, 44, 19, 20, 21, 22,
             23, 24, 25, 26, 27, 28, 29, 30, 47, 48, 49, 50, 53, 54, 51, 52,
             55, 56, 37, 38, 45, 46),
    defaults=ConnectParams(
        nms_threshold=0.05,
        min_subset_cnt=3,
        min_subset_score=0.4,
        inter_threshold=0.050,
        inter_min_above_threshold=9,
    ),
    clamp_samples=True,
)

BY_NUM_PARTS: Dict[int, ModelDescriptor] = {15: MPI_15, 18: COCO_18}


def for_num_parts(num_parts: int) -> ModelDescriptor:
    """Auto-select by the Nms layer's num_parts (warmup, rtpose.cpp:212-229)."""
    if num_parts not in BY_NUM_PARTS:
        raise ValueError(f"Unknown number of parts {num_parts}; couldn't set model")
    return BY_NUM_PARTS[num_parts]


RENDER_MAX_PEOPLE = 96  # reference include/rtpose/renderFunctions.h
