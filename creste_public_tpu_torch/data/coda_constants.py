"""UT CODa on-disk format constants.

Facts of the public dataset layout (reference: creste/datasets/
coda_utils.py:454-584 and README.md:78-108): directory names, filename
codecs, sensor dimensions, and the SAM-dynamic class taxonomy the dynamic
BEV head is trained on. Only the taxonomies used by implemented label
pipelines are included.

A copy of ``creste_public_tpu/data/coda_constants.py``.
"""
from __future__ import annotations

import os

# --- directory layout (README.md:78-108) ---------------------------------
CAMERA_DIR = "2d_rect"
POINTCLOUD_DIR = "3d_raw"
CALIBRATION_DIR = "calibrations"
POSES_DIR = "poses"
TIMESTAMPS_DIR = "timestamps"
SPLITS_DIR = "splits"
DEPTH_DIR = "depth"
ELEVATION_LABEL_DIR = "elevation"
SAM_LABEL_DIR = "3d_sam"
SAM_DYNAMIC_LABEL_DIR = "3d_sam_dynamic"
SSC_LABEL_DIR = "3d_ssc"
SOC_LABEL_DIR = "3d_soc"
TRAVERSE_LABEL_DIR = "traversability"
COUNTERFACTUAL_LABEL_DIR = "counterfactuals"
DISTILLATION_LABEL_DIR = "distillation"

DEFAULT_CAM = "cam0"
DEFAULT_LIDAR = "os1"

# Ouster OS1 cloud: 131072 points x (x, y, z, intensity)
OUSTER_POINTS = 131072
OUSTER_FEATURES = 4
LIDAR_HEIGHT_ABOVE_GROUND = 0.8  # metres

# label-key <-> task-directory mapping (coda_utils.py:501-518)
TASK_DIRS = (
    SAM_LABEL_DIR,
    SAM_DYNAMIC_LABEL_DIR,
    SSC_LABEL_DIR,
    SOC_LABEL_DIR,
    ELEVATION_LABEL_DIR,
    TRAVERSE_LABEL_DIR,
    COUNTERFACTUAL_LABEL_DIR,
)
TASK_TO_LABEL = {d: f"{d}_label" for d in TASK_DIRS}
LABEL_TO_TASK = {v: k for k, v in TASK_TO_LABEL.items()}

# SAM-dynamic 6-class taxonomy — the EXACT reference ids (coda_utils.py:6-31;
# on-disk `3d_sam_dynamic` class channels use these values): 0 unlabeled,
# 1 pedestrian, 2 vehicle, 3 bicycle, 4 motorcycle, 5 scooter.
SAM_DYNAMIC_CLASSES = (
    "unlabeled",
    "pedestrian",
    "vehicle",
    "bicycle",
    "motorcycle",
    "scooter",
)
SAM_DYNAMIC_LABEL_MAP = {name: i for i, name in enumerate(SAM_DYNAMIC_CLASSES)}
# GroundingDINO text prompts per class (create_sam_dataset.py:230-237 builds
# the prompt string from the class names; synonyms improve recall).
SAM_DYNAMIC_TEXT_PROMPTS = {
    "pedestrian": ("person", "pedestrian"),
    "vehicle": ("car", "truck", "bus", "golf cart", "service vehicle"),
    "bicycle": ("bicycle", "cyclist"),
    "motorcycle": ("motorcycle", "moped"),
    "scooter": ("scooter", "skateboard", "segway"),
}


# --- filename codec (coda_utils.py:555-584) --------------------------------
def frame_filename(
    modality: str, sensor: str, seq: int | str, frame: int | str, ext: str
) -> str:
    """e.g. ('2d_rect','cam0',0,10,'jpg') -> '2d_rect_cam0_0_10.jpg'."""
    return f"{modality}_{sensor}_{seq}_{frame}.{ext}"


def parse_frame(filename: str) -> int:
    """Trailing integer of the basename is the frame index."""
    stem = os.path.splitext(os.path.basename(filename))[0]
    return int(stem.split("_")[-1])


def parse_filename(filename: str) -> tuple[str, str, str, str]:
    """-> (modality, sensor, sequence, frame) from the standard codec."""
    parts = os.path.splitext(os.path.basename(filename))[0].split("_")
    return "_".join(parts[:2]), parts[2], parts[3], parts[4]


def frame_path(
    root: str, modality: str, sensor: str, seq: int | str,
    frame: int | str, ext: str,
) -> str:
    return os.path.join(
        root, modality, sensor, str(seq),
        frame_filename(modality, sensor, seq, frame, ext),
    )
