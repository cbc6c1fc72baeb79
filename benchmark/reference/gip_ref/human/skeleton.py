"""OpenPose-18 constants, copied from gaussianip_tpu_torch/human/skeleton.py."""

import numpy as np

OPENPOSE18_NAMES = (
    "nose", "neck", "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle", "right_eye",
    "left_eye", "right_ear", "left_ear",
)
# limb segments
OPENPOSE18_LINES = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7], [1, 8], [8, 9],
     [9, 10], [1, 11], [11, 12], [12, 13], [0, 14], [14, 16], [0, 15],
     [15, 17]],
    np.int64,
)
# controlnet_aux keypoint colors
OPENPOSE18_COLORS = np.array(
    [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
     [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
     [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
     [255, 0, 255], [255, 0, 170], [255, 0, 85]],
    np.float32,
)
