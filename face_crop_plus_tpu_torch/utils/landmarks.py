"""Landmark files, the canonical 5-point template and slice tables.

A copy of ``face_crop_plus_tpu.utils.landmarks`` (pure numpy; the port
never imports the JAX package): the canonical normalized 5-point template,
the landmark-file parsers (.json/.csv/.txt) and the slice tables that
reduce larger annotation schemes (12/17/21/29/49/51/68/98/106 points) to
mean-pooled 5-point sets.
"""

from __future__ import annotations

import json

import numpy as np

# Canonical normalized 5-point face template (left eye, right eye, nose tip,
# left mouth corner, right mouth corner) in [0, 1]^2 image coordinates: the
# standard ArcFace-style alignment constants, identical to the reference's.
STANDARD_LANDMARKS_5 = np.array(
    [
        [0.31556875000000000, 0.4615741071428571],
        [0.68262291666666670, 0.4615741071428571],
        [0.50026249999999990, 0.6405053571428571],
        [0.34947187500000004, 0.8246919642857142],
        [0.65343645833333330, 0.8246919642857142],
    ],
    dtype=np.float32,
)


# Index ranges (start, stop) into larger annotation schemes whose mean gives
# each of the 5 canonical points.  Keys are the source scheme sizes.  Mirrors
# reference utils.py:90-132 (``get_landmark_slices_5``).
_SLICES_TO_5 = {
    5: [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)],
    12: [(10, 11), (11, 12), (2, 3), (3, 4), (4, 5)],
    17: [(2, 5), (7, 10), (10, 11), (13, 14), (16, 17)],
    21: [(6, 9), (9, 12), (14, 15), (17, 18), (19, 20)],
    29: [(4, 9), (13, 18), (19, 20), (22, 23), (27, 28)],
    49: [(19, 25), (25, 31), (13, 14), (31, 32), (37, 38)],
    51: [(19, 25), (25, 31), (13, 14), (31, 32), (37, 38)],
    68: [(36, 42), (42, 48), (30, 31), (48, 49), (54, 55)],
    98: [(60, 68), (68, 76), (54, 55), (76, 77), (82, 83)],
    106: [(66, 75), (75, 84), (54, 55), (85, 86), (91, 92)],
}


def get_landmark_slices_5(num_landmarks: int) -> list[slice]:
    """Returns slices selecting/averaging a larger set down to 5 points.

    Args:
        num_landmarks: Size of the source annotation scheme.

    Raises:
        ValueError: If the scheme size is not supported.
    """
    try:
        pairs = _SLICES_TO_5[num_landmarks]
    except KeyError:
        raise ValueError(f"Invalid number of landmarks: {num_landmarks}")
    return [slice(a, b) for a, b in pairs]


def get_ldm_slices(num_tgt_landmarks: int, num_src_landmarks: int) -> list[slice]:
    """Slices reducing a source landmark scheme to the target scheme size.

    Only a 5-point target is currently defined (same restriction as the
    reference, utils.py:134-168).
    """
    if num_tgt_landmarks != 5:
        raise ValueError(
            f"The number of target (standard) landmarks is not supported "
            f"{num_tgt_landmarks}"
        )
    return get_landmark_slices_5(num_src_landmarks)


def reduce_landmarks(landmarks: np.ndarray, num_tgt: int = 5) -> np.ndarray:
    """Mean-pools an (N, L, 2) landmark batch down to (N, num_tgt, 2)."""
    if landmarks.shape[1] == num_tgt:
        return landmarks
    slices = get_ldm_slices(num_tgt, landmarks.shape[1])
    return np.stack([landmarks[:, s].mean(axis=1) for s in slices], axis=1)


def parse_landmarks_file(file_path: str, **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """Parses a landmarks file into (landmarks, filenames) arrays.

    Supported formats (same conventions as reference utils.py:21-88):

    * ``.json``: ``{"image.jpg": [x1, y1, x2, y2, ...], ...}``
    * ``.csv``: header row, first column filenames, rest coordinates
    * ``.txt``/other: whitespace-separated, first column filenames

    Args:
        file_path: Path to the landmarks file.
        **kwargs: Extra arguments forwarded to :func:`numpy.genfromtxt`
            (do not pass ``dtype``/``usecols``).

    Returns:
        Tuple of a float32 landmark array of shape (N, L, 2) and a filename
        array of shape (N,).
    """
    if file_path.endswith(".json"):
        with open(file_path, "r") as f:
            data = json.load(f)
        filenames = np.array(list(data.keys()))
        landmarks = np.array(list(data.values()), dtype=np.float32)
    else:
        if file_path.endswith(".csv"):
            kwargs.setdefault("delimiter", ",")
            kwargs.setdefault("skip_header", 1)
        # One tokenizing pass (CelebA-scale files are ~200k rows); the
        # numeric columns are converted from the string table afterwards.
        table = np.atleast_2d(np.genfromtxt(file_path, dtype=str, **kwargs))
        filenames = np.atleast_1d(table[:, 0])
        landmarks = table[:, 1:].astype(np.float32)

    return landmarks.reshape(len(landmarks), -1, 2), filenames


def make_target_landmarks(
    output_size: tuple[int, int],
    face_factor: float,
    num_std_landmarks: int = 5,
) -> np.ndarray:
    """Builds the alignment target landmark set for a given crop geometry.

    The canonical normalized template is scaled by ``face_factor`` relative
    to ``output_size`` and offset so that the face is centered in the crop.

    Args:
        output_size: Crop (width, height) in pixels.
        face_factor: Fraction of the output image occupied by the face.
        num_std_landmarks: Only 5 is supported.

    Returns:
        Float32 array of shape (5, 2): target pixel coordinates.
    """
    if num_std_landmarks != 5:
        raise ValueError(
            f"Unsupported number of standard landmarks for estimating "
            f"alignment transform matrix: {num_std_landmarks}."
        )
    tgt = STANDARD_LANDMARKS_5.copy()
    w, h = output_size
    tgt[:, 0] = tgt[:, 0] * w * face_factor + (1 - face_factor) * w / 2
    tgt[:, 1] = tgt[:, 1] * h * face_factor + (1 - face_factor) * h / 2
    return tgt
