"""Canonical 5-point template and the alignment target built from it.

A copy of the parts of ``face_crop_plus_tpu.utils.landmarks`` that the
detection path needs (pure numpy; the port never imports the JAX package).
"""

from __future__ import annotations

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
