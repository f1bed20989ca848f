"""Host-side helpers of the port."""

from .batching import as_batch, as_device, as_numpy, bucket_size, pad_batch_to
from .io import imread_rgb, imwrite, read_images
from .landmarks import (
    STANDARD_LANDMARKS_5,
    get_landmark_slices_5,
    get_ldm_slices,
    make_target_landmarks,
    parse_landmarks_file,
    reduce_landmarks,
)
from .names import clean_names

__all__ = [
    "STANDARD_LANDMARKS_5",
    "as_batch",
    "as_device",
    "as_numpy",
    "bucket_size",
    "clean_names",
    "get_landmark_slices_5",
    "get_ldm_slices",
    "imread_rgb",
    "imwrite",
    "make_target_landmarks",
    "pad_batch_to",
    "parse_landmarks_file",
    "read_images",
    "reduce_landmarks",
]
