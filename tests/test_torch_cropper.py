"""Port parity: the whole slice, ``Cropper.process_images`` in detection mode.

The JAX ``Cropper`` and the port's run the same configuration on the same
uint8 batch with the same (tamed, transplanted) detector weights.  Face
indices must match exactly and uint8 crops within ±1 level: the network
outputs agree to f32 rounding (different conv summation orders), which can
move a landmark by a tiny fraction of a pixel and a rounded crop pixel by
one level.
"""

import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import face_crop_plus_tpu_torch

from torch_parity import cropper_pair


def _pair(monkeypatch, **kw):
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    return cropper_pair(**kw)


@pytest.mark.parametrize(
    "strategy,padding,resize,shape",
    [
        ("largest", "constant", 64, (4, 72, 60, 3)),
        ("best", "reflect_101", 64, (3, 50, 70, 3)),
        ("largest", "replicate", 128, (2, 64, 64, 3)),  # caps grow: A = 672
    ],
)
def test_process_images_matches_jax(monkeypatch, strategy, padding, resize, shape):
    j, t = _pair(
        monkeypatch, output_size=64, resize_size=resize, strategy=strategy,
        padding=padding, det_threshold=-1.0, batch_size=4,
    )
    batch = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_crops, ref_idx, ref_groups = j.process_images(batch)
        crops, idx, groups = t.process_images(batch)
    np.testing.assert_array_equal(idx, ref_idx)
    assert idx.dtype == np.int64 and len(idx) == shape[0]
    assert crops.dtype == np.uint8 and crops.shape == ref_crops.shape
    diff = np.abs(crops.astype(np.int16) - ref_crops.astype(np.int16))
    assert diff.max() <= 1
    assert groups == ref_groups == (None, None)
    assert t.det_model.pre_topk == j.det_model.pre_topk


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        face_crop_plus_tpu_torch.Cropper()


@pytest.mark.parametrize(
    "kw",
    [
        dict(landmarks="lm.txt"),
        dict(enh_threshold=0.01),
        dict(attr_groups={"g": [1]}),
        dict(det_threshold=None),
        dict(mesh=object()),
    ],
)
def test_unported_paths_raise(kw):
    with pytest.raises(NotImplementedError):
        face_crop_plus_tpu_torch.Cropper(device="cpu", **kw)


def test_ragged_batch_raises():
    with pytest.warns(UserWarning):
        c = face_crop_plus_tpu_torch.Cropper(device="cpu", resize_size=64, output_size=32)
    imgs = [np.zeros((40, 30, 3), np.uint8), np.zeros((30, 40, 3), np.uint8)]
    with pytest.raises(NotImplementedError):
        c.process_images(imgs)
    crops, idx, _ = c.process_images([])
    assert crops.shape == (0, 32, 32, 3) and idx.shape == (0,)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, face_crop_plus_tpu_torch, face_crop_plus_tpu_torch.pipeline\n"
        "import face_crop_plus_tpu_torch.ops.cuda.nms, face_crop_plus_tpu_torch.ops.cuda.warp\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('face_crop_plus_tpu.')"
        " or m == 'face_crop_plus_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
