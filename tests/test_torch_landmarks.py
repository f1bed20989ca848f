"""Port parity: landmark files, their reduction to 5 points, the host fits.

The port keeps its own copies of the JAX package's pure-numpy modules
(``utils/landmarks.py``, the numpy fits of ``ops/transform.py``), so every
result here must equal the JAX package's exactly: the same files parse to
the same arrays, the same schemes reduce to the same points, the same
points fit the same matrices bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from face_crop_plus_tpu.ops import transform as jt
from face_crop_plus_tpu.utils import landmarks as jl
from face_crop_plus_tpu_torch.ops import transform as tt
from face_crop_plus_tpu_torch.utils import landmarks as tl

SCHEMES = (5, 12, 17, 21, 29, 49, 51, 68, 98, 106)


def _rows(seed: int, n: int, points: int):
    rng = np.random.default_rng(seed)
    names = [f"img_{i:03d}.jpg" for i in range(n)]
    names[1] = names[0]  # a duplicate row: both rows are kept, in order
    coords = rng.uniform(0, 300, (n, points * 2)).round(3)
    return names, coords


def _write(path, fmt, names, coords):
    if fmt == "json":
        # A JSON object keeps one value per name.
        data = {name: row.tolist() for name, row in zip(names, coords)}
        with open(path, "w") as f:
            json.dump(data, f)
    elif fmt == "csv":
        with open(path, "w") as f:
            f.write("name," + ",".join(f"c{k}" for k in range(coords.shape[1])) + "\n")
            for name, row in zip(names, coords):
                f.write(name + "," + ",".join(f"{v:.3f}" for v in row) + "\n")
    else:
        with open(path, "w") as f:
            for name, row in zip(names, coords):
                f.write(name + " " + " ".join(f"{v:.3f}" for v in row) + "\n")


@pytest.mark.parametrize("points", [5, 68, 98])
@pytest.mark.parametrize("fmt", ["json", "csv", "txt"])
def test_parse_and_reduce_match_jax(tmp_path, fmt, points):
    names, coords = _rows(points, 7, points)
    path = str(tmp_path / f"lm.{fmt}")
    _write(path, fmt, names, coords)
    lm, files = tl.parse_landmarks_file(path)
    ref_lm, ref_files = jl.parse_landmarks_file(path)
    assert lm.dtype == ref_lm.dtype == np.float32 and lm.shape == ref_lm.shape
    assert lm.shape[1:] == (points, 2)
    np.testing.assert_array_equal(lm, ref_lm)
    np.testing.assert_array_equal(files, ref_files)
    assert len(files) == (6 if fmt == "json" else 7)
    reduced = tl.reduce_landmarks(lm)
    np.testing.assert_array_equal(reduced, jl.reduce_landmarks(ref_lm))
    assert reduced.shape == (len(lm), 5, 2)
    if points == 5:
        assert reduced is lm


def test_single_row_txt(tmp_path):
    """One row still parses to (1, L, 2) (``np.atleast_2d``)."""
    path = str(tmp_path / "one.txt")
    _write(path, "txt", ["a.jpg"], np.arange(10, dtype=np.float64)[None])
    lm, files = tl.parse_landmarks_file(path)
    ref_lm, ref_files = jl.parse_landmarks_file(path)
    np.testing.assert_array_equal(lm, ref_lm)
    assert lm.shape == (1, 5, 2) and list(files) == list(ref_files) == ["a.jpg"]


@pytest.mark.parametrize("points", SCHEMES)
def test_slices_match_jax(points):
    assert tl.get_landmark_slices_5(points) == jl.get_landmark_slices_5(points)
    assert tl.get_ldm_slices(5, points) == jl.get_ldm_slices(5, points)
    lm = np.random.default_rng(points).uniform(0, 100, (3, points, 2)).astype(np.float32)
    np.testing.assert_array_equal(tl.reduce_landmarks(lm), jl.reduce_landmarks(lm))


def test_unsupported_schemes_raise():
    for mod in (tl, jl):
        with pytest.raises(ValueError, match="Invalid number of landmarks"):
            mod.get_landmark_slices_5(7)
        with pytest.raises(ValueError, match="not supported"):
            mod.get_ldm_slices(4, 68)


@pytest.mark.parametrize("fit", ["estimate_similarity_np", "estimate_affine_np"])
def test_numpy_fits_match_jax(fit):
    """The host fits are bit-equal to the JAX package's twins, and within
    f32 rounding of the port's torch fits; degenerate rows are invalid."""
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 200, (64, 5, 2)).astype(np.float32)
    src[3] = src[3, :1]  # coincident points
    src[5, :, 1] = 2 * src[5, :, 0] + 1  # collinear points
    dst = tl.make_target_landmarks((64, 64), 0.65)
    m, ok = getattr(tt, fit)(src, dst)
    ref_m, ref_ok = getattr(jt, fit)(src, dst)
    assert m.dtype == np.float32 and m.shape == (64, 2, 3)
    np.testing.assert_array_equal(m, ref_m)
    np.testing.assert_array_equal(ok, ref_ok)
    assert not ok[3] and ok.sum() >= 62
    torch_fit = getattr(tt, fit[: -len("_np")])
    tm, tok = torch_fit(torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(tok.numpy(), ok)
    np.testing.assert_allclose(tm.numpy()[ok], m[ok], rtol=1e-4, atol=1e-3)
