"""Port parity: the landmark-file mode, ``Cropper(landmarks=...).process_dir``.

The JAX ``Cropper`` and the port's read the same directory (JPEGs of three
sizes, an EXIF-rotated JPEG, a PNG, a file without a landmark row and a
corrupt file) with the same CelebA-style landmarks file (two rows for one
file).  No detector runs; both fit with the same numpy twins and warp with
the same native host binary (10-bit fixed point), or — for JPEG-in,
JPEG-out batches — warp the stored 4:2:0 planes straight into packed rows
for the raw-data encoder.  So the trees are byte-equal.  With
``FCPT_NATIVE_WARP=0`` the port crops through the warp kernel's wrapper
(the plain version on the CPU) and the JAX package through its XLA warp:
pixels within ±1 (both sample in float32; the fits' float32 sums round
differently).  Composed with a parser (tamed weights, 128² inference in
both) the trees follow ``torch_parity.check_parse_tree``; with a 2-block
enhancer the gated crops are within ±2 (the networks' float32 sums).
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import face_crop_plus_tpu
import face_crop_plus_tpu_torch
import face_crop_plus_tpu_torch.cropper as port_cropper
from face_crop_plus_tpu_torch.utils import native_io

from torch_parity import (
    check_parse_tree,
    cropper_pair,
    read_tree,
    small_enhancers,
    smooth_image,
    tree_max_diff,
    write_oriented_jpeg,
)

pytestmark = pytest.mark.skipif(
    not native_io.native_warp_available(), reason="the native host library did not build"
)

#: (file name, (h, w)) of the directory; None is a corrupt file.
FILES = [(f"a{i:02d}.jpg", (96, 80)) for i in range(6)] + [
    ("b0.jpg", (120, 100)),
    ("b1.jpg", (120, 100)),
    ("c0.jpg", (64, 72)),  # EXIF orientation 6: decodes to 72×64
    ("d0.png", (90, 70)),
    ("e0.jpg", (96, 80)),  # no landmark row
    ("z.jpg", None),
]
#: Canonical 5-point layout as fractions of (w, h).
LAYOUT = np.array([[0.36, 0.42], [0.64, 0.42], [0.50, 0.56], [0.38, 0.74], [0.62, 0.74]])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small parity runs share the machine's
    cores with the suite's other workers (see ``test_torch_enhancement.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(rng, h, w, shift=0.0):
    return LAYOUT * [w, h] + rng.normal(0, 1.5, (5, 2)) + shift


def write_landmark_dir(path: str, seed: int = 0, points: int = 5) -> tuple[str, str]:
    """Writes :data:`FILES` under ``path/in`` and a whitespace landmarks file
    (``points`` per row: 5, or 68 whose eye, nose and mouth slices average
    to the 5) beside it; a00 has two rows.  Returns (input dir, file)."""
    rng = np.random.default_rng(seed)
    src = os.path.join(path, "in")
    os.makedirs(src, exist_ok=True)
    rows = []
    for name, hw in FILES:
        full = os.path.join(src, name)
        if hw is None:
            with open(full, "wb") as f:
                f.write(b"\xff\xd8\xff\xe0 corrupt")
            continue
        if name == "c0.jpg":
            write_oriented_jpeg(full, smooth_image(rng, *hw), 6)
            hw = hw[::-1]
        else:
            face_crop_plus_tpu_torch.utils.io.imwrite(full, smooth_image(rng, *hw))
        if name == "e0.jpg":
            continue
        shifts = (0.0, 4.0) if name == "a00.jpg" else (0.0,)
        for shift in shifts:
            pts = _points(rng, *hw, shift)
            if points == 68:
                full68 = np.repeat(pts.mean(0, keepdims=True), 68, 0)
                for k, (a, b) in enumerate([(36, 42), (42, 48), (30, 31), (48, 49), (54, 55)]):
                    full68[a:b] = pts[k]
                pts = full68
            rows.append(name + " " + " ".join(f"{v:.4f}" for v in pts.ravel()))
    lm = os.path.join(path, f"lm{points}.txt")
    with open(lm, "w") as f:
        f.write("\n".join(rows) + "\n")
    return src, lm


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_landmark_dir(str(tmp_path_factory.mktemp("lmdir")))


def _run(cropper, src, out):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cropper.process_dir(src, out, desc=None)
    return out


def _pair(lm, **kw):
    kw.setdefault("output_size", 64)
    kw.setdefault("batch_size", 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = face_crop_plus_tpu.Cropper(device="cpu", landmarks=lm, **kw)
        t = face_crop_plus_tpu_torch.Cropper(device="cpu", landmarks=lm, **kw)
    assert t.det_model is None and t._fused is None
    return j, t


def _bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _expected_names(strategy, ext=None):
    names = []
    for name, hw in FILES:
        if hw is None or name == "e0.jpg":
            continue
        stem, own = os.path.splitext(name)
        ext_ = own if ext is None else "." + ext
        if strategy == "all":
            names += [f"{stem}_{k}{ext_}" for k in range(2 if name == "a00.jpg" else 1)]
        else:
            names.append(stem + ext_)
    return sorted(names)


@pytest.mark.parametrize("strategy,size", [("largest", 256), ("all", 64)])
def test_tree_byte_equal(data, tmp_path, strategy, size):
    """JPEG outputs: the JPEGs warp in 4:2:0 end to end (the PNG and the
    rotated file as RGB); the trees are equal byte for byte."""
    src, lm = data
    j, t = _pair(lm, strategy=strategy, output_size=size, padding="constant")
    assert t._yuv_crop_eligible() and j._yuv_crop_eligible()
    ours = _bytes(_run(t, src, str(tmp_path / "port")))
    ref = _bytes(_run(j, src, str(tmp_path / "jax")))
    assert sorted(ours) == sorted(ref) == _expected_names(strategy)
    assert ours == ref


@pytest.mark.parametrize("mode", ["constant", "replicate", "reflect", "wrap", "reflect_101"])
def test_border_modes_byte_equal(data, tmp_path, mode):
    """PNG outputs: every crop warps as RGB on the host; 16-pixel offsets
    push the crops over the borders."""
    src, lm = data
    j, t = _pair(lm, padding=mode, output_format="png", face_factor=0.95)
    assert not t._yuv_crop_eligible()
    ours = _bytes(_run(t, src, str(tmp_path / "port")))
    ref = _bytes(_run(j, src, str(tmp_path / "jax")))
    assert sorted(ours) == _expected_names("largest", "png") and ours == ref


def test_allow_skew_and_68_points(tmp_path):
    src, lm = write_landmark_dir(str(tmp_path), seed=1, points=68)
    j, t = _pair(lm, allow_skew=True, output_format="png", strategy="all")
    assert t.landmarks[0].shape[1:] == (68, 2)
    ours = _bytes(_run(t, src, str(tmp_path / "port")))
    ref = _bytes(_run(j, src, str(tmp_path / "jax")))
    assert sorted(ours) == _expected_names("all", "png") and ours == ref


def test_plain_warp_within_one(data, tmp_path, monkeypatch):
    """``FCPT_NATIVE_WARP=0``: the port crops through the warp kernel's
    wrapper (its plain version here), one call per source shape of a
    batch, the JAX package through its XLA warp: ±1."""
    monkeypatch.setenv("FCPT_NATIVE_WARP", "0")
    src, lm = data
    j, t = _pair(lm, output_format="png", strategy="all", padding="reflect")
    calls = []
    real = port_cropper.warp_affine_u8

    def counting(images, *a, **kw):
        calls.append(tuple(images.shape))
        return real(images, *a, **kw)

    monkeypatch.setattr(port_cropper, "warp_affine_u8", counting)
    monkeypatch.setattr(native_io, "warp_affine_batch_native",
                        lambda *a, **kw: pytest.fail("the host warp ran"))
    ours = read_tree(_run(t, src, str(tmp_path / "port")))
    ref = read_tree(_run(j, src, str(tmp_path / "jax")))
    assert sorted(ours) == _expected_names("all", "png")
    assert tree_max_diff(ours, ref) <= 1
    # Batches of 4 files: per batch one warp call per source shape.
    assert sorted(calls) == sorted([(4, 96, 80, 3), (2, 96, 80, 3), (2, 120, 100, 3),
                                   (1, 72, 64, 3), (1, 90, 70, 3)])


def test_num_processes_trees_equal(data, tmp_path):
    src, lm = data
    _, t = _pair(lm, strategy="all")
    one = _bytes(_run(t, src, str(tmp_path / "p1")))
    t.num_processes = 4
    four = _bytes(_run(t, src, str(tmp_path / "p4")))
    assert one == four and len(one) == 11


def test_crop_align_and_tuple_landmarks(data):
    """``crop_align`` on a uniform batch with paddings and on a ragged
    list, and (landmarks, names) arrays instead of a file."""
    src, lm = data
    j, t = _pair(face_crop_plus_tpu_torch.utils.landmarks.parse_landmarks_file(lm))
    rng = np.random.default_rng(3)
    batch = np.stack([smooth_image(rng, 64, 64) for _ in range(3)])
    pad = np.array([[0, 0, 0, 0], [4, 4, 0, 0], [0, 0, 6, 2]])
    pts = np.stack([_points(rng, 56, 56) for _ in range(4)]).astype(np.float32)
    pts[3] = pts[3, :1]  # degenerate: dropped
    idx = [0, 1, 2, 2]
    ours = t.crop_align(batch, pad, idx, pts)
    np.testing.assert_array_equal(ours, j.crop_align(batch, pad, idx, pts))
    assert ours.shape == (3, 64, 64, 3)
    ragged = [smooth_image(rng, 64, 48), smooth_image(rng, 50, 70), smooth_image(rng, 64, 48)]
    ours = t.crop_align(ragged, None, [1, 0, 2], pts[:3])
    np.testing.assert_array_equal(ours, j.crop_align(ragged, None, [1, 0, 2], pts[:3]))
    with pytest.raises(ValueError, match="active detector"):
        t.process_images(batch)


def test_yuv_direct_switch_divergence(data, monkeypatch):
    """``FCPT_NATIVE_WARP=0`` switches off both YUV-direct paths in the
    port; the JAX package's detection-mode gate ignores it."""
    src, lm = data
    j, t = _pair(lm)
    names = ["a.jpg"]
    det_j, det_t = cropper_pair(output_size=64, resize_size=64, det_threshold=-1.0)
    assert t._yuv_crop_eligible() and det_t._host_yuv_rows_ok(names)
    monkeypatch.setenv("FCPT_NATIVE_WARP", "0")
    assert not t._yuv_crop_eligible() and not j._yuv_crop_eligible()
    assert not det_t._host_yuv_rows_ok(names)
    assert det_j._host_yuv_rows_ok(names)
    monkeypatch.delenv("FCPT_NATIVE_WARP")
    for var, val in (("FCPT_YUV_CROP", "0"), ("FCPT_WARP_EXACT", "1")):
        monkeypatch.setenv(var, val)
        assert not t._yuv_crop_eligible() and not det_t._host_yuv_rows_ok(names)
        monkeypatch.delenv(var)
    assert not det_t._host_yuv_rows_ok(["a.png"])


def test_composed_with_parsing(data, tmp_path, monkeypatch):
    """Crops from the landmarks file, parsed into the group tree (tamed
    weights, 128² inference in both packages)."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp

    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)
    src, lm = data
    j, t = cropper_pair(landmarks=lm, output_size=64, batch_size=4, output_format="png",
                        attr_groups={"p3": [3], "no3": [-3]}, mask_groups={"face": [1, 2, 3]})
    assert t.det_model is None and t.par_model is not None
    ours = read_tree(_run(t, src, str(tmp_path / "port")))
    ref = read_tree(_run(j, src, str(tmp_path / "jax")))
    check_parse_tree(ours, ref)
    assert any(k.endswith("_mask" + os.sep + "a00.png") for k in ours)


def test_composed_with_enhancer(data, tmp_path, monkeypatch):
    """Images whose mean face factor is at or below the threshold are
    enhanced before they crop: gated crops within ±2, the others within ±1
    (with an enhancer both packages fit on the device, in float32 sums
    that round differently, and warp on the host in fixed point)."""
    small_enhancers(monkeypatch)
    src, lm = data
    j, t = cropper_pair(landmarks=lm, output_size=64, batch_size=4, output_format="png",
                        enh_threshold=0.05)
    plain = read_tree(_run(_pair(lm, output_format="png")[1], src, str(tmp_path / "plain")))
    ours = read_tree(_run(t, src, str(tmp_path / "port")))
    ref = read_tree(_run(j, src, str(tmp_path / "jax")))
    assert tree_max_diff(ours, ref) <= 2
    changed = [k for k in ours if not np.array_equal(ours[k], plain[k])]
    assert 0 < len(changed) < len(ours)
    same = [k for k in ours if k not in changed]
    assert tree_max_diff({k: ours[k] for k in same}, {k: ref[k] for k in same}) <= 1


def test_cli_landmarks_flag(data, tmp_path):
    """``-l``: the port's CLI writes the JAX CLI's tree, byte for byte."""
    src, lm = data
    trees = {}
    for pkg in ("face_crop_plus_tpu", "face_crop_plus_tpu_torch"):
        out = str(tmp_path / pkg)
        cmd = [sys.executable, "-m", pkg, "-i", src, "-o", out, "-l", lm, "-s", "48", "-st",
               "all", "-b", "5", "-d", "cpu"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-2000:]
        trees[pkg] = _bytes(out)
    assert sorted(trees["face_crop_plus_tpu_torch"]) == _expected_names("all")
    assert trees["face_crop_plus_tpu_torch"] == trees["face_crop_plus_tpu"]
