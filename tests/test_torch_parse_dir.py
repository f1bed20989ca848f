"""Port parity: parsing in the Cropper, its tree, and the landmark-free mode.

The JAX ``Cropper`` and the port's run the same configuration with the same
tamed detector and parser weights (``FCPT_HOST_CROP=0`` on the JAX side, as
in ``tests/test_torch_dir.py``) and write PNG trees.  Directory and file
names must be equal, crops within ±1, groups equal, and each mask equal to
JAX's except at near-tie pixels of its face
(``torch_parity.check_parse_tree``: a ±1 crop moves the parser's logits a
little, so a label may flip where the JAX top-2 margin is at most
``EPS_CROPS``).  The landmark-free mode parses the very same decoded
originals in both packages, so there the near-tie margin is the logit-level
``EPS`` of ``tests/test_torch_parsing.py``.

Both packages' parsers run at a 128² inference size here (the module
constant, patched in both): routing, handoff, grouping and the tree do not
depend on it, and ``tests/test_torch_parsing.py`` holds the 512² parse.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from face_crop_plus_tpu_torch.utils.io import imwrite

from torch_parity import (
    check_parse_tree,
    cropper_pair,
    read_tree,
    smooth_image,
    write_mixed_dir,
)

#: A positive attribute, a negative one, and mask groups, of which "face"
#: takes every face.  With :func:`_thresholds`, "p3"/"no3" and "c3" split
#: the mixed directory's crops, "p4" and "c4" the uniform originals.
GROUPS = dict(attr_groups={"p3": [3], "no3": [-3], "p4": [4]},
              mask_groups={"face": list(range(1, 19)), "c3": [3], "c4": [4]})
KW = dict(output_size=64, resize_size=64, det_threshold=-1.0, batch_size=4,
          output_format="png", **GROUPS)
EPS = 1e-4


@pytest.fixture(autouse=True)
def small_parse(monkeypatch):
    """The parsers' inference size, 128² in both packages (see above)."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp

    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """Part of the mixed directory: four 72×60 JPEGs (one fused group at
    batch 4), two single-shape JPEGs (staged) and the corrupt file."""
    path = str(tmp_path_factory.mktemp("src"))
    for name in write_mixed_dir(path):
        if name not in ("a00.jpg", "a01.jpg", "a02.jpg", "a03.jpg", "b0.jpg", "b2.jpeg",
                        "z_bad.jpg"):
            os.remove(os.path.join(path, name))
    return path


@pytest.fixture(scope="module")
def uniform_src(tmp_path_factory):
    """Three 218×178 JPEGs: one fused group, or one landmark-free batch."""
    path = str(tmp_path_factory.mktemp("uniform"))
    rng = np.random.default_rng(4)
    for i in range(3):
        imwrite(os.path.join(path, f"u{i}.jpg"), smooth_image(rng, 218, 178, cell=24))
    return path


def _thresholds(*croppers):
    """Raises both parsers' thresholds (knobs overridable after construction)."""
    for c in croppers:
        c.par_model.attr_threshold = c.par_model.mask_threshold = 85
    return croppers


def _run(cropper, src, out, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cropper.process_dir(src, out, desc=None, **kw)
    return read_tree(out)


@pytest.mark.parametrize("strategy,directory", [("largest", "src"), ("all", "uniform_src")])
def test_process_dir_parse_tree_matches_jax(request, tmp_path, monkeypatch, strategy, directory):
    """"largest" over the mixed directory (fused and staged batches, host
    crops to the parser); "all" over one fused group (device handoff)."""
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    src = request.getfixturevalue(directory)
    j, t = _thresholds(*cropper_pair(strategy=strategy, max_faces=2, auto_grow=False, **KW))
    ref = _run(j, src, str(tmp_path / "jax"))
    ours = _run(t, src, str(tmp_path / "port"))
    check_parse_tree(ours, ref)
    dirs = {os.path.dirname(k) for k in ours}
    assert all(d.count("/") == 1 for d in dirs)  # <attr>/<mask>[_mask]
    faces = [k for k in ours if os.path.dirname(k) in ("p3/face", "no3/face")]
    stems = {os.path.splitext(os.path.basename(k))[0] for k in faces}
    n_src = len([f for f in os.listdir(src) if f != "z_bad.jpg"])
    if strategy == "largest":
        assert len(stems) == len(faces) == n_src
        assert {"p3/face_mask", "no3/face", "no3/face_mask", "p3/c3", "p3/c3_mask"} <= dirs
        # Partial membership: "p3" and "no3" split the faces, "c3" too.
        assert 0 < len(os.listdir(tmp_path / "port" / "no3" / "face")) < n_src
        stats = t.stats.as_dict()
        assert set(stats) == {"read", "detect+crop", "detect", "crop", "parse", "save"}
        assert stats["parse"]["items"] == stats["save"]["items"] == n_src
    else:
        assert len(faces) == 2 * n_src and {s.rsplit("_", 1)[0] for s in stems} == {
            os.path.splitext(f)[0] for f in os.listdir(src)}


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_device_handoff_and_host_crops_give_same_groups(uniform_src, tmp_path, monkeypatch,
                                                        strategy):
    """One fused group and nothing staged: the parser reads the fused
    pipeline's device crops, exactly the F real rows of its power-of-two
    bucket.  With the handoff cut, it reads the host crops: the same tree."""
    _, t = _thresholds(*cropper_pair(strategy=strategy, max_faces=3, auto_grow=False,
                                     **dict(KW, batch_size=3)))
    seen = []
    real_predict = t.par_model.predict

    def recording(images, *a, **kw):
        seen.append(images)
        return real_predict(images, *a, **kw)

    monkeypatch.setattr(t.par_model, "predict", recording)
    handed = _run(t, uniform_src, str(tmp_path / "handoff"))
    assert len(t._fused_shapes) == 1  # decoded at a reduced DCT scale
    assert len(seen) == 1 and torch.is_tensor(seen[0])
    n_faces = len([k for k in handed if os.path.dirname(k) in ("p3/face", "no3/face")])
    assert len(seen[0]) == n_faces == 3 * (1 if strategy == "largest" else 3)
    real_fused = t._fused_process
    monkeypatch.setattr(t, "_fused_process", lambda b, return_device_crops=False, **kw: (
        (*real_fused(b, **kw), None) if return_device_crops else real_fused(b, **kw)))
    seen.clear()
    host = _run(t, uniform_src, str(tmp_path / "host"))
    assert len(seen) == 1 and isinstance(seen[0], np.ndarray)
    assert sorted(host) == sorted(handed)
    assert all(np.array_equal(host[k], handed[k]) for k in host)


def test_landmark_free_tree_matches_jax(uniform_src, tmp_path):
    """``det_threshold=None``: the decoded originals are parsed whole (one
    sub-batch padded to ``batch_size``) and pass through to the tree."""
    j, t = _thresholds(*cropper_pair(det_threshold=None, batch_size=2, output_format="png",
                                     **GROUPS))
    assert t.det_model is None and t._fused is None and t.par_model is not None
    ref = _run(j, uniform_src, str(tmp_path / "jax"))
    ours = _run(t, uniform_src, str(tmp_path / "port"))
    check_parse_tree(ours, ref, eps=EPS)
    originals = [k for k in ours if ours[k].ndim == 3]
    assert all(ours[k].shape == (218, 178, 3) for k in originals)
    assert {os.path.dirname(k) for k in ours} >= {"p3/face", "p3/face_mask", "p4/c4", "p4/c4_mask"}
    assert len([k for k in ours if os.path.dirname(k) == "p4/c4"]) == 1
    assert set(t.stats.as_dict()) == {"read", "parse", "save"}


def test_landmark_free_mixed_shapes_raise_like_jax(src, tmp_path):
    j, t = cropper_pair(det_threshold=None, batch_size=16, output_format="png", **GROUPS)
    for c, out in ((j, "jax"), (t, "port")):
        with pytest.raises(ValueError, match="share dimensions"):
            _run(c, src, str(tmp_path / out))
    assert not (tmp_path / "port").exists()


def test_process_images_returns_jax_groups(monkeypatch):
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    j, t = _thresholds(*cropper_pair(**dict(KW, output_format=None)))
    rng = np.random.default_rng(8)
    batch = np.stack([smooth_image(rng, 72, 60) for _ in range(4)])  # fused
    ragged = [smooth_image(rng, 50, 90), smooth_image(rng, 72, 60)]  # staged
    for images in (batch, ragged):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = j.process_images(images)
            ours = t.process_images(images)
        np.testing.assert_array_equal(ours[1], ref[1])
        assert int(np.abs(ours[0].astype(np.int16) - ref[0].astype(np.int16)).max()) <= 1
        attr, mask = ours[2]
        assert attr == ref[2][0] and mask.keys() == ref[2][1].keys() and mask
        for k, (inds, masks) in ref[2][1].items():
            assert mask[k][0] == inds
            assert (mask[k][1] != masks).mean() < 1e-3
    assert t.stats.as_dict()["parse"]["calls"] == 2


def test_process_images_needs_a_detector():
    _, t = cropper_pair(det_threshold=None, output_size=64, **GROUPS)
    with pytest.raises(ValueError, match="requires an active detector"):
        t.process_images(np.zeros((2, 32, 32, 3), np.uint8))


def test_parse_holds_the_device_lock(uniform_src, tmp_path, monkeypatch):
    _, t = cropper_pair(**dict(KW, batch_size=3))
    held = []
    real = t.par_model.predict
    monkeypatch.setattr(t.par_model, "predict",
                        lambda *a, **kw: held.append(t._device_lock.locked()) or real(*a, **kw))
    _run(t, uniform_src, str(tmp_path / "out"))
    assert held == [True]


def test_save_groups_tree_layout(tmp_path):
    """Intersections in ascending face order, masks beside their faces."""
    _, t = cropper_pair(det_threshold=None, output_size=8, output_format="png", **GROUPS)
    faces = np.arange(4 * 8 * 8 * 3, dtype=np.uint8).reshape(4, 8, 8, 3)
    masks = np.stack([np.full((8, 8), 255 * (i % 2), np.uint8) for i in range(3)])
    names = np.array(["d.jpg", "a.jpg", "c.jpg", "b.jpg"])
    t.save_groups(faces, names, str(tmp_path), {"x": [3, 0, 1], "y": [2]},
                  {"m": ([1, 3, 2], masks), "e": ([], masks[:0])})
    tree = read_tree(str(tmp_path))
    assert sorted(tree) == ["x/m/a.png", "x/m/b.png", "x/m_mask/a.png", "x/m_mask/b.png",
                            "y/m/c.png", "y/m_mask/c.png"]
    np.testing.assert_array_equal(tree["x/m_mask/b.png"], masks[1])
    np.testing.assert_array_equal(tree["y/m_mask/c.png"], masks[2])
    np.testing.assert_array_equal(tree["x/m/b.png"][..., ::-1], faces[3])
    t.save_groups(faces[:2], names[:2], str(tmp_path / "plain"), None, None)
    assert sorted(os.listdir(tmp_path / "plain")) == ["a.png", "d.png"]


def test_cli_landmark_free_parse_tree_matches_jax(uniform_src, tmp_path, monkeypatch):
    """``-dt -1 -ag … -mg …`` through both CLIs over uniform originals."""
    import face_crop_plus_tpu.__main__ as jax_cli
    import face_crop_plus_tpu_torch.__main__ as cli

    from torch_parity import write_tamed_npz

    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path / "no-cache"))
    write_tamed_npz(str(tmp_path / "w"))
    argv = ["-i", uniform_src, "-dt", "-1", "-b", "2", "-f", "png", "-w", str(tmp_path / "w"),
            "-d", "cpu", "-ag", '{"p3": [3], "p4": [4]}', "-mg", '{"face": [3, 12], "c4": [4]}']
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_cli.main(argv + ["-o", str(tmp_path / "jax")])
        cli.main(argv + ["-o", str(tmp_path / "port")])
    ours = read_tree(str(tmp_path / "port"))
    check_parse_tree(ours, read_tree(str(tmp_path / "jax")), eps=EPS)
    assert {"p3/face", "p3/face_mask", "p4/face", "p4/c4_mask"} <= {
        os.path.dirname(k) for k in ours}
