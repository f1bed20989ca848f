"""Port parity: the directory pipeline, ``Cropper.process_dir``.

The JAX ``Cropper`` and the port's read the same mixed directory
(:data:`torch_parity.MIXED_DIR`: six 72×60 JPEGs that take the fused path,
single-shape JPEGs, one decoded at 1/2 DCT scale and one EXIF-rotated, a
PNG that take the staged path, and a corrupt file that warns and is
skipped) with the same tamed detector weights, and write PNG crops.  File
names and counts must be equal.  Pixels: within ±1 with ``FCPT_HOST_CROP=0``
(both packages warp in f32; the network's sums round differently), within
±2 against the JAX default, whose host-crop mode warps in 10-bit fixed
point within ±1 of exact (``tests/test_native_warp.py``).
"""

import os
import threading
import warnings

import numpy as np
import pytest

import face_crop_plus_tpu_torch.cropper as port_cropper
from face_crop_plus_tpu_torch.utils import batching
from face_crop_plus_tpu_torch.utils import io as port_io

from torch_parity import cropper_pair, read_tree, tree_max_diff, write_mixed_dir

KW = dict(output_size=64, resize_size=64, det_threshold=-1.0, batch_size=4,
          output_format="png")


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("src"))
    write_mixed_dir(path)
    return path


@pytest.fixture(scope="module")
def pairs():
    """One (JAX, port) Cropper pair per strategy, shared by the module."""
    return {s: cropper_pair(strategy=s, **KW) for s in ("largest", "all")}


def _pair(pairs, strategy):
    j, t = pairs[strategy]
    for c in (j, t):
        c._fused_shapes.clear()
        c.num_processes = 1
    return j, t


def _run(cropper, src, out, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cropper.process_dir(src, out, desc=None, **kw)
    return read_tree(src + "_faces" if out is None else out)


@pytest.mark.parametrize("strategy", ["largest", "all"])
@pytest.mark.parametrize("jax_mode,tol", [("device warp", 1), ("default", 2)])
def test_process_dir_matches_jax(pairs, src, tmp_path, monkeypatch, strategy, jax_mode, tol):
    monkeypatch.delenv("FCPT_HOST_CROP", raising=False)
    if jax_mode == "device warp":
        monkeypatch.setenv("FCPT_HOST_CROP", "0")
    j, t = _pair(pairs, strategy)
    ref = _run(j, src, str(tmp_path / "jax"))
    ours = _run(t, src, str(tmp_path / "port"))
    assert tree_max_diff(ours, ref) <= tol
    n_src = len(os.listdir(src)) - 1  # the corrupt file
    if strategy == "largest":
        assert sorted(ours) == sorted(f"{os.path.splitext(f)[0]}.png"
                                      for f in os.listdir(src) if f != "z_bad.jpg")
    else:
        stems = {k.rsplit("_", 1)[0] for k in ours}
        assert len(stems) == n_src and len(ours) > n_src
    assert all(v.shape == (64, 64, 3) for v in ours.values())
    assert not any(".tmp-" in k for k in ours)
    # Both paths ran: the 72×60 group fused, the single shapes staged.
    assert t._fused_shapes == {(72, 60, 3)}


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_predict_matches_jax(pairs, monkeypatch, strategy):
    """The staged detector call: exact face indices, landmarks to f32 noise."""
    j, t = _pair(pairs, strategy)
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in
            [(72, 60), (50, 90), (150, 200)]]
    batch, _, _ = batching.as_batch(imgs, (64, 64))
    lm, idx = t.det_model.predict(batch)
    ref_lm, ref_idx = j.det_model.predict(batch)
    assert idx == ref_idx and isinstance(idx, list)
    assert lm.dtype == np.float32 and lm.shape == ref_lm.shape == (len(idx), 5, 2)
    np.testing.assert_allclose(lm, ref_lm, rtol=1e-4, atol=1e-3)
    if strategy == "all":
        assert idx == sorted(idx) and len(idx) > 3


def test_routing_matches_jax(pairs):
    """``_fused_eligible``: the same sticky, bounded grants as the JAX rule."""
    j, t = _pair(pairs, "largest")
    j.max_fused_shapes = t.max_fused_shapes = 2
    try:
        calls = [((8, 8, 3), 1), ((8, 8, 3), 2), ((9, 9, 3), 1), ((8, 8, 3), 1),
                 ((9, 9, 3), 4), ((7, 7, 3), 4), ((9, 9, 3), 1), ((6, 6, 3), 8)]
        got = [t._fused_eligible(s, n) for s, n in calls]
        assert got == [j._fused_eligible(s, n) for s, n in calls]
        assert got == [False, True, False, True, True, False, True, False]
    finally:
        j.max_fused_shapes = t.max_fused_shapes = 4


def test_skip_existing_and_output_dir_none(pairs, src, tmp_path, monkeypatch):
    j, t = _pair(pairs, "largest")
    full = _run(t, src, str(tmp_path / "full"))
    # output_dir=None writes beside the input.
    local = tmp_path / "in"
    local.mkdir()
    for f in os.listdir(src):
        (local / f).write_bytes(open(os.path.join(src, f), "rb").read())
    _run(t, str(local), None)
    assert read_tree(str(tmp_path / "in_faces")).keys() == full.keys()
    for f in ("a01.png", "b1.png"):
        os.remove(tmp_path / "in_faces" / f)

    read = []
    real = port_cropper.read_images

    def recording(file_names, *a, **kw):
        read.extend(file_names)
        return real(file_names, *a, **kw)

    monkeypatch.setattr(port_cropper, "read_images", recording)
    # Same process, so the 72×60 shape keeps its fused grant and the lone
    # a01.jpg of its resumed batch is cropped as in the full run.
    _run(t, str(local), None, skip_existing=True)
    # The corrupt file never produced a crop, so it is read again.
    assert sorted(read) == ["a01.jpg", "b1.jpg", "z_bad.jpg"]
    resumed = read_tree(str(tmp_path / "in_faces"))
    redone = {"a01.png", "b1.png"}
    # Batches of another size round the CPU convolutions differently.
    assert tree_max_diff({k: resumed[k] for k in redone}, {k: full[k] for k in redone}) <= 1
    kept = set(full) - redone
    assert tree_max_diff({k: resumed[k] for k in kept}, {k: full[k] for k in kept}) == 0


def test_shards_partition_the_listing(pairs, src, tmp_path, monkeypatch):
    j, t = _pair(pairs, "largest")
    read = []
    real = port_cropper.read_images

    def recording(file_names, *a, **kw):
        read.append(list(file_names))
        return real(file_names, *a, **kw)

    monkeypatch.setattr(port_cropper, "read_images", recording)
    files = sorted(os.listdir(src))
    out = str(tmp_path / "out")
    for i in range(3):
        read.clear()
        _run(t, src, out, shard_index=i, num_shards=3)
        assert [f for b in read for f in b] == files[i::3]
        assert all(len(b) <= t.batch_size for b in read)
    t._fused_shapes.clear()
    assert read_tree(out).keys() == _run(t, src, str(tmp_path / "all")).keys()


def test_occurrence_zero_written_last_like_jax(pairs, src, tmp_path, monkeypatch):
    j, t = _pair(pairs, "all")
    writes = {"jax": [], "port": []}

    def recorder(key, real):
        def imwrite(path, img):
            writes[key].append(os.path.basename(path))
            return real(path, img)
        return imwrite

    import face_crop_plus_tpu.cropper as jax_cropper

    monkeypatch.setattr(jax_cropper, "imwrite", recorder("jax", jax_cropper.imwrite))
    monkeypatch.setattr(port_cropper, "imwrite", recorder("port", port_cropper.imwrite))
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    _run(j, src, str(tmp_path / "jax"))
    _run(t, src, str(tmp_path / "port"))
    assert writes["port"] == writes["jax"]
    for stem in {w.rsplit("_", 1)[0] for w in writes["port"]}:
        own = [w for w in writes["port"] if w.rsplit("_", 1)[0] == stem]
        assert len(own) > 1 and own[-1] == f"{stem}_0.png"


def test_num_processes_4_equals_1(pairs, src, tmp_path):
    """Four worker threads share the detector, its grown caps and the
    device: the tree must equal the one-thread tree bitwise."""
    _, t = _pair(pairs, "all")
    t.batch_size = 2
    try:
        one = _run(t, src, str(tmp_path / "one"))
        t._fused_shapes.clear()
        t.num_processes = 4
        four = _run(t, src, str(tmp_path / "four"))
    finally:
        t.batch_size, t.num_processes = KW["batch_size"], 1
    assert tree_max_diff(four, one) == 0 and len(one) > 12


def test_stats_stages(pairs, src, tmp_path):
    _, t = _pair(pairs, "largest")
    t.stats = port_cropper.PipelineStats()
    _run(t, src, str(tmp_path / "out"))
    got = t.stats.as_dict()
    assert set(got) == {"read", "detect+crop", "detect", "crop", "save"}
    assert got["read"]["items"] == len(os.listdir(src))
    assert got["detect+crop"]["items"] == 6 and got["save"]["items"] == 11
    assert got["detect"]["items"] == got["crop"]["items"] == 5


def test_process_dir_raises_without_encoder(pairs, src, tmp_path, monkeypatch):
    _, t = _pair(pairs, "largest")
    monkeypatch.setattr(port_io, "_HAS_CV2", False)
    monkeypatch.setattr(port_io, "_HAS_PIL", False)
    called = threading.Event()
    monkeypatch.setattr(port_cropper, "read_images", lambda *a, **k: called.set())
    with pytest.raises(RuntimeError, match="encoding backend"):
        t.process_dir(src, str(tmp_path / "out"), desc=None)
    assert not called.is_set() and not (tmp_path / "out").exists()
