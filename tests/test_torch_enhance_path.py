"""Port parity: gated enhancement on the fused, staged and landmark-free paths.

The JAX ``Cropper`` and the port's run the same configuration on the same
numpy-seeded images with the same tamed detector and enhancer weights
(``torch_parity.cropper_pair``; 2-block enhancers by
``torch_parity.small_enhancers``).  Thresholds sit midway between two
images' mean face factors, never at one: the packages' landmarks differ by
~1e-5 px, which would flip a gate set at a factor.

The JAX side runs jitted, as in ``tests/test_torch_cropper.py``.
``tests/test_torch_pipeline_all.py`` runs it op by op because XLA:CPU's
fused fit and warp round a sample coordinate differently in two of its
uses, which moved rare pixels of far-outside samples by up to ~20 levels
over hundreds of random candidates; the crops here (at most 4 faces an
image) hold their tolerances under jit, and op by op the file took 61 s
instead of 41.

Tolerances: face indices and gated sets exact; crops of non-gated faces
within ±1 level, crops of gated faces within ±2 (the enhanced interim is
itself ±1, and the warp samples it); enhanced originals within ±1; parse
trees through ``torch_parity.check_parse_tree``.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import face_crop_plus_tpu.models.enhancement as je
import face_crop_plus_tpu_torch.models.enhancement as te
import face_crop_plus_tpu_torch.pipeline as tpipe
from face_crop_plus_tpu_torch.utils.batching import pad_batch_to

from torch_parity import (
    check_parse_tree,
    cropper_pair,
    read_tree,
    small_enhancers,
    smooth_image,
    tree_max_diff,
    write_mixed_dir,
    write_tamed_npz,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small parity runs share the machine's
    cores with the suite's other workers, where 8 threads each oversubscribe
    it (a 2 s test took 40 s in the 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(monkeypatch, **kw):
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    small_enhancers(monkeypatch)
    base = dict(output_size=32, resize_size=64, det_threshold=-1.0, batch_size=4,
                enh_threshold=1.0)
    return cropper_pair(**{**base, **kw})


def _batch(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return np.stack([smooth_image(rng, h, w) for _ in range(n)])


def _record_gates(monkeypatch):
    """Records the factors each package's gate computes: {"jax": [...],
    "port": [...]}, one array per call."""
    seen = {"jax": [], "port": []}

    def spy(real, key):
        def f(*args, **kwargs):
            out = real(*args, **kwargs)
            seen[key].append(out)
            return out
        return f

    monkeypatch.setattr(je, "mean_face_factor", spy(je.mean_face_factor, "jax"))
    monkeypatch.setattr(te, "mean_face_factor", spy(te.mean_face_factor, "port"))
    monkeypatch.setattr(tpipe, "mean_face_factor", spy(tpipe.mean_face_factor, "port"))
    return seen


def _midway(factors: np.ndarray, k: int) -> float:
    """A threshold midway between the k-th and (k+1)-th smallest factors."""
    f = np.sort(factors[np.isfinite(factors)])
    return float(f[k - 1] + f[k]) / 2


def _set_threshold(j, t, thr):
    j.enh_model.min_face_factor = t.enh_model.min_face_factor = thr


def _run_both(j, t, images):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j.process_images(images)
    return ref, t.process_images(images)


def _gated(seen, thr) -> dict:
    return {k: [np.nonzero(f <= thr)[0].tolist() for f in v] for k, v in seen.items()}


def _assert_crops(ref, ours, gated_images):
    """Indices equal; crops ±2 on faces of gated images, ±1 elsewhere."""
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[0].shape == ref[0].shape and len(ours[1]) > 0
    d = np.abs(ours[0].astype(np.int16) - ref[0].astype(np.int16)).reshape(len(ours[1]), -1)
    on_gated = np.isin(ours[1], gated_images)
    assert on_gated.any()
    assert d[on_gated].max() <= 2
    assert d[~on_gated].max(initial=0) <= 1


@pytest.mark.parametrize(
    "strategy,crop_source,shape",
    [("largest", "original", (4, 72, 60)), ("all", "interim", (4, 40, 56))],
)
def test_fused_one_of_four_gated(monkeypatch, strategy, crop_source, shape):
    j, t = _pair(monkeypatch, strategy=strategy, crop_source=crop_source, max_faces=4,
                 auto_grow=False)
    batch = _batch(*shape, seed=sum(shape))
    # The factors from one port detect pass, in the gate's interim frame.
    lm, idx = t._fused.detect_only(batch, t.resize_size)
    scale, _ = tpipe.interim_geometry(shape[1], shape[2], t.resize_size)
    thr = _midway(te.mean_face_factor(lm * scale, idx, 4, (64, 64)), 1)
    _set_threshold(j, t, thr)
    seen = _record_gates(monkeypatch)
    ref, ours = _run_both(j, t, batch)
    gated = _gated(seen, thr)
    assert gated["jax"] == gated["port"] and len(gated["port"]) == 1
    assert len(gated["port"][0]) == 1
    _assert_crops(ref, ours, gated["port"][0])

    # Faces of other images crop as without an enhancer, bitwise; the
    # gated image's faces sample the enhanced interim.
    t.enh_model.min_face_factor = -np.inf
    off = t.process_images(batch)
    np.testing.assert_array_equal(off[1], ours[1])
    on_gated = np.isin(ours[1], gated["port"][0])
    np.testing.assert_array_equal(off[0][~on_gated], ours[0][~on_gated])
    assert (off[0][on_gated] != ours[0][on_gated]).any()


def test_staged_ragged_gated(monkeypatch):
    j, t = _pair(monkeypatch, strategy="largest", padding="replicate")
    rng = np.random.default_rng(21)
    images = [smooth_image(rng, *hw) for hw in ((72, 60), (50, 90), (64, 40))]
    _, _, lm, idx = t._detect_interim(images)
    thr = _midway(te.mean_face_factor(lm, idx, 3, (64, 64)), 1)
    _set_threshold(j, t, thr)
    seen = _record_gates(monkeypatch)
    ref, ours = _run_both(j, t, images)
    assert t._fused_shapes == j._fused_shapes == set()
    gated = _gated(seen, thr)
    assert gated["jax"] == gated["port"] and [len(g) for g in gated["port"]] == [1]
    _assert_crops(ref, ours, gated["port"][0])
    stage = t.stats.as_dict()["enhance"]
    assert stage["calls"] == 1 and stage["items"] == 3


def test_staged_detect_padding_keeps_crops(monkeypatch):
    """The staged detect pads its batch to a measured size; crops and
    indices equal the unpadded run's, and no padding row's face surfaces."""
    import face_crop_plus_tpu_torch.cropper as tcrop

    _, t = _pair(monkeypatch, enh_threshold=None, strategy="all", max_faces=4,
                 auto_grow=False, batch_size=8)
    rng = np.random.default_rng(22)
    images = [smooth_image(rng, *hw) for hw in ((72, 60), (50, 90), (64, 40))]
    sizes = []
    real = t.det_model.predict

    def spy(batch):
        sizes.append(len(batch))
        return real(batch)

    t.det_model.predict = spy
    monkeypatch.setattr(tcrop, "STAGED_PAD_SIZES", (1, 4))
    assert [t._staged_pad_size(n) for n in (1, 2, 4, 5, 8, 9)] == [1, 4, 4, 8, 8, 9]
    padded = t._detect_crop_staged(images)
    monkeypatch.setattr(tcrop, "STAGED_PAD_SIZES", (1, 2, 3))
    unpadded = t._detect_crop_staged(images)
    assert sizes == [4, 3]
    np.testing.assert_array_equal(padded[1], unpadded[1])
    np.testing.assert_array_equal(padded[0], unpadded[0])
    assert padded[1].max() == 2 and len(padded[1]) > 3
    # The padding row repeats image 2, whose faces it finds again.
    _, idx = real(pad_batch_to(t._detect_interim(images)[0].numpy(), 4)[0])
    assert 3 in idx


def test_parser_handoff_only_when_nothing_gated(monkeypatch):
    _, t = _pair(monkeypatch, strategy="largest")
    batch = _batch(4, 72, 60, seed=23)
    lm, idx = t._fused.detect_only(batch, t.resize_size)
    scale, _ = tpipe.interim_geometry(72, 60, t.resize_size)
    factors = te.mean_face_factor(lm * scale, idx, 4, (64, 64))
    handles = {}
    for name, thr in (("none", -np.inf), ("one", _midway(factors, 1))):
        t.enh_model.min_face_factor = thr
        out = t._fused.process(batch, t.resize_size, return_device_crops=True)
        handles[name] = out[3]
        if out[3] is not None:
            assert torch.equal(out[3][: len(out[0])], torch.from_numpy(out[0]))
    assert handles["none"] is not None and handles["one"] is None


def test_landmark_free_enhances_and_parses(monkeypatch, tmp_path):
    """``det_threshold=None``: every original is enhanced (ragged ones in a
    bucket per shape), then parsed whole when groups are set."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp
    from face_crop_plus_tpu_torch.utils.io import imwrite

    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)
    rng = np.random.default_rng(24)
    uni, rag = tmp_path / "uni", tmp_path / "rag"
    for d, shapes in ((uni, [(40, 48)] * 3), (rag, [(40, 48), (36, 20), (40, 48)])):
        d.mkdir()
        for i, hw in enumerate(shapes):
            imwrite(str(d / f"{i}.png"), smooth_image(rng, *hw))
    for src, groups in ((uni, dict(mask_groups={"face": [1, 2, 12, 13], "c9": [9]})),
                        (rag, {})):
        j, t = _pair(monkeypatch, det_threshold=None, output_format="png", **groups)
        trees = {}
        for name, c in (("jax", j), ("port", t)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                c.process_dir(str(src), str(tmp_path / f"{src.name}_{name}"), desc=None)
            trees[name] = read_tree(str(tmp_path / f"{src.name}_{name}"))
        check_parse_tree(trees["port"], trees["jax"])
        originals = read_tree(str(src))
        crops = [k for k in trees["port"] if os.path.dirname(k) in ("", "face", "c9")]
        assert crops and all(
            np.abs(trees["port"][k].astype(np.int16) - originals[os.path.basename(k)]).max() > 5
            for k in crops)
        assert t.stats.as_dict()["enhance"]["items"] == 3


def test_process_dir_and_cli_with_et(monkeypatch, tmp_path):
    """The CLI's ``-et`` writes the tree ``process_dir`` with
    ``enh_threshold`` writes, byte for byte, over two fused images and a
    staged one, every face gated; without ``-et`` the crops differ.  The
    JAX CLI's tree with ``-et`` is held in
    ``tests/test_torch_cli.py::test_ported_flags_run``."""
    import face_crop_plus_tpu_torch
    import face_crop_plus_tpu_torch.__main__ as cli

    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path / "no-cache"))
    small_enhancers(monkeypatch)
    src, wdir = str(tmp_path / "in"), str(tmp_path / "w")
    write_mixed_dir(src)
    for f in os.listdir(src):
        if f not in ("a00.jpg", "a01.jpg", "b0.jpg"):
            os.remove(os.path.join(src, f))
    write_tamed_npz(wdir)
    argv = ["-i", src, "-r", "64", "-s", "32", "-dt", "0", "-b", "4", "-f", "png", "-w", wdir,
            "-d", "cpu", "-et", "1"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(argv + ["-o", str(tmp_path / "cli")])
        cli.main(argv[:-2] + ["-o", str(tmp_path / "plain")])
        c = face_crop_plus_tpu_torch.Cropper(
            device="cpu", resize_size=64, output_size=32, det_threshold=0.0, batch_size=4,
            output_format="png", weights_dir=wdir, enh_threshold=1.0)
        c.process_dir(src, str(tmp_path / "dir"), desc=None)
    ours, direct = read_tree(str(tmp_path / "cli")), read_tree(str(tmp_path / "dir"))
    assert sorted(ours) == ["a00.png", "a01.png", "b0.png"] and tree_max_diff(direct, ours) == 0
    assert c.stats.as_dict()["enhance"]["calls"] == 1  # the staged image
    assert tree_max_diff(read_tree(str(tmp_path / "plain")), ours) > 2
