"""Port parity: the CLI, ``python -m face_crop_plus_tpu_torch``.

Both CLIs run as subprocesses on the same mixed directory with the same
``-w`` weights (the tamed detector written as ``retinaface.npz``, the file
both packages read) and ``-d cpu``; the trees must have equal names and
pixels within ±1 (``-hc 0``: both warp in f32).  Argument parsing,
including the ``-c`` JSON layering, must give the JAX CLI's kwargs; the
landmark-free mode (``-dt -1``), parsing (``-ag``, ``-mg``) and enhancement
(``-et``) write the JAX CLI's tree; so do the host path's flags: a
landmarks file (``-l``, byte for byte), the host-crop mode (``-hc 1``) and
packed uploads (``-pu 1``) within ±1, packed fetches (``-pf 1``, JPEG
files of rows within ±1, both warping in float: ``FCPT_NATIVE_WARP=0``)
within 0.5 levels in mean and 8 at most.  ``-si auto`` (one process per
GPU) is held by ``tests/test_torch_distributed.py``.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import face_crop_plus_tpu.__main__ as jax_cli
import face_crop_plus_tpu_torch.__main__ as cli

from torch_parity import (
    check_parse_tree,
    nfkd_ascii,
    read_tree,
    small_enhancers,
    tree_max_diff,
    write_mixed_dir,
    write_tamed_npz,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_SWITCHES = ("FCPT_HOST_CROP", "FCPT_PACK_UPLOAD", "FCPT_PACK_FETCH")


@pytest.fixture
def clean_env(monkeypatch):
    """The CLIs write their wire flags into the environment; undo that.

    ``setenv`` first: ``delenv`` of an absent variable records nothing, so
    a value the CLI sets would outlive the test and reach later test files
    of the same worker.
    """
    for k in ENV_SWITCHES:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_cli_matches_jax(tmp_path, strategy):
    src, wdir = str(tmp_path / "in"), str(tmp_path / "w")
    write_mixed_dir(src)
    write_tamed_npz(wdir)
    # -dt 0 keeps every candidate of the tamed detector; a negative
    # threshold would switch detection off.
    common = ["-i", src, "-r", "64", "-s", "64", "-dt", "0", "-b", "4", "-f", "png",
              "-st", strategy, "-w", wdir, "-d", "cpu", "-hc", "0"]
    env = {k: v for k, v in os.environ.items() if k not in ENV_SWITCHES}
    env["FCPT_CACHE_DIR"] = str(tmp_path / "no-cache")
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-m", pkg, *common, "-o", str(tmp_path / pkg)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pkg in ("face_crop_plus_tpu", "face_crop_plus_tpu_torch")
    }
    for pkg, p in procs.items():
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"{pkg}:\n{out[-3000:]}"
    ref = read_tree(str(tmp_path / "face_crop_plus_tpu"))
    ours = read_tree(str(tmp_path / "face_crop_plus_tpu_torch"))
    assert len(ours) >= 11 and tree_max_diff(ours, ref) <= 1


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["-st", "all", "-s", "128", "96", "-r", "512", "-p", "reflect", "-ng", "-dt", "-1"],
        ["-si", "1", "-ns", "3", "-se", "-cs", "interim", "-mfs", "2", "-n", "4"],
        ["-hc", "0", "-pu", "0", "-f", "png", "-a", "-ff", "0.8", "-b", "3"],
    ],
)
def test_parse_args_matches_jax(clean_env, argv):
    argv = ["-i", "in"] + argv
    ours = cli.parse_args(argv)
    assert ours == jax_cli.parse_args(argv)


def test_config_layering_matches_jax(clean_env, tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "strategy": "all", "batch_size": 3, "output_size": [96, 96],
        "det_threshold": -1, "help": True, "not_a_flag": 1,
    }))
    argv = ["-c", str(cfg), "-i", "in", "-b", "5"]
    ours = cli.parse_args(argv)
    assert ours == jax_cli.parse_args(argv)
    assert ours["strategy"] == "all" and ours["batch_size"] == 5
    assert ours["output_size"] == [96, 96] and ours["det_threshold"] is None
    assert "help" not in ours and "not_a_flag" not in ours


def test_requires_input_dir():
    with pytest.raises(ValueError, match="Input directory"):
        cli.parse_args([])


def _landmarks_for(src: str) -> str:
    """A whitespace landmarks file for the readable files of ``src``, two
    rows for a00.jpg and none for a01.jpg."""
    from face_crop_plus_tpu_torch.utils.io import read_images

    images, names = read_images(sorted(os.listdir(src)), src)
    rows = []
    for name, im in zip(names, images):
        h, w = im.shape[:2]
        pts = [0.36 * w, 0.42 * h, 0.64 * w, 0.42 * h, 0.5 * w, 0.56 * h, 0.38 * w, 0.74 * h,
               0.62 * w, 0.74 * h]
        for shift in ((0, 3) if name == "a00.jpg" else () if name == "a01.jpg" else (0,)):
            rows.append(name + " " + " ".join(f"{v + shift:.3f}" for v in pts))
    path = os.path.join(os.path.dirname(src), "lm.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for in-process CLI runs, which share the
    machine's cores with the suite's other workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [["-l"], ["-hc", "1"], ["-pu", "1"], ["-pf", "1"]])
def test_host_path_flags_match_jax(clean_env, one_torch_thread, tmp_path, monkeypatch, extra):
    """Flags once refused reach the host path and write the JAX CLI's tree."""
    from face_crop_plus_tpu_torch.utils import native_io

    if not native_io.native_warp_available():
        pytest.skip("the native host library did not build")
    src, wdir = str(tmp_path / "in"), str(tmp_path / "w")
    write_mixed_dir(src)
    write_tamed_npz(wdir)
    if extra == ["-l"]:
        extra = ["-l", _landmarks_for(src), "-st", "all"]
    fmt = "jpg" if extra[0] in ("-l", "-pf") else "png"
    if extra[0] == "-pf":
        monkeypatch.setenv("FCPT_NATIVE_WARP", "0")
    argv = ["-i", src, "-r", "64", "-s", "64", "-dt", "0", "-b", "4", "-f", fmt, "-w", wdir,
            "-d", "cpu", *extra]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_cli.main(argv + ["-o", str(tmp_path / "jax")])
        cli.main(argv + ["-o", str(tmp_path / "port")])
    ref, ours = read_tree(str(tmp_path / "jax")), read_tree(str(tmp_path / "port"))
    assert len(ours) >= 10
    if extra[0] == "-l":
        for name in ours:
            with open(tmp_path / "jax" / name, "rb") as a, open(tmp_path / "port" / name,
                                                                 "rb") as b:
                assert a.read() == b.read(), name
        assert "a00_1.jpg" in ours and not any(k.startswith("a01") for k in ours)
        return
    if extra[0] != "-pf":
        assert tree_max_diff(ours, ref) <= 1
        return
    # JPEG files of rows within ±1: a re-encode may move a coefficient a
    # quantization step, so a few pixels differ by more.
    assert sorted(ours) == sorted(ref)
    diffs = [np.abs(ours[k].astype(np.int16) - ref[k]) for k in ours]
    assert max(float(d.mean()) for d in diffs) < 0.5 and max(int(d.max()) for d in diffs) <= 8


@pytest.mark.parametrize(
    "extra",
    [
        ["-dt", "-1"],  # no detector, no landmarks: the landmark-free mode
        ["-ag", '{"p3": [3], "no3": [-3]}'],
        ["-mg", '{"face": [3, 12, 17], "c14": [14]}'],
        ["-et", "1"],  # every face gated (2-block enhancers)
    ],
)
def test_ported_flags_run(clean_env, tmp_path, monkeypatch, extra):
    """Flags once refused run and write the JAX CLI's tree: images passed
    through whole, crops in their ``<attr>``/``<mask>[_mask]`` groups, or
    crops from enhanced images."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp

    small_enhancers(monkeypatch)
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path / "no-cache"))
    src, wdir = str(tmp_path / "in"), str(tmp_path / "w")
    write_mixed_dir(src)
    if extra[0] != "-dt":
        # Parsing is the slow part: both parsers run at a 128² inference
        # size (the 512² parse is held in tests/test_torch_parsing.py), on
        # two fused 72×60 files and one staged file.
        for module in (jp, tp):
            monkeypatch.setattr(module, "_INFER_SIZE", 128)
        for f in os.listdir(src):
            if f not in ("a00.jpg", "a01.jpg", "b0.jpg"):
                os.remove(os.path.join(src, f))
    write_tamed_npz(wdir)
    argv = ["-i", src, "-r", "64", "-s", "64", "-dt", "0", "-b", "4", "-f", "png", "-w", wdir,
            "-d", "cpu", "-hc", "0", *extra]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_cli.main(argv + ["-o", str(tmp_path / "jax")])
        cli.main(argv + ["-o", str(tmp_path / "port")])
    ref, ours = read_tree(str(tmp_path / "jax")), read_tree(str(tmp_path / "port"))
    dirs = {os.path.dirname(k) for k in ours}
    if extra[0] == "-et":
        # Crops of gated faces sample the enhanced interim: ±2.
        assert dirs == {""} and len(ours) == 3 and tree_max_diff(ours, ref) <= 2
        return
    check_parse_tree(ours, ref)
    if extra[0] == "-dt":
        assert dirs == {""} and tree_max_diff(ours, ref) == 0 and len(ours) == 11
        assert {v.shape[:2] for v in ours.values()} >= {(72, 60), (50, 90)}
    else:
        assert dirs == ({"p3"} if extra[0] == "-ag" else {"face", "face_mask"})
        assert len(ours) == 3 * (1 if extra[0] == "-ag" else 2)


def test_clean_names_pre_pass(clean_env, tmp_path, monkeypatch):
    from face_crop_plus_tpu_torch.utils import names

    monkeypatch.setattr(names, "_to_ascii", nfkd_ascii)
    src = tmp_path / "in"
    write_mixed_dir(str(src))
    os.rename(src / "a00.jpg", src / "ä 00?.jpg")
    write_tamed_npz(str(tmp_path / "w"))
    with pytest.warns(UserWarning, match="z_bad"):
        cli.main(["-i", str(src) + "/", "-r", "64", "-s", "32", "-dt", "0", "-b", "4",
                  "-d", "cpu", "-cn", "-w", str(tmp_path / "w")])
    out = sorted(os.listdir(tmp_path / "in_faces"))
    assert "a 00.jpg" in out and "ä 00?.jpg" not in out and len(out) == 11
    assert not (tmp_path / "in_temp").exists()
    assert "ä 00?.jpg" in os.listdir(src)
