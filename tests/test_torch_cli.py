"""Port parity: the CLI, ``python -m face_crop_plus_tpu_torch``.

Both CLIs run as subprocesses on the same mixed directory with the same
``-w`` weights (the tamed detector written as ``retinaface.npz``, the file
both packages read) and ``-d cpu``; the trees must have equal names and
pixels within ±1 (``-hc 0``: both warp in f32).  Argument parsing,
including the ``-c`` JSON layering, must give the JAX CLI's kwargs, and
flags for paths the port does not have yet must raise.
"""

import json
import os
import subprocess
import sys

import pytest

import face_crop_plus_tpu.__main__ as jax_cli
import face_crop_plus_tpu_torch.__main__ as cli

from torch_parity import (
    nfkd_ascii,
    read_tree,
    tree_max_diff,
    write_mixed_dir,
    write_tamed_npz,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_SWITCHES = ("FCPT_HOST_CROP", "FCPT_PACK_UPLOAD", "FCPT_PACK_FETCH")


@pytest.fixture
def clean_env(monkeypatch):
    """The CLIs write their wire flags into the environment; undo that."""
    for k in ENV_SWITCHES:
        monkeypatch.delenv(k, raising=False)


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


@pytest.mark.parametrize(
    "extra",
    [
        ["-l", "lm.txt"],
        ["-dt", "-1"],  # no detector, no landmarks: the landmark-free mode
        ["-et", "0.1"],
        ["-ag", '{"g": [1]}'],
        ["-mg", '{"m": [1]}'],
        ["-hc", "1"],
        ["-pu", "1"],
        ["-pf", "1"],
        ["-si", "auto"],
    ],
)
def test_unported_flags_raise(clean_env, tmp_path, extra):
    with pytest.raises(NotImplementedError):
        cli.main(["-i", str(tmp_path), "-d", "cpu", *extra])
    assert os.listdir(tmp_path) == []


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
