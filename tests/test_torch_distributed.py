"""Port: one process per GPU (``parallel.distributed`` and ``-si auto``).

``init_distributed`` and ``host_shard`` keep the JAX package's return
contracts (``face_crop_plus_tpu/parallel/distributed.py``): False and
(0, 1) on a single-process run, True once when this call created the group.
Two CLI processes with ``-si auto`` (``-d cpu``, the landmark-file mode: no
network, as ``tests/test_multihost_sharding.py`` drives the JAX CLI) join
one "gloo" group over localhost and partition the one-process tree, file
for file and byte for byte.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import face_crop_plus_tpu.parallel as jax_parallel
import face_crop_plus_tpu_torch.__main__ as cli
from face_crop_plus_tpu_torch import Cropper
from face_crop_plus_tpu_torch.parallel import host_shard, init_distributed
from face_crop_plus_tpu_torch.utils.io import imwrite

from torch_parity import read_tree, smooth_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
SWITCHES = ("FCPT_HOST_CROP", "FCPT_PACK_UPLOAD", "FCPT_PACK_FETCH")


@pytest.fixture(autouse=True)
def no_topology(monkeypatch):
    """No launcher's variables, and the CLI's switches undone (see
    ``tests/test_torch_cli.py``)."""
    for var in TOPOLOGY + SWITCHES:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_single_process_matches_jax_contract():
    assert init_distributed() is False
    assert host_shard() == (0, 1)
    assert not dist.is_initialized()
    assert host_shard() == jax_parallel.host_shard()


@pytest.mark.parametrize("rank,world", [(0, 2), (2, 3)])
def test_host_shard_reads_the_launcher(monkeypatch, rank, world):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    assert host_shard() == (rank, world)
    # Without MASTER_ADDR/MASTER_PORT there is no group to join.
    assert init_distributed() is False and not dist.is_initialized()


def test_world_of_one_group(tmp_path):
    """A group through a ``file://`` init: True, then False (it exists);
    ``host_shard`` reads the group."""
    url = "file://" + str(tmp_path / "rendezvous")
    try:
        assert init_distributed(url, num_processes=1, process_id=0) is True
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert init_distributed(url, num_processes=1, process_id=0) is False
        assert init_distributed() is False
        assert host_shard() == (0, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("local_rank,device,expected", [
    ("1", None, "cuda:1"), (None, None, "cuda:0"), ("1", "cpu", "cpu"), ("1", "cuda:3", "cuda:3"),
])
def test_si_auto_picks_the_card(monkeypatch, local_rank, device, expected):
    """``-si auto`` with ``-d auto`` runs on ``cuda:{LOCAL_RANK}``; an
    explicit ``-d`` wins.  Parsing builds no Cropper (no card needed)."""
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    argv = ["-i", "in", "-si", "auto"] + ([] if device is None else ["-d", device])
    kwargs = cli.parse_args(argv)
    assert kwargs["device"] == expected
    assert (kwargs["shard_index"], kwargs["num_shards"]) == (1, 3)
    assert cli.parse_args(["-i", "in"])["device"] == "auto"


def test_two_processes_partition_the_tree(tmp_path):
    """Two ``-si auto`` CLI processes, RANK 0/1 of WORLD_SIZE 2 on one
    rendezvous, write disjoint halves of the one-process tree."""
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(0)
    names = [f"p{i}.png" for i in range(7)]
    for name in names:
        imwrite(str(src / name), smooth_image(rng, 40, 32))
    lm = tmp_path / "lm.txt"
    lm.write_text("\n".join(f"{n} 10 14 22 14 16 20 11 27 21 27" for n in names) + "\n")
    args = ["-i", str(src), "-l", str(lm), "-dt", "-1", "-s", "24", "-b", "2", "-d", "cpu"]

    Cropper(output_size=24, landmarks=str(lm), det_threshold=None, batch_size=2,
            device="cpu").process_dir(str(src), str(tmp_path / "one"), desc=None)
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY + SWITCHES}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               LOCAL_RANK="0", FCPT_CACHE_DIR=str(tmp_path / "no-cache"))
    procs = [subprocess.Popen([sys.executable, "-m", "face_crop_plus_tpu_torch", *args,
                               "-o", str(tmp_path / f"out{r}"), "-si", "auto"],
                              cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    one = read_tree(str(tmp_path / "one"))
    halves = [read_tree(str(tmp_path / f"out{r}")) for r in range(2)]
    assert sorted(halves[0]) == names[0::2] and sorted(halves[1]) == names[1::2]
    assert sorted(one) == names
    for half in halves:
        for name, img in half.items():
            np.testing.assert_array_equal(img, one[name])
