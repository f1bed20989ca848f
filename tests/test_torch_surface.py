"""Port parity: the package surface — the re-exports, the batching and
profiling helpers, and the weight of an import.

Every public name of a JAX subpackage (its ``__all__``) imports from the
port's counterpart, except ``parallel``'s ``batch_sharding`` and
``replicated``, which build ``NamedSharding`` objects that torch lacks.
``as_numpy``, ``as_device`` and ``bucket_size`` run against the JAX
functions on the same inputs.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import face_crop_plus_tpu
import face_crop_plus_tpu.models
import face_crop_plus_tpu.ops
import face_crop_plus_tpu.parallel
import face_crop_plus_tpu.utils
import face_crop_plus_tpu_torch
import face_crop_plus_tpu_torch.models
import face_crop_plus_tpu_torch.ops
import face_crop_plus_tpu_torch.parallel
import face_crop_plus_tpu_torch.utils
from face_crop_plus_tpu.utils import batching as jb
from face_crop_plus_tpu_torch.utils import batching as tb
from face_crop_plus_tpu_torch.utils import profiling as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The JAX names with no torch counterpart.
NO_COUNTERPART = {"batch_sharding", "replicated"}

SUBPACKAGES = ["", ".models", ".ops", ".utils", ".parallel"]


def _pair(sub: str):
    return (sys.modules[f"face_crop_plus_tpu{sub}"],
            sys.modules[f"face_crop_plus_tpu_torch{sub}"])


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_name_imports_from_the_port(sub):
    jax_mod, port_mod = _pair(sub)
    names = [n for n in jax_mod.__all__ if n not in NO_COUNTERPART]
    missing = [n for n in names if not hasattr(port_mod, n)]
    assert not missing, missing
    assert set(names) <= set(port_mod.__all__)
    if sub != ".parallel":  # the port's parallel adds the mesh's own names
        assert port_mod.__all__ == jax_mod.__all__
    for n in names:  # the same kind of thing under each name
        assert callable(getattr(port_mod, n)) == callable(getattr(jax_mod, n)), n


def test_version_is_the_jax_packages_and_the_projects():
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        declared = re.search(r'^version = "([^"]+)"', f.read(), re.M).group(1)
    assert face_crop_plus_tpu_torch.__version__ == face_crop_plus_tpu.__version__ == declared


def test_constants_equal_jax():
    from face_crop_plus_tpu_torch.utils import STANDARD_LANDMARKS_5

    np.testing.assert_array_equal(STANDARD_LANDMARKS_5,
                                  face_crop_plus_tpu.utils.STANDARD_LANDMARKS_5)
    assert face_crop_plus_tpu_torch.ops.BORDER_MODES == face_crop_plus_tpu.ops.BORDER_MODES


def test_imports_stay_light():
    """Importing the package and every subpackage loads no jax and nothing
    of the JAX package, builds nothing, loads no kernel library and does
    not initialise CUDA."""
    code = (
        "import json, sys, torch\n"
        "import face_crop_plus_tpu_torch, face_crop_plus_tpu_torch.models\n"
        "import face_crop_plus_tpu_torch.ops, face_crop_plus_tpu_torch.utils\n"
        "import face_crop_plus_tpu_torch.parallel, face_crop_plus_tpu_torch.convert\n"
        "from face_crop_plus_tpu_torch.models import RetinaFace, RRDBNet, BiSeNet\n"
        "from face_crop_plus_tpu_torch.ops.cuda import build\n"
        "from face_crop_plus_tpu_torch.utils import native_io\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('face_crop_plus_tpu.')"
        " or m == 'face_crop_plus_tpu']\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps({'bad': bad, 'kernel_libs': sorted(build._libs), 'built': build.build_info,\n"
        "       'native': native_io._status, 'cuda': torch.cuda.is_initialized(),\n"
        "       'mapped': 'libfcpt_io' in maps or '/_build/lib' in maps}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    state = json.loads(proc.stdout.strip().splitlines()[-1])
    assert state == {"bad": [], "kernel_libs": [], "built": {}, "native": "not loaded",
                     "cuda": False, "mapped": False}


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------


def test_bucket_size():
    buckets = (1, 2, 4, 8)
    assert tb.bucket_size(1, buckets) == 1
    assert tb.bucket_size(3, buckets) == 4
    assert tb.bucket_size(8, buckets) == 8
    # Beyond the largest bucket: the next multiple of it, so the
    # bucket_size → pad_batch_to pairing never raises.
    assert tb.bucket_size(9, buckets) == 16
    assert tb.bucket_size(17, buckets) == 24
    padded, valid = tb.pad_batch_to(
        np.zeros((9, 2, 2, 3), np.uint8), tb.bucket_size(9, buckets)
    )
    assert padded.shape[0] == 16 and valid == 9
    for bs in [(1, 2, 4, 8), (3,), (2, 5, 16)]:
        for n in range(0, 40):
            assert tb.bucket_size(n, bs) == jb.bucket_size(n, bs), (n, bs)


def test_as_numpy_matches_jax():
    x = np.random.default_rng(0).uniform(0, 255.99, (2, 5, 4, 3)).astype(np.float32)
    ref = jb.as_numpy(jnp.asarray(x))
    got = tb.as_numpy(torch.from_numpy(x))
    assert got.dtype == np.uint8 and got.shape == (2, 5, 4, 3)
    np.testing.assert_array_equal(got, ref)
    u8 = torch.from_numpy(np.arange(24, dtype=np.uint8).reshape(2, 2, 2, 3))
    np.testing.assert_array_equal(tb.as_numpy(u8), u8.numpy())
    ragged = [torch.from_numpy(x[0]), torch.from_numpy(x[1, :3])]
    got = tb.as_numpy(ragged)
    ref = jb.as_numpy([jnp.asarray(x[0]), jnp.asarray(x[1, :3])])
    assert isinstance(got, list) and len(got) == 2
    for a, b in zip(got, ref):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    # numpy passes through, as itself.
    host = np.zeros((1, 2, 2, 3), np.uint8)
    assert tb.as_numpy(host) is host
    lst = [host]
    assert tb.as_numpy(lst) is lst and tb.as_numpy([]) == []


def test_as_device_matches_jax():
    x = np.random.default_rng(1).integers(0, 256, (3, 6, 5, 3), dtype=np.uint8)
    got = tb.as_device(x, "cpu")
    ref = np.asarray(jb.as_device(x))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == (3, 6, 5, 3)  # NHWC
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tb.as_numpy(got).tobytes() == x.tobytes()  # and back, bitwise
    ragged = [x[0], x[1, :4]]
    got = tb.as_device(ragged, torch.device("cpu"))
    ref = jb.as_device(ragged)
    assert [tuple(t.shape) for t in got] == [r.shape for r in ref]
    for t, r in zip(got, ref):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    # Tensors, and lists of them, pass through.
    t = torch.zeros(1, 2, 2, 3)
    assert tb.as_device(t, "cpu") is t
    lst = [t]
    assert tb.as_device(lst, "cpu") is lst


def test_as_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.as_device(np.zeros((1, 2, 2, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.as_device([np.zeros((2, 2, 3), np.uint8)], "auto")


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_trace_none_is_a_no_op(tmp_path):
    with tprof.trace(None):
        pass
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace" / "run"  # created
    a = torch.randn(32, 32)
    with tprof.trace(str(log_dir)):
        (a @ a).sum()
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names


def test_host_speed_probe_returns_a_rate():
    rate = tprof.host_speed_probe(reps=3)
    assert isinstance(rate, float) and rate > 0
