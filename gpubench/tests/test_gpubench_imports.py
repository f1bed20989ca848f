"""No run loads JAX or the JAX package; the reference loads nothing of the
package under test."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench.harness import spec
from gpubench.tests.helpers import ROOT, result, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "face_crop_plus_tpu"}
CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_rehearsal_loads_no_jax(workload, trace):
    rc, lines, err, modules = run_cell(workload, "--trace", trace, "--rehearse-cpu")
    assert rc == 0, err[-3000:]
    assert result(lines)["correct"] is True
    assert not modules & FORBIDDEN, sorted(modules & FORBIDDEN)
    assert "face_crop_plus_tpu_torch" in modules


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_package():
    ref = os.path.join(ROOT, "gpubench", "reference")
    for d, _, files in os.walk(ref):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(d, name)
                assert not _imports(path) & (FORBIDDEN | {"face_crop_plus_tpu_torch"}), path
    script = ("import sys; sys.path.insert(0, %r)\n"
              "import gpubench.reference.retinaface, gpubench.reference.geometry, "
              "gpubench.reference.nn, gpubench.reference.pipelines.retinaface_largest\n"
              "print(sorted({n.split('.')[0] for n in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert "face_crop_plus_tpu_torch" not in out and "'jax'" not in out
