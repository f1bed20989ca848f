"""Helpers of the benchmark's tests: a run of ``gpubench/run.py`` in a
fresh process, and its result line."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_cell(workload: str, *extra: str, root: str = ROOT, prelude: str = "", seconds: str = "1",
             timeout: int = 600) -> tuple[int, list[str], str, set]:
    """Runs ``gpubench/run.py`` under ``root`` in a fresh process (after
    ``prelude``, Python that may plant a fault); returns its exit code,
    its standard output lines, its standard error and the top-level names
    of the modules it held at the end."""
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {root!r})\n"
        f"{prelude}\n"
        "from gpubench import run\n"
        f"rc = run.main({['--workload', workload, '--seed', '12345678901', '--seconds', seconds, *extra]!r})\n"
        "print('MODULES ' + json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=timeout, cwd=root, env=env)
    lines = proc.stdout.splitlines()
    modules = set()
    if lines and lines[-1].startswith("MODULES "):
        modules = set(json.loads(lines.pop()[len("MODULES "):]))
    return proc.returncode, lines, proc.stderr, modules


def result(lines: list[str]) -> dict:
    return json.loads(lines[-1])


def benchmark_copy(dst: str, package: bool = True) -> str:
    """``dst`` holding ``BENCHMARK.json`` and the benchmark's folder (and a
    link to the package under test)."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "gpubench"), os.path.join(dst, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if package:
        os.symlink(os.path.join(ROOT, "face_crop_plus_tpu_torch"),
                   os.path.join(dst, "face_crop_plus_tpu_torch"))
    return dst
