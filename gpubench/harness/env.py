"""The run's surroundings: cache directories inside the checkout, the
card's identity and power, and the modules a run must not load."""

from __future__ import annotations

import os
import subprocess
import sys

#: Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "face_crop_plus_tpu")


def prepare(root: str):
    """Fixed cache directories under ``<checkout>/.gpubench``, set before
    torch is imported: the second run of a cell finds what the first
    built.  No weights are fetched."""
    base = os.path.join(root, ".gpubench")
    os.environ["FCPT_NO_DOWNLOAD"] = "1"
    os.environ["FCPT_CACHE_DIR"] = os.path.join(base, "weights")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds, each
    module name compared by its part before the first dot."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_lines() -> list[str]:
    """``nvidia-smi``'s name, power limit and draw, clocks and temperature
    of every card, one line each (empty without the tool)."""
    query = "index,name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def power_limit_w(lines: list[str]) -> float | None:
    """The first card's power limit in watts, from :func:`card_lines`."""
    try:
        return float(lines[0].split(",")[2].strip().split()[0])
    except (IndexError, ValueError):
        return None
