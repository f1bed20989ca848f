"""Weight conversion CLI: reference ``.pth`` checkpoints → the ``.npz`` both packages read.

Usage::

    python -m face_crop_plus_tpu_torch.convert --pth retinaface_detector.pth \
        --model retinaface [--out weights/retinaface.npz] [--verify]

Counterpart of ``face_crop_plus_tpu.convert``, with its flags, printed
lines and exit codes.  The archive is the JAX layout
(:func:`.models.weights.convert_pth_file`), so either package reads it;
``--out`` defaults to ``<cache dir>/<model>.npz``, the cache both packages
share.  ``--verify`` checks the converted key set against the port's own
network (names and shapes must match exactly, shapes taken to the JAX
layout), which catches conversion/architecture drift without the network.
The reference's checkpoints are at
``https://github.com/mantasu/face-crop-plus/releases/download/v1.0.0/``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .models.weights import (
    PTH_FILENAMES,
    convert_pth_file,
    default_cache_dir,
    save_npz,
)


def _network(model: str) -> torch.nn.Module:
    if model == "retinaface":
        from .models.detection import RetinaFaceNet

        return RetinaFaceNet()
    elif model == "rrdb":
        from .models.enhancement import RRDBNetwork

        return RRDBNetwork()
    elif model == "bisenet":
        from .models.parsing import BiSeNetNet

        return BiSeNetNet()
    raise ValueError(f"Unknown model: {model}")


def model_shapes(model: str) -> dict[str, tuple[int, ...]]:
    """The network's parameter shapes in the JAX layout (HWIO kernels),
    from a network built on the meta device (no memory, no init work)."""
    with torch.device("meta"):
        net = _network(model)
    shapes = {}
    for key, val in net.state_dict().items():
        shape = tuple(int(d) for d in val.shape)
        if key.rpartition(".")[2] == "weight" and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW → HWIO
        shapes[key] = shape
    return shapes


def verify_structure(converted: dict, model: str) -> list[str]:
    """Returns a list of mismatch descriptions (empty = exact match)."""
    expected = model_shapes(model)
    problems = []
    for k in sorted(set(expected) - set(converted)):
        problems.append(f"missing from checkpoint: {k} {expected[k]}")
    for k in sorted(set(converted) - set(expected)):
        problems.append(f"unexpected in checkpoint: {k} {np.shape(converted[k])}")
    for k in sorted(set(converted) & set(expected)):
        if tuple(np.shape(converted[k])) != expected[k]:
            problems.append(
                f"shape mismatch: {k} checkpoint {np.shape(converted[k])} "
                f"vs model {expected[k]}"
            )
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pth", required=True, help="Path to the torch .pth checkpoint")
    ap.add_argument(
        "--model",
        choices=sorted(PTH_FILENAMES),
        default=None,
        help="Target model (inferred from the filename when omitted)",
    )
    ap.add_argument("--out", default=None, help="Output .npz path (default: cache dir)")
    ap.add_argument(
        "--verify",
        action="store_true",
        help="Check converted names/shapes against the model structure",
    )
    args = ap.parse_args(argv)

    model = args.model
    if model is None:
        base = os.path.basename(args.pth)
        model = next((name for name, fname in PTH_FILENAMES.items() if base == fname), None)
        if model is None:
            ap.error("--model is required (filename not recognized)")

    converted = convert_pth_file(args.pth)
    print(f"converted {len(converted)} tensors from {args.pth}")

    if args.verify:
        problems = verify_structure(converted, model)
        if problems:
            print(f"VERIFY FAILED ({len(problems)} problems):")
            for p in problems[:40]:
                print("  " + p)
            return 1
        print("verify OK: key set and shapes match the model structure")

    out = args.out or os.path.join(default_cache_dir(), f"{model}.npz")
    if not out.endswith(".npz"):
        out += ".npz"  # np.savez appends it anyway; keep the printed path true
    save_npz(converted, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
