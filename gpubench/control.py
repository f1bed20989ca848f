"""The control of each cell's comparison: the reference in TF32, put in
the package's place, judged against the reference in float32.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13

For each seed the cell's weights and inputs are made as a run makes them;
the outputs the judge samples (a request cell's first requests, a
directory cell's whole tree) are produced by the plain reference with
TF32 on for its convolutions and products, the nearest precision below
the configurations' float32, and the cell's own judge compares them with
the reference in float32.  A sound limit is one that this fails.  Prints
one line per seed and a JSON summary; runs on one card whatever the cell
asks for (the reference runs on one card in a run too).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control(cell, seed: int, device, workdir: str) -> tuple[bool, dict]:
    """(correct, checks) of the TF32 reference in the package's place."""
    from gpubench.harness import spec
    from gpubench.reference.nn import precision

    run = spec.entry(cell, seed, device, workdir)
    with precision("float32"):
        run._make_weights()
    run._make_inputs()
    nets = run.reference_nets()
    with precision("tf32"):
        run.control_outputs(nets)
    with precision("float32"):
        result = run.judge(cell.limits, nets)
    run.clean()
    return result


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rehearse-cpu", action="store_true")
    args = p.parse_args(argv)
    from gpubench.harness import env, spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT, args.rehearse_cpu)
    env.prepare(ROOT)
    import torch

    if args.rehearse_cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("control: no CUDA card", file=sys.stderr)
        return 3
    readings = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        correct, checks = control(cell, seed, device,
                                  os.path.join(ROOT, ".gpubench", "control", cell.name))
        readings[seed] = {k: v for k, (v, _) in checks.items()}
        print(f"control {cell.name} seed {seed}: correct={correct} "
              + " ".join(f"{k}={v}" for k, (v, _) in checks.items())
              + f" ({time.perf_counter() - t:.1f} s)", flush=True)
    print(json.dumps({"workload": cell.name, "control": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
