"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the seeded weights and inputs, the package's
models, a warm-up of every shape the traffic uses) is timed from the top
of this file to the first timed request: ``setup_s``.  The window then
drives the cell's entry for ``--seconds``; with ``--trace 1`` under the
profiler, reporting the cell's per-layer metrics instead of its end-to-end
ones.  After the window the package's state is freed and the plain
reference judges a sample of what the window produced.  The last line of
standard output is one JSON object; the last lines of standard error are
the numbers compared, each beside its limit.

Each metric is ``read(ctx)`` of its file.  The untraced ``ctx`` holds
``faces``, ``window_s``, ``setup_s`` and ``latencies`` (request entries).
The traced one holds ``window_s`` (the profiled window), ``cards``,
``summary`` (:func:`gpubench.harness.trace.summarize`, with ``span_s``:
the harness's ``det_net`` wrapper's device seconds), ``work`` (the
wrappers' counts), ``stats`` (the window's ``Cropper.stats`` delta),
``real_flop`` (the reference pipeline's ``window_flop(run, stats)``, or
the sum of its ``image_flop`` over the images done), ``peak_bytes``,
``power_limit_w``, the cell's ``model`` block and cropper settings
``kw``, and ``net_s``: each of the package's network spans that ran
(``det_net``, ``enh_net``, ``parse_net``) → its ``seconds`` on the device
(None where a span has no device events: the CPU) and its ``rows``
(:func:`gpubench.harness.trace.network_spans`).

Exit codes: 0 with a result; 2 when a file of the benchmark or the package
is missing; 3 without the cards the cell needs; 4 when a forbidden module
(JAX or the JAX package) was loaded.  ``--rehearse-cpu`` runs the cell on
the CPU at the tiny sizes of its files' ``rehearse`` entries, for tests.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse-cpu", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _stats_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, now in after.items():
        was = before.get(name, {"seconds": 0.0, "calls": 0, "items": 0})
        out[name] = {k: now[k] - was[k] for k in ("seconds", "calls", "items")}
    return out


def main(argv=None, start: float = T_START) -> int:
    args = _args(argv)
    from gpubench.harness import env, spec

    try:
        cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT, args.rehearse_cpu)
    except (OSError, KeyError, ValueError) as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    env.prepare(ROOT)
    if args.rehearse_cpu:
        # The card's crop path on the CPU: the warp kernel's plain version.
        os.environ["FCPT_HOST_CROP"] = "0"
        os.environ["FCPT_NATIVE_WARP"] = "0"
    parts = {}
    t = time.perf_counter()
    import torch

    try:
        import face_crop_plus_tpu_torch  # noqa: F401
        from face_crop_plus_tpu_torch.utils.profiling import host_speed_probe
    except ImportError as e:
        print(f"gpubench: the package under test is missing: {e}", file=sys.stderr)
        return 2
    parts["import_s"] = time.perf_counter() - t

    if args.rehearse_cpu:
        devices = [torch.device("cpu")] * cell.chips
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"gpubench: {cell.name} needs {cell.chips} CUDA card(s), found {found}",
                  file=sys.stderr)
            return 3
        t = time.perf_counter()
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        for d in devices:
            torch.empty(1, device=d)
            torch.cuda.synchronize(d)
        parts["cuda_init_s"] = time.perf_counter() - t

    cards = env.card_lines()
    for line in cards:
        print(f"card: {line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; host probe "
          f"{host_speed_probe()} codec round trips/s")

    run = spec.entry(cell, args.seed, devices[0], os.path.join(ROOT, ".gpubench", "work", cell.name))
    run.setup()
    parts.update(run.parts)
    from face_crop_plus_tpu_torch.ops.cuda import build

    for source, info in build.build_info.items():
        parts[f"nvcc_{source}_s"] = info["seconds"]
    setup_s = time.perf_counter() - start
    print("setup parts: " + ", ".join(f"{k}={v:.6f}" for k, v in parts.items())
          + f"; setup_s={setup_s:.6f}")

    stats_before = run.cropper.stats.as_dict()
    summary = work = window = None
    if args.trace:
        from face_crop_plus_tpu_torch.utils.profiling import take_timeline
        from gpubench.harness.trace import Profile, Work, instrument, network_spans

        work = Work()
        prof = Profile(os.path.join(ROOT, ".gpubench", "trace.json"), work.host_spans)
        with instrument(run.cropper, work, cell.config["model"]), prof.run():
            run.run(args.seconds)
        summary, window = prof.summary, prof.window_s
        summary["span_s"] = work.device_seconds()
        net_s = network_spans(take_timeline())
    else:
        run.run(args.seconds)
    stats = _stats_delta(stats_before, run.cropper.stats.as_dict())
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)
    print(f"window: {run.window_s:.6f} s, {run.attempted} attempted, {run.failed} failed, "
          f"{run.faces} faces; stages {json.dumps(stats)}")
    if hasattr(run, "latencies"):
        n = len(run.latencies)
        print(f"requests: {n} timed, the p95 is rank {max(1, math.ceil(0.95 * n))} "
              f"with {n - max(1, math.ceil(0.95 * n))} beyond it")
    if hasattr(run, "bytes_written"):
        print(f"written: {run.bytes_written} bytes in {len(run.passes)} passes")

    run.release()
    from gpubench.reference.nn import precision

    with precision("float32"):
        correct, checks = run.judge(cell.limits, run.reference_nets())
    run.clean()

    metrics = {}
    if not args.trace:
        ctx = types.SimpleNamespace(faces=run.faces, window_s=run.window_s, setup_s=setup_s,
                                    latencies=getattr(run, "latencies", None))
        for m in cell.end_to_end:
            value = spec.metric_reader(m["name"], "end_to_end")(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        from gpubench.counts import PEAK_F32_FLOP_PER_S

        if hasattr(run.pipeline, "window_flop"):
            real_flop = run.pipeline.window_flop(run, stats)
        else:
            interim = (run.kw["resize_size"],) * 2
            real_flop = sum(run.pipeline.image_flop(h, w, interim, run.model)
                            for h, w in run.images_done())
        ctx = types.SimpleNamespace(
            window_s=window, cards=len(devices), summary=summary, work=work, stats=stats,
            real_flop=real_flop, peak_bytes=peak, power_limit_w=env.power_limit_w(cards),
            model=run.model, kw=run.kw, net_s=net_s)
        print(f"traced: {window:.6f} s, counted {real_flop} FLOP of real rows; peak "
              f"{PEAK_F32_FLOP_PER_S:.3e} FLOP/s at the card's {ctx.power_limit_w} W limit; "
              f"kernel launches {dict(work.launches)}")
        print(f"network spans: {json.dumps(net_s)}")
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = env.forbidden_modules()
    if found:
        print(f"gpubench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4

    cuda = devices[0].type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if args.trace:
        from gpubench.harness.trace import breakdown

        busy = summary["busy"]
        device["busy_s"] = sum(busy.get(i, 0.0) for i in range(len(devices))) / len(devices)
        device["window_s"] = window
        result["breakdown"] = breakdown(summary)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
