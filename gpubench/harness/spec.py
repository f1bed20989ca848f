"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

* the configuration: the file its ``configs`` entry names, and its
  reference pipeline (``reference/pipelines/<name>.py``): the module that
  the file's top-level ``"reference"`` names, or else the one its model
  and strategy name (``<detector>_<strategy>``);
* the traffic mix: ``traffic/<traffic>.json``, and the entry it drives
  (``entries/<entry>.py``);
* the limits of its comparison: ``limits/<workload>.json``;
* each end-to-end metric: ``end_to_end/<metric>.py``, and each per-layer
  metric: ``metrics/<metric>.py``; its ``read(ctx)`` returns the value,
  or None when the run has nothing to read.

A new cell is a ``workloads`` entry and these files; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _rehearsed(data: dict) -> dict:
    """``data`` with its ``rehearse`` entries (the CPU rehearsal's tiny
    sizes) put over the others, one level deep."""
    data = dict(data)
    for key, value in data.pop("rehearse", {}).items():
        if isinstance(value, dict) and isinstance(data.get(key), dict):
            data[key] = {**data[key], **value}
        else:
            data[key] = value
    return data


def pipeline_name(config: dict) -> str:
    """The configuration's reference pipeline: its ``"reference"`` when the
    file names one (a configuration with more networks than the detector:
    an enhancer, a parser), else ``<detector>_<strategy>``."""
    if "reference" in config:
        name = config["reference"]
        if not isinstance(name, str) or not name.isidentifier():
            raise ValueError(f"the configuration's reference {name!r} is not a module name")
        return name
    return f"{config['model']['detector'].lower()}_{config['cropper']['strategy']}"


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def resolve(bench: dict, workload: str, root: str, rehearse: bool = False) -> Cell:
    """The cell ``workload`` with its files read.

    Raises:
        KeyError: When ``BENCHMARK.json`` has no such cell or configuration.
        FileNotFoundError: When one of the cell's files is missing.
        ValueError: When the configuration's ``"reference"`` is not a
            module name.
    """
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise KeyError(f"no configuration {entry['config']!r} in BENCHMARK.json")
    config = _load(os.path.join(root, conf["file"]))
    traffic = _load(os.path.join(BENCH_DIR, "traffic", entry["traffic"] + ".json"))
    if rehearse:
        config, traffic = _rehearsed(config), _rehearsed(traffic)
    config.pop("rehearse", None)
    traffic.pop("rehearse", None)
    for path in (os.path.join(BENCH_DIR, "entries", traffic["entry"] + ".py"),
                 os.path.join(BENCH_DIR, "reference", "pipelines",
                              pipeline_name(config) + ".py")):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{workload}: no {os.path.relpath(path, BENCH_DIR)}")
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        limits=_load(os.path.join(BENCH_DIR, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def entry(cell: Cell, seed: int, device, workdir: str):
    """The run of ``cell``: ``entries/<entry>.py``'s ``Entry``."""
    module = importlib.import_module(f"gpubench.entries.{cell.traffic['entry']}")
    return module.Entry(cell.config, cell.traffic, seed, device, workdir)


def metric_reader(name: str, folder: str = "metrics"):
    """``read(ctx)`` of ``<folder>/<name>.py`` (``metrics`` or
    ``end_to_end``)."""
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"gpubench_{folder}__{name}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
