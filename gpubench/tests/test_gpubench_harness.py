"""The harness finds every cell's files by name, picks up new ones without
an edit, prints only the contract's keys and fails without the package."""

import json
import os
import shutil

import pytest

from gpubench.harness import spec
from gpubench.tests.helpers import ROOT, benchmark_copy, result, run_cell

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench():
    return spec.load_benchmark(ROOT)


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves_its_files(workload):
    cell = spec.resolve(_bench(), workload, ROOT)
    assert cell.config["cropper"] and cell.config["model"]
    assert os.path.isfile(os.path.join(ROOT, "gpubench", "entries", cell.traffic["entry"] + ".py"))
    assert all(v is None or v >= 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in cell.end_to_end:
        assert callable(spec.metric_reader(m["name"], "end_to_end"))
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in names


def _add_cell(root: str, config_change: dict | None = None, entry: str | None = None):
    """A cell ``extra_cell`` added to the copy at ``root`` by new files and
    entries only: a configuration (the request cell's, changed), a traffic
    mix (driving ``entry``), its limits and a per-layer metric."""
    bench_dir = os.path.join(root, "gpubench")
    config = json.load(open(os.path.join(bench_dir, "configs", "retinaface_r50_largest.json")))
    config["cropper"]["face_factor"] = 0.7
    for key, value in (config_change or {}).items():
        config[key] = {**config[key], **value}
    json.dump(config, open(os.path.join(bench_dir, "configs", "extra_config.json"), "w"))
    traffic = json.load(open(os.path.join(bench_dir, "traffic", "portraits_16.json")))
    traffic["rehearse"]["request_images"] = 2
    if entry:
        traffic["entry"] = entry
    json.dump(traffic, open(os.path.join(bench_dir, "traffic", "extra_traffic.json"), "w"))
    shutil.copy(os.path.join(bench_dir, "limits", "r50_largest_requests.json"),
                os.path.join(bench_dir, "limits", "extra_cell.json"))
    with open(os.path.join(bench_dir, "metrics", "extra_metric.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "extra_config", "source": "https://example.org/x",
                             "file": "gpubench/configs/extra_config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "extra_cell", "config": "extra_config",
                               "traffic": "extra_traffic", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "r50_largest_requests" in m.get("workloads", ["r50_largest_requests"]):
            m.setdefault("workloads", []).append("extra_cell")
    bench["per_layer"].append({"name": "extra_metric", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "faces_per_s", "workloads": ["extra_cell"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))


#: A new entry: requests of two of the mix's batches, through the same loop.
PAIRS = """
from gpubench.entries import process_images


class Entry(process_images.Entry):
    def _make_inputs(self):
        super()._make_inputs()
        n, k = self.pool.shape[:2]
        self.pool = self.pool[: n - n % 2].reshape(n // 2, 2 * k, *self.pool.shape[2:])
        self.traffic = dict(self.traffic, request_images=2 * k)
"""


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    root = benchmark_copy(str(tmp_path))
    bench_dir = os.path.join(root, "gpubench")
    before = {}
    for d, _, files in os.walk(bench_dir):
        for f in files:
            if f.endswith(".py"):
                before[os.path.join(d, f)] = open(os.path.join(d, f), "rb").read()
    with open(os.path.join(bench_dir, "entries", "pairs.py"), "w") as f:
        f.write(PAIRS)
    _add_cell(root, entry="pairs")

    rc, lines, err, _ = run_cell("extra_cell", "--trace", "1", "--rehearse-cpu", root=root)
    assert rc == 0, err[-3000:]
    out = result(lines)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["extra_metric"]["value"] == 42.0
    assert out["attempted"] > 0 and out["checks"]["judged_requests"]["value"] > 0
    for path, data in before.items():
        assert open(path, "rb").read() == data


def test_a_configuration_without_its_reference_is_refused(tmp_path):
    # Strategy "all" has no reference pipeline: the cell does not run, and
    # is never judged against another strategy's.
    root = benchmark_copy(str(tmp_path))
    _add_cell(root, {"cropper": {"strategy": "all"}})
    rc, lines, err, _ = run_cell("extra_cell", "--trace", "0", "--rehearse-cpu", root=root)
    assert rc == 2 and "retinaface_all" in err
    assert not any(line.startswith("{") for line in lines)


@pytest.mark.parametrize("change", [{"out_channel": 128, "ssh_branches": [64, 32, 32]},
                                    {"anchors_per_cell": 3}])
def test_a_model_block_that_is_not_the_packages_fails(tmp_path, change):
    # The reference builds its network from the model block; a block that
    # the package's network does not match stops the run before the window.
    if "anchors_per_cell" in change:
        change = dict(change, min_sizes=[[16, 24, 32], [64, 96, 128], [256, 384, 512]])
    root = benchmark_copy(str(tmp_path))
    _add_cell(root, {"model": change})
    rc, lines, err, _ = run_cell("extra_cell", "--trace", "0", "--rehearse-cpu", root=root)
    assert rc != 0 and "model block" in err
    assert not any(line.startswith("{") for line in lines)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_last_line_has_the_contracts_keys(trace):
    rc, lines, err, _ = run_cell("r50_largest_requests", "--trace", trace, "--rehearse-cpu")
    assert rc == 0, err[-3000:]
    out = result(lines)
    # The numbers compared come last, under a key of their own.
    expected = TOP_KEYS + (["breakdown"] if trace == "1" else []) + ["checks"]
    assert list(out) == expected
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace == "1":
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"faces_per_s", "request_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_without_the_package_a_run_fails(tmp_path):
    root = benchmark_copy(str(tmp_path), package=False)
    rc, lines, err, _ = run_cell("r50_largest_requests", "--trace", "0", "--rehearse-cpu",
                                 root=root)
    assert rc != 0 and not any(line.startswith("{") for line in lines)


def test_without_a_card_a_run_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    rc, lines, err, _ = run_cell("r50_largest_requests", "--trace", "0")
    assert rc == 3 and not any(line.startswith("{") for line in lines)


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    rc, lines, err, modules = run_cell("r50_largest_requests", "--trace", "0", seconds="3")
    assert rc == 0, err[-3000:]
    out = result(lines)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
