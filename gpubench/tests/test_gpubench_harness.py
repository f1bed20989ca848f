"""The harness finds every cell's files by name, picks up new ones without
an edit, prints only the contract's keys and fails without the package; a
configuration of more networks than the detector names its own reference
pipeline, whose hooks judge and count its cell (new files only)."""

import importlib.util
import json
import os
import re
import shutil

import numpy as np
import pytest

from gpubench.counts import retinaface as retinaface_counts
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


def _register_cell(root: str, prefix: str, config: dict, traffic: dict, metric: str, source: str):
    """Adds the cell ``<prefix>_cell`` to the copy at ``root`` by new files
    and entries only: its configuration ``<prefix>_config``, its traffic mix
    ``<prefix>_traffic``, the request cell's limits, the request cell's
    metrics, and the per-layer metric ``metric`` whose file holds
    ``source``."""
    bench_dir = os.path.join(root, "gpubench")
    cell = f"{prefix}_cell"
    json.dump(config, open(os.path.join(bench_dir, "configs", f"{prefix}_config.json"), "w"))
    json.dump(traffic, open(os.path.join(bench_dir, "traffic", f"{prefix}_traffic.json"), "w"))
    shutil.copy(os.path.join(bench_dir, "limits", "r50_largest_requests.json"),
                os.path.join(bench_dir, "limits", f"{cell}.json"))
    with open(os.path.join(bench_dir, "metrics", f"{metric}.py"), "w") as f:
        f.write(source)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": f"{prefix}_config", "source": "https://example.org/x",
                             "file": f"gpubench/configs/{prefix}_config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": cell, "config": f"{prefix}_config",
                               "traffic": f"{prefix}_traffic", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "r50_largest_requests" in m.get("workloads", ["r50_largest_requests"]):
            m.setdefault("workloads", []).append(cell)
    bench["per_layer"].append({"name": metric, "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "faces_per_s", "workloads": [cell]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))


def _request_files(root: str) -> tuple[dict, dict]:
    """The request cell's configuration and traffic mix, as dicts."""
    bench_dir = os.path.join(root, "gpubench")
    return (json.load(open(os.path.join(bench_dir, "configs", "retinaface_r50_largest.json"))),
            json.load(open(os.path.join(bench_dir, "traffic", "portraits_16.json"))))


def _add_cell(root: str, config_change: dict | None = None, entry: str | None = None):
    """A cell ``extra_cell`` added to the copy at ``root`` by new files and
    entries only: a configuration (the request cell's, changed), a traffic
    mix (driving ``entry``), its limits and a per-layer metric."""
    config, traffic = _request_files(root)
    config["cropper"]["face_factor"] = 0.7
    for key, value in (config_change or {}).items():
        config[key] = {**config[key], **value}
    traffic["rehearse"]["request_images"] = 2
    if entry:
        traffic["entry"] = entry
    _register_cell(root, "extra", config, traffic, "extra_metric",
                   "def read(ctx):\n    return 42.0\n")


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


def test_pipeline_name_takes_the_configurations_reference():
    config = json.load(open(os.path.join(ROOT, "gpubench", "configs",
                                         "retinaface_r50_largest.json")))
    assert spec.pipeline_name(config) == "retinaface_largest"
    assert spec.pipeline_name(dict(config, reference="rrdb_gated")) == "rrdb_gated"
    for bad in ("../retinaface", "pipelines.x", "", 3):
        with pytest.raises(ValueError):
            spec.pipeline_name(dict(config, reference=bad))


STUBS = os.path.join(ROOT, "gpubench", "tests", "stubs")

#: The package's enhancer at the rehearsal's one RRDB, as the stub
#: configuration's ``rehearse`` states it; and a check, after the
#: ``Cropper`` is built, that each network the pipeline serves holds the
#: run's tamed weights.
ONE_BLOCK_AND_SERVED = """
import torch
from face_crop_plus_tpu_torch.models import enhancement as _e
from gpubench.harness import cell as _cell


class _OneBlock(_e.RRDBNetwork):
    def __init__(self, num_blocks=1):
        super().__init__(1)


_e.RRDBNetwork = _OneBlock
_make = _cell.Cell._make_cropper


def _served(self, **kw):
    cropper = _make(self, **kw)
    for name, attr in self.pipeline.SERVED_BY.items():
        held = getattr(cropper, attr).net.state_dict()
        same = held.keys() == self.weights[name].keys() and all(
            torch.equal(held[k], v) for k, v in self.weights[name].items())
        print(f"served {name} by {attr}: {same}", flush=True)
    return cropper


_cell.Cell._make_cropper = _served
"""


#: A per-layer metric of the enhancer: its widths from ``ctx.model``, its
#: rows and device seconds from ``ctx.net_s``; nothing to read without
#: device events.
ENH_NET_PROBE = """
import sys


def read(ctx):
    widths = ctx.model["enhancer"]
    span = ctx.net_s.get("enh_net")
    print(f"enh_net_probe: nf {widths['nf']} gc {widths['gc']} rows {span and span['rows']} "
          f"seconds {span and span['seconds']} threshold {ctx.kw['enh_threshold']}",
          file=sys.stderr)
    if not span or not span["seconds"]:
        return None
    return 100.0 * span["rows"] / span["seconds"]
"""


def _add_gated_cell(root: str, threshold: float):
    """A cell ``gated_cell`` of two networks added to the copy at ``root``
    by new files only: the stub pipeline ``rrdb_gated`` (named by the
    configuration's ``"reference"``, though ``retinaface_largest`` would
    resolve from its detector and strategy), a configuration with an
    enhancer gated at ``threshold``, its traffic, limits and a per-layer
    metric that reads the enhancer's widths and its span."""
    shutil.copy(os.path.join(STUBS, "rrdb_gated.py"),
                os.path.join(root, "gpubench", "reference", "pipelines", "rrdb_gated.py"))
    config, traffic = _request_files(root)
    enhancer = {"nf": 64, "gc": 32, "num_blocks": 23}
    config["reference"] = "rrdb_gated"
    config["model"]["enhancer"] = enhancer
    config["cropper"]["enh_threshold"] = threshold
    config["weights"]["rrdb"] = {"gain": 1.0, "bn_scale": 1.0, "bias_std": 0.01,
                                 "head": {"conv_last.weight": 0.5, "trunk_conv.weight": 0.7}}
    config["rehearse"]["model"] = {"enhancer": dict(enhancer, num_blocks=1)}
    _register_cell(root, "gated", config, traffic, "enh_net_probe", ENH_NET_PROBE)


def _stub():
    path = os.path.join(STUBS, "rrdb_gated.py")
    module_spec = importlib.util.spec_from_file_location("rrdb_gated_stub", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def _py_files(bench_dir: str) -> dict:
    out = {}
    for d, _, files in os.walk(bench_dir):
        for f in files:
            if f.endswith(".py"):
                out[os.path.join(d, f)] = open(os.path.join(d, f), "rb").read()
    return out


def _window_line(lines: list[str]) -> tuple[int, int, dict]:
    """(attempted, failed, stages) of a run's ``window:`` line."""
    (line,) = [x for x in lines if x.startswith("window: ")]
    found = re.match(r"window: \S+ s, (\d+) attempted, (\d+) failed, \d+ faces; stages (.*)$",
                     line)
    return int(found[1]), int(found[2]), json.loads(found[3])


def _counted(lines: list[str]) -> int:
    (line,) = [x for x in lines if x.startswith("traced: ")]
    return int(re.search(r"counted (\d+) FLOP", line)[1])


def test_a_configuration_of_two_networks_runs_judged_and_counted_by_its_own_files(tmp_path):
    # Gated at 0.15, the seed's requests hold gated and plain images both.
    root = benchmark_copy(str(tmp_path))
    bench_dir = os.path.join(root, "gpubench")
    before = _py_files(bench_dir)
    _add_gated_cell(root, 0.15)
    rc, lines, err, _ = run_cell("gated_cell", "--trace", "1", "--rehearse-cpu", root=root,
                                 prelude=ONE_BLOCK_AND_SERVED)
    assert rc == 0, err[-3000:]
    out = result(lines)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["judged_requests"]["value"] > 0
    # Both networks hold the run's tamed weights.
    assert "served retinaface by det_model: True" in lines
    assert "served rrdb by enh_model: True" in lines
    # The pipeline's crops judged the window, gated and plain faces both.
    judged = re.findall(r"rrdb_gated crops: (\d+) plain, (\d+) gated", err)
    assert judged and sum(int(p) for p, _ in judged) > 0 and sum(int(g) for _, g in judged) > 0
    # Its window_flop is the traced count: the detector's images and the
    # enhancer's rows, each at the model block's widths.
    attempted, failed, stages = _window_line(lines)
    rows = stages["enh_net"]["items"]
    stub, model = _stub(), json.load(open(os.path.join(bench_dir, "configs",
                                                        "gated_config.json")))["model"]
    images = (attempted - failed) * 4
    det = images * retinaface_counts.image_flop(40, 30, 64, 64, model)
    enh = rows * 2 * stub.rrdb_macs(64, 64, dict(model["enhancer"], num_blocks=1))
    assert rows > 0 and _counted(lines) == det + enh
    # ctx.net_s: the package's network spans, rows counted, and no device
    # seconds on the CPU, so the metric reads nothing and is left out.
    (spans,) = [json.loads(x[len("network spans: "):]) for x in lines
                if x.startswith("network spans: ")]
    assert spans["enh_net"] == {"seconds": None, "rows": rows}
    assert spans["det_net"] == {"seconds": None, "rows": stages["det_net"]["items"]}
    assert f"enh_net_probe: nf 64 gc 32 rows {rows} seconds None threshold 0.15" in err
    assert "enh_net_probe" not in out["metrics"] and "mfu" in out["metrics"]
    assert _py_files(bench_dir).items() >= before.items()


#: Faults of a gated cell: the reference's crops hook returns one crop
#: altered; the package's enhancer returns its rows altered; the enhancer
#: is not served the run's weights (its own random init runs).
GATED_FAULTS = {
    "reference_crop_altered": """
from gpubench.reference.pipelines import rrdb_gated as _p
_crops = _p.crops
def _bad(*a, **k):
    out, idx = _crops(*a, **k)
    out[0] = 255 - out[0]
    return out, idx
_p.crops = _bad
""",
    "enhanced_rows_altered": """
from face_crop_plus_tpu_torch.models import enhancement as _m
_enhance = _m.RRDBNet.enhance_device
_m.RRDBNet.enhance_device = lambda self, images: 255 - _enhance(self, images)
""",
    "enhancer_not_served": """
from gpubench.reference.pipelines import rrdb_gated as _p
_p.SERVED_BY = {"retinaface": "det_model"}
""",
}


@pytest.mark.parametrize("fault", list(GATED_FAULTS))
def test_a_fault_in_a_gated_cell_is_not_correct(tmp_path, fault):
    root = benchmark_copy(str(tmp_path))
    _add_gated_cell(root, 0.15)
    rc, lines, err, _ = run_cell("gated_cell", "--trace", "0", "--rehearse-cpu", root=root,
                                 prelude=ONE_BLOCK_AND_SERVED + GATED_FAULTS[fault])
    assert rc == 0, err[-3000:]
    out = result(lines)
    assert out["correct"] is False
    check = out["checks"]["crop_diff_share"]
    assert check["value"] > check["limit"], out["checks"]


def test_a_named_reference_that_is_missing_is_refused(tmp_path):
    root = benchmark_copy(str(tmp_path))
    _add_gated_cell(root, 0.15)
    os.remove(os.path.join(root, "gpubench", "reference", "pipelines", "rrdb_gated.py"))
    rc, lines, err, _ = run_cell("gated_cell", "--trace", "0", "--rehearse-cpu", root=root)
    assert rc == 2 and "rrdb_gated" in err
    assert not any(line.startswith("{") for line in lines)


def test_default_reference_crops_are_the_fit_and_warp_of_the_faces():
    # The former inline path: faces (less the offset), the fit, dropping
    # unsound fits, and the warp inside each image's window.
    import torch

    from gpubench.reference.geometry import fit_similarity, target_landmarks, warp_constant

    cell = spec.resolve(_bench(), "r50_largest_requests", ROOT, rehearse=True)
    run = spec.entry(cell, 12345678901, torch.device("cpu"), os.path.join(ROOT, ".gpubench",
                                                                          "work", "test_default"))
    run._make_weights()
    run._make_inputs()
    nets = run.reference_nets()
    out_size, interim = (run.kw["output_size"],) * 2, (run.kw["resize_size"],) * 2
    for i, batch in enumerate(run.pool):
        images = torch.from_numpy(batch)
        offset = torch.tensor([1.5, -2.0]) if i % 2 else None
        n, h, w = images.shape[:3]
        windows = (torch.tensor([[1, 2, h - 3, w - 2]] * n, dtype=torch.int32) if i % 2
                   else None)
        lm, idx = run.pipeline.faces(nets, run.model, images, interim, run.kw["det_threshold"])
        if offset is not None:
            lm = lm - offset
        m, ok = fit_similarity(lm, target_landmarks(out_size, run.kw["face_factor"]))
        m, idx = m[ok], idx[ok]
        want = warp_constant(images, m, idx.to(torch.int32), out_size,
                             None if windows is None else windows[idx])
        crops, found = run.reference_crops(nets, images, offset, windows)
        assert np.array_equal(crops, want.numpy()) and np.array_equal(found, idx.numpy())
        assert found.dtype == np.int64 and len(found) > 0


@pytest.mark.parametrize("workload", ["r50_largest_requests", "r50_largest_dir"])
def test_default_count_is_image_flop_over_the_images_done(workload):
    from gpubench.harness import inputs

    rc, lines, err, _ = run_cell(workload, "--trace", "1", "--rehearse-cpu")
    assert rc == 0, err[-3000:]
    cell = spec.resolve(_bench(), workload, ROOT, rehearse=True)
    attempted, failed, stages = _window_line(lines)
    ih = cell.config["cropper"]["resize_size"]
    if workload == "r50_largest_requests":
        sizes = [tuple(cell.traffic["image_hw"])] * cell.traffic["request_images"]
    else:
        sizes = [hw for _, hw in inputs.directory_names(cell.traffic)]
    want = (attempted - failed) * sum(
        retinaface_counts.image_flop(h, w, ih, ih, cell.config["model"]) for h, w in sizes)
    assert want > 0 and _counted(lines) == want
    (spans,) = [json.loads(x[len("network spans: "):]) for x in lines
                if x.startswith("network spans: ")]
    assert spans == {"det_net": {"seconds": None, "rows": stages["det_net"]["items"]}}
