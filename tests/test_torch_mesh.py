"""Port parity: the in-process data mesh (``parallel/mesh.py``, ``mesh=``).

The port's mesh over repeated CPU devices
(``make_mesh(devices=[torch.device("cpu")] * 4)``) is held against the JAX
mesh over the conftest's virtual CPU devices (``make_mesh(4)``) and against
the port's own single device.  Inputs are numpy-seeded smooth images at a
tiny size (64×48 sources, 32² crops, ``pre_topk`` 32); both detectors hold
the same tamed weights (``tests/torch_parity.py``).  The JAX side runs
under jit, as its own mesh tests do: ``shard_map`` has no op-by-op mode.
Its results are shared through module-scoped fixtures.

Torch runs one intra-op thread here, as the enhancement tests do: the
suite's six workers share the machine's cores, and 8 threads each
oversubscribe it.  Port detectors are built once per mesh size and
strategy (their ResNet-50 init dominates a small test) and reset to their
initial knobs for each use.

Tolerances: the mesh helpers and face indices exact; landmarks within the
parity harness's f32 tolerance; crops within ±1 level against the JAX mesh
and against the port's single device over several shards (the network's
f32 sums may round differently at another batch size); a one-device mesh
bitwise equal to no mesh.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax

import face_crop_plus_tpu_torch
from face_crop_plus_tpu.parallel import mesh as jmesh
from face_crop_plus_tpu_torch import pipeline as tpipeline
from face_crop_plus_tpu_torch.parallel import mesh as tmesh
from face_crop_plus_tpu_torch.utils import device as tdevice

from torch_parity import (
    jax_params,
    read_tree,
    small_enhancers,
    smooth_image,
    tamed_bisenet_params,
    tamed_params,
    tamed_rrdb_params,
    tree_max_diff,
)

CPU = torch.device("cpu")
SRC = (64, 48)
INTERIM = (64, 64)
OUT = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(s: int = 4):
    return tmesh.make_mesh(devices=[CPU] * s)


def _images(n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([smooth_image(rng, *SRC) for _ in range(n)])


def _load(model, params):
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    model.net.load_state_dict(from_jax_params(params, model.net), strict=True)


def _close(a: np.ndarray, b: np.ndarray, limit: int = 1) -> bool:
    return a.shape == b.shape and (
        a.size == 0 or int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= limit
    )


# ---------------------------------------------------------------------------
# The helpers: exactly the JAX package's
# ---------------------------------------------------------------------------


def _selection(kind: str, s: int, rng):
    """(shard ids, local rows) of a request list of the given kind."""
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if kind == "single":
        return np.array([s - 1]), np.array([2])
    if kind == "one_shard":  # every other shard has nothing to do
        return np.zeros(9, np.int64), rng.integers(0, 5, 9)
    n = 23
    return rng.integers(0, s, n), rng.integers(0, 7, n)


@pytest.mark.parametrize("chunk", [1, 2, 5, 64])
@pytest.mark.parametrize("kind", ["empty", "single", "one_shard", "random"])
@pytest.mark.parametrize("s", [1, 3, 4, 8])
def test_partition_by_shard_matches_jax(s, kind, chunk):
    shard_ids, local = _selection(kind, s, np.random.default_rng(s * 10 + chunk))
    ours = tmesh.partition_by_shard(shard_ids, local, s, chunk)
    ref = jmesh.partition_by_shard(shard_ids, local, s, chunk)
    assert len(ours) == len(ref)
    for got, want in zip(ours, ref):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("rows", [(), (0,), (5, 1, 11, 6, 7), tuple(range(12))])
@pytest.mark.parametrize("s", [1, 3, 4])
def test_partition_rows_by_shard_matches_jax(s, rows, chunk):
    n_rows = 12
    ours = tmesh.partition_rows_by_shard(np.asarray(rows, np.int64), n_rows, s, chunk)
    ref = jmesh.partition_rows_by_shard(np.asarray(rows, np.int64), n_rows, s, chunk)
    assert len(ours) == len(ref)
    for got, want in zip(ours, ref):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,multiple", [(1, 1), (1, 4), (6, 4), (8, 4), (5, 8), (13, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    batch = np.arange(n * 6, dtype=np.uint8).reshape(n, 2, 3)
    ours, valid = tmesh.pad_to_multiple(batch, multiple)
    ref, ref_valid = jmesh.pad_to_multiple(batch, multiple)
    assert valid == ref_valid == n
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# Building a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw,error",
    [
        (dict(n_devices=0), ValueError),
        (dict(n_devices=-2), ValueError),
        (dict(devices=[]), ValueError),
        (dict(devices=[CPU, torch.device("cuda", 0)]), ValueError),
        (dict(devices=[torch.device("meta")]), ValueError),
        (dict(), RuntimeError),
        (dict(n_devices=2), RuntimeError),
    ],
)
def test_make_mesh_raises(kw, error):
    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_mesh() builds over it")
    with pytest.raises(error):
        tmesh.make_mesh(**kw)


def test_make_mesh_over_cards(monkeypatch):
    """With no device list, ``cuda:0…cuda:{n-1}``; more than there are raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tmesh.make_mesh()
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.make_mesh(1).devices == (torch.device("cuda", 0),)
    assert mesh.axis_names == ("data",) and mesh.size == 2
    with pytest.raises(ValueError, match="3-device"):
        tmesh.make_mesh(3)


def test_mesh_is_immutable_and_repeats_devices():
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    assert mesh.devices == (CPU,) * 3 and mesh.size == 3
    with pytest.raises(AttributeError):
        mesh.devices = (CPU,)
    assert tmesh.check_mesh(mesh) is mesh and tmesh.check_mesh(None) is None
    with pytest.raises(TypeError):
        tmesh.check_mesh(jmesh.make_mesh(2))


def test_shard_batch_gives_contiguous_blocks():
    mesh = _cpu_mesh(3)
    x = np.arange(6 * 2, dtype=np.int32).reshape(6, 2)
    blocks = tmesh.shard_batch(x, mesh)
    assert len(blocks) == 3
    for s, b in enumerate(blocks):
        np.testing.assert_array_equal(b.numpy(), x[2 * s : 2 * s + 2])
    blocks_t = tmesh.shard_batch(torch.from_numpy(x), mesh)
    assert [b.tolist() for b in blocks_t] == [b.tolist() for b in blocks]
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_batch(x[:5], mesh)


def test_shard_params_gives_separate_replicas():
    net = torch.nn.Linear(3, 2)
    replicas = tmesh.shard_params(net, _cpu_mesh(2))
    assert len(replicas) == 2 and replicas[0] is not replicas[1]
    for r in replicas:
        assert not r.training and not any(p.requires_grad for p in r.parameters())
        assert r.weight.data_ptr() != net.weight.data_ptr()
        torch.testing.assert_close(r.weight, net.weight, rtol=0, atol=0)
    assert replicas[0].weight.data_ptr() != replicas[1].weight.data_ptr()


def test_replicas_follow_loaded_weights():
    """Weights loaded into a network after its replicas were made, or a
    network swapped in, reach every shard: no shard runs stale weights."""
    net = torch.nn.Linear(3, 2).requires_grad_(False)
    reps = tmesh.Replicas(_cpu_mesh(2))
    first = reps.get(net)
    assert reps.get(net) is first  # unchanged: the same replicas
    net.load_state_dict({"weight": torch.ones(2, 3), "bias": torch.zeros(2)})
    second = reps.get(net)
    assert second is not first
    for r in second:
        torch.testing.assert_close(r.weight, torch.ones(2, 3), rtol=0, atol=0)
    other = torch.nn.Linear(3, 2).requires_grad_(False)
    third = reps.get(other)
    for r in third:
        torch.testing.assert_close(r.weight, other.weight, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The repair: host fetches wait on the tensors' own card
# ---------------------------------------------------------------------------


class _FakeCudaTensor:
    """Claims to live on ``cuda:1``; enough of a tensor for the fetch."""

    def __init__(self, index: int = 1):
        self.device = torch.device("cuda", index)
        self.shape = (2, 3)
        self.dtype = torch.float32


def _stub_cuda(monkeypatch):
    calls = {"streams": [], "events": [], "copies": []}

    class Buf:
        def __init__(self, shape, dtype, pin_memory):
            assert pin_memory
            self.shape = shape

        def copy_(self, src, non_blocking=False):
            calls["copies"].append((src.device, non_blocking))
            return self

    class Event:
        def __init__(self):
            self.stream = None
            calls["events"].append(self)

        def record(self, stream=None):
            self.stream = stream

        def synchronize(self):
            assert self.stream is not None

    def current_stream(device=None):
        calls["streams"].append(device)
        return ("stream of", device)

    monkeypatch.setattr(torch, "empty", lambda shape, dtype, pin_memory: Buf(shape, dtype,
                                                                            pin_memory))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return calls


@pytest.mark.parametrize("index", [1, 3])
def test_to_host_async_records_on_the_tensors_card(monkeypatch, index):
    """The event that a host fetch waits on is recorded on the current
    stream of the card that holds the tensors (where the copies ran), not
    on the current device's: ``cuda:1``'s copies are not ``cuda:0``'s."""
    calls = _stub_cuda(monkeypatch)
    dev = torch.device("cuda", index)
    host, event = tdevice.to_host_async((_FakeCudaTensor(index), _FakeCudaTensor(index)))
    assert len(host) == 2 and calls["copies"] == [(dev, True), (dev, True)]
    assert calls["streams"] == [dev]
    assert event is calls["events"][0] and event.stream == ("stream of", dev)


def test_mesh_fetch_waits_on_every_shards_card(monkeypatch):
    """``to_host`` starts every shard's copies, each recorded on its own
    card's stream, before it waits on any of them."""
    calls = _stub_cuda(monkeypatch)
    order = []
    real_async = tdevice.to_host_async

    def spy(tensors):
        order.append(("start", tensors[0].device.index))
        host, event = real_async(tensors)
        sync = event.synchronize
        event.synchronize = lambda: (order.append(("wait", tensors[0].device.index)), sync())
        return (), event

    monkeypatch.setattr(tdevice, "to_host_async", spy)
    tdevice.to_host([(_FakeCudaTensor(i),) for i in (0, 1, 2)])
    assert order == [("start", 0), ("start", 1), ("start", 2),
                     ("wait", 0), ("wait", 1), ("wait", 2)]
    assert [e.stream for e in calls["events"]] == [
        ("stream of", torch.device("cuda", i)) for i in (0, 1, 2)]


def test_pipeline_fetches_through_the_repaired_helper():
    """The fused pipeline's host copies are ``utils.device.to_host_async``'s."""
    assert tpipeline.to_host_async is tdevice.to_host_async


# ---------------------------------------------------------------------------
# The detector and the fused pipeline against the JAX mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")
    return jmesh.make_mesh(4)


def _jax_detector(mesh, strategy, vis=0.5):
    from face_crop_plus_tpu.models.detection import RetinaFace

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        det = RetinaFace(strategy=strategy, vis=vis, pre_topk=32, max_faces=4, mesh=mesh)
    det.params = jmesh.shard_params(jax_params(tamed_params()), mesh)
    return det


_DETECTORS: dict = {}


def _torch_detector(mesh, strategy, vis=0.5, device=None):
    """A port detector with the tamed weights, built once per (mesh size,
    strategy) and reset to the knobs a fresh one has."""
    from face_crop_plus_tpu_torch.models.detection import RetinaFace

    key = (None if mesh is None else mesh.size, strategy)
    if key not in _DETECTORS:
        det = RetinaFace(strategy=strategy, vis=vis, pre_topk=32, max_faces=4, mesh=mesh,
                         device=device)
        _load(det, tamed_params())
        _DETECTORS[key] = det
    det = _DETECTORS[key]
    det.vis_threshold, det.pre_topk, det.max_faces = float(vis), 32, 4
    det._cap_warned = False
    return det


def _pipelines(strategy, jm, tm, crop_source="original", device=None):
    from face_crop_plus_tpu.pipeline import FusedPipeline as JFused
    from face_crop_plus_tpu.utils.landmarks import make_target_landmarks as jtarget
    from face_crop_plus_tpu_torch.pipeline import FusedPipeline as TFused
    from face_crop_plus_tpu_torch.utils.landmarks import make_target_landmarks as ttarget

    kw = dict(output_size=(OUT, OUT), border_mode="reflect_101", crop_source=crop_source)
    j = None if jm is None else JFused(_jax_detector(jm, strategy), jtarget((OUT, OUT), 0.65),
                                       mesh=jm, **kw)
    t = TFused(_torch_detector(tm, strategy, device=device), ttarget((OUT, OUT), 0.65),
               mesh=tm, **kw)
    return j, t


@pytest.fixture(scope="module")
def jax_fused(jax_mesh):
    """The JAX mesh's ``FusedPipeline.process`` of 6 images (non-divisible
    over 4 shards), "largest" and "all", and its ``RetinaFace.predict``."""
    images = _images(6)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for strategy in ("largest", "all"):
            j, _ = _pipelines(strategy, jax_mesh, _cpu_mesh())
            out[strategy] = j.process(images, INTERIM)
            out[strategy + "_caps"] = (j.det.pre_topk, j.det.max_faces)
        det = _jax_detector(jax_mesh, "all")
        out["predict"] = det.predict(_interims(images))
    return images, out


def _interims(images: np.ndarray) -> np.ndarray:
    from face_crop_plus_tpu_torch.utils.batching import as_batch

    return as_batch(list(images), INTERIM)[0]


def test_retinaface_predict_matches_jax_mesh(jax_fused):
    images, ref = jax_fused
    det = _torch_detector(_cpu_mesh(), "all")
    lm, idx = det.predict(_interims(images))
    ref_lm, ref_idx = ref["predict"]
    assert idx == list(ref_idx) and len(idx) > 0
    np.testing.assert_allclose(lm, ref_lm, rtol=1e-4, atol=1e-4 * np.abs(ref_lm).max())
    assert max(idx) <= 5  # none of the padding rows' faces


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_fused_process_matches_jax_mesh(jax_fused, strategy):
    images, ref = jax_fused
    _, t = _pipelines(strategy, None, _cpu_mesh())
    crops, lm, idx = t.process(images, INTERIM)
    ref_crops, ref_lm, ref_idx = ref[strategy]
    np.testing.assert_array_equal(idx, ref_idx)
    assert len(idx) >= 6 and idx.max() <= 5
    assert (t.det.pre_topk, t.det.max_faces) == ref[strategy + "_caps"]
    np.testing.assert_allclose(lm, ref_lm, rtol=1e-4, atol=1e-3)
    assert _close(crops, np.asarray(ref_crops))


# ---------------------------------------------------------------------------
# The mesh against the port's single device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "strategy,crop_source,pack",
    [("largest", "original", False), ("largest", "interim", False), ("all", "original", False),
     ("all", "interim", False), ("best", "original", True)],
)
def test_one_device_mesh_is_bitwise_single(strategy, crop_source, pack):
    images = _images(5, seed=7)
    _, single = _pipelines(strategy, None, None, crop_source, device="cpu")
    _, mesh1 = _pipelines(strategy, None, _cpu_mesh(1), crop_source)
    want = single.process(images, INTERIM, pack_crops=pack)
    got = mesh1.process(images, INTERIM, pack_crops=pack)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_mesh_matches_single_device(strategy, s):
    images = _images(7, seed=11)  # 7 images: padding on every mesh
    _, single = _pipelines(strategy, None, None, device="cpu")
    _, mesh = _pipelines(strategy, None, _cpu_mesh(s))
    crops, lm, idx = mesh.process(images, INTERIM, valid_n=6)
    ref_crops, ref_lm, ref_idx = single.process(images, INTERIM, valid_n=6)
    np.testing.assert_array_equal(idx, ref_idx)
    assert idx.max() <= 5
    np.testing.assert_allclose(lm, ref_lm, rtol=1e-4, atol=1e-3)
    assert _close(crops, ref_crops)


@pytest.mark.parametrize("n,s,rows", [(6, 4, 8), (5, 1, 8), (36, 2, 18)])
def test_shard_network_runs_at_pad_sizes(monkeypatch, n, s, rows):
    """Each shard's network runs its block padded to ``SHARD_PAD_SIZES``
    (cuDNN runs other batch sizes slowly, with other sums); larger blocks
    run as they are, and the padding rows' outputs never surface."""
    from face_crop_plus_tpu_torch.models import detection

    det = _torch_detector(_cpu_mesh(s), "largest")
    det.pre_topk = 1024  # every candidate: no cap grows, one pass
    seen = []
    real = detection.retinaface_forward
    monkeypatch.setattr(detection, "retinaface_forward",
                        lambda net, x: (seen.append(x.shape[0]), real(net, x))[1])
    images = np.repeat(_interims(_images(1)), n, axis=0)
    lm, idx = det.predict(images)
    assert seen == [rows] * s
    assert idx == list(range(n))
    np.testing.assert_array_equal(lm, np.repeat(lm[:1], n, axis=0))


def test_packed_rows_on_the_mesh_equal_rgb():
    from face_crop_plus_tpu_torch.ops.yuv import rgb_to_yuv420_np, yuv420_to_rgb_np

    images = _images(6, seed=5)
    packed = rgb_to_yuv420_np(images)
    _, t = _pipelines("all", None, _cpu_mesh(4))
    crops_p, lm_p, idx_p = t.process(packed, INTERIM, packed_hw=SRC)
    crops_r, lm_r, idx_r = t.process(yuv420_to_rgb_np(packed, *SRC), INTERIM)
    np.testing.assert_array_equal(idx_p, idx_r)
    np.testing.assert_array_equal(crops_p, crops_r)
    lm, idx = t.detect_only(packed, INTERIM, packed_hw=SRC)
    np.testing.assert_array_equal(idx, idx_r)
    np.testing.assert_array_equal(lm, lm_r)


def test_cap_binding_on_one_shard_reruns_every_shard(monkeypatch):
    """A cap that binds on one shard only grows the caps and re-runs every
    shard; the result equals a run that starts with the grown caps."""
    images = _images(8, seed=21)
    _, probe = _pipelines("all", None, None, device="cpu")
    probe.det.vis_threshold = 0.55
    probe.det.pre_topk = 1024  # see every image's candidates
    interim = torch.from_numpy(_interims(images)).float()
    _, _, caps = probe.det._detect(interim, probe.det._detect_args())
    above = caps[:, 0].numpy()
    order = np.argsort(above)
    assert above[order[-1]] > above[order[-2]] > 0, above
    cap = int(above[order[-2]])  # only the busiest image exceeds it

    _, t = _pipelines("all", None, _cpu_mesh(4))
    t.det.vis_threshold, t.det.pre_topk = 0.55, cap
    runs = []
    real = t.det._detect
    monkeypatch.setattr(t.det, "_detect", lambda *a, **k: (runs.append(a[1]["pre_topk"]),
                                                            real(*a, **k))[1])
    got = t.process(images, INTERIM)
    assert t.det.pre_topk > cap
    assert runs == [cap] * 4 + [t.det.pre_topk] * 4  # every shard, then every shard again

    _, fresh = _pipelines("all", None, _cpu_mesh(4))
    fresh.det.vis_threshold = 0.55
    fresh.det.pre_topk, fresh.det.max_faces = t.det.pre_topk, t.det.max_faces
    want = fresh.process(images, INTERIM)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The Cropper on a mesh
# ---------------------------------------------------------------------------


def _cropper(mesh=None, **kw):
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    args = dict(output_size=OUT, resize_size=64, det_threshold=0.5, batch_size=4,
                pre_topk=32, max_faces=4)
    args.update(kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c = (face_crop_plus_tpu_torch.Cropper(device="cpu", **args) if mesh is None
             else face_crop_plus_tpu_torch.Cropper(mesh=mesh, **args))
    for model, params in ((c.det_model, tamed_params), (c.enh_model, tamed_rrdb_params),
                          (c.par_model, tamed_bisenet_params)):
        if model is not None:
            p = params()
            model.net.load_state_dict(from_jax_params(p, model.net), strict=True)
    return c


def test_cropper_mesh_device_and_models():
    from face_crop_plus_tpu_torch.models.enhancement import RRDBNet
    from face_crop_plus_tpu_torch.models.parsing import BiSeNet

    mesh = _cpu_mesh(2)
    c = _cropper(mesh, attr_groups={"a": [1]})
    assert c._device == CPU and c._fused.mesh is mesh
    assert c.det_model.mesh is mesh and c.par_model.mesh is mesh
    assert c.par_model.batch_size == 4
    assert len(c.det_model.replicas()) == 2
    # Sub-batches round up to a mesh multiple.
    assert BiSeNet(max_batch_size=4, mesh=_cpu_mesh(3)).batch_size == 6
    assert RRDBNet(num_blocks=1, mesh=_cpu_mesh(3)).enh_batch_size == 3


@pytest.mark.parametrize("bad", [object(), "cpu", [CPU, CPU]])
def test_cropper_rejects_a_foreign_mesh(bad):
    with pytest.raises(TypeError, match="Mesh"):
        face_crop_plus_tpu_torch.Cropper(device="cpu", mesh=bad)


def test_mesh_gates(monkeypatch, tmp_path):
    """A mesh turns off the host-crop mode, the host warp, the YUV-direct
    crops and the parser handoff, and the stream runs every batch as
    ``process_images``."""
    from face_crop_plus_tpu_torch.models import parsing as tp

    monkeypatch.setattr(tp, "_INFER_SIZE", 64)
    monkeypatch.setenv("FCPT_HOST_CROP", "1")
    c = _cropper(_cpu_mesh(2), attr_groups={"a": [1]})
    assert not c._host_crop_enabled()
    batch = _images(4)
    assert c._native_warp(batch, np.zeros((1, 2, 3), np.float32), np.zeros(1, np.int64),
                          None, force=True) is None
    assert not c._yuv_rows_possible() and not c._host_yuv_rows_ok(["a.jpg"])
    monkeypatch.setenv("FCPT_YUV_CROP", "1")
    lm = face_crop_plus_tpu_torch.Cropper(
        mesh=_cpu_mesh(2), landmarks=(np.zeros((1, 5, 2), np.float32), np.array(["a.jpg"])),
        output_size=OUT)
    assert not lm._yuv_crop_eligible()

    handoffs = []
    real = c._fused.process
    monkeypatch.setattr(c._fused, "process", lambda *a, **k: (
        handoffs.append(k.get("return_device_crops")), real(*a, **k))[1])
    from face_crop_plus_tpu_torch.utils.io import imwrite

    src = tmp_path / "in"
    src.mkdir()
    for i, im in enumerate(batch):
        imwrite(str(src / f"f{i}.png"), im)
    c.process_dir(str(src), str(tmp_path / "out"), desc=None)
    assert handoffs == [False]

    monkeypatch.setattr(c._fused, "process_async", lambda *a, **k: pytest.fail("in flight"))
    want = [c.process_images(b) for b in (batch, batch[:3])]
    got = list(c.process_images_stream([batch, batch[:3]], depth=2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def _write_dir(path, n_uniform: int = 6, seed: int = 9):
    from face_crop_plus_tpu_torch.utils.io import imwrite

    rng = np.random.default_rng(seed)
    os.makedirs(path)
    for i in range(n_uniform):
        imwrite(os.path.join(path, f"u{i}.png"), smooth_image(rng, *SRC))
    imwrite(os.path.join(path, "r0.png"), smooth_image(rng, 50, 70))
    imwrite(os.path.join(path, "r1.png"), smooth_image(rng, 80, 56))
    return path


@pytest.mark.parametrize("crop_source", ["original", "interim"])
def test_cropper_mesh_process_dir_all_matches_single(monkeypatch, tmp_path, crop_source):
    """Strategy "all" over a directory (fused and staged groups): the same
    names as the single device, pixels within ±1."""
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    src = _write_dir(str(tmp_path / "in"))
    kw = dict(strategy="all", crop_source=crop_source, output_format="png")
    single, mesh = _cropper(**kw), _cropper(_cpu_mesh(4), **kw)
    single.process_dir(src, str(tmp_path / "a"), desc=None)
    mesh.process_dir(src, str(tmp_path / "b"), desc=None)
    a, b = read_tree(str(tmp_path / "a")), read_tree(str(tmp_path / "b"))
    assert sorted(a) == sorted(b) and len(a) >= 8
    assert tree_max_diff(a, b) <= 1
    assert mesh.stats.calls["detect+crop"] > 0 and mesh.stats.calls["detect"] > 0


def test_gated_enhancement_and_parsing_on_the_mesh(monkeypatch):
    """Fused gated enhancement (2-block trunk) and parsing with groups on a
    mesh of 4: crops and groups equal to the single device's, with some
    images gated and some not."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp
    from face_crop_plus_tpu_torch.models.enhancement import mean_face_factor

    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)
    small_enhancers(monkeypatch)
    kw = dict(strategy="all", enh_threshold=1.0, batch_size=6, max_faces=2, auto_grow=False,
              attr_groups={"p3": [3], "no3": [-3]}, mask_groups={"m": [1, 2]})
    single, mesh = _cropper(**kw), _cropper(_cpu_mesh(4), **kw)
    batch = _images(6, seed=17)
    lm, idx = single._fused.detect_only(batch, single.resize_size)
    factors = mean_face_factor(lm, list(idx), 6, INTERIM[::-1])
    finite = np.sort(factors[np.isfinite(factors)])
    assert len(finite) >= 3
    threshold = float((finite[1] + finite[2]) / 2)  # 2 images gated
    for c in (single, mesh):
        c.enh_model.min_face_factor = threshold
    calls = []
    real = mesh.enh_model.enhance_shards
    monkeypatch.setattr(mesh.enh_model, "enhance_shards",
                        lambda blocks: (calls.append(len(blocks)), real(blocks))[1])
    crops, indices, (attr, masks) = mesh.process_images(batch)
    ref_crops, ref_indices, (ref_attr, ref_masks) = single.process_images(batch)
    assert calls and set(calls) == {4}  # the shard-local gated branch ran
    np.testing.assert_array_equal(indices, ref_indices)
    np.testing.assert_array_equal(crops, ref_crops)
    assert attr == ref_attr
    assert masks.keys() == ref_masks.keys()
    for k in masks:
        assert masks[k][0] == ref_masks[k][0]
        np.testing.assert_array_equal(masks[k][1], ref_masks[k][1])


def test_every_stage_on_the_mesh_process_dir(monkeypatch, tmp_path):
    """The port's dry run: ``process_dir`` with strategy "all", gated
    enhancement (2-block trunk) and parsing with groups on a mesh of 2
    against the single device: names equal, pixels within ±1."""
    from face_crop_plus_tpu_torch.models import parsing as tp

    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setattr(tp, "_INFER_SIZE", 128)
    small_enhancers(monkeypatch)
    src = _write_dir(str(tmp_path / "in"))
    kw = dict(strategy="all", enh_threshold=0.02, attr_groups={"a": [1]},
              mask_groups={"m": [1, 2]}, output_format="png", batch_size=8, max_faces=2,
              auto_grow=False)
    single, mesh = _cropper(**kw), _cropper(_cpu_mesh(2), **kw)
    for c in (single, mesh):
        c.par_model.attr_threshold = c.par_model.mask_threshold = -1  # every face joins
    calls = []
    real = mesh.enh_model.enhance_shards
    monkeypatch.setattr(mesh.enh_model, "enhance_shards",
                        lambda blocks: (calls.append(len(blocks)), real(blocks))[1])
    single.process_dir(src, str(tmp_path / "a"), desc=None)
    mesh.process_dir(src, str(tmp_path / "b"), desc=None)
    a, b = read_tree(str(tmp_path / "a")), read_tree(str(tmp_path / "b"))
    assert sorted(a) == sorted(b) and any(k.startswith("a/m_mask") for k in a)
    assert tree_max_diff(a, b) <= 1
    assert mesh.stats.calls["detect+crop"] > 0 and calls  # fused, and the gated branch ran
