"""Port parity: ``Cropper.process_images_stream``, batches in flight.

The port's stream keeps batches in flight in two modes: the host-crop mode
(the detect-only pass in flight, fits and warps at collect time, as the
JAX stream does) and, outside it, the single-program pass
(``FusedPipeline.process_async``/``process_finish``), which is what a
card's default configuration runs.  Tolerances:

* port stream against port ``process_images``: bitwise, at depths 1-3, in
  both modes, across a cap-growth event in the first batch (a small
  ``pre_topk``: batches dispatched before it re-run with the grown caps);
* port stream against the JAX stream (same tamed weights): indices equal,
  crops within ±1, the band of ``tests/test_torch_host_crop.py``; parser
  groups equal;
* ``pack_upload``: against the RGB stream, indices equal and mean pixel
  difference < 4 (the JAX package's band, ``tests/test_process_images.py``);
  against the JAX packed stream, indices equal and ±1.

4-image batches of smooth 72×60 images, a 96² interim, 48² crops; torch
on one intra-op thread.
"""

import itertools
import warnings

import numpy as np
import pytest
import torch

import face_crop_plus_tpu_torch
from face_crop_plus_tpu_torch.pipeline import FusedPipeline

from torch_parity import cropper_pair, small_enhancers, smooth_image, tamed_params

KW = dict(output_size=48, resize_size=96, det_threshold=-1.0, batch_size=4)
#: Below the 378 anchors of a 96² interim: the first batch grows the cap.
SMALL_TOPK = 64
ENV = ("FCPT_HOST_CROP", "FCPT_SERVE_PACK")
MODES = {"device": "0", "host": "1"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _port_cropper(**kw):
    """A port Cropper on the CPU with the tamed detector weights."""
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = face_crop_plus_tpu_torch.Cropper(device="cpu", **KW, **kw)
    t.det_model.net.load_state_dict(from_jax_params(tamed_params(), t.det_model.net),
                                    strict=True)
    return t


class _Croppers(dict):
    def __missing__(self, strategy):
        self[strategy] = _port_cropper(strategy=strategy, max_faces=2,
                                       auto_grow=strategy != "all")
        return self[strategy]


@pytest.fixture(scope="module")
def port():
    """Port Croppers with tamed detector weights, by strategy, built once."""
    return _Croppers()


def _batches(seed: int, n: int = 4, hw=(72, 60)) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [np.stack([smooth_image(rng, *hw) for _ in range(4)]) for _ in range(n)]


def _reset(cropper):
    """A fresh cap state (the growth a stream's first batch triggers) and
    shape budget."""
    cropper.det_model.pre_topk = SMALL_TOPK
    cropper._fused_shapes.clear()
    return cropper


def _serial(cropper, batches) -> list:
    _reset(cropper)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [cropper.process_images(b) for b in batches]


def _stream(cropper, batches, **kw) -> list:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(_reset(cropper).process_images_stream(batches, **kw))


def _assert_bitwise(got, ref):
    assert len(got) == len(ref)
    for (c, i, g), (rc, ri, rg) in zip(got, ref):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(c, rc)
        assert c.dtype == rc.dtype and c.shape == rc.shape
        assert (g is None) == (rg is None)


def _max_diff(got, ref) -> int:
    for (_, i, _), (_, ri, _) in zip(got, ref):
        np.testing.assert_array_equal(i, ri)
    return max(int(np.abs(c.astype(np.int16) - rc).max()) for (c, _, _), (rc, _, _)
               in zip(got, ref) if len(c))


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port Cropper ("largest") with the same tamed weights."""
    return cropper_pair(strategy="largest", **KW)


def _jax_stream(j, batches, **kw) -> list:
    j.det_model.pre_topk = SMALL_TOPK
    j._fused_shapes.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return list(j.process_images_stream(batches, depth=2, **kw))


@pytest.fixture()
def spy(monkeypatch):
    """Records the in-flight calls of both modes, in order, as ("d", k) for
    the k-th dispatch and ("f", k) for the finish of the k-th dispatch."""
    events, ids, count = [], {}, itertools.count()

    def wrap(name, kind):
        real = getattr(FusedPipeline, name)

        def call(self, *a, **kw):
            if kind == "d":
                handle = real(self, *a, **kw)
                ids[id(handle)] = next(count)
                events.append(("d", ids[id(handle)], kw.get("packed_hw")))
                return handle
            events.append(("f", ids[id(a[0])], None))
            return real(self, *a, **kw)

        monkeypatch.setattr(FusedPipeline, name, call)

    for name, kind in (("process_async", "d"), ("process_finish", "f"),
                       ("detect_only_async", "d"), ("detect_only_finish", "f")):
        wrap(name, kind)
    return events


@pytest.fixture(scope="module")
def serial_refs():
    """``process_images`` results by mode, computed once (from a reset cap)."""
    return {}


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_stream_bitwise_equals_process_images(port, serial_refs, monkeypatch, mode, depth):
    """Every yield equals ``process_images`` of its batch, bit for bit.
    The first batch grows ``pre_topk``; the batches dispatched before its
    collect re-run with the grown cap (one extra detect pass each)."""
    monkeypatch.setenv("FCPT_HOST_CROP", MODES[mode])
    t = port["largest"]
    batches = _batches(1, n=3)
    if mode not in serial_refs:
        serial_refs[mode] = _serial(t, batches)
    ref = serial_refs[mode]
    calls = []
    real_detect = t.det_model._detect
    monkeypatch.setattr(t.det_model, "_detect", lambda *a: calls.append(1) or real_detect(*a))
    got = _stream(t, batches, depth=depth)
    _assert_bitwise(got, ref)
    assert t.det_model.pre_topk == 378
    # 3 dispatches, the first batch's growth, and one re-run for each batch
    # dispatched before that growth.
    assert len(calls) == 3 + 1 + min(depth, 2)


@pytest.mark.parametrize("strategy", ["best", "all"])
def test_host_crop_stream_any_strategy(port, monkeypatch, strategy):
    """The host-crop mode streams every strategy ("all" too), bitwise."""
    monkeypatch.setenv("FCPT_HOST_CROP", "1")
    t = port[strategy]
    batches = _batches(12, n=3)
    ref = _serial(t, batches)
    _assert_bitwise(_stream(t, batches, depth=2), ref)
    assert sum(len(i) for _, i, _ in ref) == (3 * 4 * 2 if strategy == "all" else 12)


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_matches_jax_stream(pair, monkeypatch, mode):
    """The JAX stream pipelines the host-crop mode and runs ``process_images``
    per batch otherwise: indices equal, crops within ±1."""
    monkeypatch.setenv("FCPT_HOST_CROP", MODES[mode])
    j, t = pair
    batches = _batches(2, n=3)
    ref = _jax_stream(j, batches)
    got = _stream(t, batches, depth=2)
    assert _max_diff(got, ref) <= 1 and sum(len(i) for _, i, _ in got) == 12


def test_stream_parser_groups_match_jax(monkeypatch):
    """Parsing runs at collect time: groups equal to the JAX stream's, masks
    equal off near-tie pixels (at most 0.5 % of a mask)."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp

    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    groups = dict(attr_groups={"p3": [3], "no3": [-3]},
                  mask_groups={"face": list(range(1, 19)), "c3": [3]})
    j, t = cropper_pair(strategy="largest", **KW, **groups)
    for c in (j, t):
        c.par_model.attr_threshold = c.par_model.mask_threshold = 85
    batches = _batches(3, n=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = list(j.process_images_stream(batches, depth=2))
        got = list(t.process_images_stream(batches, depth=2))
        serial = [t.process_images(b) for b in batches]
    assert _max_diff(got, ref) <= 1
    for (_, _, (attr, masks)), (_, _, (rattr, rmasks)), (_, _, (sattr, smasks)) in zip(
            got, ref, serial):
        assert attr == rattr == sattr and set(masks) == set(rmasks) == set(smasks)
        assert "face" in masks
        for name, (members, m) in masks.items():
            assert members == rmasks[name][0]
            np.testing.assert_array_equal(m, smasks[name][1])
            assert (m != rmasks[name][1]).mean() <= 5e-3
    assert 0 < len(got[1][2][0]["p3"]) < 4  # a partial group


@pytest.mark.parametrize("mode", list(MODES))
def test_ragged_and_empty_batches_keep_order(port, spy, monkeypatch, mode):
    """A ragged batch (three shapes: one staged detect) and an empty one
    drain the queue and run as ``process_images``; order is kept."""
    monkeypatch.setenv("FCPT_HOST_CROP", MODES[mode])
    t = port["largest"]
    rng = np.random.default_rng(5)
    uniform = _batches(4, n=3)
    ragged = [smooth_image(rng, *hw) for hw in ((72, 60), (50, 90), (64, 40))]
    stream = [uniform[0], uniform[1], ragged, [], uniform[2]]
    ref = _serial(t, stream)
    spy.clear()
    got = _stream(t, stream, depth=2)
    _assert_bitwise(got, ref)
    assert [len(i) for _, i, _ in got] == [4, 4, 3, 0, 4]
    assert got[3][0].shape == (0, 48, 48, 3) and got[3][2] == (None, None)
    # Both uniform batches before the ragged one are collected before it runs.
    assert [e[0] for e in spy] == ["d", "d", "f", "f", "d", "f"]


@pytest.mark.parametrize("mode", list(MODES))
def test_depth_two_keeps_two_batches_in_flight(port, spy, monkeypatch, mode):
    """At depth 2 batch k+2 is dispatched before batch k is finished."""
    monkeypatch.setenv("FCPT_HOST_CROP", MODES[mode])
    got = _stream(port["best"], _batches(6, n=5), depth=2)
    assert len(got) == 5
    order = [e[:2] for e in spy]
    assert order == [("d", 0), ("d", 1), ("d", 2), ("f", 0), ("d", 3), ("f", 1), ("d", 4),
                     ("f", 2), ("f", 3), ("f", 4)]
    for k in range(3):
        assert order.index(("d", k + 2)) < order.index(("f", k))


def test_closed_generator_frees_the_lock(port, monkeypatch):
    t = port["largest"]
    batches = _batches(7, n=4)
    ref = _serial(t, batches[:1])
    gen = _reset(t).process_images_stream(batches, depth=2)
    first = next(gen)
    gen.close()
    assert not t._device_lock.locked()
    _assert_bitwise([first], ref)
    _assert_bitwise([t.process_images(batches[0])], ref)


def test_strategy_all_outside_host_crop_is_serialized(port, spy, monkeypatch):
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    t = port["all"]
    batches = _batches(8, n=2)
    ref = _serial(t, batches)
    _assert_bitwise(_stream(t, batches, depth=2), ref)
    assert spy == [] and sum(len(i) for _, i, _ in ref) == 16


def test_enhancer_is_serialized(monkeypatch, spy):
    """With an enhancer every batch runs as ``process_images`` (here no
    image is gated: the routing is the point)."""
    small_enhancers(monkeypatch)
    monkeypatch.setenv("FCPT_HOST_CROP", "1")
    t = _port_cropper(strategy="largest", enh_threshold=-np.inf)
    assert t.enh_model is not None
    batches = _batches(9, n=2)
    ref = _serial(t, batches)
    _assert_bitwise(_stream(t, batches, depth=2), ref)
    assert spy == []


def test_pack_upload_matches_jax_band(pair, monkeypatch, spy):
    """Packed detect inputs: keyed ("yuv420", h, w); crops warp from the
    caller's RGB; against the RGB stream the JAX package's band, against
    the JAX packed stream ±1.  ``FCPT_SERVE_PACK=1`` is the same switch."""
    monkeypatch.setenv("FCPT_HOST_CROP", "1")
    j, t = pair
    batches = _batches(10, n=2)
    rgb = _stream(t, batches, depth=2)
    ref = _jax_stream(j, batches, pack_upload=True)
    got = _stream(t, batches, depth=2, pack_upload=True)
    assert _max_diff(got, ref) <= 1
    for (c, i, _), (rc, ri, _) in zip(got, rgb):
        np.testing.assert_array_equal(i, ri)
        assert np.abs(c.astype(np.int16) - rc).mean() < 4.0
    assert t._fused_shapes == {("yuv420", 72, 60)}
    monkeypatch.setenv("FCPT_SERVE_PACK", "1")
    _assert_bitwise(_stream(t, batches, depth=2), got)
    assert [e[2] for e in spy if e[0] == "d"] == [None, None] + [(72, 60)] * 4


def test_pack_upload_odd_shape_and_device_mode_stay_rgb(port, spy, monkeypatch):
    """Odd H or W cannot pack: the RGB program runs, results bitwise equal.
    Outside the host-crop mode ``pack_upload`` has no effect."""
    t = port["largest"]
    for env, hw in (("1", (71, 60)), ("0", (71, 60)), ("0", (72, 60))):
        monkeypatch.setenv("FCPT_HOST_CROP", env)
        batches = _batches(11, n=1, hw=hw)
        ref = _serial(t, batches)
        spy.clear()
        _assert_bitwise(_stream(t, batches, depth=2, pack_upload=True), ref)
        assert [e[0] for e in spy] == ["d", "f"] and all(e[2] is None for e in spy)


def test_stream_requires_detector():
    c = face_crop_plus_tpu_torch.Cropper(det_threshold=None, device="cpu")
    with pytest.raises(ValueError, match="detector"):
        list(c.process_images_stream([np.zeros((1, 32, 32, 3), np.uint8)]))


def test_process_async_refuses_two_program_path(port):
    with pytest.raises(ValueError, match="best"):
        port["all"]._fused.process_async(np.zeros((4, 72, 60, 3), np.uint8), (96, 96))


def test_to_device_on_the_cpu():
    from face_crop_plus_tpu_torch.ops.anchors import anchor_grid
    from face_crop_plus_tpu_torch.utils.device import to_device

    cpu = torch.device("cpu")
    grid = anchor_grid(96, 96)  # read-only, cached
    t = to_device(grid, cpu)
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), grid)
    t += 1  # a copy: the cached grid is untouched
    assert np.array_equal(anchor_grid(96, 96), grid) and not np.array_equal(t.numpy(), grid)
    assert to_device(2.5, cpu, np.float32).shape == ()
    strided = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)[:, :, ::2]
    np.testing.assert_array_equal(to_device(strided, cpu).numpy(), strided)
