"""Port parity: the models' ``compute_dtype`` (bfloat16 when asked for).

The JAX package computes in its ``compute_dtype`` where a caller passes one
(``jnp.bfloat16``) and in float32 off the TPU otherwise; the port takes
``torch.bfloat16`` the same way and defaults to float32 on every device.
Here both packages run bfloat16 on the CPU on the same numpy-seeded
inputs with the same tamed weights (``torch_parity``); the JAX networks
run under jit, its ops op by op.

Bands, each stated where it is checked:

* Ops (a): within 1 bfloat16 ulp of the JAX op, most of them bitwise; a
  convolution differs by 1 ulp on at most :data:`CONV_SHARE` of its
  elements without a bias (other f32 summation orders) and
  :data:`CONV_BIAS_SHARE` with one: JAX adds the f32 bias to the f32
  accumulator, the port's bias rides in the convolution in bfloat16 (one
  code path on the CPU and the card).
* Networks (c, e, f): each output within a stated absolute band of the JAX
  bfloat16 output, and no farther from it, by its largest and by its mean
  difference, than the JAX bfloat16 output is from the JAX float32 one on
  the same input (:func:`_held`), so a fault cannot hide in a loose band.
* Selections (c, d, g): given the same scores the two packages select the
  same faces in the same order, ties included (d).  Between the two
  networks a bfloat16 score moves by up to :data:`SCORE_BAND` (3 ulps
  near 1), which flips near-ties of the visibility threshold and of NMS;
  JAX's own bfloat16 run flips as many against its float32 run.  So
  "best"/"largest" hold landmarks within :data:`LANDMARK_BAND` px, and
  "all" holds the share of faces matched within that band both ways
  (:data:`MATCHED_SHARE`), printing how many it excuses.
* Crops (g): a crop is only as close as its landmarks (the tamed
  detector's faces are a few pixels wide, so 0.1 px of landmark moves a
  48² crop by tens of levels, between JAX's own bfloat16 and float32 runs
  too); the port's crops are held within ±1 of the JAX package's crops
  of the port's own landmarks.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_crop_plus_tpu.models import detection as jdet
from face_crop_plus_tpu.models import enhancement as jenh
from face_crop_plus_tpu.models import parsing as jpar
from face_crop_plus_tpu.ops import nms as jnms
from face_crop_plus_tpu.ops import nn as jnn
from face_crop_plus_tpu.ops.anchors import anchor_grid as j_anchor_grid
from face_crop_plus_tpu_torch.models import detection as tdet
from face_crop_plus_tpu_torch.models import enhancement as tenh
from face_crop_plus_tpu_torch.models import parsing as tpar
from face_crop_plus_tpu_torch.models.weights import from_jax_params
from face_crop_plus_tpu_torch.ops import nms as tnms
from face_crop_plus_tpu_torch.ops import nn as tnn
from face_crop_plus_tpu_torch.parallel import mesh as tmesh
from face_crop_plus_tpu_torch.utils import device as tdevice

from torch_parity import (
    compute_dtype_models,
    cropper_pair,
    jax_params,
    smooth_image,
    tamed_bisenet_params,
    tamed_params,
    tamed_rrdb_params,
)

BF16 = torch.bfloat16

#: Share of a convolution's outputs 1 ulp off the JAX one, without a bias
#: (measured: 1.4e-4 on the 3x3 case, 0 on the 7x7/2) and with one
#: (measured: 8.9e-3 to 1.3e-2 with biases of spread 0.01, the tamed
#: enhancer's; the ulp is taken at max(|output|, |bias|)).
CONV_SHARE = 1e-3
CONV_BIAS_SHARE = 2e-2

#: Largest |score| difference of the detector (3 ulps near 1; measured
#: 0.0059 on the 2×64² batch, 0.0117 on other seeds), of its box and
#: landmark regressions (measured 0.023 / 0.021 at |x| ~ 8), and of the
#: parser's logits (measured 0.069 at |x| ~ 13).
SCORE_BAND = 3 * 2.0**-8
REGRESSION_BAND = 0.0625
LOGIT_BAND = 0.125

#: Largest landmark difference (px) of a face both packages select
#: (measured 0.10 px at 64², 0.17 px in 72×60 sources).
LANDMARK_BAND = 0.5

#: Least share of one package's "all" faces with a face of the other
#: within LANDMARK_BAND in the same image (measured at vis 0.6: at most 3
#: of ~75 faces on one side over 6 seeds; JAX bfloat16 against JAX
#: float32 at most 2 on one side over 4 seeds).
MATCHED_SHARE = 0.9

#: Level band of the enhancer's uint8 output against JAX's (measured: 2
#: levels on 16 % of values, as far as JAX's own op-by-op run is from its
#: run under jit; JAX bfloat16 against float32: 1 level).
ENHANCE_LEVELS = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these parity runs share the machine's cores with
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if torch.is_tensor(t) else jnp.asarray(t, jnp.float32))


def _ulps(ours: np.ndarray, ref: np.ndarray, floor=0.0) -> np.ndarray:
    """|ours - ref| in bfloat16 ulps of max(|ref|, ``floor``): the spacing
    of bfloat16 values (8 significant bits) at that magnitude.  A bias
    rounded to bfloat16 moves an output by up to half an ulp of the bias,
    so a biased convolution's floor is its bias."""
    mag = np.maximum(np.abs(ref), np.abs(floor))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.float32(2.0**-126)))) - 7)
    return np.abs(ours - ref) / ulp


def _held(name, ours, ref_bf16, ref_f32, band):
    """The network band: ``ours`` within ``band`` of the JAX bfloat16
    output, and no farther from it than the JAX bfloat16 output is from the
    JAX float32 one, by the largest and by the mean difference.  The
    largest differences of two bfloat16 runs are their extremes, which
    grow with the output's size: ``chip_smoke.py`` phase 12 holds a 1024²
    image of the card against the CPU by the mean and prints the rest."""
    d = np.abs(ours - ref_bf16)
    j = np.abs(ref_bf16 - ref_f32)
    print(f"{name}: port-vs-JAX bf16 max {d.max():.6g} mean {d.mean():.6g}; "
          f"JAX bf16-vs-f32 max {j.max():.6g} mean {j.mean():.6g}")
    assert d.max() <= band, name
    assert d.max() <= j.max() and d.mean() <= j.mean(), name


def _smooth_batch(n, h, w, seed, cell=8):
    rng = np.random.default_rng(seed)
    return np.stack([smooth_image(rng, h, w, cell) for _ in range(n)])


# ---------------------------------------------------------------------------
# (a) the ops' dtype rules
# ---------------------------------------------------------------------------


def _bf16_input(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("kernel,stride,bias", [(3, 1, False), (3, 1, True), (1, 1, True),
                                                (7, 2, False), (3, 2, True)])
def test_conv_in_bf16_matches_jax(kernel, stride, bias):
    rng = np.random.default_rng(kernel * 10 + stride)
    cin, cout = 32, 48
    x = _bf16_input((2, 24, 24, cin), 1)
    w = (rng.normal(size=(kernel, kernel, cin, cout)) / np.sqrt(kernel * kernel * cin))
    b = rng.normal(size=(cout,)) * 0.01
    params = {"c.weight": w.astype(np.float32), "c.bias": b.astype(np.float32)}
    ref = jnn.conv2d(jnn.Params(jax_params(params)), "c", jnp.asarray(x, jnp.bfloat16), cout,
                     kernel, stride, bias=bias)
    conv = tnn.conv(cin, cout, kernel, stride=stride, bias=bias)
    conv.weight.data = torch.from_numpy(params["c.weight"].transpose(3, 2, 0, 1).copy())
    if bias:
        conv.bias.data = torch.from_numpy(params["c.bias"])
    conv = conv.to(BF16)
    with torch.no_grad():
        ours = conv(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16))
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    ulps = _ulps(_np(ours).transpose(0, 2, 3, 1), _np(ref), b if bias else 0.0)
    share = float((ulps > 0).mean())
    print(f"conv k{kernel} s{stride} bias={bias}: {share:.6g} of outputs 1 ulp off")
    assert ulps.max() <= 1 and share <= (CONV_BIAS_SHARE if bias else CONV_SHARE)


def _op_cases():
    x4 = _bf16_input((2, 12, 10, 5), 2, 3.0)  # NHWC
    return {
        "batch_norm": (
            lambda x: jnn.batch_norm(jnn.Params({"n.scale": jnp.linspace(0.5, 1.5, 5),
                                                 "n.bias": jnp.linspace(-1, 1, 5)}), "n", x),
            lambda x: _folded_bn(x), x4, True),
        "leaky_relu": (lambda x: jnn.leaky_relu(x), lambda x: tnn.leaky_relu(x), x4, True),
        "max_pool": (lambda x: jnn.max_pool(x, 3, 2, 1), lambda x: tnn.max_pool(x, 3, 2, 1),
                     x4, True),
        "global_avg_pool": (jnn.global_avg_pool, tnn.global_avg_pool, x4, True),
        "resize_nearest": (lambda x: jnn.resize_nearest(x, (17, 7)),
                           lambda x: tnn.resize_nearest(x, (17, 7)), x4, True),
        "softmax": (lambda x: jnn.softmax(x, axis=-1), None, x4, False),
        "resize_bilinear": (lambda x: jnn.resize_bilinear(x, (20, 16), pad=((2, 3), (1, 0))),
                            None, x4, False),
        "resize_bilinear_ac": (lambda x: jnn.resize_bilinear(x, (23, 31), align_corners=True),
                               None, x4, False),
        "resize_bilinear_nchw": (lambda x: jnn.resize_bilinear(x, (23, 31), align_corners=True),
                                 lambda x: tnn.resize_bilinear_nchw(x, (23, 31), True), x4,
                                 True),
        "downscale4x_bicubic": (jnn.downscale4x_bicubic, tnn.downscale4x_bicubic,
                                _bf16_input((2, 16, 24, 3), 3), True),
    }


def _folded_bn(x):
    bn = tnn.FoldedBatchNorm(5)
    bn.scale.data = torch.linspace(0.5, 1.5, 5)
    bn.bias.data = torch.linspace(-1, 1, 5)
    return bn.to(BF16)(x)


@pytest.mark.parametrize("op", list(_op_cases()))
def test_op_in_bf16_matches_jax(op):
    """Each op of the dtype rules in bfloat16: the port's NCHW ops on NCHW
    tensors (``nchw``), the NHWC ones on NHWC tensors; within 1 ulp."""
    jax_fn, torch_fn, x, nchw = _op_cases()[op]
    if torch_fn is None:
        torch_fn = {"softmax": lambda t: tnn.softmax(t, dim=-1),
                    "resize_bilinear": lambda t: tnn.resize_bilinear(t, (20, 16),
                                                                     pad=((2, 3), (1, 0))),
                    "resize_bilinear_ac": lambda t: tnn.resize_bilinear(t, (23, 31), True)}[op]
    ref = jax_fn(jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(BF16)
    with torch.no_grad():
        ours = torch_fn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) if nchw else torch_fn(xt)
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    ulps = _ulps(_np(ours), _np(ref))
    print(f"{op}: max {ulps.max():.3g} ulp, {float((ulps > 0).mean()):.6g} of values off")
    assert ours.shape == ref.shape and ulps.max() <= 1


# ---------------------------------------------------------------------------
# (b) the default, the accepted dtypes, the reported precision
# ---------------------------------------------------------------------------


def _models(compute_dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (tdet.RetinaFace(device="cpu", compute_dtype=compute_dtype),
                tpar.BiSeNet(device="cpu", max_batch_size=1, compute_dtype=compute_dtype),
                tenh.RRDBNet(device="cpu", num_blocks=1, compute_dtype=compute_dtype))


def _outputs(models):
    det, par, enh = models
    images = _smooth_batch(1, 32, 32, seed=4, cell=4)
    with torch.no_grad():
        return (det._detect(torch.from_numpy(images), det._detect_args())[0],
                par._logits(torch.from_numpy(images)),
                enh._sr_uint8(torch.from_numpy(images[:, :16, :16])))


def test_default_is_float32_and_bitwise_explicit_float32(monkeypatch, small_parse):
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    default, explicit = _models(None), _models(torch.float32)
    for model in default:
        assert model.compute_dtype == torch.float32
        assert tdevice.compute_precision(model)["dtype"] == "float32"
        tensors = list(model.net.parameters()) + list(model.net.buffers())
        assert {t.dtype for t in tensors} == {torch.float32}
    assert tdevice.compute_precision()["dtype"] == "float32"
    for a, b in zip(_outputs(default), _outputs(explicit)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_models_hold_bf16_weights_and_report_it(monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    f32 = _models(None)
    for model, ref in zip(_models(BF16), f32):
        assert model.compute_dtype == BF16
        assert tdevice.compute_precision(model)["dtype"] == "bfloat16"
        ours, want = model.net.state_dict(), ref.net.state_dict()
        for key in want:  # the seeded f32 weights, rounded once
            assert ours[key].dtype == BF16 and torch.equal(ours[key], want[key].to(BF16)), key
    assert tdevice.compute_precision(BF16)["dtype"] == "bfloat16"
    assert tdevice.compute_precision(torch.float16)["dtype"] == "float16"


@pytest.mark.parametrize("bad", [torch.float64, torch.int8, "bfloat16", jnp.bfloat16,
                                 np.float32])
def test_other_compute_dtypes_raise(bad):
    with pytest.raises(ValueError, match="compute_dtype"):
        tdevice.resolve_compute_dtype(bad)
    with pytest.raises(ValueError, match="compute_dtype"):
        tdet.RetinaFace(device="cpu", compute_dtype=bad)


# ---------------------------------------------------------------------------
# (c) RetinaFace in bfloat16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def detector_run():
    """JAX (bf16 and f32, under jit) and port (bf16) network outputs of a
    seeded 2×64² batch with the tamed weights, through each package's own
    preprocessing, and both bf16 detectors."""
    p = tamed_params()
    images = _smooth_batch(2, 64, 64, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jdet.RetinaFace(device=jax.devices("cpu")[0], compute_dtype=jnp.bfloat16)
        t = tdet.RetinaFace(device="cpu", compute_dtype=BF16)
    j.params = jax_params(p)
    t.net.load_state_dict(from_jax_params(p, t.net))

    def jax_forward(dtype):
        x = images.astype(np.float32)[..., ::-1] - np.float32([104.0, 117.0, 123.0])
        fwd = jax.jit(lambda params, x: jdet.retinaface_forward(jnn.Params(params), x))
        return [_np(o) for o in fwd(j.params, jnp.asarray(x).astype(dtype))]

    with torch.no_grad():
        x = tdet.preprocess(torch.from_numpy(images)).to(t.compute_dtype)
        ours = tdet.retinaface_forward(t.net, x)
    assert all(o.dtype == BF16 for o in ours)
    return images, j, t, jax_forward(jnp.bfloat16), jax_forward(jnp.float32), \
        [_np(o) for o in ours]


def test_retinaface_bf16_outputs_match_jax(detector_run):
    _, _, _, ref16, ref32, ours = detector_run
    for name, o, r16, r32, band in zip(("scores", "loc", "ldm"), ours, ref16, ref32,
                                       (SCORE_BAND, REGRESSION_BAND, REGRESSION_BAND)):
        _held(f"detector {name}", o, r16, r32, band)
    # The scores are rounded to bfloat16 after the f32 softmax, in both.
    for s in (ours[0], ref16[0]):
        assert np.array_equal(s, np.asarray(jnp.asarray(s, jnp.bfloat16), np.float32))


def _match(lm_a, idx_a, lm_b, idx_b) -> tuple[int, float]:
    """(faces of a without a face of b within LANDMARK_BAND in the same
    image, largest landmark distance of a matched face)."""
    lm_b, idx_b = np.asarray(lm_b).reshape(len(idx_b), -1), np.asarray(idx_b)
    unmatched, worst = 0, 0.0
    for face, img in zip(np.asarray(lm_a).reshape(len(idx_a), -1), idx_a):
        d = np.abs(lm_b[idx_b == img] - face).max(axis=1) if (idx_b == img).any() else [np.inf]
        if np.min(d) > LANDMARK_BAND:
            unmatched += 1
        else:
            worst = max(worst, float(np.min(d)))
    return unmatched, worst


def _predict(det, images, strategy):
    det.strategy = strategy
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return det.predict(images)


@pytest.mark.parametrize("strategy", ["best", "largest", "all"])
def test_retinaface_bf16_predict_matches_jax(detector_run, strategy):
    images, j, t, ref16, _, _ = detector_run
    ref_lm, ref_idx = _predict(j, images, strategy)
    lm, idx = _predict(t, images, strategy)
    assert lm.dtype == np.float32 and len(ref_idx) > 0
    if strategy != "all":
        # One face an image, valid where any score passes vis: each image
        # has candidates far above vis, so validity is exact.
        assert list(idx) == list(ref_idx)
        _, worst = _match(lm, idx, ref_lm, ref_idx)
        print(f"{strategy}: landmarks within {worst:.6g} px")
        assert np.abs(lm - ref_lm).max() <= LANDMARK_BAND
        return
    miss_ours, worst = _match(lm, idx, ref_lm, ref_idx)
    miss_ref, _ = _match(ref_lm, ref_idx, lm, idx)
    near_vis = int((np.abs(ref16[0][..., 1] - j.vis_threshold) <= SCORE_BAND).sum())
    print(f"all: {len(idx)} faces against JAX's {len(ref_idx)}; unmatched {miss_ours} / "
          f"{miss_ref} (excused); {near_vis} candidates within SCORE_BAND of vis; matched "
          f"within {worst:.6g} px")
    assert miss_ours <= (1 - MATCHED_SHARE) * len(idx)
    assert miss_ref <= (1 - MATCHED_SHARE) * len(ref_idx)


# ---------------------------------------------------------------------------
# (d) bfloat16 score ties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["all", "best", "largest"])
def test_select_faces_on_bf16_ties_matches_jax(detector_run, strategy):
    """The JAX bfloat16 detector's own decoded outputs through both
    packages' face selection: identical faces in identical order, though
    many candidates share a score."""
    _, _, _, ref16, _, _ = detector_run
    scores, loc, ldm = ref16
    priors = j_anchor_grid(64, 64)
    boxes, landms = (np.asarray(a) for a in jdet.decode_detections(
        jnp.asarray(loc), jnp.asarray(ldm), jnp.asarray(priors), (64, 64)))
    s = scores[..., 1]
    vis = 0.5
    above = s[s > vis]
    ties = len(above) - len(np.unique(above))
    assert ties > 20  # bfloat16 quantises the scores: many exact ties
    kw = dict(vis_threshold=vis, nms_threshold=0.4, pre_topk=256, max_faces=64,
              strategy=strategy)
    ref = jnms.select_faces(jnp.asarray(s), jnp.asarray(boxes), jnp.asarray(landms),
                            use_pallas=False, **kw)
    ours = tnms.select_faces(torch.from_numpy(s), torch.from_numpy(boxes),
                             torch.from_numpy(landms), **kw)
    print(f"{strategy}: {len(above)} candidates above {vis}, {ties} tied")
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# (e) BiSeNet in bfloat16
# ---------------------------------------------------------------------------


@pytest.fixture
def small_parse(monkeypatch):
    """Both parsers at a 128² inference size."""
    for module in (jpar, tpar):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)


def test_bisenet_bf16_matches_jax(small_parse):
    p = tamed_bisenet_params()
    images = _smooth_batch(2, 96, 96, seed=8, cell=12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = {dt: jpar.BiSeNet(max_batch_size=2, device=jax.devices("cpu")[0],
                               compute_dtype=dt) for dt in (jnp.bfloat16, jnp.float32)}
        t = tpar.BiSeNet(max_batch_size=2, device="cpu", compute_dtype=BF16)
    t.net.load_state_dict(from_jax_params(p, t.net))

    def jax_logits(j):
        def f(params, images):
            x = jnn.resize_bilinear(images.astype(jnp.float32) / 255.0, (128, 128))
            x = ((x - jnp.array(j.mean)) / jnp.array(j.std)).astype(j.compute_dtype)
            return jpar.bisenet_forward(jnn.Params(params), x)
        return np.asarray(jax.jit(f)(jax_params(p), jnp.asarray(images)))

    ref16, ref32 = jax_logits(js[jnp.bfloat16]), jax_logits(js[jnp.float32])
    with torch.no_grad():
        ours = t._logits(torch.from_numpy(images))
        labels, counts = t._parse(torch.from_numpy(images), 96, 96)
    assert ours.dtype == torch.float32  # logits go to f32 before the upsample
    ours = ours.permute(0, 2, 3, 1).numpy()
    _held("parser logits", ours, ref16, ref32, LOGIT_BAND)

    j = js[jnp.bfloat16]
    j.params = jax_params(p)
    ref_labels, ref_counts = (np.asarray(a) for a in j._parse(
        j.params, jnp.asarray(images), 96, 96, tuple(j.mean), tuple(j.std)))
    top2 = np.sort(ref16, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]  # at 128², resized to 96² as the labels are
    from face_crop_plus_tpu_torch.ops.nn import resize_nearest
    margin = resize_nearest(torch.from_numpy(margin)[:, None], (96, 96))[:, 0].numpy()
    near = margin <= 2 * LOGIT_BAND
    differ = labels.numpy() != ref_labels
    print(f"parser labels: {int(differ.sum())} differ, {int(near.sum())} within the "
          f"margin {2 * LOGIT_BAND} of a tie")
    assert not (differ & ~near).any() and near.mean() < 0.5
    assert (np.abs(counts.numpy() - ref_counts).sum(1) <= 2 * differ.reshape(2, -1).sum(1)).all()


# ---------------------------------------------------------------------------
# (f) RRDBNet in bfloat16
# ---------------------------------------------------------------------------


def test_rrdbnet_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    p = tamed_rrdb_params(1)
    images = _smooth_batch(1, 32, 32, seed=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = {dt: jenh.RRDBNet(num_blocks=1, device=jax.devices("cpu")[0], compute_dtype=dt)
              for dt in (jnp.bfloat16, jnp.float32)}
        t = tenh.RRDBNet(num_blocks=1, device="cpu", compute_dtype=BF16)
    t.net.load_state_dict(from_jax_params(p, t.net))
    for j in js.values():
        j.params = jax_params(p)

    def jax_hr(dtype):
        fwd = jax.jit(lambda params, x: jenh.rrdbnet_forward(jnn.Params(params), x, 1))
        x = (jnp.asarray(images, jnp.float32) / 255.0).astype(dtype)
        return _np(fwd(jax_params(p), x))

    x = (torch.from_numpy(images).permute(0, 3, 1, 2).float() / 255.0).to(BF16)
    with torch.no_grad():
        hr = t.net(x)
    assert hr.dtype == BF16
    _held("enhancer 4x output", _np(hr).transpose(0, 2, 3, 1), jax_hr(jnp.bfloat16),
          jax_hr(jnp.float32), 2.0**-7)

    j16 = js[jnp.bfloat16]
    ref = np.asarray(j16._enhance(j16.params, jnp.asarray(images))).astype(np.int16)
    with jax.disable_jit():  # JAX's own op-by-op run: other bfloat16 roundings
        eager = np.asarray(j16._enhance(j16.params, jnp.asarray(images))).astype(np.int16)
    ours = t._sr_uint8(torch.from_numpy(images)).numpy()
    d, e = np.abs(ours - ref), np.abs(eager - ref)
    print(f"enhanced uint8: port max {int(d.max())} levels, {float((d > 0).mean()):.6g} "
          f"differ; JAX op by op against JAX under jit max {int(e.max())}, "
          f"{float((e > 0).mean()):.6g} differ")
    assert ours.dtype == np.uint8 and d.max() <= ENHANCE_LEVELS
    assert d.max() <= e.max() and (d > 0).mean() <= 1.25 * (e > 0).mean()

    # The gate decides on landmarks, whatever the dtype: the same images.
    batch = _smooth_batch(3, 32, 32, seed=7)
    lm = np.array([[[4, 4], [10, 4], [7, 7], [4, 10], [10, 10]],
                   [[2, 2], [30, 2], [16, 16], [2, 30], [30, 30]],
                   [[8, 8], [12, 8], [10, 10], [8, 12], [12, 12]]], np.float32)
    for model in (js[jnp.bfloat16], t):
        model.min_face_factor = 0.1
    out = t.predict(batch, lm, [0, 1, 2])
    ref_out = np.asarray(js[jnp.bfloat16].predict(batch, lm, [0, 1, 2]))
    gated = [i for i in range(3) if not np.array_equal(ref_out[i], batch[i])]
    assert gated == [0, 2]
    assert np.array_equal(out[1], batch[1])
    assert all(np.abs(out[i].astype(np.int16) - ref_out[i]).max() <= ENHANCE_LEVELS
               for i in gated)


# ---------------------------------------------------------------------------
# (g) the fused pipeline with a bfloat16 detector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_fused_pipeline_bf16_matches_jax(monkeypatch, strategy):
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_NATIVE_WARP", "0")
    compute_dtype_models(monkeypatch, jnp.bfloat16, BF16)
    j, t = cropper_pair(output_size=48, resize_size=64, strategy=strategy, batch_size=2)
    assert t.det_model.compute_dtype == BF16 and j.det_model.compute_dtype == jnp.bfloat16
    images = _smooth_batch(2, 72, 60, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_crops, ref_lm, ref_idx = j._fused.process(images, j.resize_size)
    crops, lm, idx = t._fused.process(images, t.resize_size)
    assert crops.dtype == np.uint8 and crops.shape[1:] == (48, 48, 3)
    miss_ours, worst = _match(lm, idx, ref_lm, ref_idx)
    miss_ref, _ = _match(ref_lm, ref_idx, lm, idx)
    print(f"{strategy}: {len(idx)} faces against JAX's {len(ref_idx)}, unmatched "
          f"{miss_ours} / {miss_ref}, matched within {worst:.6g} px")
    if strategy == "largest":
        np.testing.assert_array_equal(idx, ref_idx)
        assert miss_ours == miss_ref == 0
    else:
        assert miss_ours <= (1 - MATCHED_SHARE) * len(idx)
        assert miss_ref <= (1 - MATCHED_SHARE) * len(ref_idx)
    # The crops are the JAX package's crops of the port's landmarks.
    with warnings.catch_warnings(), jax.disable_jit():
        warnings.simplefilter("ignore")
        want = j.crop_align(images, None, idx, lm)
    d = np.abs(crops.astype(np.int16) - want)
    print(f"{strategy}: crops within {int(d.max())} of JAX's crops of the same landmarks")
    assert want.shape == crops.shape and d.max() <= 1


# ---------------------------------------------------------------------------
# (h) the mesh in bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2])
def test_bf16_mesh_equals_no_mesh(monkeypatch, s):
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    from face_crop_plus_tpu_torch.pipeline import FusedPipeline
    from face_crop_plus_tpu_torch.utils.landmarks import make_target_landmarks

    p = tamed_params()
    images = _smooth_batch(3, 72, 60, seed=2)

    def fused(mesh):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            det = tdet.RetinaFace(strategy="all", pre_topk=32, max_faces=4, mesh=mesh,
                                  device=None if mesh else "cpu", compute_dtype=BF16)
        det.net.load_state_dict(from_jax_params(p, det.net))
        return FusedPipeline(det, make_target_landmarks((32, 32), 0.65), (32, 32),
                             border_mode="reflect_101", mesh=mesh)

    mesh = tmesh.make_mesh(devices=["cpu"] * s)
    on_mesh = fused(mesh)
    replicas = on_mesh.det.replicas()
    assert len(replicas) == s
    assert all(t.dtype == BF16 for r in replicas for t in r.state_dict().values())
    got = on_mesh.process(images, (64, 64))
    want = fused(None).process(images, (64, 64))
    np.testing.assert_array_equal(got[2], want[2])
    if s == 1:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(got[1], want[1], atol=1e-3)
        assert np.abs(got[0].astype(np.int16) - want[0]).max() <= 1

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for model in (tpar.BiSeNet(mesh=mesh, compute_dtype=BF16),
                      tenh.RRDBNet(mesh=mesh, num_blocks=1, compute_dtype=BF16)):
            assert all(t.dtype == BF16 for r in model.replicas()
                       for t in r.state_dict().values())


# ---------------------------------------------------------------------------
# (i) trunk_mode and use_s2d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,error", [
    (dict(), None), (dict(trunk_mode="auto"), None), (dict(trunk_mode="plain"), None),
    (dict(trunk_mode="ws2d"), NotImplementedError), (dict(trunk_mode="s2d"), NotImplementedError),
    (dict(use_s2d=True), NotImplementedError),
    (dict(use_s2d=True, trunk_mode="plain"), NotImplementedError),
    (dict(trunk_mode="lanes"), ValueError),
])
def test_rrdbnet_trunk_modes(monkeypatch, kw, error):
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if error is None:
            model = tenh.RRDBNet(device="cpu", num_blocks=1, **kw)
            assert model.trunk_mode == "plain" and model.use_s2d is False
            return
        with pytest.raises(error, match="TPU" if error is NotImplementedError else "trunk_mode"):
            tenh.RRDBNet(device="cpu", num_blocks=1, **kw)
        if error is ValueError:  # the JAX package refuses the same value
            with pytest.raises(ValueError, match="trunk_mode"):
                jenh.RRDBNet(num_blocks=1, device=jax.devices("cpu")[0], **kw)
