"""Port parity: RetinaFace network, weights, decode and cap growth.

Network outputs are compared in f32 with ``rtol=1e-4, atol=1e-4·max|ref|``:
the CPU conv backends of the two packages sum in different orders (and the
JAX stem runs as an exact space-to-depth reformulation of the 7x7/2 conv).
Parity runs on *tamed* weights (``torch_parity.tamed_params``): the
random-init detector saturates, which would hide every difference.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_crop_plus_tpu.models import backbones as jbb
from face_crop_plus_tpu.models import detection as jdet
from face_crop_plus_tpu.models import weights as jw
from face_crop_plus_tpu.ops.anchors import anchor_grid as j_anchor_grid
from face_crop_plus_tpu.ops.anchors import num_anchors as j_num_anchors
from face_crop_plus_tpu.ops.nn import Params
from face_crop_plus_tpu_torch.models import detection as tdet
from face_crop_plus_tpu_torch.models import weights as tw
from face_crop_plus_tpu_torch.ops.anchors import anchor_grid, num_anchors

from torch_parity import jax_params, jax_retinaface_params, tamed_params, torch_net


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def tamed():
    p = tamed_params()
    return p, jax_params(p), torch_net(p)


@pytest.mark.parametrize("hw", [(64, 64), (1024, 1024), (218, 178), (13, 7)])
def test_anchor_grid_exact(hw):
    np.testing.assert_array_equal(anchor_grid(*hw), j_anchor_grid(*hw))
    assert num_anchors(*hw) == j_num_anchors(*hw) == len(anchor_grid(*hw))


def test_from_jax_params_exact_key_set():
    jp = jax_retinaface_params()
    assert len(jp) == 237
    net = tdet.RetinaFaceNet()
    sd = tw.from_jax_params(jp, net)
    assert set(sd) == set(net.state_dict()) == set(jp)
    net.load_state_dict(sd, strict=True)
    w = jp["body.conv1.weight"]  # HWIO (7, 7, 3, 64)
    ours = net.body.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(ours, w.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("drop,add", [(True, False), (False, True)])
def test_from_jax_params_rejects_other_key_sets(drop, add):
    jp = dict(jax_retinaface_params())
    if drop:
        jp.pop("fpn.merge1.1.scale")
    if add:
        jp["body.extra.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(KeyError):
        tw.from_jax_params(jp, tdet.RetinaFaceNet())


def test_random_init_equals_jax_random_init():
    # Children are registered in the JAX forward's parameter-creation order,
    # so the seeded draws are the same numbers.
    jp = jax_retinaface_params()
    net = tdet.RetinaFaceNet()
    ours = tw.random_state_dict(net, seed=0)
    assert list(ours) == list(jp)
    ref = tw.from_jax_params(jp, net)
    for k in ours:
        assert torch.equal(ours[k], ref[k]), k


def test_convert_state_dict_matches_jax_bn_folding():
    rng = np.random.default_rng(5)
    sd = {
        "a.0.weight": torch.from_numpy(rng.normal(size=(8, 3, 3, 3)).astype(np.float32)),
        "a.1.weight": torch.from_numpy(rng.uniform(0.5, 2, 8).astype(np.float32)),
        "a.1.bias": torch.from_numpy(rng.normal(size=8).astype(np.float32)),
        "a.1.running_mean": torch.from_numpy(rng.normal(size=8).astype(np.float32)),
        "a.1.running_var": torch.from_numpy(rng.uniform(0.1, 3, 8).astype(np.float32)),
        "a.1.num_batches_tracked": torch.tensor(3),
        "h.conv1x1.bias": torch.from_numpy(rng.normal(size=8).astype(np.float32)),
    }
    ours = tw.convert_state_dict(sd)
    ref = jw.convert_state_dict(sd)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        r = ref[k].transpose(3, 2, 0, 1) if ref[k].ndim == 4 else ref[k]
        np.testing.assert_array_equal(v.numpy(), r)  # float64 folding, exact


def test_load_or_init_reads_jax_npz(tmp_path, monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path / "empty"))
    p = tamed_params()
    jw.save_npz(p, str(tmp_path / "retinaface.npz"))
    net = tdet.RetinaFaceNet()
    assert tw.load_or_init("retinaface", net, str(tmp_path))
    ref = torch_net(p).state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_load_or_init_falls_back_to_random_init(tmp_path, monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path))
    net = tdet.RetinaFaceNet()
    with pytest.warns(UserWarning, match="Falling back to random"):
        assert not tw.load_or_init("retinaface", net, None)
    assert torch.equal(net.body.bn1.scale, torch.ones(64))


def test_preprocess_exact():
    x = np.random.default_rng(6).integers(0, 256, (2, 9, 7, 3), dtype=np.uint8)
    xf = x.astype(np.float32)
    ref = xf[..., ::-1] - np.array(jdet._BGR_MEAN, np.float32)
    np.testing.assert_array_equal(tdet.preprocess(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("n", [1, 2])
def test_resnet50_features_matches_jax(tamed, n):
    _, jp, net = tamed
    x = np.random.default_rng(n).uniform(-120, 130, (n, 64, 64, 3)).astype(np.float32)
    ref = jbb.resnet50_features(Params(jp), "body", jnp.asarray(x))
    with torch.no_grad():
        ours = net.body(torch.from_numpy(x).permute(0, 3, 1, 2))
    for o, r in zip(ours, ref):
        _close(o.permute(0, 2, 3, 1).numpy(), r)


@pytest.mark.parametrize("n", [1, 2])
def test_retinaface_forward_matches_jax(tamed, n):
    _, jp, net = tamed
    x = np.random.default_rng(10 + n).uniform(-120, 130, (n, 64, 64, 3)).astype(np.float32)
    ref = [np.asarray(a) for a in jdet.retinaface_forward(Params(jp), jnp.asarray(x))]
    # Precondition (tamed weights): scores spread inside (0, 1), all
    # distinct, and |loc| small enough that decode stays finite.
    s = ref[0][..., 1]
    assert 0.0 < s.min() and s.max() < 1.0 and s.max() - s.min() > 0.5
    assert len(np.unique(s)) == s.size
    assert np.abs(ref[1]).max() < 10.0
    with torch.no_grad():
        ours = tdet.retinaface_forward(net, torch.from_numpy(x))
    assert [tuple(o.shape) for o in ours] == [r.shape for r in ref]
    for o, r in zip(ours, ref):
        _close(o.numpy(), r)


def test_decode_detections_matches_jax():
    rng = np.random.default_rng(7)
    a = num_anchors(64, 48)
    loc = rng.normal(size=(2, a, 4)).astype(np.float32) * 3
    ldm = rng.normal(size=(2, a, 10)).astype(np.float32) * 3
    priors = anchor_grid(64, 48)
    rb, rl = jdet.decode_detections(
        jnp.asarray(loc), jnp.asarray(ldm), jnp.asarray(priors), (64, 48)
    )
    ob, ol = tdet.decode_detections(
        torch.from_numpy(loc), torch.from_numpy(ldm), torch.tensor(priors), (64, 48)
    )
    # exp() of the two backends' vector libraries may differ by an ulp.
    np.testing.assert_allclose(ob.numpy(), np.asarray(rb), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(ol.numpy(), np.asarray(rl))  # no exp: exact


@pytest.fixture(scope="module")
def detectors():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jdet.RetinaFace(strategy="all", vis=0.6, max_faces=8, pre_topk=64)
        t = tdet.RetinaFace(strategy="all", vis=0.6, max_faces=8, pre_topk=64,
                            device="cpu")
    return j, t


@pytest.mark.parametrize(
    "caps,strategy,max_faces,pre_topk,n_anchors,auto_grow",
    [
        ([[10, 3]], "all", 8, 64, 43008, True),        # nothing binds
        ([[100, 3], [70, 5]], "all", 8, 64, 43008, True),   # pre_topk grows
        ([[50000, 900]], "all", 8, 64, 43008, True),  # both grow to ceilings
        ([[5, 30]], "all", 8, 64, 43008, True),       # max_faces grows
        ([[5, 30]], "largest", 8, 64, 43008, True),   # faces cap unused
        ([[300, 3]], "all", 8, 256, 168, True),       # anchor-count ceiling
        ([[300, 30]], "all", 8, 64, 43008, False),    # growth off: warn only
        ([[1024, 3]], "largest", 8, 1024, 43008, True),  # at the ceiling
    ],
)
def test_grown_args_match_jax(detectors, caps, strategy, max_faces, pre_topk,
                              n_anchors, auto_grow):
    j, t = detectors
    args = dict(strategy=strategy, vis_threshold=0.6, nms_threshold=0.4,
                max_faces=max_faces, pre_topk=pre_topk, variances=(0.1, 0.2))
    caps = np.asarray(caps, np.int32)
    for d in (j, t):
        d.auto_grow = auto_grow
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j.grown_args(caps, args, n_anchors)
        ours = t.grown_args(caps, args, n_anchors)
    assert ours == ref
