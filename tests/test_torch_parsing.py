"""Port parity: the BiSeNet parser, its primitives, weights and grouping.

The JAX package and the port run the same tamed weights
(``torch_parity.tamed_bisenet_params``) on the same seeded inputs on the
CPU.  Logits are compared in f32 with ``rtol=1e-4, atol=1e-4·max|ref|`` (the
two packages' convolutions sum in different orders).  Labels are the argmax
of the logits, so they can differ only where the JAX top-2 margin is within
that error: labels must be exactly equal wherever the margin exceeds
``EPS`` = 1e-4 (a margin moves by at most twice the logit difference,
which stays below 1.3e-5 at |logit| ~ 10), and the near-tie pixels are
counted.  Counts may differ only by those pixels' flips.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_crop_plus_tpu.models import parsing as jp
from face_crop_plus_tpu.models import weights as jw
from face_crop_plus_tpu.ops import nn as jnn
from face_crop_plus_tpu.ops.nn import Params
from face_crop_plus_tpu_torch.models import parsing as tp
from face_crop_plus_tpu_torch.models import weights as tw
from face_crop_plus_tpu_torch.ops import nn as tnn
from face_crop_plus_tpu_torch.utils import device as tdevice

from torch_parity import (
    jax_bisenet_params,
    jax_margins,
    jax_params,
    label_margins,
    smooth_image,
    tamed_bisenet_params,
    torch_bisenet,
)

#: Top-2 logit margin below which a label may differ between the packages.
EPS = 1e-4


@pytest.fixture
def small_parse(monkeypatch):
    """Both packages' parsers at a 128² inference size, for tests of logic
    that does not depend on it (packing, grouping, padding, knobs); the
    parse parity tests run at the real 512²."""
    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def parsers():
    """A JAX and a port ``BiSeNet`` (batch 2) holding the tamed weights."""
    p = tamed_bisenet_params()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jp.BiSeNet(attr_groups={"a": [1]}, mask_groups={"m": [1]}, max_batch_size=2)
        t = tp.BiSeNet(attr_groups={"a": [1]}, mask_groups={"m": [1]}, max_batch_size=2,
                       device="cpu")
    j.params = jax_params(p)
    t.net.load_state_dict(tw.from_jax_params(p, t.net), strict=True)
    return j, t


def _faces(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([smooth_image(rng, h, w, cell=max(4, h // 8)) for _ in range(n)])


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jnn.global_avg_pool(jnp.asarray(x)))
    ours = tnn.global_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ours.shape == (2, 3, 1, 1) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("out_hw", [(256, 256), (218, 178), (27, 13)])
def test_resize_nearest_keeps_label_maps_exact(out_hw):
    """Labels take the nearest resize as uint8 (no float round trip), with
    the JAX package's source rows and columns at a non-integer ratio."""
    labels = np.random.default_rng(1).integers(0, 19, (2, 512, 512), dtype=np.uint8)
    ours = tnn.resize_nearest(torch.from_numpy(labels)[:, None], out_hw)[:, 0]
    assert ours.dtype == torch.uint8
    ref = np.asarray(jnn.resize_nearest(jnp.asarray(labels)[..., None], out_hw))[..., 0]
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize(
    "in_hw,align_corners", [((64, 64), True), ((256, 256), False), ((218, 178), False)]
)
def test_resize_bilinear_nchw_matches_jax(in_hw, align_corners):
    """The parser's two resizes: the 64→512 align-corners logit upsample and
    the half-pixel input resize to 512²."""
    x = np.random.default_rng(2).normal(size=(2, *in_hw, 5)).astype(np.float32)
    ref = np.asarray(jnn.resize_bilinear(jnp.asarray(x), (512, 512), align_corners))
    ours = tnn.resize_bilinear_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), (512, 512),
                                    align_corners)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)
    nhwc = tnn.resize_bilinear(torch.from_numpy(x), (512, 512), align_corners)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), nhwc.numpy(), rtol=1e-5,
                               atol=1e-5)
    if align_corners:
        lib = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(512, 512), mode="bilinear",
            align_corners=True)
        np.testing.assert_allclose(ours.numpy(), lib.numpy(), rtol=1e-5, atol=1e-5)


def _block_params(fn, shape, seed, *args):
    """JAX init-mode params of one block, with spread BN scales and biases."""
    p = Params(rng=np.random.default_rng(seed))
    fn(p, "blk", jnp.zeros(shape, jnp.float32), *args)
    rng = np.random.default_rng(seed + 100)
    out = {}
    for k, v in p.data.items():
        if k.endswith(".scale"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(".bias"):
            v = rng.normal(size=v.shape).astype(np.float32) * 0.2
        out[k] = v
    return out


def _load_block(module, params):
    local = {k[len("blk."):]: v for k, v in params.items()}
    module.load_state_dict(tw.from_jax_params(local, module), strict=True)
    return module.eval().requires_grad_(False)


@pytest.mark.parametrize("cin,cout,stride", [(8, 8, 1), (8, 16, 2)])
def test_basic_block_matches_jax(cin, cout, stride):
    params = _block_params(jp._basic_block, (1, 12, 12, cin), 3, cout, stride)
    block = _load_block(tp.BasicBlock(cin, cout, stride), params)
    x = np.random.default_rng(4).normal(size=(2, 12, 12, cin)).astype(np.float32)
    ref = np.asarray(jp._basic_block(Params(jax_params(params)), "blk", jnp.asarray(x), cout,
                                     stride))
    with torch.no_grad():
        ours = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(ours.permute(0, 2, 3, 1).numpy(), ref)


def test_arm_matches_jax():
    params = _block_params(jp._arm, (1, 10, 10, 8), 5, 4)
    arm = _load_block(tp.AttentionRefinement(8, 4), params)
    x = np.random.default_rng(6).normal(size=(2, 10, 10, 8)).astype(np.float32)
    ref = np.asarray(jp._arm(Params(jax_params(params)), "blk", jnp.asarray(x), 4))
    with torch.no_grad():
        ours = arm(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(ours.permute(0, 2, 3, 1).numpy(), ref)


def test_sigmoid_gates_run_in_f32():
    x = torch.tensor([[-30.0, 0.1, 30.0]], dtype=torch.bfloat16)
    assert tp._gate(x).dtype == torch.bfloat16
    torch.testing.assert_close(tp._gate(x).float(), torch.sigmoid(x.float()).bfloat16().float())


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def test_random_init_equals_jax_random_init():
    jparams = jax_bisenet_params()
    assert len(jparams) == 90
    net = tp.BiSeNetNet()
    ours = tw.random_state_dict(net, seed=1)
    assert list(ours) == list(jparams)  # registration follows JAX creation order
    ref = tw.from_jax_params(jparams, net)
    for k in ours:
        assert torch.equal(ours[k], ref[k]), k
    assert "cp.resnet.layer2.0.downsample.0.weight" in ours
    assert "cp.resnet.layer1.0.downsample.0.weight" not in ours


@pytest.mark.parametrize("drop,add", [(True, False), (False, True)])
def test_from_jax_params_rejects_other_key_sets(drop, add):
    params = dict(jax_bisenet_params())
    if drop:
        params.pop("ffm.conv2.weight")
    if add:
        params["conv_out16.conv_out.weight"] = np.zeros((1, 1, 128, 19), np.float32)
    with pytest.raises(KeyError):
        tw.from_jax_params(params, tp.BiSeNetNet())


def test_pth_checkpoint_loads_like_jax(tmp_path, monkeypatch):
    """``bise_parser.pth``: BN folded in float64 as the JAX converter folds
    it, an auxiliary head the network lacks is dropped, the rest strict."""
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path / "empty"))
    rng = np.random.default_rng(7)
    sd = {}
    for k, v in tamed_bisenet_params().items():
        prefix, _, leaf = k.rpartition(".")
        if leaf == "scale":
            c = v.shape
            sd[f"{prefix}.weight"] = torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32))
            sd[f"{prefix}.bias"] = torch.from_numpy(rng.normal(size=c).astype(np.float32))
            sd[f"{prefix}.running_mean"] = torch.from_numpy(rng.normal(size=c).astype(np.float32))
            sd[f"{prefix}.running_var"] = torch.from_numpy(
                rng.uniform(0.1, 3, c).astype(np.float32))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(5)
        elif leaf == "weight" and v.ndim == 4:
            sd[k] = torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
    sd["conv_out16.conv_out.weight"] = torch.zeros(19, 128, 1, 1)
    torch.save(sd, tmp_path / "bise_parser.pth")
    assert tw.PTH_FILENAMES["bisenet"] == jw.PTH_FILENAMES["bisenet"] == "bise_parser.pth"
    net = tp.BiSeNetNet()
    assert tw.load_or_init("bisenet", net, str(tmp_path))
    ref = jw.convert_state_dict(sd)
    ref.pop("conv_out16.conv_out.weight")
    expected = tw.from_jax_params(ref, net)
    for k, v in net.state_dict().items():
        assert torch.equal(v, expected[k]), k
    # The conversion is cached next to the checkpoint, as the JAX package
    # caches it, and read first from then on: drop it to read the new .pth.
    (tmp_path / "bisenet.npz").unlink()
    # A checkpoint that lacks a key of the network is refused.
    sd.pop("ffm.conv1.weight")
    torch.save(sd, tmp_path / "bise_parser.pth")
    with pytest.raises(RuntimeError, match="ffm.conv1.weight"):
        tw.load_or_init("bisenet", tp.BiSeNetNet(), str(tmp_path))


def test_parser_falls_back_to_seeded_random_init(tmp_path, monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="Falling back to random"):
        t = tp.BiSeNet(device="cpu")
    assert not t.pretrained and t.device.type == "cpu"
    ref = tw.from_jax_params(jax_bisenet_params(), t.net)
    assert all(torch.equal(v, ref[k]) for k, v in t.net.state_dict().items())
    assert all(v.device.type == "cpu" for v in t.net.state_dict().values())
    assert not any(p.requires_grad for p in t.net.parameters())


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.BiSeNet()


# ---------------------------------------------------------------------------
# Network and parse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2])
def test_bisenet_forward_matches_jax(n):
    p = tamed_bisenet_params()
    x = np.random.default_rng(10 + n).normal(size=(n, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jp.bisenet_forward(Params(jax_params(p)), jnp.asarray(x)))
    # Precondition (tamed weights): logits spread, many classes, margins
    # well above the error at nearly every pixel.
    assert np.abs(ref).max() > 2.0 and len(np.unique(ref.argmax(-1))) >= 5
    assert np.quantile(label_margins(ref), 0.001) > 10 * EPS
    with torch.no_grad():
        ours = tp.bisenet_forward(torch_bisenet(p), torch.from_numpy(x))
    assert ours.shape == ref.shape == (n, 64, 64, 19) and ours.dtype == torch.float32
    _close(ours.numpy(), ref)
    assert np.abs(ours.numpy() - ref).max() < EPS / 4


@pytest.mark.parametrize("hw", [(256, 256), (218, 178)])
def test_parse_labels_and_counts_match_jax(parsers, hw):
    j, t = parsers
    images = _faces(2, *hw, seed=hw[1])
    ref_labels, ref_counts = (np.asarray(a) for a in j._parse(
        j.params, jnp.asarray(images), *hw, tuple(j.mean), tuple(j.std)))
    with torch.no_grad():
        labels, counts = t._parse(torch.from_numpy(images), *hw)
    labels, counts = labels.numpy(), counts.numpy()
    assert labels.dtype == np.uint8 and labels.shape == (2, *hw)
    assert counts.dtype == np.int32 and counts.shape == (2, 19)
    near = jax_margins(images) <= EPS
    differ = labels != ref_labels
    assert not (differ & ~near).any()  # exact off near-ties
    assert near.mean() < 1e-3, near.sum()
    flips = differ.reshape(2, -1).sum(1)
    assert (np.abs(counts - ref_counts).sum(1) <= 2 * flips).all()
    for b in range(2):
        np.testing.assert_array_equal(counts[b], np.bincount(labels[b].ravel(), minlength=19))
    assert (counts > 0).sum(1).min() >= 3


@pytest.mark.parametrize("w", [178, 64, 27])
def test_packed_masks_equal_packbits(small_parse, parsers, w):
    """MSB-first packing with each row padded to a multiple of 8 columns."""
    _, t = parsers
    images = _faces(2, 40, w, seed=w)
    attrs = ((3, 12), (8,), (0, 18))
    labels, counts = t.parse_batch(images)
    packed, counts_p = t.parse_batch_packed(images, attrs)
    np.testing.assert_array_equal(counts_p, counts)
    assert packed.shape == (3, 2, 40, -(-w // 8)) and packed.dtype == np.uint8
    for g, a in enumerate(attrs):
        np.testing.assert_array_equal(packed[g], np.packbits(np.isin(labels, a), axis=-1))
    np.testing.assert_array_equal(t.parse_counts(images), counts)


def test_group_semantics_match_jax(parsers):
    """AND/OR joins, negative indices and both thresholds, on crafted counts
    and labels, with the knobs overridden after construction."""
    j, t = parsers
    counts = np.zeros((4, 19), np.int32)
    counts[0, 6], counts[1, [4, 5]], counts[2, 6], counts[3, 18] = 10, 10, 3, 6
    labels = np.zeros((4, 16, 13), np.uint8)
    labels[0, :4, :4], labels[1, 0, 0], labels[2, 5:, 2:9], labels[3, :, 12] = 4, 5, 17, 4
    lcounts = np.stack([np.bincount(lab.ravel(), minlength=19) for lab in labels]).astype(np.int32)
    for knobs in [dict(), dict(attr_join_by_and=False), dict(attr_threshold=2, mask_threshold=0)]:
        for m in (j, t):
            m.attr_join_by_and, m.attr_threshold, m.mask_threshold = True, 5, 10
            m.__dict__.update(knobs)
            m.attr_groups = {"has6": [6], "no6_no18": [-6, -18], "both45": [4, 5], "mix": [4, -6]}
            m.mask_groups = {"eyes": [4, 5], "skin": [17], "none": [2]}
        assert t.group_by_attributes(counts) == j.group_by_attributes(counts)
        ref = j.group_by_masks(labels, lcounts)
        ours = t.group_by_masks(labels, lcounts)
        packed = np.packbits(labels[None] == np.array([4, 17, 2])[:, None, None, None], axis=-1)
        packed[0] |= np.packbits(labels == 5, axis=-1)
        ours_p = t.group_by_masks_packed(packed, lcounts, 13)
        assert ours.keys() == ref.keys() == ours_p.keys()
        for k, (inds, masks) in ref.items():
            assert ours[k][0] == ours_p[k][0] == inds
            np.testing.assert_array_equal(ours[k][1], masks)
            np.testing.assert_array_equal(ours_p[k][1], masks)
    assert t.group_by_attributes(counts)["mix"] == [1]


def test_predict_with_valid_n_matches_jax(small_parse, parsers):
    """Three faces at batch 2 (two sub-batches, the last padded) with the
    last marked as padding: groups equal JAX's, masks off near-ties."""
    j, t = parsers
    images = _faces(3, 32, 27, seed=3)
    _, counts = t.parse_batch(images)
    common = int(np.argmax(counts[:2].min(0)))  # a class every real face has
    # Class 0 cannot be negated (-0 == 0 reads as "absent"): pick from 1..18.
    rare = 1 + int(np.argmin(counts[:2, 1:].max(0)))
    for m in (j, t):
        m.attr_join_by_and, m.attr_threshold, m.mask_threshold = True, 5, 10
        m.attr_groups = {"pos": [common], "neg": [-rare], "or": [rare, common], "never": [rare]}
        m.mask_groups = {"common": [common], "pair": [common, rare], "rare": [rare]}
    ref = j.predict(images, valid_n=2)
    ours = t.predict(images, valid_n=2)
    assert ours[0] == ref[0] and ours[0]["pos"] == [0, 1] and "never" not in ours[0]
    near = jax_margins(images) <= EPS
    assert ours[1].keys() == ref[1].keys() and "rare" not in ours[1]
    for k, (inds, masks) in ref[1].items():
        assert ours[1][k][0] == inds and max(inds) < 2
        assert masks.dtype == ours[1][k][1].dtype == np.uint8
        assert not ((ours[1][k][1] != masks) & ~near[inds]).any()
    # A device tensor gives the same groups as the host array.
    tensor_groups = t.predict(torch.from_numpy(images), valid_n=2)
    assert tensor_groups[0] == ours[0]
    for k in ours[1]:
        np.testing.assert_array_equal(tensor_groups[1][k][1], ours[1][k][1])


def test_sub_batches_padded_to_batch_size(small_parse, parsers, monkeypatch):
    """Every sub-batch the network sees holds ``batch_size`` rows, padding
    repeats the last face, and results do not depend on the padding."""
    _, t = parsers
    images = _faces(3, 24, 24, seed=9)
    for src in (images, torch.from_numpy(images)):
        chunks = list(t._sub_batches(src))
        assert [(c.shape[0], s, v) for c, s, v in chunks] == [(2, 0, 2), (2, 2, 1)]
        assert torch.equal(chunks[1][0][1], chunks[1][0][0])
        assert torch.equal(chunks[1][0][0].cpu(), torch.from_numpy(images[2]))
    seen = []
    real = t.net.forward
    monkeypatch.setattr(t.net, "forward", lambda x: seen.append(x.shape[0]) or real(x))
    labels3, counts3 = t.parse_batch(images)
    assert seen == [2, 2]
    t.batch_size = 4
    try:
        labels4, counts4 = t.parse_batch(images)  # one sub-batch, one padding row
        single = [t.parse_batch(images[i : i + 1]) for i in range(3)]  # three padding rows
    finally:
        t.batch_size = 2
    assert seen == [2, 2, 4, 4, 4, 4]
    np.testing.assert_array_equal(counts4, counts3)
    np.testing.assert_array_equal(labels4, labels3)
    for i, (lab, cnt) in enumerate(single):
        np.testing.assert_array_equal(lab[0], labels3[i])
        np.testing.assert_array_equal(cnt[0], counts3[i])


def test_mean_std_overridable_after_construction(small_parse, parsers):
    j, t = parsers
    images = _faces(2, 24, 24, seed=12)
    before = t.parse_counts(images)
    try:
        for m in (j, t):
            m.mean, m.std = [0.0, 0.0, 0.0], [0.1, 0.1, 0.1]
        after = t.parse_counts(images)
        ref_labels, _ = j.parse_batch(images)
        labels, _ = t.parse_batch(images)
    finally:
        for m in (j, t):
            m.mean, m.std = list(jp._MEAN), list(jp._STD)
    assert not np.array_equal(before, after)
    assert (labels != ref_labels).mean() < 1e-3


def test_packed_sources_match_jax(small_parse, parsers):
    """``src_hw``: packed 4:2:0 rows are reconstructed on the device, so
    the labels, counts and groups equal those of the reconstruction, and
    the JAX parser's on the same rows except at near-ties."""
    from face_crop_plus_tpu_torch.ops.yuv import rgb_to_yuv420_np, yuv420_to_rgb_np

    j, t = parsers
    rows = rgb_to_yuv420_np(_faces(3, 24, 26, seed=13))
    recon = yuv420_to_rgb_np(rows, 24, 26)
    labels, counts = t.parse_batch(rows, src_hw=(24, 26))
    ref_labels, ref_counts = t.parse_batch(recon)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(counts, ref_counts)
    assert labels.shape == (3, 24, 26)
    np.testing.assert_array_equal(t.parse_counts(rows, src_hw=(24, 26)), counts)
    groups = t.predict(rows, src_hw=(24, 26))
    ref_groups = t.predict(recon)
    assert groups[0] == ref_groups[0] and groups[1].keys() == ref_groups[1].keys()
    for k, (inds, masks) in ref_groups[1].items():
        assert groups[1][k][0] == inds and groups[1][k][1].shape[1:] == (24, 26)
        np.testing.assert_array_equal(groups[1][k][1], masks)
    jax_labels, _ = j.parse_batch(rows, src_hw=(24, 26))
    assert (labels != np.asarray(jax_labels)).mean() < 1e-3


def test_parse_runs_in_f32(small_parse, parsers, monkeypatch):
    """The network and resizes run with TF32 off; the caller's flags stay."""
    _, t = parsers
    seen = []
    real = t.net.forward

    def spy(x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(x)

    monkeypatch.setattr(t.net, "forward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    t.parse_counts(_faces(1, 16, 16))
    assert seen == [(False, False)] and torch.backends.cudnn.allow_tf32
    assert tdevice.compute_precision()["dtype"] == "float32"


@pytest.mark.gpu
def test_parse_on_gpu_matches_cpu(parsers):
    """The parser on the card against the CPU: labels equal off near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, t = parsers
    g = tp.BiSeNet(max_batch_size=2, device="cuda")
    g.net.load_state_dict(t.net.state_dict())
    assert all(v.device.type == "cuda" for v in g.net.state_dict().values())
    images = _faces(2, 256, 256, seed=5)
    labels_g, counts_g = g.parse_batch(images)
    labels_c, counts_c = t.parse_batch(images)
    near = jax_margins(images) <= EPS
    assert not ((labels_g != labels_c) & ~near).any()
