"""The convolutions' epilogue ``ops/nn.py: bn_act`` and its CUDA kernel.

On the CPU: the plain path equals the modules' own composition
(``FoldedBatchNorm``, the residual add, ``leaky_relu``, ``torch.cat``) bit
for bit, for every residual kind, with and without ReLU, into a fresh
tensor and into a channel slice, in float32 and bfloat16; a seeded
``RetinaFaceNet`` forward equals, bitwise, the forward composed from its
modules as they were before the epilogue; the tracer's counter reads
plain.  On a card (marked ``gpu``): the kernel bitwise against the plain
version at the network's shapes, at N = 1, odd H*W, unaligned slices and
inputs, with NaN, ±0 and ±inf, in place, on a second card's stream, and
the whole network against its plain passes.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from face_crop_plus_tpu_torch import Cropper
from face_crop_plus_tpu_torch.models import detection
from face_crop_plus_tpu_torch.models import backbones
from face_crop_plus_tpu_torch.models.weights import random_state_dict
from face_crop_plus_tpu_torch.ops import nn as tnn
from face_crop_plus_tpu_torch.ops.cuda import bn_act as cuda_bn_act
from face_crop_plus_tpu_torch.utils import profiling

RESIDUALS = ["none", "plain", "affine"]
#: Epilogues of one RetinaFaceNet forward: the stem, 16 bottlenecks × 3,
#: the FPN's 5 and the three SSHs' 5 each.
EPILOGUES = 1 + 16 * 3 + 5 + 3 * 5


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _specials(rng, shape, dtype, device="cpu") -> torch.Tensor:
    """Normal values with NaN, ±0 and ±inf planted (and values that sum
    to -0 with a zero bias)."""
    x = rng.normal(0, 2, shape).astype(np.float32)
    flat = x.reshape(-1)
    k = max(1, flat.size // 16)
    picks = rng.permutation(flat.size)[:6 * k] if flat.size < 96 else rng.integers(0, flat.size, 6 * k)
    for j, v in enumerate((np.nan, 0.0, -0.0, np.inf, -np.inf, -1e-30)):
        flat[picks[j * k:(j + 1) * k]] = v
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _bn(rng, c, dtype, device="cpu") -> tnn.FoldedBatchNorm:
    bn = tnn.FoldedBatchNorm(c)
    scale = rng.uniform(-1.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.5, c).astype(np.float32)
    scale[::7], bias[1::5], bias[2::5] = 0.0, 0.0, -0.0
    bn.scale.copy_(torch.from_numpy(scale))
    bn.bias.copy_(torch.from_numpy(bias))
    return bn.to(device=device, dtype=dtype)


def _case(seed, shape, residual, dtype, device="cpu"):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = _specials(rng, shape, dtype, device)
    bn = _bn(rng, c, dtype, device)
    res = None if residual == "none" else _specials(rng, shape, dtype, device)
    res_bn = _bn(rng, c, dtype, device) if residual == "affine" else None
    return x, bn, res, res_bn


def _composed(x, bn, relu, res, res_bn):
    """The modules' composition as the network ran it before ``bn_act``."""
    y = bn(x)
    if res is not None:
        y = y + (res if res_bn is None else res_bn(res))
    return tnn.leaky_relu(y) if relu else y


# ---------------------------------------------------------------------------
# The plain path on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("into", ["new", "slice"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", RESIDUALS)
def test_plain_path_equals_the_module_composition(residual, relu, into, dtype):
    shape = (2, 6, 5, 7)
    x, bn, res, res_bn = _case(3, shape, residual, dtype)
    want = _composed(x, bn, relu, res, res_bn)
    if into == "new":
        got = tnn.bn_act(x.clone(), bn, relu=relu, residual=res, residual_bn=res_bn)
        assert _bitwise_equal(got, want)
        return
    out = torch.full((2, 11, 5, 7), 7.0, dtype=dtype)
    got = tnn.bn_act(x.clone(), bn, relu=relu, residual=res, residual_bn=res_bn,
                     out=out[:, 3:9])
    assert got.data_ptr() == out[:, 3:9].data_ptr()
    assert _bitwise_equal(out[:, 3:9], want)
    assert bool((out[:, :3] == 7).all()) and bool((out[:, 9:] == 7).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_into_slices_equals_relu_of_the_concatenation(dtype):
    # The SSH: each branch's ReLU'd epilogue in its slice = ReLU(cat(...)).
    # Bit for bit, but for one thing: in bfloat16, ATen's CPU ReLU gives a
    # NaN the payload 0xffff in its vector loop and keeps 0x7fc0 in its
    # scalar tail, so where a NaN lands in those loops decides its bits.
    rng = np.random.default_rng(4)
    xs = [_specials(rng, (2, c, 6, 5), dtype) for c in (8, 4, 4)]
    bns = [_bn(rng, c, dtype) for c in (8, 4, 4)]
    want = tnn.leaky_relu(torch.cat([bn(x) for bn, x in zip(bns, xs)], dim=1))
    out = torch.empty((2, 16, 6, 5), dtype=dtype)
    for (lo, hi), bn, x in zip(((0, 8), (8, 12), (12, 16)), bns, xs):
        tnn.bn_act(x, bn, relu=True, out=out[:, lo:hi])
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(out), nan)
    assert _bitwise_equal(out[~nan], want[~nan])
    if dtype == torch.float32:
        assert _bitwise_equal(out, want)


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def _seeded_net(dtype=torch.float32, device="cpu", seed=0) -> detection.RetinaFaceNet:
    """He-normal convolutions and random folded BNs (scale, bias)."""
    net = detection.RetinaFaceNet()
    state = random_state_dict(net, seed)
    rng = np.random.default_rng(seed + 1)
    for key, val in state.items():
        if key.endswith(".scale"):
            state[key] = torch.from_numpy(rng.uniform(0.6, 1.2, val.shape).astype(np.float32))
        elif key.endswith(".bias"):
            state[key] = torch.from_numpy(rng.normal(0, 0.1, val.shape).astype(np.float32))
    net.load_state_dict(state)
    return net.to(device=device, dtype=dtype).eval().requires_grad_(False)


def _old_convbn(m, x, act=None):
    y = m[1](m[0](x))
    return tnn.leaky_relu(y) if (m.act if act is None else act) else y


def _old_bottleneck(b, x):
    out = tnn.leaky_relu(b.bn1(b.conv1(x)))
    out = tnn.leaky_relu(b.bn2(b.conv2(out)))
    out = b.bn3(b.conv3(out))
    identity = x if b.downsample is None else b.downsample(x)
    return tnn.leaky_relu(out + identity)


def _old_ssh(s, x):
    b3 = _old_convbn(s.conv3X3, x)
    b5_1 = _old_convbn(s.conv5X5_1, x)
    b5 = _old_convbn(s.conv5X5_2, b5_1)
    b7 = _old_convbn(s.conv7x7_3, _old_convbn(s.conv7X7_2, b5_1))
    return tnn.leaky_relu(torch.cat([b3, b5, b7], dim=1))


def _old_forward(net, x):
    """RetinaFaceNet's forward composed from its modules as before the
    epilogue: each BN, add and ReLU an ATen pass, the SSH a ``torch.cat``."""
    body = net.body
    x = tnn.leaky_relu(body.bn1(body.conv1(x)))
    x = tnn.max_pool(x, window=3, stride=2, padding=1)
    feats = []
    for layer in (body.layer1, body.layer2, body.layer3, body.layer4):
        for block in layer:
            x = _old_bottleneck(block, x)
        feats.append(x)
    c3, c4, c5 = feats[1:]
    f = net.fpn
    o1, o2, o3 = _old_convbn(f.output1, c3), _old_convbn(f.output2, c4), _old_convbn(f.output3, c5)
    o2 = _old_convbn(f.merge2, o2 + tnn.resize_nearest(o3, tuple(o2.shape[2:])))
    o1 = _old_convbn(f.merge1, o1 + tnn.resize_nearest(o2, tuple(o1.shape[2:])))
    outs = [_old_ssh(s, o) for s, o in zip((net.ssh1, net.ssh2, net.ssh3), (o1, o2, o3))]
    cls = torch.cat([h(o) for h, o in zip(net.ClassHead, outs)], dim=1)
    loc = torch.cat([h(o) for h, o in zip(net.BboxHead, outs)], dim=1)
    ldm = torch.cat([h(o) for h, o in zip(net.LandmarkHead, outs)], dim=1)
    return tnn.softmax(cls, dim=-1), loc, ldm


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (2, 3, 64, 64)),
                                         (torch.float32, (1, 3, 72, 40)),
                                         (torch.bfloat16, (1, 3, 64, 48))])
def test_retinaface_forward_equals_the_module_composition(dtype, shape):
    net = _seeded_net(dtype)
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 50, shape).astype(np.float32))
    x = x.to(dtype)
    with torch.no_grad():
        got = net(x)
        want = _old_forward(net, x)
    for g, w in zip(got, want):
        assert _bitwise_equal(g, w)
        assert bool(torch.isfinite(g.float()).all())


def test_the_counter_reads_plain_on_the_cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random weights
        c = Cropper(device="cpu", output_size=32, resize_size=64, det_threshold=-1.0,
                    batch_size=4)
    images = np.random.default_rng(0).integers(0, 256, (4, 72, 60, 3), np.uint8)
    c.process_images(images)
    elements = []
    net = c.det_model.net
    # Every convolution but the downsamples' (they feed a residual) and the
    # heads' ends in one epilogue of its output's size.
    convs = [m for name, m in net.named_modules() if isinstance(m, torch.nn.Conv2d)
             and "downsample" not in name and "Head" not in name]
    hooks = [m.register_forward_hook(lambda m, i, o: elements.append(o.numel())) for m in convs]
    c.stats = profiling.PipelineStats()
    profiling.take_timeline()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            c.process_images(images)
            with torch.no_grad():  # no span open: the timeline alone
                tnn.bn_act(torch.ones(1, 2, 3, 3), tnn.FoldedBatchNorm(2))
    finally:
        for h in hooks:
            h.remove()
    stats = c.stats.as_dict()
    records = [r for r in profiling.take_timeline()
               if isinstance(r, profiling.Count) and r.name.startswith("bn_act")]
    forwards = stats["det_net"]["calls"]
    assert forwards >= 1 and len(convs) == EPILOGUES
    assert "bn_act.fused" not in stats
    assert stats["bn_act.plain"]["calls"] == EPILOGUES * forwards == len(elements)
    assert stats["bn_act.plain"]["items"] == sum(elements)
    assert [r.name for r in records] == ["bn_act.plain"] * (EPILOGUES * forwards + 1)
    assert records[-1].parent is None and records[-1].items == 18


def test_the_kernels_wrapper_refuses_what_it_cannot_take():
    x, bn, res, res_bn = _case(1, (1, 4, 3, 3), "affine", torch.float32)
    with pytest.raises(ValueError, match="CUDA card"):
        cuda_bn_act.bn_act_cuda(x, bn.scale, bn.bias, True)
    with pytest.raises(ValueError, match="go together"):
        cuda_bn_act.bn_act_cuda(x, bn.scale, bn.bias, True, res, res_bn.scale, None)
    with pytest.raises(ValueError, match="go together"):
        cuda_bn_act.bn_act_cuda(x, bn.scale, bn.bias, True, None, res_bn.scale, res_bn.bias)
    assert cuda_bn_act._planes_stride(torch.empty(2, 9, 3, 5)[:, 2:6]) == 9 * 15
    assert cuda_bn_act._planes_stride(torch.empty(2, 3, 5, 4).transpose(2, 3)) is None


# ---------------------------------------------------------------------------
# The kernel on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _kernel_vs_plain(x, bn, relu, res, res_bn, out=None):
    """The dispatcher's kernel launch against the plain version on the same
    card; the launch count rises by one."""
    want = tnn.bn_act_plain(x.clone(), bn, relu, res, res_bn)
    before = cuda_bn_act.launches
    got = tnn.bn_act(x, bn, relu=relu, residual=res, residual_bn=res_bn, out=out)
    torch.cuda.synchronize()
    assert cuda_bn_act.launches == before + 1
    return got, want


#: The network's epilogue shapes at a 1024² interim (N = 2 of the cell's 16),
#: then N = 1, odd and tiny planes, and a plane longer than one unit.
KERNEL_SHAPES = [(2, 64, 512, 512), (2, 256, 256, 256), (2, 512, 128, 128),
                 (2, 1024, 64, 64), (2, 2048, 32, 32), (2, 64, 128, 128),
                 (1, 64, 64, 64), (1, 7, 9, 11), (3, 5, 1, 1), (2, 3, 67, 129),
                 (1, 2, 1, 4099)]


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_kernel_matches_plain_on_gpu(card, shape, residual, relu):
    x, bn, res, res_bn = _case(sum(shape), shape, residual, torch.float32, card)
    got, want = _kernel_vs_plain(x, bn, relu, res, res_bn)
    assert got.data_ptr() == x.data_ptr()  # in place
    assert _bitwise_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 3, 64])
@pytest.mark.parametrize("hw", [(32, 32), (7, 9)])
def test_kernel_writes_channel_slices_on_gpu(card, hw, offset):
    shape = (3, 16, *hw)
    x, bn, res, res_bn = _case(offset, shape, "affine", torch.float32, card)
    out = torch.full((3, 16 + offset + 5, *hw), 7.0, device=card)
    got, want = _kernel_vs_plain(x, bn, True, res, res_bn, out=out[:, offset:offset + 16])
    assert got.data_ptr() == out[:, offset:].data_ptr()
    assert _bitwise_equal(out[:, offset:offset + 16], want)
    assert bool((out[:, :offset] == 7).all()) and bool((out[:, offset + 16:] == 7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_kernel_takes_unaligned_inputs_on_gpu(card, shift):
    # Contiguous views that start 4·shift bytes into their storage.
    shape = (2, 4, 33, 35)
    n = int(np.prod(shape))
    rng = np.random.default_rng(shift)
    x = _specials(rng, (n + shift,), torch.float32, card)[shift:].view(shape)
    res = _specials(rng, (n + 2 * shift,), torch.float32, card)[2 * shift:].view(shape)
    bn = _bn(rng, 4, torch.float32, card)
    got, want = _kernel_vs_plain(x, bn, True, res, None)
    assert _bitwise_equal(got, want)


@pytest.mark.gpu
def test_kernel_keeps_to_its_cards_stream(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    dev = torch.device("cuda", 1)
    x, bn, res, res_bn = _case(9, (2, 64, 96, 96), "affine", torch.float32, dev)
    want = tnn.bn_act_plain(x.clone(), bn, True, res, res_bn)
    stream = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    with torch.cuda.device(0), torch.cuda.stream(stream):
        got = tnn.bn_act(x, bn, relu=True, residual=res, residual_bn=res_bn)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    assert _bitwise_equal(got, want)


@pytest.mark.gpu
def test_bfloat16_keeps_the_plain_passes_on_gpu(card):
    x, bn, res, res_bn = _case(2, (2, 8, 16, 16), "plain", torch.bfloat16, card)
    before = cuda_bn_act.launches
    got = tnn.bn_act(x.clone(), bn, relu=True, residual=res)
    assert cuda_bn_act.launches == before
    assert _bitwise_equal(got, _composed(x, bn, True, res, None))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 256, 256), (1, 3, 90, 120)])
def test_network_matches_its_plain_passes_on_gpu(card, shape, monkeypatch):
    net = _seeded_net(device=card)
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 50, shape).astype(np.float32))
    x = x.to(card)
    before = cuda_bn_act.launches
    with torch.no_grad():
        got = net(x)
        assert cuda_bn_act.launches == before + EPILOGUES
        monkeypatch.setattr(backbones, "bn_act", tnn.bn_act_plain)
        monkeypatch.setattr(detection, "bn_act", tnn.bn_act_plain)
        want = net(x)
        old = _old_forward(net, x)
    torch.cuda.synchronize()
    for g, w, o in zip(got, want, old):
        assert _bitwise_equal(g, w) and _bitwise_equal(g, o)
