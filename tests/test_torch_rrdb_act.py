"""RRDBNet's convolution epilogue ``ops/nn.py: rrdb_conv`` and its CUDA
kernel, and the network's dense-block buffers.

On the CPU: each form of the plain path (bias, LeakyReLU, ``+ r``, one and
two 0.2-scaled residuals) equals the modules' own composition bit for bit,
into a fresh tensor and into a channel slice, in float32 and bfloat16; a
seeded ``RRDBNetwork`` forward, its trunk in a rotation of three (N, 192,
H, W) buffers, equals bitwise the forward composed from its modules as it
was before (``torch.cat``, in-place LeakyReLU, ``mul_`` and ``add_``), at
N = 1 and N = 3, NCHW and channels-last; the layout probe runs once a
convolution's shape, and where it finds that NCHW disagrees the trunk's
convolutions run channels-last; the tracer's counter reads plain, 15 a
block and 6 a forward, inside ``enh_net``.  On a card (marked ``gpu``): the
kernel bitwise against the plain version for every form, in place and into
channel slices with aligned and unaligned heads, with residuals that are
slices, at N = 1 and N = 3, on planted NaN, ±0 and ±inf; the network
against its old composition, channels-last too at the small sizes where
cuDNN picks another algorithm for NCHW; the counter reads fused.
"""

import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from face_crop_plus_tpu_torch.models import enhancement as te
from face_crop_plus_tpu_torch.models.weights import random_state_dict
from face_crop_plus_tpu_torch.ops import nn as tnn
from face_crop_plus_tpu_torch.ops.cuda import rrdb_act as cuda_rrdb_act
from face_crop_plus_tpu_torch.utils import profiling

FORMS = list(cuda_rrdb_act.FORMS)
#: Epilogues of one forward: 15 a block, conv_first, trunk_conv and the
#: tail's four.
BLOCK_EPILOGUES, OTHER_EPILOGUES = 15, 6


def _reads(form: str) -> int:
    """Residuals the form reads."""
    return cuda_rrdb_act.FORMS[form][1]


def _plain(y, bias, form, r=None, r2=None, out=None):
    """The plain epilogue of a convolution's output ``y`` without its bias:
    ATen's add of the bias, then :func:`rrdb_act_plain`."""
    return tnn.rrdb_act_plain(y.add_(bias.reshape(1, -1, 1, 1)), form, r, r2, out)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _specials(rng, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Normal values with NaN, ±0, ±inf and tiny negatives planted."""
    x = rng.normal(0, 2, shape).astype(np.float32)
    flat = x.reshape(-1)
    k = max(1, flat.size // 16)
    picks = rng.permutation(flat.size)[:6 * k] if flat.size < 96 else rng.integers(0, flat.size, 6 * k)
    for j, v in enumerate((np.nan, 0.0, -0.0, np.inf, -np.inf, -1e-30)):
        flat[picks[j * k:(j + 1) * k]] = v
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _bias(rng, c, dtype=torch.float32, device="cpu") -> torch.Tensor:
    b = rng.normal(0, 0.5, c).astype(np.float32)
    b[1::5], b[2::5] = 0.0, -0.0
    return torch.from_numpy(b).to(device=device, dtype=dtype)


def _residuals(rng, form, shape, dtype=torch.float32, device="cpu"):
    res = [_specials(rng, shape, dtype, device) for _ in range(_reads(form))]
    return res + [None] * (2 - len(res))


def _composed(a, form, r, r2):
    """The modules' composition after a convolution's output ``a`` (its
    bias included), as the network ran it before ``rrdb_conv``."""
    if form == "leaky":
        return F.leaky_relu(a, 0.2, inplace=True)
    if form == "add":
        return a.add_(r)
    if form == "dense":
        return a.mul_(0.2).add_(r)
    if form == "rrdb":
        return a.mul_(0.2).add_(r).mul_(0.2).add_(r2)
    return a


def _seeded_conv(rng, c_in, c_out, dtype=torch.float32, device="cpu") -> torch.nn.Conv2d:
    conv = tnn.conv(c_in, c_out, bias=True)
    w = rng.normal(0, (2.0 / (9 * c_in)) ** 0.5, (c_out, c_in, 3, 3)).astype(np.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(_bias(rng, c_out))
    return conv.to(device=device, dtype=dtype).requires_grad_(False)


# ---------------------------------------------------------------------------
# The plain path on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("into", ["new", "slice"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_path_equals_the_module_composition(form, into, dtype):
    rng = np.random.default_rng(FORMS.index(form))
    conv = _seeded_conv(rng, 6, 4, dtype)
    x = _specials(rng, (2, 6, 5, 7), dtype)
    r, r2 = _residuals(rng, form, (2, 4, 5, 7), dtype)
    with torch.no_grad():
        want = _composed(conv(x), form, r, r2)
        if into == "new":
            got = tnn.rrdb_conv(x, conv, form, r, r2)
            assert _bitwise_equal(got, want)
            return
        out = torch.full((2, 11, 5, 7), 7.0, dtype=dtype)
        got = tnn.rrdb_conv(x, conv, form, r, r2, out=out[:, 3:7])
    assert got.data_ptr() == out[:, 3:7].data_ptr()
    assert _bitwise_equal(out[:, 3:7], want)
    assert bool((out[:, :3] == 7).all()) and bool((out[:, 7:] == 7).all())


def test_plain_epilogue_adds_the_bias_as_aten_does():
    # The kernel's yardstick on a card: the convolution without its bias,
    # then ATen's add of the bias, equals ``F.conv2d``'s own bias add there;
    # on the CPU, where the bias rides inside the sums, within rounding.
    rng = np.random.default_rng(9)
    conv = _seeded_conv(rng, 8, 5)
    x = torch.from_numpy(rng.normal(0, 1, (1, 8, 6, 9)).astype(np.float32))
    with torch.no_grad():
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding)
        got = _plain(y.clone(), conv.bias, "leaky")
        want = F.leaky_relu(conv(x), 0.2)
    assert float((got - want).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="unknown form"):
        tnn.rrdb_act_plain(y, "relu")


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def _seeded_net(blocks=2, dtype=torch.float32, device="cpu", seed=0) -> te.RRDBNetwork:
    """He-normal convolutions with biases of spread 0.05, trunk_conv tamed
    so the trunk stays in range."""
    net = te.RRDBNetwork(blocks)
    state = random_state_dict(net, seed)
    rng = np.random.default_rng(seed + 1)
    for key, val in state.items():
        if key.endswith(".bias"):
            state[key] = torch.from_numpy(rng.normal(0, 0.05, val.shape).astype(np.float32))
    net.load_state_dict(state)
    return net.to(device=device, dtype=dtype).eval().requires_grad_(False)


def _act(x):
    return F.leaky_relu(x, 0.2, inplace=True)


def _old_dense_block(d, x):
    c = x
    for k in range(1, 5):
        c = torch.cat([c, _act(getattr(d, f"conv{k}")(c))], dim=1)
    return d.conv5(c).mul_(0.2).add_(x)


def _old_network(net, x):
    """RRDBNetwork's forward composed from its modules as before the
    epilogue: the bias in each convolution, each LeakyReLU, ``mul_`` and
    ``add_`` an ATen pass, the dense blocks' ``torch.cat``."""
    fea = net.conv_first(x)
    t = fea
    for b in net.RRDB_trunk:
        out = _old_dense_block(b.RDB3, _old_dense_block(b.RDB2, _old_dense_block(b.RDB1, t)))
        t = out.mul_(0.2).add_(t)
    fea = net.trunk_conv(t).add_(fea)
    fea = _act(net.upconv1(tnn.upsample2x_nearest(fea)))
    fea = _act(net.upconv2(tnn.upsample2x_nearest(fea)))
    fea = _act(net.HRconv(fea))
    return net.conv_last(fea)


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(shape, dtype, layout, device="cpu", seed=5) -> torch.Tensor:
    """Images in [0, 1], NCHW-contiguous or channels-last (the layout
    ``RRDBNet._sr_uint8``'s permute of NHWC rows gives)."""
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if layout == "channels_last":
        nhwc = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
        return nhwc.to(device=device, dtype=dtype).permute(0, 3, 1, 2)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (1, 3, 24, 20)),
                                         (torch.float32, (3, 3, 12, 10)),
                                         (torch.bfloat16, (1, 3, 16, 12)),
                                         (torch.bfloat16, (3, 3, 8, 10))])
def test_network_forward_equals_the_module_composition(_one_thread, dtype, shape, layout):
    # The CPU's path: the trunk in its buffers, each epilogue the plain one
    # copied into its slice, a channels-last input's convolutions in the
    # layout the probe finds to keep their bits.
    net = _seeded_net(dtype=dtype)
    x = _input(shape, dtype, layout)
    with torch.no_grad():
        got = net(x)
        want = _old_network(net, x)
    assert got.shape == (shape[0], 3, 4 * shape[2], 4 * shape[3])
    assert _bitwise_equal(got, want)
    assert bool(torch.isfinite(got.float()).all()) and float(got.float().std()) > 0


@pytest.mark.parametrize("dtype,shape,layout", [(torch.float32, (1, 3, 24, 20), "contiguous"),
                                                (torch.float32, (3, 3, 12, 10), "contiguous"),
                                                (torch.bfloat16, (1, 3, 16, 12), "contiguous"),
                                                (torch.float32, (3, 3, 12, 10), "channels_last")])
def test_buffered_trunk_equals_the_module_composition(_one_thread, monkeypatch, dtype, shape,
                                                      layout):
    # The trunk in the rotation of three (N, 192, H, W) buffers and no
    # other allocation of that size; bitwise, as each CPU convolution of a
    # slice view equals the one of its concatenated copy.
    net = _seeded_net(dtype=dtype)
    x = _input(shape, dtype, layout)
    allocated = []
    real_empty = torch.Tensor.new_empty

    def new_empty(t, size, *args, **kwargs):
        allocated.append(tuple(size))
        return real_empty(t, size, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "new_empty", new_empty)
    with torch.no_grad():
        got = net(x)
    monkeypatch.undo()
    with torch.no_grad():
        want = _old_network(net, x)
    assert allocated == [(shape[0], 192, shape[2], shape[3])] * 3
    assert _bitwise_equal(got, want)


def _trunk_shapes():
    """The weight shapes of the trunk's convolutions: conv1-5 of a dense
    block and trunk_conv."""
    return sorted({(32, 64, 3, 3), (32, 96, 3, 3), (32, 128, 3, 3), (32, 160, 3, 3),
                   (64, 192, 3, 3), (64, 64, 3, 3)})


def test_the_layout_probe_runs_once_a_convolution_shape(_one_thread, monkeypatch):
    # A channels-last input probes each trunk convolution's shape once, on
    # its first forward; an NCHW input and later forwards probe nothing.
    net = _seeded_net()
    monkeypatch.setattr(tnn, "_NCHW_AGREES", {})
    draws = []
    real_randn = torch.randn

    def randn(*args, **kwargs):
        draws.append(args[0])
        return real_randn(*args, **kwargs)

    monkeypatch.setattr(torch, "randn", randn)
    with torch.no_grad():
        net(_input((1, 3, 12, 10), torch.float32, "contiguous"))
        assert draws == [] and tnn._NCHW_AGREES == {}
        x = _input((1, 3, 12, 10), torch.float32, "channels_last")
        net(x)
        assert len(draws) == 6
        assert sorted(k[0] for k in tnn._NCHW_AGREES) == _trunk_shapes()
        assert {k[1][2:] for k in tnn._NCHW_AGREES} == {(12, 10)}
        net(x)
    assert len(draws) == 6


@pytest.mark.parametrize("shape", [(1, 3, 12, 10), (3, 3, 8, 6)])
def test_a_layout_that_disagrees_runs_channels_last(_one_thread, monkeypatch, shape):
    # Where the probe finds that NCHW would give other bits, the trunk's
    # convolutions run on channels-last copies of their buffer slices, as
    # the modules ran them, and the output keeps the composition's bits.
    net = _seeded_net()
    x = _input(shape, torch.float32, "channels_last")
    layouts = []
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    hooks = [m.register_forward_pre_hook(
        lambda m, i: layouts.append(i[0].is_contiguous(memory_format=torch.channels_last)))
        for m in convs]
    monkeypatch.setattr(tnn, "nchw_agrees", lambda x, conv: False)
    try:
        with torch.no_grad():
            got = net(x)
    finally:
        for h in hooks:
            h.remove()
    monkeypatch.undo()
    with torch.no_grad():
        want = _old_network(net, x)
    # conv_first on the input itself, the trunk's 31, then the tail's 4 on
    # NCHW upsamplings, as before.
    assert layouts == [True] * (1 + BLOCK_EPILOGUES * 2 + 1) + [False] * 4
    assert _bitwise_equal(got, want)


def test_the_counter_reads_plain_on_the_cpu(_one_thread, monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    blocks = 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random weights
        enh = te.RRDBNet(device="cpu", num_blocks=blocks)
    images = np.random.default_rng(0).integers(0, 256, (2, 12, 10, 3), np.uint8)
    elements = []
    convs = [m for m in enh.net.modules() if isinstance(m, torch.nn.Conv2d)]
    hooks = [m.register_forward_hook(lambda m, i, o: elements.append(o.numel())) for m in convs]
    profiling.take_timeline()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            enh.enhance_images(images)
    finally:
        for h in hooks:
            h.remove()
    records = profiling.take_timeline()
    spans = [r for r in records if isinstance(r, profiling.Span) and r.name == "enh_net"]
    counts = [r for r in records if isinstance(r, profiling.Count) and r.name.startswith("rrdb_act")]
    per_forward = BLOCK_EPILOGUES * blocks + OTHER_EPILOGUES
    assert len(spans) == 2 and len(convs) == per_forward
    assert [r.name for r in counts] == ["rrdb_act.plain"] * (2 * per_forward)
    assert {r.parent for r in counts} == {s.id for s in spans}
    assert [r.items for r in counts] == elements
    stats = enh.stats.as_dict()
    assert "rrdb_act.fused" not in stats
    assert stats["rrdb_act.plain"] == {"seconds": 0.0, "calls": 2 * per_forward,
                                       "items": sum(elements)}


def test_the_kernels_wrapper_refuses_what_it_cannot_take():
    y = torch.zeros(1, 4, 3, 3)
    b = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA card"):
        cuda_rrdb_act.rrdb_act_cuda(y, b, "leaky")
    with pytest.raises(ValueError, match="unknown form"):
        cuda_rrdb_act.rrdb_act_cuda(y, b, "relu")
    with pytest.raises(ValueError, match="reads 1 residual"):
        cuda_rrdb_act.rrdb_act_cuda(y, b, "dense")
    with pytest.raises(ValueError, match="reads 2 residual"):
        cuda_rrdb_act.rrdb_act_cuda(y, b, "rrdb", y)
    with pytest.raises(ValueError, match="reads 0 residual"):
        cuda_rrdb_act.rrdb_act_cuda(y, b, "bias", y)


# ---------------------------------------------------------------------------
# The kernel on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _kernel_vs_plain(y, bias, form, r, r2, out=None):
    """The kernel's launch against the plain version on the same card; the
    launch count rises by one."""
    want = _plain(y.clone(), bias, form, r, r2)
    before = cuda_rrdb_act.launches
    got = cuda_rrdb_act.rrdb_act_cuda(y, bias, form, r, r2, out)
    torch.cuda.synchronize()
    assert cuda_rrdb_act.launches == before + 1
    return got, want


#: The network's epilogue shapes at a 1024² interim (growth, conv5,
#: conv_last at 4x), then N = 1 and N = 3 at odd and tiny
#: planes, and a plane longer than one unit.
KERNEL_SHAPES = [(1, 32, 1024, 1024), (1, 64, 1024, 1024), (1, 3, 4096, 4096), (1, 32, 64, 48), (3, 32, 16, 12), (3, 7, 9, 11),
                 (1, 5, 1, 1), (3, 3, 67, 129), (1, 2, 1, 4099)]


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_kernel_matches_plain_on_gpu(card, shape, form):
    rng = np.random.default_rng(sum(shape) + FORMS.index(form))
    y = _specials(rng, shape, device=card)
    bias = _bias(rng, shape[1], device=card)
    r, r2 = _residuals(rng, form, shape, device=card)
    got, want = _kernel_vs_plain(y, bias, form, r, r2)
    assert got.data_ptr() == y.data_ptr()  # in place
    assert _bitwise_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("offset", [0, 1, 3, 64])
@pytest.mark.parametrize("hw", [(32, 32), (7, 9)])
@pytest.mark.parametrize("form", FORMS)
def test_kernel_writes_and_reads_channel_slices_on_gpu(card, form, hw, offset, n):
    # out and the residuals are channel slices of wider buffers: at offset
    # 64 of a 32² plane every base stays 16-byte aligned (vector path), at
    # 1 and 3 or on 7×9 planes the heads and bases are not.
    rng = np.random.default_rng(offset + 7 * n)
    c = 16
    y = _specials(rng, (n, c, *hw), device=card)
    bias = _bias(rng, c, device=card)
    wide = [_specials(rng, (n, c + offset + 5, *hw), device=card) for _ in range(_reads(form))]
    r, r2 = [t[:, offset:offset + c] for t in wide] + [None] * (2 - len(wide))
    out = torch.full((n, c + offset + 5, *hw), 7.0, device=card)
    got, want = _kernel_vs_plain(y, bias, form, r, r2, out=out[:, offset:offset + c])
    assert got.data_ptr() == out[:, offset:].data_ptr()
    assert _bitwise_equal(out[:, offset:offset + c], want)
    assert bool((out[:, :offset] == 7).all()) and bool((out[:, offset + c:] == 7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3])
def test_kernel_writes_over_the_rrdb_input_on_gpu(card, n):
    # The third block's conv5: out is outer itself, a slice of a buffer.
    rng = np.random.default_rng(n)
    shape = (n, 64, 33, 35)
    y = _specials(rng, shape, device=card)
    bias = _bias(rng, 64, device=card)
    bufs = [_specials(rng, (n, 192, 33, 35), device=card) for _ in range(2)]
    x, x0 = bufs[1][:, :64], bufs[0][:, :64]
    want = _plain(y.clone(), bias, "rrdb", x, x0)
    got = cuda_rrdb_act.rrdb_act_cuda(y, bias, "rrdb", x, x0, out=x0)
    torch.cuda.synchronize()
    assert got.data_ptr() == bufs[0].data_ptr()
    assert _bitwise_equal(bufs[0][:, :64], want)


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_kernel_takes_unaligned_inputs_on_gpu(card, shift):
    # Contiguous views that start 4·shift bytes into their storage.
    shape = (2, 4, 33, 35)
    n = int(np.prod(shape))
    rng = np.random.default_rng(shift)
    y = _specials(rng, (n + shift,), device=card)[shift:].view(shape)
    r = _specials(rng, (n + 2 * shift,), device=card)[2 * shift:].view(shape)
    bias = _bias(rng, 4, device=card)
    got, want = _kernel_vs_plain(y, bias, "dense", r, None)
    assert _bitwise_equal(got, want)


@pytest.mark.gpu
def test_kernel_keeps_to_its_cards_stream(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(9)
    y = _specials(rng, (2, 64, 96, 96), device=dev)
    bias = _bias(rng, 64, device=dev)
    r, r2 = _residuals(rng, "rrdb", (2, 64, 96, 96), device=dev)
    want = _plain(y.clone(), bias, "rrdb", r, r2)
    stream = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    with torch.cuda.device(0), torch.cuda.stream(stream):
        got = cuda_rrdb_act.rrdb_act_cuda(y, bias, "rrdb", r, r2)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    assert _bitwise_equal(got, want)


@pytest.mark.gpu
def test_bfloat16_keeps_the_plain_passes_on_gpu(card):
    rng = np.random.default_rng(2)
    conv = _seeded_conv(rng, 8, 8, torch.bfloat16, card)
    x = _specials(rng, (2, 8, 16, 16), torch.bfloat16, card)
    r = _specials(rng, (2, 8, 16, 16), torch.bfloat16, card)
    before = cuda_rrdb_act.launches
    with torch.no_grad():
        got = tnn.rrdb_conv(x, conv, "dense", r)
        want = _composed(conv(x), "dense", r, None)
    assert cuda_rrdb_act.launches == before
    assert _bitwise_equal(got, want)


#: Inputs on the card: NCHW ones meet the same cuDNN picks on both sides
#: at any size; channels-last ones (``_sr_uint8``'s layout) ran the old
#: composition's trunk channels-last, whose picks equal the NCHW buffers'
#: at 64×48, 96×80 and the cell's 1024² (chip_smoke phase 7 (g)) but not at
#: 24×20, 32², 48×40 or 200×150, where cuDNN picks an FFT for one layout
#: and the layout probe keeps those convolutions channels-last.
GPU_NETWORK_CASES = [(torch.float32, (1, 3, 64, 48), "contiguous"),
                     (torch.float32, (3, 3, 24, 20), "contiguous"),
                     (torch.float32, (1, 3, 64, 48), "channels_last"),
                     (torch.float32, (2, 3, 96, 80), "channels_last"),
                     (torch.float32, (1, 3, 24, 20), "channels_last"),
                     (torch.float32, (3, 3, 24, 20), "channels_last"),
                     (torch.float32, (4, 3, 24, 20), "channels_last"),
                     (torch.float32, (1, 3, 32, 32), "channels_last"),
                     (torch.float32, (2, 3, 32, 32), "channels_last"),
                     (torch.float32, (3, 3, 32, 32), "channels_last"),
                     (torch.float32, (1, 3, 48, 40), "channels_last"),
                     (torch.float32, (3, 3, 48, 40), "channels_last"),
                     (torch.float32, (1, 3, 200, 150), "channels_last"),
                     (torch.float32, (2, 3, 200, 150), "channels_last"),
                     (torch.float32, (3, 3, 200, 150), "channels_last"),
                     (torch.bfloat16, (1, 3, 64, 48), "contiguous"),
                     (torch.bfloat16, (3, 3, 24, 20), "channels_last"),
                     (torch.bfloat16, (1, 3, 200, 150), "channels_last")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,layout", GPU_NETWORK_CASES)
def test_network_matches_its_module_composition_on_gpu(card, dtype, shape, layout):
    from face_crop_plus_tpu_torch.utils.device import f32_precision

    net = _seeded_net(dtype=dtype, device=card)
    x = _input(shape, dtype, layout, card, seed=6)
    before = cuda_rrdb_act.launches
    with torch.no_grad(), f32_precision():
        got = net(x)
        launched = cuda_rrdb_act.launches - before
        want = _old_network(net, x)
    torch.cuda.synchronize()
    fused = dtype == torch.float32
    assert launched == (BLOCK_EPILOGUES * 2 + OTHER_EPILOGUES if fused else 0)
    assert _bitwise_equal(got, want)
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.gpu
def test_the_counter_reads_fused_on_gpu(card, monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    blocks = 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random weights
        enh = te.RRDBNet(device=card, num_blocks=blocks)
    images = np.random.default_rng(0).integers(0, 256, (1, 40, 32, 3), np.uint8)
    enh.enhance_images(images)
    profiling.take_timeline()
    with profile(activities=[ProfilerActivity.CPU]):
        enh.enhance_images(images)
    records = profiling.take_timeline()
    spans = [r for r in records if isinstance(r, profiling.Span) and r.name == "enh_net"]
    counts = [r for r in records if isinstance(r, profiling.Count) and r.name.startswith("rrdb_act")]
    per_forward = BLOCK_EPILOGUES * blocks + OTHER_EPILOGUES
    assert len(spans) == 1
    assert [r.name for r in counts] == ["rrdb_act.fused"] * per_forward
    assert {r.parent for r in counts} == {spans[0].id}
    assert enh.stats.as_dict()["rrdb_act.fused"]["calls"] == per_forward
