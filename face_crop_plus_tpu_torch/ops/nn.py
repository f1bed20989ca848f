"""NN primitives for the inference-only frozen networks (PyTorch).

Counterpart of ``face_crop_plus_tpu.ops.nn``.  The networks are
``nn.Module`` trees whose state-dict keys equal the JAX package's flat
parameter names (which mirror the reference's torch module paths), so one
``.npz`` weight contract serves both packages:

* The conv stack runs NCHW with OIHW kernels; images and resize inputs stay
  NHWC at the public boundaries, as in the JAX package.
* BatchNorm is inference-only and pre-folded to a per-channel
  ``scale``/``bias`` pair (γ/√(σ²+ε), β−μ·scale), held as buffers.
* Random init draws He-normal conv kernels, zero biases and unit BN scale
  from ``np.random.default_rng(seed)`` in parameter-creation order, the
  same draws the JAX package's ``Params`` init mode makes.

``upsample2x_nearest`` and ``downscale4x_bicubic`` serve the enhancer; like
its convolutions they take NCHW tensors.

Dtypes follow the JAX module's rules (``face_crop_plus_tpu/ops/nn.py``),
so a network cast to a model's ``compute_dtype`` (float32 by default,
bfloat16 when its caller asks) rounds where the JAX one rounds:

* convolutions take their input, weights and bias in the activation dtype
  (the module's own, cast with the network) and accumulate in f32; the
  bias rides in the convolution, but for RRDBNet's in float32 on a card,
  whose bias the epilogue kernel adds (ATen adds it after cuDNN in a pass
  of its own there, so the bits are the same);
* folded BatchNorm multiplies and adds in the activation dtype;
* the resize and bicubic matrices are cast to the activation dtype, every
  product accumulates in f32 and is rounded once to the activation dtype;
* softmax and the global average pool compute in f32 and return the
  activation dtype.

In float32 every cast is the identity, so the default path computes what
it computed before ``compute_dtype`` existed.

:func:`bn_act` is a convolution's epilogue (folded BN, an optional
residual, an optional ReLU): in float32 on a card one pass of a
hand-written kernel with the plain composition's bits, else that
composition (:func:`bn_act_plain`).  :func:`rrdb_conv` is the same for
RRDBNet: a convolution, its bias, then LeakyReLU or the 0.2-scaled
residuals, written into its final place (a channel slice of a dense
block's buffer); in float32 on a card the convolution without its bias
and one pass of a second kernel, else the module's convolution and
:func:`rrdb_act_plain`.  Where the modules ran a convolution on a
channels-last input and NCHW would pick another algorithm
(:func:`nchw_agrees`), it runs channels-last still.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import to_device
from ..utils.profiling import count_in_span
from .cuda.bn_act import bn_act_cuda
from .cuda.rrdb_act import rrdb_act_cuda


def conv(
    in_ch: int,
    out_ch: int,
    kernel: int = 3,
    stride: int = 1,
    padding: int | None = None,
    bias: bool = False,
) -> nn.Conv2d:
    """A 2D convolution with torch-style padding.

    ``padding=None`` means ``kernel // 2`` ("same" for odd kernels at
    stride 1), the JAX ``conv2d`` default.
    """
    pad = kernel // 2 if padding is None else padding
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad, bias=bias)


class FoldedBatchNorm(nn.Module):
    """Inference BatchNorm folded to per-channel ``scale``/``bias`` (NCHW)."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope == 0.0:
        return torch.relu(x)
    return torch.where(x >= 0, x, x * negative_slope)


def bn_act_plain(
    x: torch.Tensor,
    bn: FoldedBatchNorm,
    relu: bool = False,
    residual: torch.Tensor | None = None,
    residual_bn: FoldedBatchNorm | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`bn_act` as the modules compose it: ``bn(x)``, then the
    residual (``residual_bn(residual)`` when given) added, then ReLU; the
    result copied into ``out`` when one is given."""
    y = bn(x)
    if residual is not None:
        y = y + (residual if residual_bn is None else residual_bn(residual))
    if relu:
        y = leaky_relu(y)
    return y if out is None else out.copy_(y)


def bn_act(
    x: torch.Tensor,
    bn: FoldedBatchNorm,
    relu: bool = False,
    residual: torch.Tensor | None = None,
    residual_bn: FoldedBatchNorm | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """A convolution's epilogue: folded BN, an optional residual, an
    optional ReLU.

    ``relu?((x * bn.scale + bn.bias) + r)`` per element of an NCHW tensor,
    with ``r`` absent, ``residual``, or ``residual_bn(residual)``.  A
    float32 tensor on a card goes through one launch of the hand-written
    kernel (:func:`.cuda.bn_act.bn_act_cuda`), which computes the same bits
    as :func:`bn_act_plain` and writes over ``x`` unless ``out`` is given:
    ``x`` is a convolution's output that its caller reads no more.  Any
    other device or dtype runs :func:`bn_act_plain`, whose ops round as
    the activation dtype's ATen ops do.  ``out``, when given, receives the
    result: an (N, C, H, W) tensor with contiguous planes, such as a
    channel slice of a concatenated output.

    While tracing, counts ``bn_act.fused`` or ``bn_act.plain`` (one call a
    launch or composition, the output's elements as items) into the open
    span's stats.
    """
    if x.device.type == "cuda" and x.dtype == torch.float32:
        y = bn_act_cuda(
            x, bn.scale, bn.bias, relu, residual,
            None if residual_bn is None else residual_bn.scale,
            None if residual_bn is None else residual_bn.bias,
            out,
        )
        count_in_span("bn_act.fused", y.numel())
        return y
    y = bn_act_plain(x, bn, relu, residual, residual_bn, out)
    count_in_span("bn_act.plain", y.numel())
    return y


#: RRDBNet's LeakyReLU slope and its residuals' scale.
RRDB_POINT2 = 0.2


def rrdb_act_plain(
    y: torch.Tensor,
    form: str,
    residual: torch.Tensor | None = None,
    outer: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`rrdb_conv`'s epilogue as the modules composed it, over a
    convolution's output ``y`` (its bias added) in place: the form (see
    :func:`.cuda.rrdb_act.rrdb_act_cuda`) as the in-place LeakyReLU, each
    ``mul_(0.2)`` and ``add_``; the result copied into ``out`` when one is
    given."""
    if form == "leaky":
        y = F.leaky_relu(y, RRDB_POINT2, inplace=True)
    elif form == "add":
        y = y.add_(residual)
    elif form in ("dense", "rrdb"):
        y = y.mul_(RRDB_POINT2).add_(residual)
        if form == "rrdb":
            y = y.mul_(RRDB_POINT2).add_(outer)
    elif form != "bias":
        raise ValueError(f"unknown form {form!r}")
    return y if out is None else out.copy_(y)


def rrdb_fused(x: torch.Tensor) -> bool:
    """Whether :func:`rrdb_conv` runs the epilogue kernel on ``x``: float32
    on a card."""
    return x.device.type == "cuda" and x.dtype == torch.float32


#: Per convolution call (weight and input shapes, dtype, device, cuDNN's
#: TF32 and determinism switches): whether an NCHW input gives the bits of
#: a channels-last one.
_NCHW_AGREES: dict = {}


def nchw_agrees(x: torch.Tensor, conv: nn.Conv2d) -> bool:
    """Whether :func:`rrdb_conv`'s convolution of ``x``'s shape gives the
    same bits on an NCHW input as on a channels-last one.

    cuDNN (and the CPU's library) choose an algorithm by the call's shape
    and layout, and at some shapes choose another one for each layout: on
    an H100, at 1024² and most sizes measured one implicit GEMM for both,
    at some small ones (24×20, 32², 48×40, 200×150) an FFT for one
    layout.  Seen once a call, on a seeded random input: the same
    convolution on both layouts, compared bit for bit."""
    key = (tuple(conv.weight.shape), tuple(x.shape), x.dtype, x.device,
           torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    agrees = _NCHW_AGREES.get(key)
    if agrees is None:
        gen = torch.Generator(x.device).manual_seed(0)
        z = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
        bias = None if rrdb_fused(x) else conv.bias
        args = (conv.weight, bias, conv.stride, conv.padding, conv.dilation, conv.groups)
        nchw = F.conv2d(z, *args)
        cl = F.conv2d(z.contiguous(memory_format=torch.channels_last), *args)
        agrees = _NCHW_AGREES[key] = torch.equal(nchw, cl)
    return agrees


def rrdb_conv(
    x: torch.Tensor,
    conv: nn.Conv2d,
    form: str = "bias",
    residual: torch.Tensor | None = None,
    outer: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    channels_last: bool = False,
) -> torch.Tensor:
    """One of RRDBNet's convolutions and its epilogue, into ``out``.

    ``form(conv(x))``: the bias, then nothing more, LeakyReLU 0.2, a
    ``residual`` added, or the dense block's ``residual`` after a 0.2 scale
    and, for ``"rrdb"``, the RRDB's ``outer`` after another (see
    :func:`.cuda.rrdb_act.rrdb_act_cuda`).  A float32 ``x`` on a card runs
    the convolution without its bias (cuDNN's same call; ATen would add the
    bias in a pass of its own), its output made NCHW-contiguous (a copy
    only where ``x`` is channels-last), and one launch of the hand-written
    kernel, which adds the bias, applies the form and writes the result
    into ``out``: the same bits as the module's convolution and the plain
    passes.  Any other device or dtype calls the module, bias and all (the
    CPU's convolutions add the bias inside their sums), and runs
    :func:`rrdb_act_plain`.  ``out``, when given, receives the result: an
    (N, C, H, W) tensor with contiguous planes, such as a channel slice of
    a dense block's buffer, or ``outer`` itself.

    ``channels_last`` says that the module composition ran this
    convolution on a channels-last input (the trunk of a channels-last
    network input): ``x`` is then copied to that layout first, unless
    :func:`nchw_agrees`, so every result keeps the composition's bits.

    While tracing, counts ``rrdb_act.fused`` or ``rrdb_act.plain`` (one call
    a launch or composition, the output's elements as items) into the open
    span's stats.
    """
    if channels_last and not nchw_agrees(x, conv):
        x = x.contiguous(memory_format=torch.channels_last)
    if rrdb_fused(x):
        # cuDNN gets the module's call in x's own layout; the kernel reads
        # NCHW planes.
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation,
                     conv.groups).contiguous()
        y = rrdb_act_cuda(y, conv.bias, form, residual, outer, out)
        count_in_span("rrdb_act.fused", y.numel())
        return y
    y = rrdb_act_plain(conv(x), form, residual, outer, out)
    count_in_span("rrdb_act.plain", y.numel())
    return y


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pooling (NCHW) with -inf symmetric padding."""
    return F.max_pool2d(x, window, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pooling of an NCHW tensor to (N, C, 1, 1), f32 sums."""
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Torch-legacy nearest resize of an NCHW tensor: src = floor(i*in/out).

    Two axis gathers with the JAX package's float32 index arithmetic, so the
    source rows and columns are the same for any size ratio.  The gathers
    copy values, so integer label maps keep their dtype.
    """
    h, w = x.shape[2], x.shape[3]
    oh, ow = size
    dev = x.device
    iy = torch.floor(torch.arange(oh, dtype=torch.float32, device=dev) * (h / oh))
    ix = torch.floor(torch.arange(ow, dtype=torch.float32, device=dev) * (w / ow))
    return x[:, :, iy.long()][:, :, :, ix.long()]


def _linear_resize_matrix(
    n_in: int, n_out: int, align_corners: bool, pad: tuple[int, int] = (0, 0)
) -> np.ndarray:
    """Dense (n_out, n_in) bilinear interpolation matrix (one axis).

    ``pad`` embeds (before, after) rows of zeros around the interpolation
    rows, folding a zero pad of the resized output into the same product.
    """
    if pad != (0, 0):
        m = _linear_resize_matrix(n_in, n_out, align_corners)
        out = np.zeros((pad[0] + n_out + pad[1], n_in), dtype=np.float32)
        out[pad[0] : pad[0] + n_out] = m
        return out
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    if align_corners:
        # torch uses scale (n_in-1)/(n_out-1), which degenerates to 0 for a
        # single output sample: the corner pixel, not the center.
        scale_ac = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = np.arange(n_out, dtype=np.float64) * scale_ac
    else:
        scale = n_in / n_out
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float64)
    m = np.zeros((n_out, n_in), dtype=np.float32)
    m[np.arange(n_out), lo] += (1.0 - frac).astype(np.float32)
    m[np.arange(n_out), hi] += frac.astype(np.float32)
    return m


def _matrix_f32(m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """An interpolation matrix on ``x``'s device, rounded to ``x``'s dtype
    and held in f32 for the product (exact: the rounded values are f32)."""
    return to_device(m, x.device).to(x.dtype).float()


def resize_bilinear(
    x: torch.Tensor,
    size: tuple[int, int],
    align_corners: bool = False,
    pad: tuple[tuple[int, int], tuple[int, int]] | None = None,
) -> torch.Tensor:
    """Separable bilinear resize of an NHWC float tensor as two products.

    Matches ``F.interpolate(mode="bilinear", align_corners=...)`` sampling.
    ``pad`` = ((top, bottom), (left, right)) appends zero borders around the
    resized image inside the same products.  The interpolation matrices are
    the JAX package's, so the padded geometry is identical.  A bfloat16 or
    float16 ``x`` meets matrices rounded to its dtype, each product sums
    in f32 and is rounded once to ``x``'s dtype (the JAX rule).
    """
    h, w = x.shape[1], x.shape[2]
    oh, ow = size
    py, px = pad if pad is not None else ((0, 0), (0, 0))
    my = _matrix_f32(_linear_resize_matrix(h, oh, align_corners, tuple(py)), x)
    mx = _matrix_f32(_linear_resize_matrix(w, ow, align_corners, tuple(px)), x)
    y = torch.einsum("oh,nhwc->nowc", my, x.float()).to(x.dtype)
    return torch.einsum("pw,nhwc->nhpc", mx, y.float()).to(x.dtype)


def resize_bilinear_nchw(
    x: torch.Tensor, size: tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """:func:`resize_bilinear` of an NCHW float tensor.

    The same interpolation matrices, rows first, as two batched products
    over the last two axes (the parser's channel-first logits need no
    transpose), with the same dtype rule.
    """
    h, w = x.shape[2], x.shape[3]
    oh, ow = size
    my = _matrix_f32(_linear_resize_matrix(h, oh, align_corners), x)
    mx = _matrix_f32(_linear_resize_matrix(w, ow, align_corners), x)
    y = torch.matmul(my, x.float()).to(x.dtype)
    return torch.matmul(y.float(), mx.t()).to(x.dtype)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsampling (pixel replication) of an NCHW tensor.

    One allocation: the replicated view is copied once into its result.
    """
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


#: Torch bicubic (a = -0.75) downscaling by exactly 4 with
#: ``align_corners=False`` samples at constant fractional offsets (±0.5,
#: ±1.5) inside each group of 4 pixels: a separable stride-4 filter whose
#: taps never leave the image, so no border rule applies.
BICUBIC_DOWN4_TAPS = (-0.09375, 0.59375, 0.59375, -0.09375)


def downscale4x_bicubic(x: torch.Tensor) -> torch.Tensor:
    """Exact torch-parity bicubic x0.25 downscale of an NCHW tensor.

    Equals ``F.interpolate(x, scale_factor=0.25, mode="bicubic")`` (the
    enhancer's undo of its 4x upscale) for H and W divisible by 4.  Rows
    first, then columns, as the JAX function filters; each pass sums in
    f32 and is rounded once to ``x``'s dtype (the taps are exact in
    bfloat16).
    """
    xf = x.float()
    rows = sum(t * xf[:, :, k::4] for k, t in enumerate(BICUBIC_DOWN4_TAPS)).to(x.dtype).float()
    return sum(t * rows[:, :, :, k::4] for k, t in enumerate(BICUBIC_DOWN4_TAPS)).to(x.dtype)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=dim).to(x.dtype)
