"""The convolutions' epilogue: the hand-written CUDA kernel's launcher.

The kernel (``csrc/bn_act.cu``) computes, over an NCHW float32 tensor in
one pass, ``act((x * s[c] + b[c]) + r)`` with ``r`` absent, a plain tensor
or ``u * s2[c] + b2[c]``, and ``act`` ReLU or the identity: bit for bit
what :func:`..nn.bn_act_plain` computes with three to five ATen passes.
It replaces no TPU kernel (XLA fuses the same operations into the
convolutions there); the source says what bounds it and how it is laid
out.  It is built with ``nvcc`` at first use (:mod:`.build`) and called
through ``ctypes`` on the current stream of the tensors' own card, which
the C launcher makes current around the launch (cheaper on the host than
``torch.cuda.device``), without synchronising.

:func:`bn_act_cuda` takes CUDA tensors only; the dispatcher
:func:`..nn.bn_act` chooses it or the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

#: Kernel launches so far (each call of the kernel counts one).
launches = 0

_MAX_BLOCKS = 2**31 - 1
_UNITS_A_BLOCK = 8
#: Elements of one plane a warp of the kernel walks.
_SEGMENT = 4096


def _lib():
    lib = load_library("bn_act.cu")
    if lib.fcpt_bn_act.argtypes is None:
        lib.fcpt_bn_act.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # scale
            ctypes.c_void_p,  # bias
            ctypes.c_void_p,  # residual (or None)
            ctypes.c_void_p,  # residual scale (or None)
            ctypes.c_void_p,  # residual bias (or None)
            ctypes.c_void_p,  # out
            ctypes.c_longlong,  # n
            ctypes.c_int,  # c
            ctypes.c_longlong,  # h * w
            ctypes.c_longlong,  # out's batch stride
            ctypes.c_int,  # residual kind
            ctypes.c_int,  # relu
            ctypes.c_int,  # vector path
            ctypes.c_int,  # the card's index
            ctypes.c_void_p,  # stream
        ]
        lib.fcpt_bn_act.restype = ctypes.c_int
        lib.fcpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fcpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _planes_stride(t: torch.Tensor) -> int | None:
    """The batch stride of a 4-D tensor whose (n, c) planes each hold H*W
    contiguous elements at channel stride H*W, or None when it is laid out
    otherwise (a dimension of size 1 may have any stride)."""
    _, c, h, w = t.shape
    for size, stride, want in zip((c, h, w), t.stride()[1:], (h * w, w, 1)):
        if size > 1 and stride != want:
            return None
    return t.stride(0)


def bn_act_cuda(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    relu: bool,
    residual: torch.Tensor | None = None,
    residual_scale: torch.Tensor | None = None,
    residual_bias: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``act((x * scale[c] + bias[c]) + r)`` of an NCHW float32 tensor.

    Args:
        x: float32 (N, C, H, W) contiguous, on a CUDA card.
        scale, bias: float32 (C,) contiguous: the folded BatchNorm.
        relu: ReLU (True) or the identity.
        residual: Optional float32 (N, C, H, W) contiguous ``r``, or ``u``
            when ``residual_scale`` and ``residual_bias`` are given: then
            ``r = u * residual_scale[c] + residual_bias[c]``.
        out: Optional float32 (N, C, H, W) destination whose planes are
            contiguous, such as a channel slice of a larger NCHW tensor;
            by default ``x`` itself is written over.

    Returns:
        ``out`` (or ``x``), once the launch is enqueued on the current
        stream of ``x``'s card.
    """
    global launches
    if (residual_scale is None) != (residual_bias is None) or (
        residual_scale is not None and residual is None
    ):
        raise ValueError("residual_scale and residual_bias go together, with a residual")
    kind = 0 if residual is None else 1 if residual_scale is None else 2
    out = x if out is None else out
    dev = x.device
    if dev.type != "cuda" or x.dim() != 4:
        raise ValueError(f"expected x (N, C, H, W) on a CUDA card, got {tuple(x.shape)} on {dev}")
    n, c, h, w = x.shape
    planes = (x, out) if residual is None else (x, out, residual)
    channels = (scale, bias) if kind < 2 else (scale, bias, residual_scale, residual_bias)
    for t in planes + channels:
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"expected float32 tensors on {dev}, got {t.dtype} on {t.device}")
    for t in planes:
        if t.shape != x.shape:
            raise ValueError(f"out and residual must have x's shape {tuple(x.shape)}, "
                             f"got {tuple(t.shape)}")
    for t in channels:
        if t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"scales and biases must be contiguous ({c},), got {tuple(t.shape)}")
    if not x.is_contiguous() or (residual is not None and not residual.is_contiguous()):
        raise ValueError("x and residual must be contiguous (NCHW)")
    out_stride = _planes_stride(out)
    if out_stride is None:
        raise ValueError(f"out's (n, c) planes must be contiguous, got strides {out.stride()}")
    hw = h * w
    if x.numel() == 0:
        return out
    blocks = (n * c * -(-hw // _SEGMENT) + _UNITS_A_BLOCK - 1) // _UNITS_A_BLOCK
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"{tuple(x.shape)} needs {blocks} blocks, above the grid's {_MAX_BLOCKS}")
    vec = all(t.data_ptr() % 16 == 0 for t in planes) and (
        n == 1 or (out_stride - c * hw) % 4 == 0)
    lib = _lib()
    err = lib.fcpt_bn_act(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        None if residual_scale is None else residual_scale.data_ptr(),
        None if residual_bias is None else residual_bias.data_ptr(),
        out.data_ptr(), n, c, hw, out_stride, kind, int(relu), int(vec), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.fcpt_cuda_error_string(err).decode()
        raise RuntimeError(f"bn_act kernel launch failed: {msg} ({err})")
    launches += 1
    return out
