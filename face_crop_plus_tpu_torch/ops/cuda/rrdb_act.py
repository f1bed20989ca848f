"""RRDBNet's convolution epilogue: the hand-written CUDA kernel's launcher.

The kernel (``csrc/rrdb_act.cu``) adds a convolution's bias to its output
``y`` (computed without it) and applies the enhancer's form in one pass over
an NCHW float32 tensor: nothing more (``"bias"``), LeakyReLU 0.2
(``"leaky"``), a residual (``"add"``), the dense block's 0.2-scaled residual
(``"dense"``) or that and the RRDB's own on top (``"rrdb"``), bit for bit
what ATen's add of the bias and :func:`..nn.rrdb_act_plain` compute with
two to five passes.  Its
output may be a channel slice of a larger NCHW tensor, so a dense block's
growth convolutions write into one preallocated buffer in place of
``torch.cat``.  It replaces no TPU kernel (XLA fuses the same operations
into the convolutions there); the source says what bounds it and how it is
laid out.  It is built with ``nvcc`` at first use (:mod:`.build`) and called
through ``ctypes`` on the current stream of the tensors' own card, which the
C launcher makes current around the launch, without synchronising.

:func:`rrdb_act_cuda` takes CUDA tensors only; the dispatcher
:func:`..nn.rrdb_conv` chooses it or the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .bn_act import _planes_stride
from .build import load_library

#: Kernel launches so far (each call of the kernel counts one).
launches = 0

#: The forms, in the kernel's numbering, with the residuals each reads.
FORMS = {"bias": (0, 0), "leaky": (1, 0), "add": (2, 1), "dense": (3, 1), "rrdb": (4, 2)}

_MAX_BLOCKS = 2**31 - 1
_UNITS_A_BLOCK = 8
#: Elements of one plane a warp of the kernel walks.
_SEGMENT = 4096


def _lib():
    lib = load_library("rrdb_act.cu")
    if lib.fcpt_rrdb_act.argtypes is None:
        lib.fcpt_rrdb_act.argtypes = [
            ctypes.c_void_p,  # y
            ctypes.c_void_p,  # bias
            ctypes.c_void_p,  # residual (or None)
            ctypes.c_void_p,  # outer residual (or None)
            ctypes.c_void_p,  # out
            ctypes.c_longlong,  # n
            ctypes.c_int,  # c
            ctypes.c_longlong,  # h * w
            ctypes.c_longlong,  # residual's batch stride
            ctypes.c_longlong,  # outer residual's batch stride
            ctypes.c_longlong,  # out's batch stride
            ctypes.c_int,  # form
            ctypes.c_int,  # vector path
            ctypes.c_int,  # the card's index
            ctypes.c_void_p,  # stream
        ]
        lib.fcpt_rrdb_act.restype = ctypes.c_int
        lib.fcpt_rrdb_act_error_string.argtypes = [ctypes.c_int]
        lib.fcpt_rrdb_act_error_string.restype = ctypes.c_char_p
    return lib


def rrdb_act_cuda(
    y: torch.Tensor,
    bias: torch.Tensor,
    form: str,
    residual: torch.Tensor | None = None,
    outer: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``form(y + bias[c])`` of an NCHW float32 tensor, into ``out``.

    Args:
        y: float32 (N, C, H, W) contiguous, on a CUDA card: a convolution's
            output without its bias.
        bias: float32 (C,) contiguous.
        form: ``"bias"`` (``a``), ``"leaky"`` (``a > 0 ? a : a * 0.2``),
            ``"add"`` (``a + residual``), ``"dense"`` (``a * 0.2 +
            residual``) or ``"rrdb"`` (``(a * 0.2 + residual) * 0.2 +
            outer``), with ``a = y + bias[c]``.
        residual, outer: float32 (N, C, H, W) with contiguous planes, such
            as a channel slice of a larger NCHW tensor; given where the form
            reads them, else None.
        out: Optional float32 (N, C, H, W) destination whose planes are
            contiguous; by default ``y`` itself is written over.  It may be
            ``outer`` itself; it overlaps no other input.

    Returns:
        ``out`` (or ``y``), once the launch is enqueued on the current
        stream of ``y``'s card.
    """
    global launches
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; expected one of {sorted(FORMS)}")
    code, reads = FORMS[form]
    if (residual is not None, outer is not None) != (reads >= 1, reads == 2):
        raise ValueError(f"form {form!r} reads {reads} residual(s): residual is given "
                         f"{residual is not None}, outer {outer is not None}")
    out = y if out is None else out
    dev = y.device
    if dev.type != "cuda" or y.dim() != 4:
        raise ValueError(f"expected y (N, C, H, W) on a CUDA card, got {tuple(y.shape)} on {dev}")
    n, c, h, w = y.shape
    planes = [t for t in (out, residual, outer) if t is not None]
    for t in [y, bias] + planes:
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"expected float32 tensors on {dev}, got {t.dtype} on {t.device}")
    for t in planes:
        if t.shape != y.shape:
            raise ValueError(f"out and the residuals must have y's shape {tuple(y.shape)}, "
                             f"got {tuple(t.shape)}")
    if bias.shape != (c,) or not bias.is_contiguous():
        raise ValueError(f"bias must be contiguous ({c},), got {tuple(bias.shape)}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous (NCHW)")
    strides = [_planes_stride(t) for t in planes]
    if None in strides:
        raise ValueError("out's and the residuals' (n, c) planes must be contiguous, got "
                         f"strides {[t.stride() for t in planes]}")
    hw = h * w
    if y.numel() == 0:
        return out
    blocks = (n * c * -(-hw // _SEGMENT) + _UNITS_A_BLOCK - 1) // _UNITS_A_BLOCK
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"{tuple(y.shape)} needs {blocks} blocks, above the grid's {_MAX_BLOCKS}")
    vec = all(t.data_ptr() % 16 == 0 for t in [y] + planes) and (
        n == 1 or all((s - c * hw) % 4 == 0 for s in strides))
    out_stride, *res_strides = strides
    res_strides += [c * hw] * (2 - len(res_strides))
    lib = _lib()
    err = lib.fcpt_rrdb_act(
        y.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        None if outer is None else outer.data_ptr(),
        out.data_ptr(), n, c, hw, res_strides[0], res_strides[1], out_stride, code,
        int(vec), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.fcpt_rrdb_act_error_string(err).decode()
        raise RuntimeError(f"rrdb_act kernel launch failed: {msg} ({err})")
    launches += 1
    return out
