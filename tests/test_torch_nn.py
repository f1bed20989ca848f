"""Port parity: NN primitives (ops/nn.py) against face_crop_plus_tpu.ops.nn."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_crop_plus_tpu.ops import nn as jnn
from face_crop_plus_tpu_torch.ops import nn as tnn


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize(
    "kernel,stride,padding,bias",
    [(1, 1, 0, False), (3, 1, None, False), (3, 2, None, False),
     (7, 2, 3, False), (1, 1, 0, True), (1, 2, 0, False)],
)
def test_conv_folded_bn(kernel, stride, padding, bias):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(2, 17, 15, 8)).astype(np.float32)
    params = {
        "c.weight": rng.normal(size=(kernel, kernel, 8, 12)).astype(np.float32),
        "c.bias": rng.normal(size=(12,)).astype(np.float32),
        "bn.scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
        "bn.bias": rng.normal(size=(12,)).astype(np.float32),
    }
    p = jnn.Params({k: jnp.asarray(v) for k, v in params.items()})
    y = jnn.conv2d(p, "c", jnp.asarray(x), 12, kernel=kernel, stride=stride,
                   padding=padding, bias=bias)
    ref = np.asarray(jnn.batch_norm(p, "bn", y))

    conv = tnn.conv(8, 12, kernel, stride=stride, padding=padding, bias=bias)
    bn = tnn.FoldedBatchNorm(12)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(params["c.weight"].transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(params["c.bias"]))
        bn.scale.copy_(torch.from_numpy(params["bn.scale"]))
        bn.bias.copy_(torch.from_numpy(params["bn.bias"]))
        ours = _nhwc(bn(conv(_nchw(x))))
    # f32 conv sums are ordered differently by the two CPU backends.
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_leaky_relu_exact(slope):
    x = np.random.default_rng(0).normal(size=(2, 5, 5, 3)).astype(np.float32)
    ref = np.asarray(jnn.leaky_relu(jnp.asarray(x), slope))
    np.testing.assert_array_equal(tnn.leaky_relu(torch.from_numpy(x), slope).numpy(), ref)


@pytest.mark.parametrize("hw", [(16, 16), (17, 13), (1, 5)])
def test_max_pool_exact(hw):
    x = np.random.default_rng(1).normal(size=(2, *hw, 4)).astype(np.float32)
    ref = np.asarray(jnn.max_pool(jnp.asarray(x), window=3, stride=2, padding=1))
    ours = _nhwc(tnn.max_pool(_nchw(x), 3, 2, 1))
    np.testing.assert_array_equal(ours, ref)  # max is exact


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((3, 5), (7, 9)),
                                     ((8, 8), (8, 8)), ((5, 7), (16, 13))])
def test_resize_nearest_exact(src, dst):
    x = np.random.default_rng(2).normal(size=(2, *src, 3)).astype(np.float32)
    ref = np.asarray(jnn.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(_nhwc(tnn.resize_nearest(_nchw(x), dst)), ref)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("n_in,n_out,pad", [(218, 1024, (0, 0)), (178, 835, (94, 95)),
                                            (64, 512, (0, 0)), (7, 1, (2, 0)),
                                            (12, 12, (1, 1))])
def test_resize_matrix_exact(n_in, n_out, pad, align):
    ref = jnn._linear_resize_matrix(n_in, n_out, align, pad)
    np.testing.assert_array_equal(tnn._linear_resize_matrix(n_in, n_out, align, pad), ref)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("size,pad", [((64, 64), None), ((40, 52), ((3, 4), (0, 1))),
                                      ((23, 11), ((0, 0), (5, 0)))])
def test_resize_bilinear(size, pad, align):
    x = np.random.default_rng(3).uniform(0, 255, (2, 29, 21, 3)).astype(np.float32)
    ref = np.asarray(jnn.resize_bilinear(jnp.asarray(x), size, align, pad))
    ours = tnn.resize_bilinear(torch.from_numpy(x), size, align, pad).numpy()
    # Same interpolation matrices; each output sums at most two nonzero
    # products, which the two backends may fuse or order differently
    # (an ulp or so of a 0-255 value).
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    if pad is not None:
        (t, b), (l, r) = pad
        assert not ours[:, :t].any() and not ours[:, ours.shape[1] - b:].any()
        assert not ours[:, :, :l].any() and not ours[:, :, ours.shape[2] - r:].any()


def test_softmax():
    x = np.random.default_rng(4).normal(size=(2, 50, 2)).astype(np.float32) * 5
    ref = np.asarray(jnn.softmax(jnp.asarray(x), axis=-1))
    # exp/sum differ by an ulp or so between the backends' vector libraries.
    np.testing.assert_allclose(tnn.softmax(torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-6, atol=1e-7)
