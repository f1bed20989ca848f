"""Port parity: greedy NMS and face selection (ops/nms.py, ops/cuda/nms.py).

The port's plain NMS is held against the JAX package's XLA path
(``greedy_nms_mask(iou_matrix_plus1(b), ...)``) and its Pallas kernel in
interpret mode; numpy models of the CUDA kernel's pair test and word-by-word
scan are held against both.  Tolerance: exact — keep masks, IoU matrices, top-K
indices, selections, validity and cap diagnostics are discrete results or
the same f32 operations in the same order on identical inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_crop_plus_tpu.ops import nms as jnms
from face_crop_plus_tpu.ops.pallas.nms_kernel import greedy_nms_mask_pallas
from face_crop_plus_tpu_torch.ops import nms as tnms
from face_crop_plus_tpu_torch.ops.cuda import nms as cuda_nms

from torch_parity import sorted_boxes

THR = 0.4


def _near_threshold(rng, n, k):
    """Pairs of boxes whose IoU lies within a few ulps of 0.4.

    An anchor box [0, y, w, y + w] (integer w, +1 area convention) and its
    copy shifted by d = 3(w + 1)/7 along x have IoU exactly 0.4; d is then
    nudged by up to 2 f32 ulps either way.  Pairs are stacked 100 px apart
    in y so that only partners overlap.
    """
    boxes = np.zeros((n, k, 4), np.float32)
    for b in range(n):
        for p in range(0, k - 1, 2):
            w = np.float32(rng.integers(20, 91))
            y = np.float32(100 * (p // 2))
            d = np.float32(3.0 * (w + 1.0) / 7.0)
            toward = np.float32(np.inf if rng.random() < 0.5 else -np.inf)
            for _ in range(int(rng.integers(0, 3))):
                d = np.nextafter(d, toward)
            boxes[b, p] = (0, y, w, y + w)
            boxes[b, p + 1] = (d, y, d + w, y + w)
        if k % 2:
            boxes[b, k - 1] = (0, -500, 10, -490)
    return boxes, np.ones((n, k), bool)


def _nonfinite(rng, n, k):
    boxes, valid = sorted_boxes(rng, n, k)
    hit = rng.random(boxes.shape) < 0.05
    specials = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), boxes.shape)
    return np.where(hit, specials, boxes).astype(np.float32), valid


def _make(case, rng, n, k):
    if case == "random":
        return sorted_boxes(rng, n, k)
    if case == "all_invalid":
        boxes, _ = sorted_boxes(rng, n, k)
        return boxes, np.zeros((n, k), bool)
    if case == "identical":
        box = np.array([10, 10, 50, 50], np.float32)
        return np.tile(box, (n, k, 1)), np.ones((n, k), bool)
    if case == "near_threshold":
        return _near_threshold(rng, n, k)
    if case == "nonfinite":
        return _nonfinite(rng, n, k)
    raise ValueError(case)


CASES = ["random", "all_invalid", "identical", "near_threshold", "nonfinite"]


def _port_keep(boxes, valid):
    return tnms.greedy_nms_mask(
        tnms.iou_matrix_plus1(torch.from_numpy(boxes)), torch.from_numpy(valid), THR
    ).numpy()


def _jax_xla_keep(boxes, valid):
    iou = jnms.iou_matrix_plus1(jnp.asarray(boxes))
    return np.asarray(jnms.greedy_nms_mask(iou, jnp.asarray(valid), THR))


@pytest.mark.parametrize("k", [128, 168, 256, 512, 1024])
@pytest.mark.parametrize("case", CASES)
def test_plain_nms_matches_jax_xla(case, k):
    boxes, valid = _make(case, np.random.default_rng(k), 3, k)
    np.testing.assert_array_equal(_port_keep(boxes, valid), _jax_xla_keep(boxes, valid))


@pytest.mark.parametrize("k", [128, 168, 256])
@pytest.mark.parametrize("case", CASES)
def test_plain_nms_matches_jax_pallas_interpret(case, k):
    boxes, valid = _make(case, np.random.default_rng(k + 1), 2, k)
    ref = np.asarray(
        greedy_nms_mask_pallas(
            jnp.asarray(boxes), jnp.asarray(valid), THR, interpret=True
        )
    )
    np.testing.assert_array_equal(_port_keep(boxes, valid), ref)


@pytest.mark.parametrize("case", CASES)
def test_iou_matrix_exact(case):
    boxes, _ = _make(case, np.random.default_rng(7), 2, 168)
    ours = tnms.iou_matrix_plus1(torch.from_numpy(boxes)).numpy()
    ref = np.asarray(jnms.iou_matrix_plus1(jnp.asarray(boxes)))
    np.testing.assert_array_equal(ours, ref)


def test_near_threshold_case_straddles_the_threshold():
    # Precondition of the near-threshold case: partner IoUs fall on both
    # sides of 0.4 and within a few ulps of it.
    boxes, _ = _near_threshold(np.random.default_rng(0), 4, 256)
    iou = tnms.iou_matrix_plus1(torch.from_numpy(boxes)).numpy()
    partner = iou[:, np.arange(0, 256, 2), np.arange(1, 256, 2)]
    assert np.abs(partner - np.float32(THR)).max() < 2e-7  # a few f32 ulps
    assert (partner > np.float32(THR)).any() and (partner <= np.float32(THR)).any()


def test_identical_boxes_keep_first_valid_only():
    boxes, valid = _make("identical", None, 1, 128)
    keep = _port_keep(boxes, valid)
    assert keep[0, 0] and not keep[0, 1:].any()


def test_cuda_wrapper_on_cpu_is_plain_version():
    boxes, valid = sorted_boxes(np.random.default_rng(3), 2, 168)
    before = cuda_nms.launches
    ours = cuda_nms.greedy_nms_mask_cuda(
        torch.from_numpy(boxes), torch.from_numpy(valid), THR
    ).numpy()
    np.testing.assert_array_equal(ours, _port_keep(boxes, valid))
    assert cuda_nms.launches == before  # the kernel did not launch


def _select_inputs(case, rng, n=3, a=300):
    boxes, _ = sorted_boxes(rng, n, a, hi=200.0)
    landms = rng.uniform(0, 200, (n, a, 10)).astype(np.float32)
    if case == "spread":
        scores = rng.uniform(0, 1, (n, a)).astype(np.float32)
        scores[:, ::7] = scores[:, :1]  # some exact ties
    elif case == "saturated":
        # The random-weight detector's regime: scores exactly 0.0 or 1.0,
        # so the order among equal scores decides every selection.
        scores = (rng.random((n, a)) < 0.6).astype(np.float32)
    elif case == "nonfinite":
        scores = (rng.random((n, a)) < 0.6).astype(np.float32)
        hit = rng.random(boxes.shape) < 0.05
        specials = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), boxes.shape)
        boxes = np.where(hit, specials, boxes).astype(np.float32)
    else:
        raise ValueError(case)
    return scores, boxes, landms


@pytest.mark.parametrize("pre_topk", [128, 256, 512])
@pytest.mark.parametrize("strategy", ["all", "best", "largest"])
@pytest.mark.parametrize("case", ["spread", "saturated", "nonfinite"])
@pytest.mark.parametrize("vis", [0.5, -1.0])
def test_select_faces_matches_jax(case, strategy, pre_topk, vis):
    scores, boxes, landms = _select_inputs(case, np.random.default_rng(pre_topk))
    kw = dict(
        vis_threshold=vis, nms_threshold=THR, pre_topk=pre_topk,
        max_faces=16, strategy=strategy,
    )
    ref = jnms.select_faces(
        jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(landms), **kw
    )
    ours = tnms.select_faces(
        torch.from_numpy(scores), torch.from_numpy(boxes), torch.from_numpy(landms), **kw
    )
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_top_candidates_tie_order_is_lower_index_first():
    scores = torch.tensor([[1.0, 1.0, 0.0, 1.0, 0.0, 1.0]])
    idx, valid, n_above = tnms.top_candidates(scores, -1.0, 4)
    assert idx.tolist() == [[0, 1, 3, 5]]
    assert valid.all() and n_above.tolist() == [6]


# ---------------------------------------------------------------------------
# numpy models of the CUDA kernel's two passes (csrc/nms.cu)
# ---------------------------------------------------------------------------


def _max_c(v, c):
    """The kernel's NaN-propagating max(v, c) for a constant c: v < c ? c : v."""
    return np.where(v < c, c, v)


def _kernel_pair_gt(boxes, thr=THR):
    """The mask pass's pair test, IoU(i, j) > thr, for (K, 4) f32 boxes.

    NaN-dropping fmax/fmin where the reference propagates NaN, and a
    NaN-propagating max only for the union: every NaN the reference's IoU
    would carry also makes an area NaN, and the union carries that.
    """
    with np.errstate(all="ignore"):
        x1, y1, x2, y2 = (boxes[:, c] for c in range(4))
        one = np.float32(1.0)
        area = ((x2 - x1) + one) * ((y2 - y1) + one)
        ix1 = np.fmax(x1[:, None], x1[None])
        iy1 = np.fmax(y1[:, None], y1[None])
        ix2 = np.fmin(x2[:, None], x2[None])
        iy2 = np.fmin(y2[:, None], y2[None])
        iw = np.fmax((ix2 - ix1) + one, np.float32(0.0))
        ih = np.fmax((iy2 - iy1) + one, np.float32(0.0))
        inter = iw * ih
        uni = _max_c((area[:, None] + area[None]) - inter, np.float32(1e-12))
        return inter / uni > np.float32(thr)


def _packed_mask(gt):
    """(K, W) uint64 words, bit b of word w set when j = 64w + b > i and gt."""
    k = gt.shape[0]
    words = (k + 63) // 64
    upper = np.zeros((k, 64 * words), bool)
    upper[:, :k] = np.triu(gt, 1)
    return np.packbits(upper, axis=1, bitorder="little").view("<u8")


def _word_scan(mask, valid):
    """The scan pass, word by word, over one image's packed mask."""
    k = len(valid)
    words = mask.shape[1]
    bits = np.zeros(64 * words, bool)
    bits[:k] = valid
    vwords = [int(x) for x in np.packbits(bits, bitorder="little").view("<u8")]
    removed = [0] * words
    kept = [0] * words
    for w in range(words):
        alive = vwords[w] & ~removed[w]
        for b in range(min(64, k - 64 * w)):  # greedy inside the word
            if (alive >> b) & 1:
                alive &= ~int(mask[64 * w + b, w])
        kept[w] = alive
        for b in (b for b in range(64) if (alive >> b) & 1):
            for lane in range(w + 1, words):
                removed[lane] |= int(mask[64 * w + b, lane])
    return np.array([(kept[j >> 6] >> (j & 63)) & 1 for j in range(k)], bool)


@pytest.mark.parametrize("k", [1, 63, 64, 65, 256, 1000, 1024])
@pytest.mark.parametrize("case", CASES)
def test_word_scan_model_matches_greedy(case, k):
    boxes, valid = _make(case, np.random.default_rng(k + 2), 2, k)
    iou = tnms.iou_matrix_plus1(torch.from_numpy(boxes)).numpy()
    ours = np.stack([
        _word_scan(_packed_mask(iou[b] > np.float32(THR)), valid[b]) for b in range(len(boxes))
    ])
    np.testing.assert_array_equal(ours, _port_keep(boxes, valid))
    np.testing.assert_array_equal(ours, _jax_xla_keep(boxes, valid))


def _overflow_boxes(rng, n, k):
    # Finite coordinates whose widths and areas overflow to inf (inf * 0
    # and inf - inf arise inside the IoU), mixed with infinities.
    vals = np.array([-3e38, -1.0, 0.0, 1.0, 2.0, 3e38, np.inf, -np.inf], np.float32)
    return rng.choice(vals, (n, k, 4)), np.ones((n, k), bool)


@pytest.mark.parametrize("case", CASES + ["overflow"])
def test_kernel_pair_test_model_matches_iou(case):
    rng = np.random.default_rng(11)
    boxes, _ = (_overflow_boxes(rng, 2, 200) if case == "overflow" else _make(case, rng, 2, 200))
    iou = tnms.iou_matrix_plus1(torch.from_numpy(boxes)).numpy()
    for b in range(len(boxes)):
        np.testing.assert_array_equal(_kernel_pair_gt(boxes[b]), iou[b] > np.float32(THR))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 63, 64, 65, 168, 256, 512, 1000, 1024])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_gpu(case, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    boxes, valid = _make(case, np.random.default_rng(k), 16, k)
    b = torch.from_numpy(boxes).cuda()
    v = torch.from_numpy(valid).cuda()
    before = cuda_nms.launches
    ours = cuda_nms.greedy_nms_mask_cuda(b, v, THR)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 1
    plain = tnms.greedy_nms_mask(tnms.iou_matrix_plus1(b), v, THR)
    assert torch.equal(ours, plain)
    np.testing.assert_array_equal(ours.cpu().numpy(), _jax_xla_keep(boxes, valid))
