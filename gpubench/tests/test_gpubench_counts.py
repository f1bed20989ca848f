"""The counted work against forward hooks on the reference's modules, and
the reference's parameters against the package's."""

import json
import os

import pytest
import torch

from gpubench.counts import kernels
from gpubench.counts import retinaface as retinaface_counts
from gpubench.reference.retinaface import RetinaFaceNet
from gpubench.tests.helpers import ROOT

MODEL = json.load(open(os.path.join(ROOT, "gpubench", "configs",
                                    "retinaface_r50_largest.json")))["model"]


def hooked_macs(net: torch.nn.Module, x: torch.Tensor) -> int:
    """Multiply-adds of every convolution of one image, from the
    convolutions' output shapes as they run."""
    total = [0]

    def hook(m, _inp, out):
        total[0] += out[0].numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


@pytest.mark.parametrize("hw", [(64, 64), (96, 80), (100, 72)])
@pytest.mark.parametrize("anchors,width", [(2, 256), (3, 64)])
def test_retinaface_counts_match_hooks(hw, anchors, width):
    # The published widths, and others: the counts read the model block.
    model = dict(MODEL, anchors_per_cell=anchors, out_channel=width,
                 ssh_branches=[width // 2, width // 4, width // 4],
                 min_sizes=[[16 * (i + 1)] * anchors for i in range(3)])
    net = RetinaFaceNet(model).eval()
    assert retinaface_counts.network_macs(*hw, model) == hooked_macs(net, torch.zeros(1, 3, *hw))


def test_detector_count_at_the_cell_size():
    # 16 images at 1024²: the 3.626 TFLOP that PERF.md's TFLOP/s divide by.
    assert 16 * 2 * retinaface_counts.network_macs(1024, 1024, MODEL) == 3_626_160_357_376
    resize = retinaface_counts.interim_resize_macs(218, 178, 1024, 1024)
    assert resize == 3 * (1024 * 218 * 178 + 1024 * 1024 * 178)
    assert retinaface_counts.interim_resize_macs(1024, 1024, 1024, 1024) == 0


def test_kernel_bounds():
    assert kernels.nms_ops(16, 1024) == 20 * 16 * 1024 * 1023 // 2
    assert kernels.warp_bytes(16, 256, 256) == 16 * (256 * 256 * 3 + 28)


def test_reference_parameters_are_the_packages():
    from face_crop_plus_tpu_torch.models.detection import RetinaFaceNet as PortDet

    shapes = lambda net: {k: tuple(v.shape) for k, v in net.state_dict().items()}  # noqa: E731
    assert shapes(RetinaFaceNet(MODEL)) == shapes(PortDet())


@pytest.mark.parametrize("change", [{"backbone": "mobilenet0.25"}, {"in_channel": 32},
                                    {"ssh_branches": [128, 128, 0]}, {"min_sizes": [[16]] * 3}])
def test_a_model_block_the_reference_cannot_build_is_refused(change):
    with pytest.raises(ValueError):
        RetinaFaceNet(dict(MODEL, **change))
