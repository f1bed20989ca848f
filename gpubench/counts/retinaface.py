"""Multiply-adds of RetinaFace R50 and its input resize, at the widths of a
configuration's ``model`` block (``cfg_re50``'s keys)."""

from __future__ import annotations

from .convs import conv_macs, out_size, resize_macs


def _bottleneck(h, w, cin, width, stride, project):
    total, _, _ = conv_macs(h, w, cin, width, 1, padding=0)
    m, oh, ow = conv_macs(h, w, width, width, 3, stride)
    total += m + conv_macs(oh, ow, width, width * 4, 1, padding=0)[0]
    if project:
        total += conv_macs(h, w, cin, width * 4, 1, stride, padding=0)[0]
    return total, oh, ow


def _ssh(h, w, cin=256, cout=256):
    q = cout // 4
    return (conv_macs(h, w, cin, cout // 2, 3)[0] + conv_macs(h, w, cin, q, 3)[0]
            + 3 * conv_macs(h, w, q, q, 3)[0])


def network_macs(h: int, w: int, model: dict) -> int:
    """Multiply-adds of one image's forward at an h×w interim: trunk, FPN,
    SSH and the three heads over ``anchors_per_cell`` anchors a cell."""
    cout, a = model["out_channel"], model["anchors_per_cell"]
    total, h1, w1 = conv_macs(h, w, 3, 64, 7, 2, 3)
    h1, w1 = out_size(h1, 3, 2, 1), out_size(w1, 3, 2, 1)
    cin, levels = 64, []
    for width, depth, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(depth):
            m, h1, w1 = _bottleneck(h1, w1, cin, width, stride if i == 0 else 1, i == 0)
            total, cin = total + m, width * 4
        levels.append((h1, w1, cin))
    levels = levels[1:]  # C3, C4, C5
    for lh, lw, c in levels:
        total += conv_macs(lh, lw, c, cout, 1, padding=0)[0]  # FPN lateral
    for lh, lw, _ in levels[:2]:
        total += conv_macs(lh, lw, cout, cout, 3)[0]  # FPN merges
    for lh, lw, _ in levels:
        total += _ssh(lh, lw, cout, cout) + conv_macs(lh, lw, cout, a * (2 + 4 + 10), 1,
                                                      padding=0)[0]
    return total


def interim_resize_macs(h: int, w: int, ih: int, iw: int) -> int:
    """Multiply-adds of resizing an RGB h×w image into the ih×iw interim
    (dense products over the whole interim, border rows included)."""
    return 0 if (h, w) == (ih, iw) else resize_macs(h, w, ih, iw, 3)


def image_flop(h: int, w: int, ih: int, iw: int, model: dict) -> int:
    """FLOPs (2 × multiply-adds) of detecting one h×w image at ih×iw."""
    return 2 * (network_macs(ih, iw, model) + interim_resize_macs(h, w, ih, iw))
