"""Seeded, tamed weights, made on the device in a few large draws.

He-scaled random weights saturate a deep network; "tamed" ones keep its
activations, scores and logits spread: each convolution kernel is drawn
N(0, gain / fan_in), every folded BatchNorm scale is a constant and every
bias N(0, bias_std²).  All kernels come from one draw and all biases from a
second, from a generator seeded with the run's seed on the device that
serves them, in float32 (the configurations' precision).  The recipe is the
configuration file's ``"weights"`` entry.
"""

from __future__ import annotations

import torch

#: Largest seed a torch generator takes (unsigned 64 bits).
_SEED_MASK = (1 << 64) - 1


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one of the run's independent streams."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & _SEED_MASK)
    return g


def tamed_state_dict(shapes: dict, recipe: dict, seed: int, device) -> dict:
    """float32 tensors on ``device`` for every key of ``shapes`` (name →
    shape, in the network's order).

    ``recipe``: ``gain`` (kernel variance × fan-in), ``bn_scale``,
    ``bias_std``; optional ``head`` {key: gain} for kernels with their own
    gain.
    """
    kernels = [(k, s) for k, s in shapes.items() if len(s) == 4]
    biases = [(k, s) for k, s in shapes.items() if len(s) != 4 and not k.endswith(".scale")]
    n_k = sum(torch.Size(s).numel() for _, s in kernels)
    n_b = sum(torch.Size(s).numel() for _, s in biases)
    flat_k = torch.randn(n_k, generator=generator(seed, device, 1), device=device)
    flat_b = torch.randn(max(n_b, 1), generator=generator(seed, device, 2), device=device)
    out, heads = {}, recipe.get("head", {})
    at = 0
    for key, shape in kernels:
        size = torch.Size(shape).numel()
        fan_in = shape[1] * shape[2] * shape[3]
        gain = heads.get(key, recipe["gain"])
        out[key] = flat_k[at: at + size].view(shape) * (gain / fan_in) ** 0.5
        at += size
    at = 0
    for key, shape in biases:
        size = torch.Size(shape).numel()
        out[key] = flat_b[at: at + size].view(shape) * recipe["bias_std"]
        at += size
    for key, shape in shapes.items():
        if key.endswith(".scale"):
            out[key] = torch.full(tuple(shape), float(recipe["bn_scale"]), device=device)
    return {k: out[k].contiguous() for k in shapes}
