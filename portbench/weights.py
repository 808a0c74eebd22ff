"""Seeded weights for a configuration, made on the device in a few calls.

Every conv weight is He-normal, every dense weight normal with variance
1 / fan_in, the LSTM uniform in +-1/sqrt(H), BatchNorm's scale and running
variance uniform in [0.8, 1.2], its shift, its running mean and every bias
0.05 times a normal draw: activations stay of order one through the ReLU
stack, and eval-mode BatchNorm has statistics that are not the identity.
Metadata features 4..7 are raw years and months (about 2000 and 6), so
their weights are scaled by 1e-3.  One normal draw and one uniform draw
cover every leaf; the benchmark hands the same state_dict to the program
and to the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import Reference


def spec(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(key, shape) of every entry of the configuration's state_dict."""
    with torch.device("meta"):
        model = Reference(cfg)
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def _law(key: str, shape: tuple[int, ...]):
    """("normal", std) or ("uniform", lo, hi) or ("zero",) for one leaf."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return ("zero",)
    if ".lstm." in key:
        b = 1 / math.sqrt(shape[0] // 4)
        return ("uniform", -b, b)
    if ".bn" in key:
        if leaf in ("weight", "running_var"):
            return ("uniform", 0.8, 1.2)
        return ("normal", 0.05)
    if leaf == "weight" and len(shape) == 4:
        return ("normal", math.sqrt(2 / math.prod(shape[1:])))
    if leaf == "weight" and len(shape) == 2:
        return ("normal", 1 / math.sqrt(shape[1]))
    return ("normal", 0.05)


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The configuration's state_dict from ``seed``, f32 on ``device``."""
    leaves = spec(cfg)
    laws = [_law(k, s) for k, s in leaves]
    sizes = [math.prod(s) for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(n for n, law in zip(sizes, laws) if law[0] == "normal")
    n_uniform = sum(n for n, law in zip(sizes, laws) if law[0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    lens = lambda kind: torch.tensor([n for n, law in zip(sizes, laws) if law[0] == kind],
                                     device=device)
    normal *= torch.tensor([law[1] for law in laws if law[0] == "normal"],
                           device=device).repeat_interleave(lens("normal"))
    lo = torch.tensor([law[1] for law in laws if law[0] == "uniform"], device=device)
    hi = torch.tensor([law[2] for law in laws if law[0] == "uniform"], device=device)
    uniform = uniform * (hi - lo).repeat_interleave(lens("uniform")) \
        + lo.repeat_interleave(lens("uniform"))
    out, pos = {}, {"normal": 0, "uniform": 0}
    for (key, shape), n, law in zip(leaves, sizes, laws):
        if law[0] == "zero":
            out[key] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        src = normal if law[0] == "normal" else uniform
        out[key] = src[pos[law[0]]:pos[law[0]] + n].view(shape)
        pos[law[0]] += n
    meta = "model.meta_encoder.fc.0.weight"
    if meta in out and out[meta].shape[1] > 4:
        out[meta][:, 4:] *= 1e-3
    return out
