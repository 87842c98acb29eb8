"""Seeded SDNet weights, made on the device in a few large calls.

One `torch.Generator` on the device, seeded by the run's seed, draws one
normal vector for all convolution weights and one for all the other
vectors; each tensor is a slice of them. Convolutions are LeCun-normal
(standard deviation 1 / sqrt(fan_in), the initialization the program
uses), biases 0.1 N(0, 1), BatchNorm scales 1 + 0.1 N, shifts and running
means 0.1 N, running variances exp(0.2 N), so every BatchNorm does work in
eval mode. The head's heatmap biases are 0 (`HEATMAP_BIAS`), not drawn: the
top K anchors of every image, far in the tail of its logits, then lie
well above the 0.5 threshold on every seed, so each image fills the
decode's budget and the host's work a batch does not move with the seed;
a larger bias would saturate the sigmoid, and bf16 would round the top
scores into ties.
The same tensors go to the program (`load_state_dict`) and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.sdnet import param_specs

HEATMAP_BIAS = 0.0


def make_state_dict(backbone: str, fpn_depth: int, n_out: int, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    specs = param_specs(backbone, fpn_depth, n_out)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n_conv = sum(math.prod(s) for _, s, kind in specs if kind == "conv")
    n_vec = sum(math.prod(s) for _, s, kind in specs if kind not in ("conv", "count"))
    conv = torch.randn(n_conv, generator=gen, device=device)
    vec = torch.randn(n_vec, generator=gen, device=device)
    sd, ic, iv = {}, 0, 0
    for key, shape, kind in specs:
        n = math.prod(shape)
        if kind == "conv":
            fan_in = n // shape[0]
            sd[key] = conv[ic:ic + n].view(shape) * (1.0 / math.sqrt(fan_in))
            ic += n
        elif kind == "count":
            sd[key] = torch.zeros((), dtype=torch.long, device=device)
        else:
            v = vec[iv:iv + n].view(shape)
            iv += n
            sd[key] = {"bias": 0.1 * v, "bn_weight": 1.0 + 0.1 * v, "bn_bias": 0.1 * v,
                       "bn_mean": 0.1 * v, "bn_var": torch.exp(0.2 * v)}[kind]
    sd["head.conv.bias"][:n_out - 4] = HEATMAP_BIAS
    return sd
