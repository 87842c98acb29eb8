"""The plain reference of SDNet on a Swin Transformer V2 encoder (Liu et
al., "Swin Transformer V2", CVPR 2022, arXiv:2111.09883; torchvision's
`swin_v2_b` and its `shifted_window_attention`), then the FPN and the 1x1
head of `reference/sdnet.py`.

Functional float32 code over a state dict whose keys are the program's
(`encoder.features.*` in torchvision's layout, `encoder.norms.{0..3}`,
the FPN and head keys as `sdnet.param_specs` writes them), so the
benchmark hands one set of tensors to the program and to this file. It
imports nothing of the program. The window attention follows
torchvision step by step: pad the map with zeros to a multiple of the
window, roll odd blocks by half a window (not along a dimension whose
padded size is the window), partition, qkv (its k third of the bias held
at zero), scaled cosine attention, the continuous position bias, the
-100 mask of the shifted regions, softmax, proj, reverse, roll back,
crop. Departures from torchvision's classifier, as the configuration
file lists them: a LayerNorm on each stage's output (the detection
backbones' form) and no stochastic depth.

`quant` (the fp8 control) rounds each Linear's input and weight to float8
e4m3 at a per-tensor scale before it runs (`sdnet.fp8_round`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from .sdnet import Net, Spec, _bn, _conv, no_tf32, normalize_uint8

# torchvision swin_v2_b: patch 4, embed 128, depths (2, 2, 18, 2), heads
# (4, 8, 16, 32), window 8, MLP ratio 4
ARCHS = {"swin_v2_b": {"embed": 128, "depths": (2, 2, 18, 2), "heads": (4, 8, 16, 32),
                       "window": 8, "mlp_ratio": 4, "patch": 4}}
CPB_HIDDEN = 512
HEATMAP_BIAS = 0.0  # as `sdbench/weights.py`: every image fills the decode's budget


def arch_of(config: dict) -> dict:
    """The encoder's sizes as a configuration file states them."""
    return {"embed": config["embed_dim"], "depths": tuple(config["depths"]),
            "heads": tuple(config["num_heads"]), "window": config["window_size"],
            "mlp_ratio": config["mlp_ratio"], "patch": config["patch_size"]}


def widths(arch: dict) -> List[int]:
    return [arch["embed"] * 2 ** i for i in range(len(arch["depths"]))]


def _linear(key: str, cin: int, cout: int, bias: bool = True) -> List[Spec]:
    out = [(f"{key}.weight", (cout, cin), "linear")]
    if bias:
        out.append((f"{key}.bias", (cout,), "bias"))
    return out


def _ln(key: str, c: int) -> List[Spec]:
    return [(f"{key}.weight", (c,), "ln_weight"), (f"{key}.bias", (c,), "ln_bias")]


def param_specs(arch: dict, fpn_depth: int, n_out: int, in_channels: int = 3) -> List[Spec]:
    """Every tensor of the state dict, in module order."""
    c, p = arch["embed"], arch["patch"]
    specs = _conv("encoder.features.0.0", in_channels, c, p, True)
    specs += _ln("encoder.features.0.2", c)
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["heads"])):
        dim = c * 2 ** i
        if i > 0:
            key = f"encoder.features.{2 * i}"
            specs += _linear(f"{key}.reduction", 2 * dim, dim, bias=False) + _ln(f"{key}.norm", dim)
        for j in range(depth):
            key = f"encoder.features.{2 * i + 1}.{j}"
            specs += _ln(f"{key}.norm1", dim)
            specs.append((f"{key}.attn.logit_scale", (heads, 1, 1), "logit_scale"))
            specs += _linear(f"{key}.attn.qkv", dim, 3 * dim) + _linear(f"{key}.attn.proj", dim, dim)
            specs += _linear(f"{key}.attn.cpb_mlp.0", 2, CPB_HIDDEN)
            specs += _linear(f"{key}.attn.cpb_mlp.2", CPB_HIDDEN, heads, bias=False)
            specs += _ln(f"{key}.norm2", dim)
            hidden = arch["mlp_ratio"] * dim
            specs += _linear(f"{key}.mlp.0", dim, hidden) + _linear(f"{key}.mlp.3", hidden, dim)
    for i, dim in enumerate(widths(arch)):
        specs += _ln(f"encoder.norms.{i}", dim)
    c2, c3, c4, c5 = widths(arch)
    specs += _conv("up1", c5, fpn_depth, 1, True)
    for k, skip in ((2, c4), (3, c3), (4, c2)):
        specs += _conv(f"up{k}.lateral", skip, fpn_depth, 1, True)
        specs += _conv(f"up{k}.conv.0", fpn_depth, fpn_depth, 3, False)
        specs += _bn(f"up{k}.conv.1", fpn_depth)
    specs += _conv("head.conv", fpn_depth, n_out, 1, True)
    return specs


def make_state_dict(arch: dict, fpn_depth: int, n_out: int, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """Seeded weights, made on the device in a few large calls, as
    `sdbench/weights.py` makes them: one generator seeded by the run's
    seed draws one normal vector for the convolution and Linear weights
    and one for the other vectors. Convolutions and Linears LeCun-normal
    (standard deviation 1 / sqrt(fan_in)), biases 0.1 N, LayerNorm scales
    1 + 0.1 N and shifts 0.1 N, logit scales ln 10 + 0.1 N, BatchNorm as
    `weights.py` (running variances exp(0.2 N)), the head's heatmap
    biases 0."""
    specs = param_specs(arch, fpn_depth, n_out)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    matrix = ("conv", "linear")
    n_mat = sum(math.prod(s) for _, s, kind in specs if kind in matrix)
    n_vec = sum(math.prod(s) for _, s, kind in specs if kind not in matrix + ("count",))
    mat = torch.randn(n_mat, generator=gen, device=device)
    vec = torch.randn(n_vec, generator=gen, device=device)
    sd, im, iv = {}, 0, 0
    for key, shape, kind in specs:
        n = math.prod(shape)
        if kind in matrix:
            sd[key] = mat[im:im + n].view(shape) * (1.0 / math.sqrt(n // shape[0]))
            im += n
        elif kind == "count":
            sd[key] = torch.zeros((), dtype=torch.long, device=device)
        else:
            v = vec[iv:iv + n].view(shape)
            iv += n
            sd[key] = {"bias": 0.1 * v, "bn_weight": 1.0 + 0.1 * v, "bn_bias": 0.1 * v,
                       "bn_mean": 0.1 * v, "bn_var": torch.exp(0.2 * v),
                       "ln_weight": 1.0 + 0.1 * v, "ln_bias": 0.1 * v,
                       "logit_scale": math.log(10.0) + 0.1 * v}[kind]
    sd["head.conv.bias"][:n_out - 4] = HEATMAP_BIAS
    return sd


def _coords_table(window: int, device) -> torch.Tensor:
    r = torch.arange(-(window - 1), window, dtype=torch.float32, device=device)
    t = torch.stack(torch.meshgrid([r, r], indexing="ij")).permute(1, 2, 0).contiguous()
    t[:, :, 0] /= window - 1
    t[:, :, 1] /= window - 1
    t *= 8
    return torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / 3.0


def _position_index(window: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).flatten().to(device)


class SwinNet:
    """The forward over a state dict `sd` (float32 tensors) of the
    architecture `arch`. `train`: batch statistics in the FPN's BatchNorms,
    else the running ones. `quant`: a rounding applied to each Linear's
    input and weight (None: float32)."""

    def __init__(self, sd: Dict[str, torch.Tensor], arch: dict, train: bool = False,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.sd, self.arch, self.quant = sd, arch, quant
        self.fpn = Net(sd, "swin", train=train)
        device = next(iter(sd.values())).device
        self.table = _coords_table(arch["window"], device)
        self.index = _position_index(arch["window"], device)

    def linear(self, x, key, bias=None):
        w = self.sd[f"{key}.weight"]
        b = self.sd.get(f"{key}.bias") if bias is None else bias
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.linear(x, w, b)

    def ln(self, x, key):
        c = x.shape[-1]
        return F.layer_norm(x, (c,), self.sd[f"{key}.weight"], self.sd[f"{key}.bias"], 1e-5)

    def attention(self, x, key, heads, odd):
        sd, ws = self.sd, self.arch["window"]
        b, h, w, c = x.shape
        pad_r, pad_b = (ws - w % ws) % ws, (ws - h % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        _, ph, pw, _ = x.shape
        shift = [ws // 2 if odd else 0] * 2
        if ws >= ph:
            shift[0] = 0
        if ws >= pw:
            shift[1] = 0
        if sum(shift) > 0:
            x = torch.roll(x, shifts=(-shift[0], -shift[1]), dims=(1, 2))
        n_win = (ph // ws) * (pw // ws)
        x = x.view(b, ph // ws, ws, pw // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b * n_win, ws * ws, c)
        qkv_bias = sd[f"{key}.qkv.bias"].clone()
        qkv_bias[c:2 * c] = 0
        qkv = self.linear(x, f"{key}.qkv", qkv_bias)
        qkv = qkv.reshape(x.size(0), x.size(1), 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
        attn = attn * torch.clamp(sd[f"{key}.logit_scale"], max=math.log(100.0)).exp()
        table = self.linear(F.relu(self.linear(self.table, f"{key}.cpb_mlp.0")),
                            f"{key}.cpb_mlp.2").view(-1, heads)
        n = ws * ws
        bias = table[self.index].view(n, n, -1).permute(2, 0, 1).contiguous().unsqueeze(0)
        attn = attn + 16 * torch.sigmoid(bias)
        if sum(shift) > 0:
            mask = x.new_zeros((ph, pw))
            h_slices = ((0, -ws), (-ws, -shift[0]), (-shift[0], None))
            w_slices = ((0, -ws), (-ws, -shift[1]), (-shift[1], None))
            count = 0
            for hs in h_slices:
                for wsl in w_slices:
                    mask[hs[0]:hs[1], wsl[0]:wsl[1]] = count
                    count += 1
            mask = mask.view(ph // ws, ws, pw // ws, ws).permute(0, 2, 1, 3).reshape(n_win, n)
            mask = mask.unsqueeze(1) - mask.unsqueeze(2)
            mask = mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)
            attn = attn.view(b, n_win, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, heads, n, n)
        attn = F.softmax(attn, dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(x.size(0), x.size(1), c)
        x = self.linear(x, f"{key}.proj")
        x = x.view(b, ph // ws, pw // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, c)
        if sum(shift) > 0:
            x = torch.roll(x, shifts=(shift[0], shift[1]), dims=(1, 2))
        return x[:, :h, :w, :].contiguous()

    def block(self, x, key, heads, odd):
        x = x + self.ln(self.attention(x, f"{key}.attn", heads, odd), f"{key}.norm1")
        y = self.linear(F.gelu(self.linear(x, f"{key}.mlp.0")), f"{key}.mlp.3")
        return x + self.ln(y, f"{key}.norm2")

    def merge(self, x, key):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.ln(self.linear(x, f"{key}.reduction"), f"{key}.norm")

    def encode(self, x):
        """(B, 3, H, W) normalized -> [C2, C3, C4, C5] NCHW."""
        p = self.arch["patch"]
        x = F.conv2d(x, self.sd["encoder.features.0.0.weight"],
                     self.sd["encoder.features.0.0.bias"], stride=p)
        x = self.ln(x.permute(0, 2, 3, 1), "encoder.features.0.2")
        outs = []
        for i, (depth, heads) in enumerate(zip(self.arch["depths"], self.arch["heads"])):
            if i > 0:
                x = self.merge(x, f"encoder.features.{2 * i}")
            for j in range(depth):
                x = self.block(x, f"encoder.features.{2 * i + 1}.{j}", heads, j % 2 == 1)
            outs.append(self.ln(x, f"encoder.norms.{i}").permute(0, 3, 1, 2))
        return outs

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalized float32 -> (B, n_out, H/4, W/4) logits."""
        c2, c3, c4, c5 = self.encode(x)
        net = self.fpn
        f = net.conv(c5, "up1")
        for k, skip in ((2, c4), (3, c3), (4, c2)):
            f = F.interpolate(f, scale_factor=2, mode="nearest") + net.conv(skip, f"up{k}.lateral")
            f = F.relu(net.bn(net.conv(f, f"up{k}.conv.0", 1, 1), f"up{k}.conv.1"))
        return net.conv(f, "head.conv")


@torch.no_grad()
def infer_heads(sd, arch: dict, images_u8: torch.Tensor, block: int = 32,
                quant=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, n_out, H/4, W/4) float32 logits, in
    blocks of `block` images."""
    net = SwinNet(sd, arch, train=False, quant=quant)
    outs = []
    with no_tf32():
        for s in range(0, images_u8.shape[0], block):
            outs.append(net(normalize_uint8(images_u8[s:s + block])))
    return torch.cat(outs)
