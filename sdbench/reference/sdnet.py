"""The plain reference of the SDNet forward: ResNet-34 or ResNet-50 encoder
(He et al. 2016, arXiv:1512.03385, Table 1; ResNet-50 in torchvision's v1.5
form, the stride on the 3x3), FPN and a 1x1 head, as laclouis5/
StructureDetector `src/sdnet/model/network.py:32-87` defines it.

Functional float32 code over a state dict whose keys are the reference's
module names (`adpater.*`, `down{1..4}.*`, `up{1..4}.*`, `head.conv.*`),
so the benchmark hands one set of tensors to the program and to this file.
It imports nothing of the program. `param_specs` lists every tensor of that
state dict with its shape and kind; `forward` runs it, with TF32 off on the
card. `quant` (the fp8 control) rounds each convolution's input and weight
to float8 e4m3 at a per-tensor scale before it runs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGE_WIDTHS = (64, 128, 256, 512)
# backbone -> (bottleneck blocks?, blocks per stage)
ARCHS = {"resnet34": (False, (3, 4, 6, 3)), "resnet50": (True, (3, 4, 6, 3))}

Spec = Tuple[str, Tuple[int, ...], str]  # (key, shape, kind)


def _conv(key: str, cin: int, cout: int, k: int, bias: bool) -> List[Spec]:
    out = [(f"{key}.weight", (cout, cin, k, k), "conv")]
    if bias:
        out.append((f"{key}.bias", (cout,), "bias"))
    return out


def _bn(key: str, c: int) -> List[Spec]:
    return [(f"{key}.weight", (c,), "bn_weight"), (f"{key}.bias", (c,), "bn_bias"),
            (f"{key}.running_mean", (c,), "bn_mean"), (f"{key}.running_var", (c,), "bn_var"),
            (f"{key}.num_batches_tracked", (), "count")]


def blocks(backbone: str):
    """(stage index, block index, in channels, width, stride, has projection)
    of every residual block, in order."""
    bottleneck, sizes = ARCHS[backbone]
    expansion = 4 if bottleneck else 1
    in_ch = 64
    out = []
    for i, (n, width) in enumerate(zip(sizes, STAGE_WIDTHS), start=1):
        for j in range(n):
            stride = 2 if (j == 0 and i > 1) else 1
            out_ch = width * expansion
            out.append((i, j, in_ch, width, stride, stride != 1 or in_ch != out_ch))
            in_ch = out_ch
    return out


def stage_channels(backbone: str) -> Tuple[int, ...]:
    bottleneck, _ = ARCHS[backbone]
    return tuple(w * (4 if bottleneck else 1) for w in STAGE_WIDTHS)


def param_specs(backbone: str, fpn_depth: int, n_out: int, in_channels: int = 3) -> List[Spec]:
    """Every tensor of the state dict, in module order."""
    bottleneck, _ = ARCHS[backbone]
    specs = _conv("adpater.0", in_channels, 64, 7, False) + _bn("adpater.1", 64)
    for i, j, cin, width, _, proj in blocks(backbone):
        key = f"down{i}.{j}"
        if bottleneck:
            out_ch = 4 * width
            specs += _conv(f"{key}.conv1", cin, width, 1, False) + _bn(f"{key}.bn1", width)
            specs += _conv(f"{key}.conv2", width, width, 3, False) + _bn(f"{key}.bn2", width)
            specs += _conv(f"{key}.conv3", width, out_ch, 1, False) + _bn(f"{key}.bn3", out_ch)
        else:
            out_ch = width
            specs += _conv(f"{key}.conv1", cin, width, 3, False) + _bn(f"{key}.bn1", width)
            specs += _conv(f"{key}.conv2", width, width, 3, False) + _bn(f"{key}.bn2", width)
        if proj:
            specs += (_conv(f"{key}.downsample.0", cin, out_ch, 1, False)
                      + _bn(f"{key}.downsample.1", out_ch))
    c2, c3, c4, c5 = stage_channels(backbone)
    specs += _conv("up1", c5, fpn_depth, 1, True)
    for k, skip in ((2, c4), (3, c3), (4, c2)):
        specs += _conv(f"up{k}.lateral", skip, fpn_depth, 1, True)
        specs += _conv(f"up{k}.conv.0", fpn_depth, fpn_depth, 3, False)
        specs += _bn(f"up{k}.conv.1", fpn_depth)
    specs += _conv("head.conv", fpn_depth, n_out, 1, True)
    return specs


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale (amax -> 448), back in
    x's dtype; gradients pass straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


class Net:
    """The forward over a state dict `sd` (float32 tensors). `train`: batch
    statistics in every BatchNorm (the running buffers are left alone),
    else the running ones. `quant`: a rounding applied to each
    convolution's input and weight (None: float32)."""

    def __init__(self, sd: Dict[str, torch.Tensor], backbone: str, train: bool = False,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.sd, self.backbone, self.train, self.quant = sd, backbone, train, quant

    def conv(self, x, key, stride=1, padding=0):
        w, b = self.sd[f"{key}.weight"], self.sd.get(f"{key}.bias")
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.conv2d(x, w, b, stride, padding)

    def bn(self, x, key):
        sd = self.sd
        if self.train:
            return F.batch_norm(x, None, None, sd[f"{key}.weight"], sd[f"{key}.bias"],
                                True, 0.0, 1e-5)
        return F.batch_norm(x, sd[f"{key}.running_mean"], sd[f"{key}.running_var"],
                            sd[f"{key}.weight"], sd[f"{key}.bias"], False, 0.0, 1e-5)

    def block(self, x, key, stride, proj):
        bottleneck, _ = ARCHS[self.backbone]
        identity = x
        if proj:
            identity = self.bn(self.conv(x, f"{key}.downsample.0", stride), f"{key}.downsample.1")
        if bottleneck:
            y = F.relu(self.bn(self.conv(x, f"{key}.conv1"), f"{key}.bn1"))
            y = F.relu(self.bn(self.conv(y, f"{key}.conv2", stride, 1), f"{key}.bn2"))
            y = self.bn(self.conv(y, f"{key}.conv3"), f"{key}.bn3")
        else:
            y = F.relu(self.bn(self.conv(x, f"{key}.conv1", stride, 1), f"{key}.bn1"))
            y = self.bn(self.conv(y, f"{key}.conv2", 1, 1), f"{key}.bn2")
        return F.relu(y + identity)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalized float32 -> (B, n_out, H/4, W/4) logits."""
        x = F.relu(self.bn(self.conv(x, "adpater.0", 2, 3), "adpater.1"))
        x = F.max_pool2d(x, 3, 2, 1)
        stages = []
        last = 1
        for i, j, _, _, stride, proj in blocks(self.backbone):
            if i != last:
                stages.append(x)
                last = i
            x = self.block(x, f"down{i}.{j}", stride, proj)
        c2, c3, c4 = stages
        f = self.conv(x, "up1")
        for k, skip in ((2, c4), (3, c3), (4, c2)):
            f = F.interpolate(f, scale_factor=2, mode="nearest") + self.conv(skip, f"up{k}.lateral")
            f = F.relu(self.bn(self.conv(f, f"up{k}.conv.0", 1, 1), f"up{k}.conv.1"))
        return self.conv(f, "head.conv")


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, H, W) ImageNet-normalized float32."""
    x = images.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def no_tf32():
    """float32 means float32 on the card: TF32 off in cuDNN and cuBLAS."""
    return _NoTF32()


class _NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


@torch.no_grad()
def infer_heads(sd, backbone: str, images_u8: torch.Tensor, block: int = 32,
                quant=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, n_out, H/4, W/4) float32 logits, in
    blocks of `block` images."""
    net = Net(sd, backbone, train=False, quant=quant)
    outs = []
    with no_tf32():
        for s in range(0, images_u8.shape[0], block):
            outs.append(net(normalize_uint8(images_u8[s:s + block])))
    return torch.cat(outs)
