"""Int8 inference convolutions.

The port of `structuredetector_tpu/models/quantize.py`:

- weights: symmetric int8 per output channel, scale = amax / 127 (an
  all-zero channel gets scale 1 / 127), quantized at call time or once
  by `prequantize_variables`;
- activations: symmetric int8 per SAMPLE, each batch element scaled by
  its own amax over (C, H, W), so one loud request cannot coarsen its
  batchmates' quantization; or a static `act_scale` baked by
  `calibrate_activation_scales`;
- int8 x int8 -> int32 accumulation, dequantized as
  `y * (x_scale * w_scale)`, then `+ bias`, then cast to the compute
  dtype, in the JAX order (`quantize.py:140-143`).

`Int8Conv2d` is an `nn.Conv2d` whose state_dict keys stay `weight` and
`bias`, so float checkpoints load unchanged; `weight_scale` and
`act_scale` are optional buffers. Inference only: a train-mode SDNet
with int8 convs raises (`models.network.SDNet.forward`).

The product. The JAX package leaves it to XLA's convolution with int32
accumulation (`quantize.py:132-139`), outside any Pallas kernel; the
port leaves it to the library too: an int8 im2col built from
`Tensor.unfold` views of the zero-padded NHWC int8 input (columns in
(kh, kw, Cin) order, as the weight reshape), then `torch._int_mm`
(cuBLASLt's int8 GEMM on the card). A float im2col (`F.unfold`) would
move four times the bytes. `_int_mm` on CUDA refuses M of 16 rows or
fewer and K or N off a multiple of 8 (PyTorch's checks), and cuBLASLt
refuses some M that are not multiples of 32 (measured on an H100 with
torch 2.11: K 64, N 32 at M 17, 20, 24, 40, 48; `chip_smoke.py`'s `int8`
phase). So the wrapper pads K and N with zero columns, and each
sample's rows with zero rows to a multiple of 32 where its output map
is not one: the sums stay exact. The decisions depend on the map and
channel sizes only, never on the batch, so a `torch.export` trace with
a symbolic batch keeps them. At 512x512 every map is a multiple of 32
pixels and nothing is padded.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round `x / scale` to int8 (ties to even), clipped to [-127, 127]."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, with an all-zero range at 1 / 127. The divisor is a
    tensor: CUDA divides by a Python scalar as a multiply by its
    reciprocal, an ulp off the true quotient that the CPU and XLA give."""
    one = torch.ones_like(amax)
    return torch.where(amax > 0, amax, one) / (127.0 * one)


def weight_qparams(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(OIHW float weight) -> (int8 weight, per-Cout float32 scale)."""
    w = weight.float()
    scale = scale_of(w.abs().amax(dim=(1, 2, 3)))
    return quantize_symmetric(w, scale.view(-1, 1, 1, 1)), scale


def int8_conv_nhwc(x_q: torch.Tensor, w_q: torch.Tensor, stride, padding) -> torch.Tensor:
    """(B, H, W, Cin) int8 input, (Cout, Cin, kh, kw) int8 weight ->
    (B, Ho, Wo, Cout) int32 sums, exact: an int8 im2col and
    `torch._int_mm`."""
    b, h, w, cin = x_q.shape
    cout, _, kh, kw = w_q.shape
    (sh, sw), (ph, pw) = stride, padding
    if ph or pw:
        x_q = F.pad(x_q, (0, 0, pw, pw, ph, ph))
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    if kh == kw == 1:
        cols = x_q[:, ::sh, ::sw, :]
    else:
        # (B, Ho, Wo, Cin, kh, kw) windows -> columns in (kh, kw, Cin) order
        cols = x_q.unfold(1, kh, sh).unfold(2, kw, sw).permute(0, 1, 2, 4, 5, 3)
    k, hw = kh * kw * cin, ho * wo
    wmat = w_q.permute(0, 2, 3, 1).reshape(cout, k)
    k_pad, n_pad, row_pad = -k % 8, -cout % 8, -hw % 32
    cols = cols.reshape(b, hw, k)
    if k_pad or row_pad:
        cols = F.pad(cols, (0, k_pad, 0, row_pad))
    if k_pad or n_pad:
        wmat = F.pad(wmat, (0, k_pad, 0, n_pad))
    acc = torch._int_mm(cols.reshape(b * (hw + row_pad), k + k_pad), wmat.t().contiguous())
    return acc.reshape(b, hw + row_pad, cout + n_pad)[:, :hw, :cout].reshape(b, ho, wo, cout)


def int8_conv_reference(x_q: torch.Tensor, w_q: torch.Tensor, stride, padding) -> torch.Tensor:
    """Plain version of `int8_conv_nhwc`: a float64 convolution of the
    int8 values. Every product and partial sum is an integer below 2^53,
    so it is exact (float32 is not: 3 * 3 * 512 products of 127 * 127
    pass its 2^24)."""
    y = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.double(), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1).to(torch.int32)


class Int8Conv2d(nn.Conv2d):
    """Inference-only conv: per-sample dynamic (or calibrated static) int8
    activations x per-channel int8 weights -> int32 sums -> dequant, the
    computation of JAX `Int8Conv.__call__` (`quantize.py:70-143`) in
    NCHW. `out_dtype` is the model's compute dtype."""

    def __init__(self, *args, out_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.dilation != (1, 1) or self.padding_mode != "zeros" \
                or isinstance(self.padding, str):
            raise ValueError("Int8Conv2d takes ungrouped, undilated convs with integer "
                             "zero padding")
        self.out_dtype = out_dtype
        self.register_buffer("weight_scale", None)
        self.register_buffer("act_scale", None)
        self.calibrating = False  # record the input amax (calibrate_activation_scales)
        self.act_amax = None

    @classmethod
    def from_conv(cls, conv: nn.Conv2d, out_dtype: torch.dtype) -> "Int8Conv2d":
        q = cls(conv.in_channels, conv.out_channels, conv.kernel_size, stride=conv.stride,
                padding=conv.padding, bias=conv.bias is not None, out_dtype=out_dtype)
        q.weight, q.bias = conv.weight, conv.bias
        return q

    def int8_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.weight.dtype == torch.int8:  # prequantize_variables
            return self.weight, self.weight_scale
        return weight_qparams(self.weight)

    def quantize_input(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, H, W) -> (int8 x, its scale: (B, 1, 1, 1) per sample,
        or the static 0-d `act_scale`)."""
        x = x.float()
        if self.act_scale is not None:
            scale = self.act_scale
        else:
            amax = x.abs().amax(dim=(1, 2, 3))
            if self.calibrating:
                top = amax.max()
                self.act_amax = top if self.act_amax is None else torch.maximum(self.act_amax, top)
            scale = scale_of(amax).view(-1, 1, 1, 1)
        return quantize_symmetric(x, scale), scale

    def accumulate(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, C, H, W) -> ((B, Ho, Wo, Cout) int32 sums, x scale, w scale)."""
        x_q, x_scale = self.quantize_input(x)
        w_q, w_scale = self.int8_weight()
        acc = int8_conv_nhwc(x_q.permute(0, 2, 3, 1), w_q, self.stride, self.padding)
        return acc, x_scale, w_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc, x_scale, w_scale = self.accumulate(x)
        y = acc.float()
        y.mul_(x_scale * w_scale)  # x_scale (B, 1, 1, 1) or 0-d; w_scale on Cout
        if self.bias is not None:
            y.add_(self.bias)
        return y.to(self.out_dtype).permute(0, 3, 1, 2)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """Take int8 weights with their `weight_scale`, and `act_scale`,
        from a prequantized or calibrated state (and float weights into a
        prequantized module): the parameter and buffers follow the
        checkpoint's dtype and keys."""
        w = state_dict.get(prefix + "weight")
        if w is not None and w.dtype != self.weight.dtype:
            self.weight = nn.Parameter(torch.empty_like(w, device=self.weight.device),
                                       requires_grad=w.is_floating_point())
        for name in ("weight_scale", "act_scale"):
            if prefix + name in state_dict and getattr(self, name) is None:
                setattr(self, name, torch.empty_like(state_dict[prefix + name],
                                                     device=self.weight.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _int8_eligible(name: str) -> bool:
    """Whether the SDNet conv at module path `name` runs int8: every
    residual-block conv (Bottleneck `conv3` and downsamples included) and
    every FPN conv. The stem (`adpater`, in either form, whatever the
    conv's path inside it), the hidden head (`head_hidden`) and the head
    (`head.conv`) stay float: JAX builds them as `nn.Conv`
    (`resnet.py:186-195`, `network.py:176-180,201-203`)."""
    return name.partition(".")[0] not in ("adpater", "head_hidden", "head")


def swap_int8_convs(model: nn.Module, out_dtype: torch.dtype) -> nn.Module:
    """Replace every int8-eligible `nn.Conv2d` of an SDNet by an
    `Int8Conv2d` with the same parameters, in place (module order and
    names unchanged, so seeded init and checkpoints see the same model)."""
    for name, module in list(model.named_modules()):
        if type(module) is nn.Conv2d and _int8_eligible(name):
            parent, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent), child, Int8Conv2d.from_conv(module, out_dtype))
    return model


def int8_convs(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, Int8Conv2d)]


def prequantize_variables(model: nn.Module) -> nn.Module:
    """Quantize the weights of every `Int8Conv2d` once, in place: the
    weight becomes int8 with its per-Cout `weight_scale` beside it, so the
    forward skips the per-call quantization (and an exported program
    carries a quarter of the weight bytes). Bit-identical to the dynamic
    path. Returns the model."""
    with torch.no_grad():
        for m in int8_convs(model):
            if m.weight.dtype != torch.int8:
                w_q, scale = weight_qparams(m.weight)
                m.weight = nn.Parameter(w_q, requires_grad=False)
                m.weight_scale = scale
    return model


def calibrate_activation_scales(model: nn.Module, batches: Iterable[torch.Tensor]) -> nn.Module:
    """Bake static per-conv activation scales, in place (JAX
    `quantize.py:188-247`). Old scales are stripped first; each batch
    (B, C, H, W), normalized as at serving time and on the model's
    device, runs through the dynamically quantized model while every
    `Int8Conv2d` records the largest |input| it sees; the running max
    over batches becomes its `act_scale` (amax / 127). Raises when the
    model has no int8 conv or no batch comes. Returns the model."""
    convs = int8_convs(model)
    for m in convs:
        m.act_scale, m.act_amax, m.calibrating = None, None, True
    seen = False
    try:
        with torch.inference_mode():
            for x in batches:
                if not convs:
                    raise ValueError("nothing to calibrate: the model has no Int8Conv2d "
                                     "running dynamic quantization (build it with "
                                     "config.int8=True)")
                model(x, raw_output=True)
                seen = True
    finally:
        for m in convs:
            m.calibrating = False
    if not seen:
        raise ValueError("calibration needs at least one batch")
    for m in convs:
        m.act_scale = scale_of(m.act_amax.float().clone())  # clone: not an inference tensor
        m.act_amax = None
    return model
