"""Weights for the port's SDNet: reference-layout `.pth` files, the JAX
package's `.msgpack` checkpoints, and the carry-over between the two
layouts; the counterpart of JAX `models/torch_bridge.py` and
`models/torch_export.py`.

The port's modules use the reference's names (`adpater.{0,1}`,
`down1..4`, `up1`, `up{2,3,4}.{lateral,conv.0,conv.1}`, `head.conv`), so
a `.pth` written by the reference, or by the JAX package's
`save_reference_pth`, loads with `strict=True`, and the port writes one
the reference loads so (`save_reference_pth`, JAX
`torch_export.py:50-119`). A `.msgpack` written by
the JAX package's `save_params` (the trainer's `model_best_*.msgpack`)
is read without flax (`models.msgpack`) and mapped by
`state_dict_from_jax`. A checkpoint of another architecture (other
`fpn_depth`, labels, input channels, backbone, stem or head) raises a
`ValueError` that names the difference instead of loading partly; the
one adaptation is JAX `_adapt_stem`'s: a 7x7 stem kernel loads into a
space-to-depth stem through the exact `stem_kernel_to_s2d` rewrite
(`adapt_stem`).

`state_dict_from_jax` maps every variant of the JAX package's SDNet
(resnet18/34/50 blocks, the 4x4 stem kernel, `head_hidden`) as the
mapping in `structuredetector_tpu/models/torch_export.py` maps resnet34:
a `{'params', 'batch_stats'}` tree of numpy arrays (HWIO kernels)
becomes a state_dict (OIHW kernels); `jax_tree_from_state_dict` is its
inverse, so the port writes checkpoints the JAX package loads
(`save_msgpack`). A torchvision resnet18, resnet34 or resnet50 ImageNet
state_dict warm-starts the encoder (`load_imagenet_encoder`).
A Swin encoder (`models.swin`, `encoder.*` keys in torchvision's layout)
loads and saves as `.pth` only: the JAX package's `.msgpack` layout has
no Swin encoder, so writing or reading one for it raises a ValueError
naming the encoder, and the trainer's snapshots of a Swin model are
`.pth` (`save_snapshot`). A torchvision `swin_v2_b` state_dict
warm-starts its encoder.
Int8 state crosses too: a tree from JAX `prequantize_variables` (int8
HWIO kernels with `kernel_scale`) and from
`calibrate_activation_scales` (`act_scale`) maps onto the port's int8
OIHW weights and its `weight_scale` / `act_scale` buffers, exactly.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from . import msgpack
from .resnet import stem_kernel_to_s2d
from .swin import ARCHS as SWIN_ARCHS

STEM = "adpater.0.weight"
SWIN = "encoder.features."  # the key prefix of a Swin encoder's state


def swin_encoder(sd: Mapping[str, Any]) -> bool:
    """Whether a state_dict holds a Swin encoder (`models.swin`)."""
    return any(k.startswith(SWIN) for k in sd)


def no_msgpack(what: str) -> ValueError:
    return ValueError(f"{what}: the JAX package's .msgpack layout has no swin_v2_b "
                      "encoder; a Swin model is saved and loaded as .pth")


def _conv_oihw(kernel) -> torch.Tensor:
    """HWIO -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1))))


def _vec(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _put_conv(out: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    """A conv's kernel (float, or int8 from JAX `prequantize_variables`),
    its bias, and the int8 scales where the tree has them."""
    out[f"{prefix}.weight"] = _conv_oihw(p["kernel"])
    for src, dst in (("bias", "bias"), ("kernel_scale", "weight_scale"),
                     ("act_scale", "act_scale")):
        if src in p:
            out[f"{prefix}.{dst}"] = _vec(p[src])


def _put_bn(out: Dict[str, torch.Tensor], prefix: str,
            params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _vec(params["scale"])
    out[f"{prefix}.bias"] = _vec(params["bias"])
    out[f"{prefix}.running_mean"] = _vec(stats["mean"])
    out[f"{prefix}.running_var"] = _vec(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def state_dict_from_jax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX `{'params', 'batch_stats'}` tree (numpy leaves) -> the port's
    state_dict, for any backbone, stem and head of the JAX package: the
    blocks of each stage are the tree's `layer{s}_{b}`, with their
    `conv3`/`bn3` (Bottleneck) and downsample where the tree has them."""
    params, stats = tree["params"], tree["batch_stats"]
    enc_p, enc_s = params["encoder"], stats["encoder"]

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _put_conv(out, "adpater.0", enc_p["conv1"])
    _put_bn(out, "adpater.1", enc_p["bn1"], enc_s["bn1"])
    for stage_i in range(1, 5):
        n_blocks = sum(1 for k in enc_p if k.startswith(f"layer{stage_i}_"))
        for block in range(n_blocks):
            src, dst = f"layer{stage_i}_{block}", f"down{stage_i}.{block}"
            p, s = enc_p[src], enc_s[src]
            for i in (1, 2, 3):
                if f"conv{i}" in p:
                    _put_conv(out, f"{dst}.conv{i}", p[f"conv{i}"])
                    _put_bn(out, f"{dst}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if "downsample_conv" in p:
                _put_conv(out, f"{dst}.downsample.0", p["downsample_conv"])
                _put_bn(out, f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])

    _put_conv(out, "up1", params["up1"])
    for k in (2, 3, 4):
        blk_p, blk_s = params[f"up{k}"], stats[f"up{k}"]
        _put_conv(out, f"up{k}.lateral", blk_p["lateral"])
        _put_conv(out, f"up{k}.conv.0", blk_p["conv"])
        _put_bn(out, f"up{k}.conv.1", blk_p["bn"], blk_s["bn"])
    if "head_hidden" in params:
        _put_conv(out, "head_hidden", params["head_hidden"])
    _put_conv(out, "head.conv", params["head"])
    return out


def _hwio(w: torch.Tensor) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(w.detach().cpu().numpy(), (2, 3, 1, 0)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def jax_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict -> the JAX package's `{'params',
    'batch_stats'}` tree of numpy arrays; `state_dict_from_jax` inverts
    it. A Swin encoder raises: the tree has no layout for it."""
    if swin_encoder(sd):
        raise no_msgpack("save_msgpack")

    def conv(prefix):
        out = {"kernel": _hwio(sd[f"{prefix}.weight"])}
        for src, dst in (("weight_scale", "kernel_scale"), ("act_scale", "act_scale")):
            if f"{prefix}.{src}" in sd:
                out[dst] = _np(sd[f"{prefix}.{src}"])
        return out

    def bn(prefix):
        return ({"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])},
                {"mean": _np(sd[f"{prefix}.running_mean"]),
                 "var": _np(sd[f"{prefix}.running_var"])})

    enc_p: Dict[str, Any] = {"conv1": conv("adpater.0")}
    enc_s: Dict[str, Any] = {}
    enc_p["bn1"], enc_s["bn1"] = bn("adpater.1")
    for stage_i in range(1, 5):
        for block in _blocks(sd, stage_i):
            src, dst = f"down{stage_i}.{block}", f"layer{stage_i}_{block}"
            p, s = {}, {}
            for i in (1, 2, 3):
                if f"{src}.conv{i}.weight" in sd:
                    p[f"conv{i}"] = conv(f"{src}.conv{i}")
                    p[f"bn{i}"], s[f"bn{i}"] = bn(f"{src}.bn{i}")
            if f"{src}.downsample.0.weight" in sd:
                p["downsample_conv"] = conv(f"{src}.downsample.0")
                p["downsample_bn"], s["downsample_bn"] = bn(f"{src}.downsample.1")
            enc_p[dst], enc_s[dst] = p, s

    params: Dict[str, Any] = {"encoder": enc_p}
    stats: Dict[str, Any] = {"encoder": enc_s}
    params["up1"] = {**conv("up1"), "bias": _np(sd["up1.bias"])}
    for k in (2, 3, 4):
        blk_p = {"lateral": {**conv(f"up{k}.lateral"), "bias": _np(sd[f"up{k}.lateral.bias"])},
                 "conv": conv(f"up{k}.conv.0")}
        blk_p["bn"], blk_s = bn(f"up{k}.conv.1")
        params[f"up{k}"], stats[f"up{k}"] = blk_p, {"bn": blk_s}
    if "head_hidden.weight" in sd:
        params["head_hidden"] = {**conv("head_hidden"), "bias": _np(sd["head_hidden.bias"])}
    params["head"] = {**conv("head.conv"), "bias": _np(sd["head.conv.bias"])}
    return {"params": params, "batch_stats": stats}


def _blocks(sd: Mapping[str, Any], stage_i: int) -> list:
    """The block indices of stage `stage_i` (`down{stage_i}.{b}`) in `sd`."""
    return sorted({int(k.split(".")[1]) for k in sd if k.startswith(f"down{stage_i}.")})


def _architecture(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """What a state_dict says of the architecture it was saved from."""
    def dim(key, axis):
        return int(sd[key].shape[axis]) if key in sd else None

    stem = tuple(sd[STEM].shape[2:]) if STEM in sd else None
    swin = None
    if swin_encoder(sd):
        depths = tuple(len({k.split(".")[3] for k in sd if k.startswith(f"{SWIN}{i}.")})
                       for i in (1, 3, 5, 7))
        swin = (dim("encoder.features.0.0.weight", 0), depths)
    return {
        "encoder (resnet, or Swin V2 embed width and blocks per stage)": swin or "resnet",
        "fpn_depth": dim("up1.weight", 0),
        "head outputs (labels + parts + 4)": dim("head.conv.weight", 0),
        "input channels": None if stem is None
        else dim(STEM, 1) // (4 if stem == (4, 4) else 1),
        "stem kernel (7x7; 4x4 with --s2d_stem)": stem,
        "backbone blocks per stage (resnet18: 2, 2, 2, 2; resnet34, resnet50: 3, 4, 6, 3)":
        tuple(len(_blocks(sd, i)) for i in (1, 2, 3, 4)),
        "backbone block kind (resnet50: bottleneck)":
        "bottleneck" if any(".conv3." in k for k in sd) else "basic",
        "hidden head width (--head_conv)": dim("head_hidden.weight", 0) or 0,
        "head kernel": tuple(sd["head.conv.weight"].shape[2:]) if "head.conv.weight" in sd
        else "another head",
    }


def check_architecture(model: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                       source="checkpoint") -> None:
    """Raise a ValueError naming each way `sd` was saved from another
    architecture than `model`'s."""
    have, want = _architecture(sd), _architecture(model.state_dict())
    diffs = [f"{name}: {have[name]} in the {source}, {want[name]} in the model"
             for name in want if have[name] != want[name]]
    if diffs:
        raise ValueError(f"{source} is of another architecture than the model: "
                         + "; ".join(diffs))


def load_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A reference-layout state_dict from a `.pth`/`.pt` file or a JAX
    `.msgpack` checkpoint."""
    path = Path(path)
    if path.suffix == ".msgpack":
        return state_dict_from_jax(msgpack.loads(path.read_bytes()))
    if path.suffix not in {".pth", ".pt"}:
        raise ValueError(
            f"{path}: the port loads reference-layout torch .pth checkpoints "
            "and the JAX package's .msgpack checkpoints"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state_dict, got {type(sd).__name__}")
    return sd


def adapt_stem(sd: Mapping[str, torch.Tensor], model_sd: Mapping[str, torch.Tensor]):
    """`sd` with its stem kernel in the layout of the model whose
    state_dict is `model_sd` (JAX `network.py::_adapt_stem`): a 7x7
    kernel becomes the 4x4 kernel of a space-to-depth stem through
    `stem_kernel_to_s2d`; a 4x4 kernel for a 7x7 stem raises, since a
    trained s2d stem has no 7x7 form. Other shapes are left to
    `check_architecture` to name."""
    have, want = sd.get(STEM), model_sd.get(STEM)
    if have is None or want is None or have.shape == want.shape:
        return sd
    have_k, want_k = tuple(have.shape[2:]), tuple(want.shape[2:])
    if have_k == (7, 7) and want_k == (4, 4):
        return {**sd, STEM: _conv_oihw(stem_kernel_to_s2d(_hwio(have)))}
    if have_k == (4, 4) and want_k == (7, 7):
        raise ValueError(
            "This checkpoint was trained with --s2d_stem (4x4 stem kernel); "
            "pass --s2d_stem to load it. A trained s2d stem cannot be "
            "folded back into a 7x7/stride-2 conv."
        )
    return sd


def load_weights(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a `.pth` or `.msgpack` into `model` strictly, its stem kernel
    adapted (`adapt_stem`): another architecture raises a ValueError that
    names the difference; a missing, extra or differently shaped tensor
    beyond that raises too."""
    if Path(path).suffix == ".msgpack" and swin_encoder(model.state_dict()):
        raise no_msgpack(str(path))
    sd = adapt_stem(load_checkpoint(path), model.state_dict())
    check_architecture(model, sd, source=str(path))
    model.load_state_dict(sd, strict=True)
    return model


def save_msgpack(weights, path) -> Path:
    """Write a model's weights (the module or its state_dict) as the JAX
    package's `save_params` would: a `.msgpack` that JAX `load_params`
    and the port's `load_weights` read. The file is replaced atomically,
    so a reader never sees half of it."""
    path = Path(path)
    sd = weights.state_dict() if isinstance(weights, torch.nn.Module) else weights
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(msgpack.dumps(jax_tree_from_state_dict(sd)))
    os.replace(tmp, path)
    return path


def save_snapshot(weights, path) -> Path:
    """Write a model's weights (the module or its state_dict) at `path`
    plus the suffix its layout takes: `.msgpack` (`save_msgpack`), or
    `.pth` (`torch.save` of the state_dict on the CPU, replaced
    atomically) for a Swin encoder, which the `.msgpack` layout lacks.
    Returns the file written."""
    sd = weights.state_dict() if isinstance(weights, torch.nn.Module) else weights
    path = Path(path)
    if not swin_encoder(sd):
        return save_msgpack(sd, path.with_name(path.name + ".msgpack"))
    path = path.with_name(path.name + ".pth")
    tmp = path.with_name(path.name + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, tmp)
    os.replace(tmp, path)
    return path


def export_reference_state_dict(weights) -> "OrderedDict[str, torch.Tensor]":
    """A model's weights (the port's SDNet or its state_dict, whole: a
    sharded model's `ChannelPlan.full_state_dict`) as the reference's
    `Network` state_dict on the CPU, which it loads strictly (JAX
    `torch_export.py::export_sdnet_state_dict`): the port's keys, each
    `num_batches_tracked` a 0-d int64 0. Only the reference's model is
    written: `--head_conv`, resnet18 and resnet50 raise with JAX's
    reasons, a prequantized int8 model raises too."""
    sd = weights.state_dict() if isinstance(weights, torch.nn.Module) else weights
    if swin_encoder(sd):
        raise ValueError("the reference Network has a ResNet-34 encoder; a swin_v2_b "
                         "model has no reference-layout .pth")
    if "head_hidden.weight" in sd:
        raise ValueError(
            "--head_conv deep head has no reference counterpart; only the "
            "1x1 head is exportable to the reference layout"
        )
    if "head.conv.weight" not in sd:
        raise ValueError("unrecognized head structure")
    n_blocks = len(_blocks(sd, 1))
    if n_blocks != 3:
        raise ValueError(
            f"encoder has {n_blocks} layer1 blocks; only resnet34 (3) matches the "
            "reference Network"
        )
    if "down1.0.downsample.0.weight" in sd:
        raise ValueError("bottleneck (resnet50-style) encoder is not "
                         "representable in the reference layout")
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, value in sd.items():
        if key.endswith(".num_batches_tracked"):
            out[key] = torch.tensor(0, dtype=torch.long)
        elif not value.is_floating_point() or key.endswith("_scale"):
            raise ValueError(f"{key}: a prequantized int8 model has no reference "
                             "counterpart; export the float model")
        else:
            out[key] = value.detach().cpu().clone()
    return out


def save_reference_pth(weights, path) -> Path:
    """Write `export_reference_state_dict(weights)` with `torch.save`: a
    `.pth` the reference's `Network.load_state_dict` and the port's
    `load_weights` load strictly (JAX `torch_export.py::
    save_reference_pth`). The file is replaced atomically."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(export_reference_state_dict(weights), tmp)
    os.replace(tmp, path)
    return path


def find_imagenet_resnet34(backbone: str = "resnet34") -> Path:
    """A torchvision ImageNet checkpoint of `backbone` already on disk (the
    reference's `pretrained=True`, network.py:41; nothing is downloaded):
    `$SDNET_PRETRAINED` if set, else the first `<backbone>-*.pth` under
    `$TORCH_HOME/hub/checkpoints` (default `~/.cache/torch`), as JAX
    `torch_bridge.py::find_imagenet_resnet34` looks. Raises
    FileNotFoundError naming the place it looked."""
    explicit = os.environ.get("SDNET_PRETRAINED")
    if explicit:
        p = Path(explicit)
        if p.is_file():
            return p
        raise FileNotFoundError(f"$SDNET_PRETRAINED points at '{p}', which does not exist")
    torch_home = Path(os.environ.get("TORCH_HOME", Path.home() / ".cache" / "torch"))
    where = torch_home / "hub" / "checkpoints"
    hits = sorted(where.glob(f"{backbone}-*.pth"))
    if hits:
        return hits[0]
    raise FileNotFoundError(
        f"--pretrained: no ImageNet {backbone} checkpoint ({backbone}-*.pth) in {where}; "
        f"place torchvision's {backbone} weights there, or set $SDNET_PRETRAINED "
        "(or $TORCH_HOME), or pass a model with --load_model")


# the constants torchvision's Swin V2 keeps as buffers; the port builds them
_SWIN_CONSTANTS = ("relative_coords_table", "relative_position_index")


def _torchvision_arch(sd: Mapping[str, Any]) -> str:
    """Which torchvision resnet a state_dict is, as JAX
    `torch_bridge.py::_detect_arch` tells: Bottleneck blocks carry a
    `conv3`, resnet18 has no `layer1.2`; or which of the port's Swin V2
    encoders (`models.swin.ARCHS`: embed width, blocks per stage) it is."""
    if "features.1.0.attn.cpb_mlp.0.weight" in sd:
        embed = int(sd["features.0.0.weight"].shape[0])
        depths = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"features.{i}.")})
                       for i in (1, 3, 5, 7))
        for name, spec in SWIN_ARCHS.items():
            if (spec.embed, spec.depths) == (embed, depths):
                return name
        raise ValueError(f"a torchvision Swin V2 of embed {embed} and blocks {depths}: the "
                         f"port's Swin encoders are {sorted(SWIN_ARCHS)}")
    if "layer1.0.conv3.weight" in sd:
        return "resnet50"
    if "layer1.2.conv1.weight" in sd:
        return "resnet34"
    if "layer1.0.conv1.weight" in sd:
        return "resnet18"
    raise ValueError("not a torchvision resnet state_dict (no layer1.0.conv1)")


def load_imagenet_encoder(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a torchvision resnet18, resnet34 or resnet50 state_dict into
    the SDNet's encoder (`conv1`/`bn1` -> `adpater.{0,1}`, `layer{i}` ->
    `down{i}`; `fc` is dropped; a 7x7 stem into an `--s2d_stem` model
    through `adapt_stem`), or a torchvision `swin_v2_b` one into a Swin
    encoder (`features.*` -> `encoder.features.*`, the classifier's final
    `norm` -> C5's `encoder.norms.3`; `head` and the table and index
    buffers are dropped, C2..C4's norms keep their values). The family
    must be the model's backbone and every encoder tensor must be there
    (`num_batches_tracked` may not); the FPN and the head keep their
    values."""
    src = torch.load(path, map_location="cpu", weights_only=True)
    arch = _torchvision_arch(src)
    if arch != model.backbone:
        raise ValueError(f"{path} is a torchvision {arch}, the model's backbone is "
                         f"{model.backbone} (--backbone)")
    sd = {}
    for key, value in src.items():
        head, _, rest = key.partition(".")
        if model.swin:
            if head == "features" and not key.endswith(_SWIN_CONSTANTS):
                sd[f"encoder.{key}"] = value
            elif head == "norm":
                sd[f"encoder.norms.3.{rest}"] = value
        elif head == "conv1":
            sd[f"adpater.0.{rest}"] = value
        elif head == "bn1":
            sd[f"adpater.1.{rest}"] = value
        elif head.startswith("layer"):
            sd[f"down{head[5:]}.{rest}"] = value
    model_sd = model.state_dict()
    sd = adapt_stem(sd, model_sd)
    # torchvision's published checkpoints predate `num_batches_tracked`,
    # which JAX's bridge does not read either
    encoder = {k for k in model_sd if k.startswith(("adpater.", "down", "encoder."))
               and not k.startswith(("encoder.norms.0.", "encoder.norms.1.", "encoder.norms.2."))}
    missing = sorted(k for k in encoder - set(sd) if not k.endswith(".num_batches_tracked"))
    extra = sorted(set(sd) - encoder)
    if missing or extra:
        raise ValueError(f"{path} is not a torchvision {arch}: missing {missing[:4]}, "
                         f"unexpected {extra[:4]}")
    model.load_state_dict(sd, strict=False)
    return model
