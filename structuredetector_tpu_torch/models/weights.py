"""Weights for the port's SDNet: reference-layout `.pth` files, the JAX
package's `.msgpack` checkpoints, and the carry-over between the two
layouts.

The port's modules use the reference's names (`adpater.{0,1}`,
`down1..4`, `up1`, `up{2,3,4}.{lateral,conv.0,conv.1}`, `head.conv`), so
a `.pth` written by the reference, or by the JAX package's
`save_reference_pth`, loads with `strict=True`. A `.msgpack` written by
the JAX package's `save_params` (the trainer's `model_best_*.msgpack`)
is read without flax (`models.msgpack`) and mapped by
`state_dict_from_jax`. A checkpoint of another architecture (other
`fpn_depth`, labels, input channels, backbone or head) raises a
`ValueError` that names the difference instead of loading partly.

`state_dict_from_jax` is the port's own copy of the mapping in
`structuredetector_tpu/models/torch_export.py`: a
`{'params', 'batch_stats'}` tree of numpy arrays (HWIO kernels) becomes
a state_dict (OIHW kernels); `jax_tree_from_state_dict` is its inverse,
so the port writes checkpoints the JAX package loads (`save_msgpack`).
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
from .resnet import STAGE_SIZES


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
    state_dict. Only the reference architecture maps: resnet34 encoder,
    1x1 head."""
    params, stats = tree["params"], tree["batch_stats"]
    enc_p, enc_s = params["encoder"], stats["encoder"]
    if "head_hidden" in params or "kernel" not in params["head"]:
        raise ValueError("only the reference's single 1x1 head maps to the port's SDNet")
    n_blocks = sum(1 for k in enc_p if k.startswith("layer1_"))
    if n_blocks != STAGE_SIZES[0] or "downsample_conv" in enc_p.get("layer1_0", {}):
        raise ValueError("only the resnet34 encoder maps to the port's SDNet")

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _put_conv(out, "adpater.0", enc_p["conv1"])
    _put_bn(out, "adpater.1", enc_p["bn1"], enc_s["bn1"])
    for stage_i, n in enumerate(STAGE_SIZES):
        for block in range(n):
            src, dst = f"layer{stage_i + 1}_{block}", f"down{stage_i + 1}.{block}"
            p, s = enc_p[src], enc_s[src]
            _put_conv(out, f"{dst}.conv1", p["conv1"])
            _put_bn(out, f"{dst}.bn1", p["bn1"], s["bn1"])
            _put_conv(out, f"{dst}.conv2", p["conv2"])
            _put_bn(out, f"{dst}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                _put_conv(out, f"{dst}.downsample.0", p["downsample_conv"])
                _put_bn(out, f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])

    _put_conv(out, "up1", params["up1"])
    for k in (2, 3, 4):
        blk_p, blk_s = params[f"up{k}"], stats[f"up{k}"]
        _put_conv(out, f"up{k}.lateral", blk_p["lateral"])
        _put_conv(out, f"up{k}.conv.0", blk_p["conv"])
        _put_bn(out, f"up{k}.conv.1", blk_p["bn"], blk_s["bn"])
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
    it."""

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
    for stage_i, n in enumerate(STAGE_SIZES):
        for block in range(n):
            src, dst = f"down{stage_i + 1}.{block}", f"layer{stage_i + 1}_{block}"
            p, s = {"conv1": conv(f"{src}.conv1"), "conv2": conv(f"{src}.conv2")}, {}
            p["bn1"], s["bn1"] = bn(f"{src}.bn1")
            p["bn2"], s["bn2"] = bn(f"{src}.bn2")
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
    params["head"] = {**conv("head.conv"), "bias": _np(sd["head.conv.bias"])}
    return {"params": params, "batch_stats": stats}


def _architecture(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """What a state_dict says of the architecture it was saved from."""
    def dim(key, axis):
        return int(sd[key].shape[axis]) if key in sd else None

    blocks = tuple(
        len({k.split(".")[1] for k in sd if k.startswith(f"down{i}.")}) for i in (1, 2, 3, 4))
    return {
        "fpn_depth": dim("up1.weight", 0),
        "head outputs (labels + parts + 4)": dim("head.conv.weight", 0),
        "input channels": dim("adpater.0.weight", 1),
        "backbone blocks per stage (resnet34: 3, 4, 6, 3)": blocks,
        "backbone block kind": "bottleneck" if any(".conv3." in k for k in sd) else "basic",
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


def load_weights(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a `.pth` or `.msgpack` into `model` strictly: another
    architecture raises a ValueError that names the difference; a
    missing, extra or differently shaped tensor beyond that raises
    too."""
    sd = load_checkpoint(path)
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


def find_imagenet_resnet34() -> Path:
    """A torchvision ImageNet resnet34 checkpoint already on disk (the
    reference's `pretrained=True`, network.py:41; nothing is downloaded):
    `$SDNET_PRETRAINED` if set, else the first `resnet34-*.pth` under
    `$TORCH_HOME/hub/checkpoints` (default `~/.cache/torch`). Raises
    FileNotFoundError naming the place it looked."""
    explicit = os.environ.get("SDNET_PRETRAINED")
    if explicit:
        p = Path(explicit)
        if p.is_file():
            return p
        raise FileNotFoundError(f"$SDNET_PRETRAINED points at '{p}', which does not exist")
    torch_home = Path(os.environ.get("TORCH_HOME", Path.home() / ".cache" / "torch"))
    where = torch_home / "hub" / "checkpoints"
    hits = sorted(where.glob("resnet34-*.pth"))
    if hits:
        return hits[0]
    raise FileNotFoundError(
        f"--pretrained: no ImageNet resnet34 checkpoint (resnet34-*.pth) in {where}; "
        "place torchvision's resnet34 weights there, or set $SDNET_PRETRAINED "
        "(or $TORCH_HOME), or pass a model with --load_model")


def load_imagenet_encoder(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a torchvision resnet34 state_dict into the SDNet's encoder
    (`conv1`/`bn1` -> `adpater.{0,1}`, `layer{i}` -> `down{i}`; `fc` is
    dropped). Every encoder tensor must be there; the FPN and the head
    keep their values."""
    src = torch.load(path, map_location="cpu", weights_only=True)
    sd = {}
    for key, value in src.items():
        head, _, rest = key.partition(".")
        if head == "conv1":
            sd[f"adpater.0.{rest}"] = value
        elif head == "bn1":
            sd[f"adpater.1.{rest}"] = value
        elif head.startswith("layer"):
            sd[f"down{head[5:]}.{rest}"] = value
    encoder = {k for k in model.state_dict() if k.startswith(("adpater.", "down"))}
    missing = sorted(encoder - set(sd))
    if missing:
        raise ValueError(f"{path} is not a torchvision resnet34: missing {missing[:4]}")
    model.load_state_dict(sd, strict=False)
    return model
