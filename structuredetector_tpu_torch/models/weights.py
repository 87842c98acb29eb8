"""Weights for the port's SDNet: reference-layout `.pth` files, and the
carry-over from the JAX package's variable tree.

The port's modules use the reference's names (`adpater.{0,1}`,
`down1..4`, `up1`, `up{2,3,4}.{lateral,conv.0,conv.1}`, `head.conv`), so
a `.pth` written by the reference, or by the JAX package's
`save_reference_pth`, loads with `strict=True`. A checkpoint of another
architecture (other widths, labels, backbone or head) raises instead of
loading partly.

`state_dict_from_jax` is the port's own copy of the mapping in
`structuredetector_tpu/models/torch_export.py`: a
`{'params', 'batch_stats'}` tree of numpy arrays (HWIO kernels) becomes
a state_dict (OIHW kernels).
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .resnet import STAGE_SIZES


def _conv_oihw(kernel) -> torch.Tensor:
    """HWIO -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1))))


def _vec(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


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
    out["adpater.0.weight"] = _conv_oihw(enc_p["conv1"]["kernel"])
    _put_bn(out, "adpater.1", enc_p["bn1"], enc_s["bn1"])
    for stage_i, n in enumerate(STAGE_SIZES):
        for block in range(n):
            src, dst = f"layer{stage_i + 1}_{block}", f"down{stage_i + 1}.{block}"
            p, s = enc_p[src], enc_s[src]
            out[f"{dst}.conv1.weight"] = _conv_oihw(p["conv1"]["kernel"])
            _put_bn(out, f"{dst}.bn1", p["bn1"], s["bn1"])
            out[f"{dst}.conv2.weight"] = _conv_oihw(p["conv2"]["kernel"])
            _put_bn(out, f"{dst}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                out[f"{dst}.downsample.0.weight"] = _conv_oihw(p["downsample_conv"]["kernel"])
                _put_bn(out, f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])

    out["up1.weight"] = _conv_oihw(params["up1"]["kernel"])
    out["up1.bias"] = _vec(params["up1"]["bias"])
    for k in (2, 3, 4):
        blk_p, blk_s = params[f"up{k}"], stats[f"up{k}"]
        out[f"up{k}.lateral.weight"] = _conv_oihw(blk_p["lateral"]["kernel"])
        out[f"up{k}.lateral.bias"] = _vec(blk_p["lateral"]["bias"])
        out[f"up{k}.conv.0.weight"] = _conv_oihw(blk_p["conv"]["kernel"])
        _put_bn(out, f"up{k}.conv.1", blk_p["bn"], blk_s["bn"])
    out["head.conv.weight"] = _conv_oihw(params["head"]["kernel"])
    out["head.conv.bias"] = _vec(params["head"]["bias"])
    return out


def load_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A reference-layout state_dict from a `.pth`/`.pt` file."""
    path = Path(path)
    if path.suffix not in {".pth", ".pt"}:
        raise ValueError(
            f"{path}: the port loads reference-layout torch .pth checkpoints; "
            "convert a .msgpack checkpoint with the JAX package's "
            "save_reference_pth first"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state_dict, got {type(sd).__name__}")
    return sd


def load_weights(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a `.pth` into `model` strictly: a missing, extra or
    differently shaped tensor raises."""
    model.load_state_dict(load_checkpoint(path), strict=True)
    return model
