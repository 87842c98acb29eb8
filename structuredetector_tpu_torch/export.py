"""Model export: a serialized inference program plus its decode metadata.

The port of `structuredetector_tpu/export.py`. The artifact (`.sdz`) is
a zip of `params.json`, with the JAX package's keys (`export.py:123-138`)
and this port's `framework`, and `model.pt2`, the program
`torch.export.save` writes:

- the forward, then clamped sigmoid + 5x5 plateau NMS on the M+N
  heatmap channels, the regression channels raw (JAX `export.py:34-56`).
  These are the plain ops of `ops.tensor`, as in the JAX graph, so the
  program holds no hand-written kernel (kernel A is bound through ctypes,
  which `torch.export` cannot trace);
- input (B, H, W, 3) NHWC, float32 or, with `uint8_input`, uint8;
  output (B, M+N+4, H/4, W/4) float32, channels first as the port's
  model emits them;
- with `fold_normalization` (`--norm`) the program takes raw [0, 255]
  RGB and does the /255 + ImageNet normalization itself, from buffers
  that live on the program's device;
- with `config.int8` the int8 convs carry prequantized weights
  (`models.quantize.prequantize_variables`) and any calibrated
  `act_scale`;
- `dynamic_batch` gives the batch a `torch.export.Dim`, traced on an
  example batch of at least 2 (sizes 0 and 1 would specialize).

The program is traced for one device (`platforms` in `params.json`):
its autocast region, its constants and its weights belong to that
device. Loading it for another raises `ArtifactDeviceError`; loading a
JAX artifact (`model.stablehlo`, no program) raises `JaxArtifactError`.
`evaluate_export` and `ExportPredictor` decode its output with
`ExportDecoder`: sigmoid and NMS never run twice (JAX `export.py:12-15`).
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Tuple

import torch
import torch.nn as nn

from .models.network import build_model, no_tf32
from .models.quantize import prequantize_variables
from .ops.device_augment import IMAGENET_MEAN, IMAGENET_STD
from .ops.tensor import clamped_sigmoid, plateau_nms
from .utils import resolve_device

METADATA_NAME = "params.json"
PROGRAM_NAME = "model.pt2"
FRAMEWORK = "structuredetector-tpu-torch"


class JaxArtifactError(ValueError):
    """The artifact was written by the JAX package (or another tool): it
    holds no program this port can run."""


class ArtifactDeviceError(RuntimeError):
    """The artifact's program was traced for another device."""


class _ExportGraph(nn.Module):
    """The exported function: [normalize ->] forward -> sigmoid + NMS on
    the heatmap channels."""

    def __init__(self, model: nn.Module, n_labels: int, n_parts: int,
                 fold_normalization: bool = False):
        super().__init__()
        self.model = model
        self.nb_hm = n_labels + n_parts
        self.fold_normalization = fold_normalization
        self.register_buffer("mean", torch.as_tensor(IMAGENET_MEAN))
        self.register_buffer("std", torch.as_tensor(IMAGENET_STD))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        if self.fold_normalization:
            # the arithmetic of Predictor's device normalization
            image = (image.float() / 255.0 - self.mean) / self.std
        raw = self.model(image.permute(0, 3, 1, 2).contiguous(), raw_output=True)
        heatmaps = plateau_nms(clamped_sigmoid(raw[:, : self.nb_hm]))
        return torch.cat((heatmaps, raw[:, self.nb_hm :]), dim=1)


def make_export_fn(model: nn.Module, n_labels: int, n_parts: int,
                   fold_normalization: bool = False) -> nn.Module:
    """The function an artifact holds, as a module over `model` (in eval
    mode): NHWC image batch -> (B, M+N+4, H/4, W/4) with the heatmap
    channels suppressed probabilities and the regression channels raw."""
    return _ExportGraph(model.eval(), n_labels, n_parts, fold_normalization)


def config_from_metadata(meta: Mapping[str, Any], **overrides):
    """Config rebuilt from an artifact's metadata, the one function that
    `evaluate_export` and `ExportPredictor` share. `overrides` fills what
    the metadata does not carry (max_objects, thresholds, ...); an
    `anchor_name` override is a fallback only: the metadata's wins."""
    from .config import Config

    fallback_anchor = overrides.pop("anchor_name", "anchor")
    config = Config(
        width=meta["width"], height=meta["height"],
        down_ratio=float(meta["scale_factor"]),
        anchor_name=meta.get("anchor_name", fallback_anchor),
        **overrides,
    ).set_labels(meta["anchors"], meta["parts"])
    config.validate()
    return config


def export_model(config, weights: Mapping[str, torch.Tensor], path, batch_size: int = 1,
                 fold_normalization: bool = False, dynamic_batch: bool = False,
                 uint8_input: bool = False, device="cuda") -> Path:
    """Trace `build_model(config)` with `weights` (a state_dict; int8
    scales included when the model is int8) on `device` and write the
    `.sdz` artifact. `uint8_input` needs `fold_normalization`."""
    if uint8_input and not fold_normalization:
        raise ValueError("uint8_input requires fold_normalization (the graph must own "
                         "the /255 + mean/std normalization)")
    device = resolve_device(device)
    model = build_model(config)
    model.load_state_dict(weights, strict=True)
    if config.int8:
        # int8 weights in the program: a quarter of the bytes, and no
        # weight quantization at run time
        prequantize_variables(model)
    graph = make_export_fn(model, config.n_labels, config.n_parts,
                           fold_normalization=fold_normalization).to(device)
    example = max(2, batch_size) if dynamic_batch else batch_size
    image = torch.zeros((example, config.height, config.width, config.in_channels),
                        dtype=torch.uint8 if uint8_input else torch.float32, device=device)
    dynamic_shapes = ({"image": {0: torch.export.Dim("batch", min=1)}}
                      if dynamic_batch else None)
    program = torch.export.export(graph, (image,), dynamic_shapes=dynamic_shapes)
    # the example batch is zeros: the archive need not carry it (a static
    # batch of 32 float32 images at 512x512 is 100 MB)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)

    metadata = {
        "anchors": list(config.labels.keys()),
        "parts": list(config.parts.keys()),
        "scale_factor": config.down_ratio,
        "width": config.width,
        "height": config.height,
        "anchor_name": config.anchor_name,
        "batch_size": batch_size,
        "dynamic_batch": dynamic_batch,
        "platforms": [device.type],
        "normalized": fold_normalization,
        "input_dtype": "uint8" if uint8_input else "float32",
        "int8": bool(config.int8),
        "compute_dtype": str(config.compute_dtype).removeprefix("torch."),
        "framework": FRAMEWORK,
        "version": "1",
    }
    path = Path(path)
    # the weights do not deflate: stored, the write takes a fraction
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr(METADATA_NAME, json.dumps(metadata, indent=2))
        zf.writestr(PROGRAM_NAME, buf.getvalue())
    return path


def load_exported(path, device="cuda") -> Tuple[Callable[[Any], torch.Tensor], Dict[str, Any]]:
    """Load a `.sdz` artifact for `device` -> (call, metadata). `call`
    takes a (B, H, W, 3) array or tensor, casts it to the program's input
    dtype on its device, and returns the (B, M+N+4, H/4, W/4) float32
    output there."""
    path = Path(path)
    device = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        members = set(zf.namelist())
        metadata = json.loads(zf.read(METADATA_NAME))
        if PROGRAM_NAME not in members or metadata.get("framework") != FRAMEWORK:
            raise JaxArtifactError(
                f"{path} holds no program of this port (framework "
                f"{metadata.get('framework')!r}, members {sorted(members)}); a JAX "
                "artifact is lowered StableHLO: export the checkpoint again with "
                "python -m structuredetector_tpu_torch.cli.convert_export")
        if device.type not in metadata["platforms"]:
            raise ArtifactDeviceError(
                f"{path} was traced for {metadata['platforms']} and cannot run on "
                f"{device}: export it again with convert_export --device {device.type}")
        module = torch.export.load(io.BytesIO(zf.read(PROGRAM_NAME))).module()

    dtype = torch.uint8 if metadata["input_dtype"] == "uint8" else torch.float32
    compute = getattr(torch, metadata["compute_dtype"])

    def call(image) -> torch.Tensor:
        image = torch.as_tensor(image).to(device=device, dtype=dtype)
        # fp32 means fp32 on the card: TF32 off around the convolutions,
        # as the live model's forward does
        with torch.inference_mode(), no_tf32(compute, device):
            return module(image)

    return call, metadata
