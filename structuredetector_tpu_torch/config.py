"""Typed configuration shared by the port's CLIs.

The port's own copy of `structuredetector_tpu/config.py`: the
reference's flag names, defaults and invariants
(`/root/reference/src/sdnet/utils/args.py`), so a reference command
line works unchanged. The JAX package's TPU knobs (mesh axes, XLA
caches, native IO, int8, alternate backbones and heads) are not part
of this port yet; the device is a `--device` flag of each CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

DEFAULT_SEED = 926354916  # reference args.py:257


@dataclasses.dataclass
class Config:
    # data
    train_dir: Optional[Path] = None
    valid_dir: Optional[Path] = None
    labels_path: Path = Path("labels.json")
    anchor_name: str = "anchor"

    # model
    width: int = 512
    height: int = 512
    in_channels: int = 3
    fpn_depth: int = 128
    down_ratio: float = 4.0
    pretrained_model: Optional[Path] = None  # --load_model

    # training
    batch_size: int = 8
    epochs: int = 100
    no_augmentation: bool = False
    learning_rate: float = 1e-3
    lr_step: int = 3  # number of /10 divisions; converted to step size at parse
    hm_loss_fn: str = "mse"
    max_objects: int = 20
    max_parts: int = 40
    hm_weight: float = 1.0
    offset_weight: float = 1e-3
    embedding_weight: float = 1e-3
    sigma_gauss: float = 0.1

    # decode / eval thresholds
    conf_threshold: float = 0.5
    dist_threshold: float = 0.05
    decoder_dist_thresh: float = 0.1
    csi_threshold: float = 0.75
    csv_path: Optional[Path] = None

    # bf16 convolutions (autocast) with f32 parameters; False = fp32 with
    # TF32 off
    use_amp: bool = True

    seed: int = DEFAULT_SEED
    num_workers: int = -1  # -1 = auto, min(cpu_count, 4) like the reference

    # label maps, filled by `finalize()`
    labels: Dict[str, int] = dataclasses.field(default_factory=dict)
    parts: Dict[str, int] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def n_labels(self) -> int:
        return len(self.labels)

    @property
    def n_parts(self) -> int:
        return len(self.parts)

    @property
    def out_channels(self) -> int:
        """Head channels: M anchor heatmaps + N part heatmaps + 2 offsets
        + 2 embeddings (reference network.py:38)."""
        return self.n_labels + self.n_parts + 4

    @property
    def input_size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def r_labels(self) -> Dict[int, str]:
        return {v: k for k, v in self.labels.items()}

    @property
    def r_parts(self) -> Dict[int, str]:
        return {v: k for k, v in self.parts.items()}

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_amp else torch.float32

    # ------------------------------------------------------------------
    def validate(self) -> "Config":
        """Same invariants as the reference parse() (args.py:181-211)."""
        checks = [
            (self.width % 32 == 0 and self.width > 0,
             "Width should be divisible by 32 and greater than 0"),
            (self.height % 32 == 0 and self.height > 0,
             "Height should be divisible by 32 and greater than 0"),
            (self.in_channels > 0, "in_channels must be > 0"),
            (self.fpn_depth > 0, "fpn_depth must be > 0"),
            (self.batch_size > 0, "batch_size must be > 0"),
            (self.epochs > 0, "epochs must be > 0"),
            (self.learning_rate > 0, "learning_rate must be > 0"),
            (self.lr_step >= 0, "lr_step must be >= 0"),
            (self.down_ratio > 0, "down_ratio must be > 0"),
            (self.max_objects > 0, "max_objects must be > 0"),
            (self.max_parts > 0, "max_parts must be > 0"),
            (self.hm_weight >= 0, "hm_weight must be >= 0"),
            (self.offset_weight >= 0, "offset_weight must be >= 0"),
            (self.embedding_weight >= 0, "embedding_weight must be >= 0"),
            (0 <= self.conf_threshold <= 1, "conf_threshold must be in [0, 1]"),
            (0 <= self.dist_threshold <= 1, "dist_threshold must be in [0, 1]"),
            (0 <= self.decoder_dist_thresh <= 1,
             "decoder_dist_thresh must be in [0, 1]"),
            (0 <= self.csi_threshold <= 1, "csi_threshold must be in [0, 1]"),
            (0 < self.sigma_gauss <= 1, "sigma_gauss must be in (0, 1]"),
        ]
        for ok, message in checks:
            if not ok:
                raise ValueError(message)
        if self.hm_loss_fn.lower() not in {"focal", "mse"}:
            raise ValueError(
                f"unknown hm_loss_fn {self.hm_loss_fn!r}: pick 'focal' or 'mse'"
            )
        if self.num_workers < 0:  # auto: reference num_workers policy (args.py:251)
            self.num_workers = min(os.cpu_count() or 1, 4)
        return self

    def load_labels(self) -> "Config":
        """Load the name->index maps from the labels JSON
        (args.py:224-239, same list/dict/str forms)."""
        data = json.loads(Path(self.labels_path).expanduser().resolve().read_text())
        self.labels = _as_index_map(data["labels"])
        self.parts = _as_index_map(data["parts"])
        return self

    def set_labels(self, labels, parts) -> "Config":
        self.labels = _as_index_map(labels)
        self.parts = _as_index_map(parts)
        return self

    def finalize(self) -> "Config":
        self.validate()
        if not self.labels:
            self.load_labels()
        return self


def _as_index_map(value) -> Dict[str, int]:
    if isinstance(value, dict):
        return dict(value)
    if isinstance(value, (list, tuple)):
        return {v: i for i, v in enumerate(value)}
    return {value: 0}


# ----------------------------------------------------------------------
# CLI


def build_parser(parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    """Argparse front-end with the reference's flag names and defaults
    (args.py:17-175)."""
    p = parser or argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    d = Config()

    p.add_argument("--train_dir", type=str, help="The training directory.")
    p.add_argument("--valid_dir", type=str, help="The validation directory.")
    p.add_argument("--labels", "-m", dest="labels_path", type=str, default=str(d.labels_path),
                   help="Json file of anchor and part names.")
    p.add_argument("--anchor_name", "-s", type=str, default=d.anchor_name,
                   help="Name of the keypoint representing the anchor of the object.")
    p.add_argument("--width", "-W", type=int, default=d.width, help="The network input width.")
    p.add_argument("--height", "-H", type=int, default=d.height, help="The network input height.")
    p.add_argument("--in_channels", "-c", type=int, default=d.in_channels,
                   help="Number of input channels.")
    p.add_argument("--fpn_depth", type=int, default=d.fpn_depth,
                   help="Depth of FPN layers of the decoder.")
    p.add_argument("--load_model", "-o", dest="pretrained_model", default=None,
                   help="Load a trained model (a reference-layout torch .pth).")
    p.add_argument("--batch_size", "-b", type=int, default=d.batch_size,
                   help="Batch size for training.")
    p.add_argument("--epochs", "-e", type=int, default=d.epochs,
                   help="The number of epochs to train.")
    p.add_argument("--no_augmentation", "-a", action="store_true",
                   help="Disable augmentations during training.")
    p.add_argument("--learning_rate", "-l", type=float, default=d.learning_rate,
                   help="The learning rate for training.")
    p.add_argument("--lr_step", type=int, default=d.lr_step,
                   help="Number of divisions by 10 of the learning rate during training.")
    p.add_argument("--down_ratio", "-g", type=float, default=d.down_ratio,
                   help="Downsampling ratio of the network output.")
    p.add_argument("--hm_loss_fn", "-f", type=str, default=d.hm_loss_fn,
                   help="Loss for heatmap regression: 'focal' or 'mse'.")
    p.add_argument("--max_objects", "-n", type=int, default=d.max_objects,
                   help="Maximum number of objects detectable in an image.")
    p.add_argument("--max_parts", "-k", type=int, default=d.max_parts,
                   help="Maximum number of parts detectable in an image.")
    p.add_argument("--hm_weight", type=float, default=d.hm_weight,
                   help="Weight for the heatmap loss.")
    p.add_argument("--offset_weight", type=float, default=d.offset_weight,
                   help="Weight for the offset loss.")
    p.add_argument("--embedding_weight", type=float, default=d.embedding_weight,
                   help="Weight for the embedding loss.")
    p.add_argument("--sigma_gauss", type=float, default=d.sigma_gauss,
                   help="Gaussian splat size in percent of image side length.")
    p.add_argument("--conf_threshold", "-t", type=float, default=d.conf_threshold,
                   help="Confidence threshold for keypoint detection, in [0, 1].")
    p.add_argument("--dist_threshold", "-d", type=float, default=d.dist_threshold,
                   help="Eval match radius in percent of min image length, in [0, 1].")
    p.add_argument("--decoder_dist_thresh", type=float, default=d.decoder_dist_thresh,
                   help="Part->anchor linkage radius in percent of min image length.")
    p.add_argument("--csi_threshold", type=float, default=d.csi_threshold,
                   help="CSI threshold for evaluation, in [0, 1].")
    p.add_argument("--save_csv_eval", dest="csv_path", type=Path, default=None)
    p.add_argument("--amp", action="store_true", dest="amp_flag",
                   help="Mixed precision (bf16 convolutions) — the default, so "
                        "this flag confirms it; conflicts with --no_amp.")
    p.add_argument("--no_amp", action="store_true",
                   help="Force fp32 compute (TF32 off).")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="Host-side data prefetch threads.")
    return p


def config_from_args(argv=None) -> Config:
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.amp_flag and ns.no_amp:
        parser.error("--amp and --no_amp are mutually exclusive")
    cfg = Config(
        train_dir=_opt_path(ns.train_dir),
        valid_dir=_opt_path(ns.valid_dir),
        labels_path=Path(ns.labels_path),
        anchor_name=ns.anchor_name,
        width=ns.width,
        height=ns.height,
        in_channels=ns.in_channels,
        fpn_depth=ns.fpn_depth,
        pretrained_model=_opt_path(ns.pretrained_model),
        batch_size=ns.batch_size,
        epochs=ns.epochs,
        no_augmentation=ns.no_augmentation,
        learning_rate=ns.learning_rate,
        lr_step=ns.lr_step,
        down_ratio=ns.down_ratio,
        hm_loss_fn=ns.hm_loss_fn,
        max_objects=ns.max_objects,
        max_parts=ns.max_parts,
        hm_weight=ns.hm_weight,
        offset_weight=ns.offset_weight,
        embedding_weight=ns.embedding_weight,
        sigma_gauss=ns.sigma_gauss,
        conf_threshold=ns.conf_threshold,
        dist_threshold=ns.dist_threshold,
        decoder_dist_thresh=ns.decoder_dist_thresh,
        csi_threshold=ns.csi_threshold,
        csv_path=ns.csv_path,
        use_amp=not ns.no_amp,
        seed=ns.seed,
        num_workers=ns.num_workers,
    )
    return cfg.finalize()


def _opt_path(v) -> Optional[Path]:
    return Path(v).expanduser().resolve() if v is not None else None
