"""Typed configuration shared by the port's CLIs.

The port's own copy of `structuredetector_tpu/config.py`: the
reference's flag names, defaults and invariants
(`/root/reference/src/sdnet/utils/args.py`), so a reference command
line works unchanged, plus the JAX package's training flags and model
variants (`--backbone`, `--s2d_stem`, `--head_conv`). `--data_parallel`
and `--model_parallel` lay the ranks torchrun started out as a (data, model)
mesh whose product is their number (`parallel.mesh.mesh_shape`; data 0
takes every rank the model axis leaves). The device is a `--device` flag of each CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .annotations import get_unique_color_map

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
    summary_path: Optional[Path] = None
    # evaluate only: re-decode the same forward outputs at each of these
    # confidence thresholds (one pass over the dataset, one metric table
    # per threshold)
    conf_sweep: Optional[Tuple[float, ...]] = None

    # bf16 convolutions (autocast) with f32 parameters; False = fp32 with
    # TF32 off
    use_amp: bool = True

    # training runtime (the JAX package's defaults, config.py:72-169)
    profile: bool = False  # torch.profiler trace of steps 5-10, sd.* spans included
    # exit with code 87 when no step completes for this many seconds
    # (0 = off); resumable with --resume
    stall_timeout_s: float = 0.0
    malloc_trim: bool = False  # glibc malloc_trim(0) at each epoch end
    # per-step EMA decay of the parameters (0 = off); validation and the
    # best snapshots use the average, saved as ema_params.msgpack
    ema: float = 0.0
    # one throwaway step per multi-scale size before the first epoch, so
    # cuDNN's and the allocator's first use of each shape happens before
    # the stall watchdog is armed
    prewarm: bool = True
    # directory the CUDA kernels and the native I/O library are built in
    # and looked up from ('' = the package's _build/), so a fresh checkout
    # reuses the builds of an earlier run (cli.train sets it)
    compile_cache: str = ""
    # native C++ decode + resize (data/native.py), exact mode byte-equal
    # to the PIL path; PIL when the library does not build
    native_io: bool = True
    # the training feed decodes JPEG in DCT space with a 2-tap bilinear
    # (close to PIL, not equal); validation and evaluate stay exact
    native_io_fast: bool = False
    device_augment: bool = True  # jitter and flips on the card (--host_augment: PIL)
    uint8_feed: bool = True  # device augment: ship uint8, /255 on the card
    flip_prob: float = 0.5  # train-time h and v flip probability
    pretrained_backbone: bool = False  # --pretrained: cached torchvision <backbone>
    debug_nans: bool = False  # autograd anomaly detection
    resume_dir: Optional[Path] = None  # trainings/<ts> directory to resume

    # inference-only int8 convs (models.quantize)
    int8: bool = False

    # model variants (models.resnet.ARCHS, the space-to-depth stem, the
    # hidden head width; 0 = the reference's single 1x1 head)
    backbone: str = "resnet34"
    s2d_stem: bool = False
    head_conv: int = 0

    # the (data, model) mesh over the ranks torchrun started (data 0 = every
    # rank the model axis leaves; parallel.mesh)
    data_parallel: int = 0
    model_parallel: int = 1

    seed: int = DEFAULT_SEED
    num_workers: int = -1  # -1 = auto, min(cpu_count, 4) like the reference
    # images per device batch in evaluate and detect (metrics identical)
    eval_batch_size: int = 1
    # detect: sliding-window tiles at native resolution
    # (Predictor.predict_tiled) instead of downscaling the image
    tiled: bool = False
    tile_overlap: float = 0.25  # fraction of shared border between tiles

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
    def label_color_map(self) -> Dict[str, tuple]:
        return get_unique_color_map(self.labels)

    @property
    def part_color_map(self) -> Dict[str, tuple]:
        return get_unique_color_map(self.parts)

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
            (self.eval_batch_size > 0, "eval_batch_size must be > 0"),
            (0 <= self.ema < 1, f"--ema must be in [0, 1): {self.ema}"),
            (0 <= self.flip_prob <= 1, f"--flip_prob must be in [0, 1]: {self.flip_prob}"),
        ]
        if self.conf_sweep is not None:
            checks += [
                (len(self.conf_sweep) > 0, "--conf_sweep needs at least one threshold"),
                (all(0 <= t <= 1 for t in self.conf_sweep),
                 f"--conf_sweep thresholds must be in [0, 1]: {self.conf_sweep}"),
            ]
        for ok, message in checks:
            if not ok:
                raise ValueError(message)
        if self.hm_loss_fn.lower() not in {"focal", "mse"}:
            raise ValueError(
                f"unknown hm_loss_fn {self.hm_loss_fn!r}: pick 'focal' or 'mse'"
            )
        # imported here: the package's import of Config loads neither
        # the models nor torch.distributed's groups
        from .models.resnet import ARCHS
        from .models.swin import ARCHS as SWIN_ARCHS
        from .parallel.mesh import mesh_shape, world_size

        # data x model must be the number of ranks torchrun started
        mesh_shape(self.data_parallel, self.model_parallel, world_size())
        # the JAX package's message: the Swin encoders are the port's own
        if self.backbone not in ARCHS and self.backbone not in SWIN_ARCHS:
            raise ValueError(
                f"unknown backbone {self.backbone!r}: pick one of {sorted(ARCHS)}"
            )
        if self.num_workers < 0:  # auto: reference num_workers policy (args.py:251)
            self.num_workers = min(os.cpu_count() or 1, 4)
        return self

    def lr_step_epochs(self) -> int:
        """StepLR step size in epochs: epochs // lr_step, or `epochs`
        (never) when lr_step == 0 (args.py:213-215)."""
        return int(self.epochs / self.lr_step) if self.lr_step != 0 else self.epochs

    def grid_size(self, input_size: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
        w, h = input_size or self.input_size
        return int(w / self.down_ratio), int(h / self.down_ratio)

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
                   help="Load a trained model (a reference-layout torch .pth or "
                        "the JAX package's .msgpack).")
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
    p.add_argument("--save_summary", dest="summary_path", type=Path, default=None,
                   help="Write the flat metric summary (scalar_summary) as JSON.")
    p.add_argument("--conf_sweep", type=str, default=None,
                   help="evaluate only: comma-separated confidence thresholds "
                        "(e.g. 0.2,0.3,0.4); the dataset is forwarded once and "
                        "re-decoded per threshold, one metric row each.")
    p.add_argument("--amp", action="store_true", dest="amp_flag",
                   help="Mixed precision (bf16 convolutions) — the default, so "
                        "this flag confirms it; conflicts with --no_amp.")
    p.add_argument("--no_amp", action="store_true",
                   help="Force fp32 compute (TF32 off).")
    p.add_argument("--pretrained", action="store_true", dest="pretrained_backbone",
                   help="Warm-start the encoder from a locally cached torchvision "
                        "ImageNet checkpoint of --backbone ($SDNET_PRETRAINED, then "
                        "$TORCH_HOME/hub/checkpoints/<backbone>-*.pth); nothing is "
                        "downloaded.")
    p.add_argument("--data_parallel", type=int, default=d.data_parallel,
                   help="Ranks on the data axis: 0 (every rank) or the number of ranks "
                        "(torchrun --nproc_per_node N -m structuredetector_tpu_torch.cli."
                        "train --data_parallel N).")
    p.add_argument("--model_parallel", type=int, default=d.model_parallel,
                   help="Ranks on the model axis: each conv's output channels split "
                        "over them (torchrun --nproc_per_node D*M ... --data_parallel D "
                        "--model_parallel M).")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace of training steps 5-10 to "
                        "<run dir>/profile; it carries the port's sd.* spans "
                        "(loader, step phases, garbage collections) beside the kernels.")
    p.add_argument("--stall_timeout_s", type=float, default=d.stall_timeout_s,
                   help="Exit with code 87 if no step completes for this many "
                        "seconds (0 = off). Resumable via --resume.")
    p.add_argument("--malloc_trim", action="store_true",
                   help="Call glibc malloc_trim(0) at each epoch end.")
    p.add_argument("--ema", type=float, default=d.ema,
                   help="Per-step EMA decay of the parameters (e.g. 0.999); "
                        "validation and the best snapshots use the average. "
                        "0 disables.")
    p.add_argument("--no_prewarm", dest="prewarm", action="store_false", default=d.prewarm,
                   help="Skip the throwaway step per multi-scale size before the "
                        "first epoch.")
    p.add_argument("--compile_cache", type=str, default=d.compile_cache,
                   help="Directory to build the CUDA kernels and the native I/O "
                        "library in and reuse them from across runs ('' = the "
                        "package's _build/).")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="Host-side data prefetch threads.")
    p.add_argument("--host_augment", action="store_true",
                   help="Augment on the host with PIL (reference behavior) instead "
                        "of on the card.")
    p.add_argument("--native_io", dest="native_io", action="store_true",
                   default=d.native_io,
                   help="Decode images with the native C++ library (byte-equal to "
                        "the PIL path; the default, PIL when it does not build).")
    p.add_argument("--no_native_io", dest="native_io", action="store_false",
                   help="Decode images with PIL.")
    p.add_argument("--native_io_fast", action="store_true",
                   help="Approximate fast decode of the training feed (DCT-scaled "
                        "JPEG, 2-tap bilinear); validation and evaluate stay exact.")
    p.add_argument("--float_feed", action="store_true",
                   help="Ship the training batch as float32 [0, 1] instead of raw "
                        "uint8 (device augment only).")
    p.add_argument("--backbone", type=str, default=d.backbone,
                   choices=["resnet18", "resnet34", "resnet50", "swin_v2_b"],
                   help="Encoder family (reference ships resnet34; swin_v2_b: "
                        "Swin Transformer V2-B).")
    p.add_argument("--s2d_stem", action="store_true",
                   help="Space-to-depth stem: equivalent 4x4/1 conv on 12 "
                        "channels instead of 7x7/2 on 3 (changes the checkpoint "
                        "stem layout; a 7x7 checkpoint loads into it).")
    p.add_argument("--flip_prob", type=float, default=d.flip_prob,
                   help="Train-time h/v flip probability (0 disables).")
    p.add_argument("--head_conv", type=int, default=d.head_conv,
                   help="Hidden 3x3 head width before the 1x1 output conv "
                        "(0 = reference single-1x1 head). Changes the "
                        "checkpoint layout; pass the same value when "
                        "evaluating/exporting the checkpoint.")
    p.add_argument("--int8", action="store_true",
                   help="Inference-only int8 convs (per-sample dynamic activation "
                        "and per-channel weight quantization); stem and head stay "
                        "float. Training with it raises.")
    p.add_argument("--debug_nans", action="store_true",
                   help="Turn on autograd anomaly detection (NaN/inf in backward "
                        "raise where they arise).")
    p.add_argument("--resume", dest="resume_dir", type=str, default=None,
                   help="Resume training from a trainings/<ts> directory written by "
                        "the port (parameters, optimizer state and step).")
    p.add_argument("--eval_batch_size", type=int, default=d.eval_batch_size,
                   help="Images per device batch in evaluate and detect "
                        "(metrics are identical).")
    p.add_argument("--tiled", action="store_true",
                   help="detect: run sliding-window tiles at native resolution "
                        "instead of downscaling the image (cross-tile "
                        "duplicates are merged).")
    p.add_argument("--tile_overlap", type=float, default=d.tile_overlap,
                   help="Fraction of shared border between detect tiles.")
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
        summary_path=ns.summary_path,
        conf_sweep=(tuple(float(t) for t in ns.conf_sweep.split(","))
                    if ns.conf_sweep else None),
        use_amp=not ns.no_amp,
        profile=ns.profile,
        stall_timeout_s=max(0.0, ns.stall_timeout_s),
        malloc_trim=ns.malloc_trim,
        ema=ns.ema,
        prewarm=ns.prewarm,
        compile_cache=ns.compile_cache,
        native_io=ns.native_io or ns.native_io_fast,
        native_io_fast=ns.native_io_fast,
        device_augment=not ns.host_augment,
        uint8_feed=not ns.float_feed,
        flip_prob=min(1.0, max(0.0, ns.flip_prob)),
        pretrained_backbone=ns.pretrained_backbone,
        debug_nans=ns.debug_nans,
        resume_dir=_opt_path(ns.resume_dir),
        data_parallel=ns.data_parallel,
        model_parallel=ns.model_parallel,
        backbone=ns.backbone,
        s2d_stem=ns.s2d_stem,
        head_conv=max(0, ns.head_conv),
        int8=ns.int8,
        seed=ns.seed,
        num_workers=ns.num_workers,
        eval_batch_size=max(1, ns.eval_batch_size),
        tiled=ns.tiled,
        tile_overlap=ns.tile_overlap,
    )
    return cfg.finalize()


def _opt_path(v) -> Optional[Path]:
    return Path(v).expanduser().resolve() if v is not None else None
