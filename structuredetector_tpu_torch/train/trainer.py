"""Training orchestrator.

The port of `structuredetector_tpu/train/trainer.py` (reference
`trainer.py:23-309`) for one device: the model, the loss, Adam with the
StepLR-equivalent schedule, the train and validation loaders, the
`Decoder` and `Evaluator`, the metrics writer. Each epoch runs the train
step over the shuffled set at the epoch's multi-scale size; every second
epoch (`trainer.py:519`) validates through `Decoder(return_metadata=True)`
(kernel A on the card) and the `Evaluator`, snapshots the 4 best models
and logs the debug panels; every epoch saves the full state.

Beside the reference: exact resume (`--resume`: the step, the epoch, the
batch order and the multi-scale size of the unbroken run), a save at the
batch boundary on SIGTERM/SIGINT, a stall watchdog (exit code 87), an
EMA of the parameters kept outside the state, and a `torch.profiler`
trace of steps 5-10 (`--profile`). The entry point runs on the card
unless the caller asks for the CPU.

Data parallelism (JAX `trainer.py:218-222`): under a process group
started by torchrun (`parallel.mesh`), each rank loads its slice of
every global batch and the train step has global-batch semantics. Rank
0 alone (`is_lead`) logs, prints progress and writes: it makes the run
directory, whose name every rank takes from it, localizes the datasets'
JSONs before the others read them, saves the state, the EMA and the best
snapshots. Every rank validates the whole valid set through the
`Decoder` (kernel A on the card) on its module, and runs the stall
watchdog; a SIGTERM/SIGINT stops every rank at the same batch boundary.

The model axis (`--model_parallel M`, `parallel.partition.shard_model`):
each rank keeps the Cout slices of its model index (its `ChannelPlan`,
`self.partition`, goes to every forward), the ranks of a model group
load the same slice of each global batch and, where the host augments
it, take their first rank's draw (each rank computes its channels of
one batch), and the state, the EMA
and the best snapshots are gathered whole on every rank before rank 0
writes them, in the one-process layout; `--resume` under any mesh keeps
each rank's slices of them.
"""

from __future__ import annotations

import copy
import json
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.augment import TrainAugmentation, ValidationAugmentation
from ..data.dataset import CropDataset
from ..data.decoders import Decoder
from ..data.pipeline import Loader, choose_batch_fetch, device_prefetch
from ..evaluation import Evaluator
from ..models.network import init_model
from ..models.weights import (
    find_imagenet_resnet34,
    load_checkpoint,
    load_imagenet_encoder,
    load_weights,
    save_msgpack,
)
from ..parallel.mesh import create_mesh
from ..parallel.partition import shard_model, share_over_model
from ..tracing import span
from ..utils import progress, resolve_device
from .checkpoints import BestModelSaver, CheckpointManager
from .state import TrainState, create_train_state, make_optimizer
from .steps import capture_train_step, eval_step, train_step

STALL_EXIT_CODE = 87
# under data parallelism the ranks agree on a stop (SIGTERM/SIGINT) every
# this many steps and at each epoch's end
PREEMPT_POLL_STEPS = 10


class MetricsWriter:
    """TensorBoard writer; does nothing when tensorboard is missing."""

    def __init__(self, log_dir=None, enabled: bool = True):
        self._w = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._w = SummaryWriter(log_dir=str(log_dir) if log_dir else None)

    def scalars(self, tag: str, values: Dict[str, float], step: int):
        if self._w:
            self._w.add_scalars(tag, values, step)

    def scalar(self, tag: str, value: float, step: int):
        if self._w:
            self._w.add_scalar(tag, value, step)

    def image(self, tag: str, image, step: int):
        """image: PIL or (H, W, 3) uint8 numpy."""
        if self._w:
            self._w.add_image(tag, np.asarray(image), step, dataformats="HWC")

    def flush(self):
        if self._w:
            self._w.flush()

    def close(self):
        if self._w:
            self._w.close()


def host_rss_mb() -> float:
    """Resident set size of this process in MB (0.0 if unreadable),
    logged per epoch as "Host/rss_mb"."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except ImportError:
        return 0.0


def malloc_trim() -> bool:
    """Ask glibc to return freed heap pages to the OS; True on success,
    False where there is no glibc."""
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        return bool(libc.malloc_trim(0) >= 0)
    except (OSError, AttributeError):
        return False


def embedding_plateau_warning(first: Dict[str, float],
                              current: Dict[str, float]) -> Optional[str]:
    """The grouping failure the JAX package documents (DESIGN.md
    "Structural grouping"): with too small an --embedding_weight the
    embedding head never trains, and keypoint metrics look good while
    grouping collapses. Signature: the weighted heatmap loss fell 5x or
    more since the first validation while the weighted embedding loss
    moved < 10 %. Returns the warning, or None."""
    emb0 = first.get("embedding_loss", 0.0)
    hm0 = first.get("hm_loss", 0.0)
    emb = current.get("embedding_loss", 0.0)
    hm = current.get("hm_loss", 0.0)
    if emb0 <= 0.0 or hm0 <= 0.0:  # no parts / embedding_weight 0
        return None
    if hm < 0.2 * hm0 and emb > 0.9 * emb0:
        return (
            "WARNING: the embedding loss has not moved "
            f"({emb0:.4g} -> {emb:.4g}) while the heatmap loss dropped "
            f"{hm0 / max(hm, 1e-12):.0f}x. The embedding head is likely "
            "not training: keypoint metrics will look good but "
            "part-to-anchor grouping (CSI/classification) will collapse. "
            "Consider a larger --embedding_weight."
        )
    return None


class StallWatchdog:
    """Ends the process when training stops making progress: `beat()`
    after every completed step; when no beat comes within `timeout_s`, a
    sidecar thread prints a diagnostic and `os._exit(STALL_EXIT_CODE)`,
    so a supervisor can relaunch with --resume. A thread blocked inside a
    C call takes no Python exception, so a hard exit is the one way out."""

    def __init__(self, timeout_s: float, on_fire=None):
        import threading

        if timeout_s <= 0:
            raise ValueError("timeout_s must be > 0")
        self.timeout_s = timeout_s
        self._beat_t = time.monotonic()
        self._stop = threading.Event()
        self._on_fire = on_fire  # test seam; None = os._exit for real
        self._thread = threading.Thread(target=self._run, daemon=True, name="stall-watchdog")

    def start(self) -> "StallWatchdog":
        self._thread.start()
        return self

    def beat(self):
        self._beat_t = time.monotonic()

    def stop(self):
        self._stop.set()

    def _run(self):
        import os
        import sys

        poll = max(0.05, min(10.0, self.timeout_s / 4))
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._beat_t
            if idle > self.timeout_s:
                print(
                    f"[stall-watchdog] no step completed in {idle:.0f}s "
                    f"(> {self.timeout_s:.0f}s): the device is presumed wedged; "
                    f"aborting with exit code {STALL_EXIT_CODE}. The run dir "
                    f"holds a resumable checkpoint (--resume).",
                    file=sys.stderr, flush=True,
                )
                if self._on_fire is not None:
                    self._on_fire(idle)
                    return
                os._exit(STALL_EXIT_CODE)


def ema_decay(decay: float, step: int) -> float:
    """The warm-up corrected decay min(decay, (1 + t) / (10 + t)): the
    average starts at the initial weights, and a flat decay near 1 would
    keep the first validations near the initialization."""
    return min(decay, (1.0 + step) / (10.0 + step))


def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module, decay: float,
               step: int) -> None:
    """ema <- ema * d + params * (1 - d), in place, d = ema_decay(decay, step)."""
    d = ema_decay(decay, step)
    averages = list(ema.values())
    params = [p.detach() for _, p in model.named_parameters()]
    torch._foreach_mul_(averages, d)
    torch._foreach_add_(averages, params, alpha=1.0 - d)


def _zeros_batch(b: int, h: int, w: int, config, image_dtype, device):
    """A batch of black images without a valid keypoint, on `device`."""
    o, p = config.max_objects, config.max_parts

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    kp = {"anchors_xy": zeros(b, o, 2), "anchor_cls": zeros(b, o, dtype=torch.int32),
          "anchor_mask": zeros(b, o, dtype=torch.bool), "parts_xy": zeros(b, p, 2),
          "part_kind": zeros(b, p, dtype=torch.int32), "part_owner_xy": zeros(b, p, 2),
          "part_mask": zeros(b, p, dtype=torch.bool)}
    return zeros(b, h, w, 3, dtype=image_dtype), kp


class Trainer:
    def __init__(self, config, device="cuda", log: bool = True):
        """`device` defaults to CUDA and raises where CUDA is missing; pass
        "cpu" explicitly to train there."""
        self.config = config
        self.device = resolve_device(device)
        # rank 0 owns logging and the files; every rank loads its data
        # index's slice of each global batch (parallel.multihost)
        self.mesh = create_mesh(config.data_parallel, config.model_parallel, self.device)
        self.process_index = self.mesh.rank
        self.process_count = self.mesh.world
        self.is_lead = self.process_index == 0
        self.log = log and self.is_lead
        if config.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        model = init_model(config)
        # warm start (reference trainer.py:45-48); a 7x7 stem loads into an
        # --s2d_stem model (`load_weights` and `load_imagenet_encoder` adapt it)
        if config.pretrained_model:
            load_weights(model, config.pretrained_model)
        elif config.pretrained_backbone:
            path = find_imagenet_resnet34(config.backbone)
            load_imagenet_encoder(model, path)
            if self.is_lead:
                print(f"Warm-started encoder from {path}")
        self.model = model.to(self.device)
        # before the optimizer: Adam's moments are slices too
        self.partition = shard_model(self.model, self.mesh) if self.mesh.model > 1 else None

        self.decoder = Decoder(config)
        self.evaluator = Evaluator(config)

        # data (reference trainer.py:58-87)
        self.train_augmentation = TrainAugmentation(config)
        self.train_set = CropDataset(config, config.train_dir, self.train_augmentation)
        # --native_io: whole batches through the native library where the
        # host does no per-pixel augmentation, else the per-sample PIL path
        self.train_loader = Loader(
            self.train_set, batch_size=config.batch_size, shuffle=True, drop_last=True,
            num_workers=config.num_workers, seed=config.seed,
            batch_fetch=choose_batch_fetch(config, self.train_set, self.train_augmentation),
            process_index=self.mesh.data_index, process_count=self.mesh.data)
        valid_augmentation = ValidationAugmentation(config)
        self.valid_set = CropDataset(config, config.valid_dir, valid_augmentation)
        if self.is_lead:
            self.train_set.localize_image_names()
            self.valid_set.localize_image_names()
        if self.process_count > 1:  # the JSONs are rewritten before any rank reads one
            dist.barrier()
        # --eval_batch_size > 1 batches validation; detection metrics are
        # batch-invariant, the reported loss shifts a little because the
        # focal loss normalizes over the batch
        self.valid_loader = Loader(
            self.valid_set, batch_size=config.eval_batch_size,
            num_workers=config.num_workers,
            batch_fetch=choose_batch_fetch(config, self.valid_set, valid_augmentation))

        self.state = create_train_state(config, self.model, max(1, len(self.train_loader)),
                                        partition=self.partition)
        self.lr_schedule = self.state.lr_schedule

        if config.resume_dir:
            self.save_dir = Path(config.resume_dir)
            if not self.save_dir.is_dir():
                raise FileNotFoundError(f"resume dir {self.save_dir} not found")
        else:
            name = [f"{datetime.now():%Y-%m-%d_%H-%M-%S}"]
            if self.process_count > 1:  # rank 0's clock names the run
                dist.broadcast_object_list(name, src=0)
            self.save_dir = Path("trainings") / name[0]
            if self.is_lead:
                self.save_dir.mkdir(parents=True, exist_ok=True)
        self.writer = MetricsWriter(self.save_dir / "tb", enabled=self.log)
        self.checkpoints = CheckpointManager(self.save_dir)
        self.best_models = BestModelSaver(self.save_dir)

        # --ema: the average lives outside the state (the checkpoint layout
        # is the same with or without it) and is saved as ema_params.msgpack
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        if config.ema > 0:
            self.ema_params = self._param_copy()

        self.global_step = 0  # images seen, as the JAX trainer counts
        self._profiled = False
        self._preempted = False
        self._current_epoch = 0
        self._watchdog: Optional[StallWatchdog] = None
        self._first_val_losses: Optional[Dict[str, float]] = None
        self._warned_embedding_plateau = False

    def _stop_agreed(self) -> bool:
        """Whether a SIGTERM/SIGINT came: this process's flag, or under data
        parallelism any rank's (a collective: every rank calls it at the
        same step)."""
        if self.process_count == 1:
            return self._preempted
        flag = torch.tensor([float(self._preempted)], device=self.device)
        dist.all_reduce(flag)
        self._preempted = bool(flag.item())
        return self._preempted

    def _param_copy(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def _weights(self) -> Dict[str, torch.Tensor]:
        """The weights the snapshots keep, whole: the EMA parameters with the
        live BN buffers when --ema is on. Under the model axis a collective
        of every rank."""
        sd = self.model.state_dict()
        if self.ema_params is not None:
            sd.update(self.ema_params)
        return sd if self.partition is None else self.partition.full_state_dict(sd)

    # -- preemption -----------------------------------------------------

    def _install_preemption_handlers(self):
        """SIGTERM/SIGINT set a flag; the step loop stops at the next batch
        boundary, saves the full state and returns, so the run resumes
        where it stopped. Installed only from the main thread, restored
        after training."""
        import signal

        self._prev_handlers = {}

        def on_signal(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass

    def _restore_signal_handlers(self):
        import signal

        for sig, prev in getattr(self, "_prev_handlers", {}).items():
            signal.signal(sig, prev)
        self._prev_handlers = {}

    def _save(self):
        """The state and the EMA, gathered on every rank, written by rank 0."""
        state = self.state.state_dict()
        weights = self._weights() if self.ema_params is not None else None
        if self.is_lead:
            self.checkpoints.save_state(self.global_step, state)
            if weights is not None:
                save_msgpack(weights, self.save_dir / "ema_params.msgpack")

    def _preemption_save(self):
        # a long save is progress: the watchdog must not exit mid-write
        if self._watchdog is not None:
            self._watchdog.stop()
        self._save()
        if self.is_lead:
            print(f"Preemption: saved train state at step {self.state.step} to "
                  f"{self.save_dir}; resume with --resume {self.save_dir}", flush=True)

    # -- warm-up ----------------------------------------------------------

    def prewarm(self) -> int:
        """One throwaway train step per multi-scale size on a copy of the
        model and a fresh optimizer, before the first epoch: cuDNN's and
        the allocator's first use of each of the sizes then happens
        before the stall watchdog is armed, not in a random epoch. After
        each, where the train step replays a CUDA graph
        (`train.graphs`), the real state's graph of that size is captured,
        which runs nothing: the real state is untouched. Returns the number
        of sizes warmed: 0 under data parallelism, as in the JAX package
        (each rank's first step at a size is then cold)."""
        if self.process_count > 1:
            return 0
        cfg = self.config
        aug = self.train_augmentation
        sizes = [aug.current_size] + [s for s in aug.bucket_sizes() if s != aug.current_size]
        image_dtype = torch.uint8 if aug.device_augment and aug.uint8_feed else torch.float32
        shadow = copy.deepcopy(self.model)
        state = TrainState(shadow, make_optimizer(shadow, self.lr_schedule(0)),
                           self.lr_schedule, step=self.state.step)
        t0 = time.monotonic()
        captured = 0
        for w, h in sizes:
            images, kp = _zeros_batch(cfg.batch_size, h, w, cfg, image_dtype, self.device)
            stats = train_step(state, images, kp, cfg, augment=aug.device_augment)
            float(stats["total_loss"])  # waits for the step
            captured += capture_train_step(self.state, images, kp, cfg, shadow,
                                           augment=aug.device_augment, mesh=self.mesh)
            if self._watchdog is not None:
                self._watchdog.beat()
        del state, shadow
        if captured:  # the steps replay from the graphs' pool: give back the warm-ups' cache
            torch.cuda.empty_cache()
        print(f"Pre-warmed {len(sizes)} resolution buckets ({captured} train-step graphs "
              f"captured) in {time.monotonic() - t0:.1f}s: "
              + ", ".join(f"{w}x{h}" for w, h in sizes), flush=True)
        return len(sizes)

    # -- loops ----------------------------------------------------------

    def train(self):
        """The epoch loop (reference trainer.py:94-101): validate every 2
        epochs, save the state every epoch."""
        start_epoch = 0
        if self.config.resume_dir and self.resume():
            # skip the epochs already done: the run ends at --epochs total
            steps_per_epoch = max(1, len(self.train_loader))
            start_epoch = min(self.state.step // steps_per_epoch, self.config.epochs)
            if self.is_lead:
                print(f"Resumed from step {self.state.step} "
                      f"(epoch {start_epoch}/{self.config.epochs})", flush=True)
            if start_epoch > 0:
                # the size the unbroken run rolled for this epoch
                self.train_augmentation.trigger_random_resize(start_epoch)

        self._install_preemption_handlers()
        try:
            # warm up before the watchdog is armed: first use of a shape is
            # legitimate start-up work of unbounded length
            if self.config.prewarm:
                self.prewarm()
            if self.config.stall_timeout_s > 0:
                self._watchdog = StallWatchdog(self.config.stall_timeout_s).start()
            epochs = range(start_epoch, self.config.epochs)
            for epoch in progress(epochs, len(epochs), "Training epochs", every=1,
                                  show=self.is_lead):
                self._current_epoch = epoch
                self.train_epoch(epoch)
                if self._stop_agreed():
                    self._preemption_save()
                    return
                if epoch % 2 == 0:
                    self.valid()
                self._save()
                if self._watchdog is not None:
                    self._watchdog.beat()
                self.writer.flush()
                if self.config.malloc_trim:
                    malloc_trim()
            # the conditional policy can freeze a "best" snapshot on an
            # early one-off metric: say so
            if self.is_lead:
                for line in self.best_models.staleness_report(self._current_epoch):
                    print(line)
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
            self._restore_signal_handlers()
            self.writer.close()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.save_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        self._profiled = True

    def train_epoch(self, epoch: int = 0):
        cfg = self.config
        # the shuffle order is a function of (seed, epoch): a resumed run
        # replays the unbroken run's batches
        self.train_loader.set_epoch(epoch)
        augment = self.train_augmentation.device_augment
        profile_this = cfg.profile and not self._profiled and self.is_lead
        prof = None

        batches = device_prefetch(
            progress(self.train_loader, len(self.train_loader), f"Epoch {epoch}",
                     show=self.is_lead), self.device)
        # The stats are read on the host (a wait for the card) every 10th
        # step and whenever a third of the watchdog's timeout has passed:
        # a beat must witness a completed step, and a wait every step
        # would stall the card's queue. No consumer, no wait.
        wd = self._watchdog
        beat_floor_s = wd.timeout_s / 3.0 if wd is not None else None
        last_fetch_t = time.monotonic()
        for i, batch in enumerate(batches):
            if profile_this and i == 5:
                prof = self._start_profile()
            if self.partition is not None and not augment:
                # the host's draws come from one rng that the loader's
                # threads share in no set order
                share_over_model([batch["image"], *batch["keypoints"].values()], self.mesh)
            with span("sd.train.step"):
                stats = train_step(self.state, batch["image"], batch["keypoints"], cfg,
                                   augment=augment, mesh=self.mesh)
            if self.ema_params is not None:
                ema_update(self.ema_params, self.model, cfg.ema, self.state.step)
            if prof is not None and i == 10:
                self._stop_profile(prof)
                prof, profile_this = None, False

            overdue = beat_floor_s is not None and time.monotonic() - last_fetch_t > beat_floor_s
            if (self.log or wd is not None) and (i % 10 == 0 or overdue):
                values = torch.stack(list(stats.values())).tolist()
                last_fetch_t = time.monotonic()
                if self.log:
                    self.writer.scalars("Loss/Train", dict(zip(stats, values)), self.global_step)
                if wd is not None:
                    wd.beat()
            self.global_step += cfg.batch_size
            # SIGTERM/SIGINT: stop at the batch boundary (the ranks agree
            # on one every PREEMPT_POLL_STEPS steps)
            if self.process_count == 1 and self._preempted:
                break
            if self.process_count > 1 and i % PREEMPT_POLL_STEPS == PREEMPT_POLL_STEPS - 1 \
                    and self._stop_agreed():
                break
        if prof is not None:  # an epoch shorter than 11 batches
            self._stop_profile(prof)

        self.writer.scalar("Learning rate", self.lr_schedule(self.state.step), self.global_step)
        self.writer.scalar("Host/rss_mb", host_rss_mb(), self.global_step)
        # multi-scale re-roll for the next epoch (trainer.py:135), keyed on
        # the epoch so a resumed run follows the same sizes
        self.train_augmentation.trigger_random_resize(epoch + 1)

    def valid(self) -> Dict[str, float]:
        """Validation pass (reference trainer.py:137-309): loss, decode and
        metrics per image, the 4 best snapshots, scalars and debug panels."""
        cfg = self.config
        self.evaluator.reset()
        loss_sums: Dict[str, float] = {}
        n = 0
        last = None
        batches = device_prefetch(
            progress(self.valid_loader, len(self.valid_loader), "Validation",
                     show=self.is_lead), self.device)
        for batch in batches:
            outputs, stats, gt_maps = eval_step(self.model, batch["image"], batch["keypoints"],
                                                cfg, params=self.ema_params,
                                                partition=self.partition)
            data = self.decoder(outputs, return_metadata=True)
            bn = len(batch["annotation"])
            for i, annotation in enumerate(batch["annotation"]):
                self.evaluator.accumulate(data["annotation"][i], annotation,
                                          data["raw_parts"][i], eval_csi=True,
                                          eval_classif=True)
            # stats are batch means: weight by the batch's images, so the
            # average is per image whatever the last batch's size (JAX
            # trainer.py:708-712)
            for k, v in zip(stats, torch.stack(list(stats.values())).tolist()):
                loss_sums[k] = loss_sums.get(k, 0.0) + v * bn
            n += bn
            last = (batch, data, gt_maps)
            if self._watchdog is not None:
                self._watchdog.beat()

        loss_avg = {k: v / max(n, 1) for k, v in loss_sums.items()}
        summary = self.evaluator.scalar_summary()
        weights = self._weights()
        if not self.is_lead:  # every rank validated the same set: rank 0 writes
            return summary
        self._check_embedding_plateau(loss_avg)
        self.best_models.update(
            weights,
            loss=loss_avg.get("total_loss", float("inf")),
            csi_f1=summary.get("csi/f1_total", 0.0),
            classif_f1=summary.get("classif/f1_total", 0.0),
            kp_f1=summary.get("kps/f1_total", 0.0),
            epoch=self._current_epoch,
        )
        if self.log:
            self._log_validation(loss_avg, summary)
            if last is not None:
                try:
                    self._log_debug_images(*last)
                except Exception as e:  # drawing must never end a training run
                    print(f"Warning: debug panels not drawn: {e!r}")
        return summary

    def _check_embedding_plateau(self, loss_avg: Dict[str, float]):
        if self._first_val_losses is None:
            # the baseline survives --resume: re-baselining on a resumed
            # run's first validation would silence the warning
            baseline = self.save_dir / "first_val_losses.json"
            try:
                self._first_val_losses = json.loads(baseline.read_text())
            except (OSError, json.JSONDecodeError):
                self._first_val_losses = dict(loss_avg)
                baseline.write_text(json.dumps(self._first_val_losses))
        if not self._warned_embedding_plateau:
            warning = embedding_plateau_warning(self._first_val_losses, loss_avg)
            if warning is not None:
                print(warning)
                self._warned_embedding_plateau = True

    def _log_validation(self, loss_avg, summary):
        step = self.global_step
        self.writer.scalars("Loss/Validation", loss_avg, step)
        for tag, prefix in (("Metrics_AllKps", "kps"), ("Metrics_Anchor", "anchor"),
                            ("Metrics_Parts", "part")):
            for metric in ("f1", "precision", "recall", "acc"):
                vals = {k.split("/", 1)[1].replace(f"{metric}_", ""): v
                        for k, v in summary.items() if k.startswith(f"{prefix}/{metric}")}
                if vals:
                    self.writer.scalars(f"{tag}/{metric}", vals, step)
        self.writer.scalars("Metrics_CSI/f1", {k.split("_", 1)[1]: v for k, v in summary.items()
                                               if k.startswith("csi/f1")}, step)
        self.writer.scalars("Metrics_Classif/f1",
                            {"total": summary.get("classif/f1_total", 0.0)}, step)
        if "grouping/accuracy" in summary:
            self.writer.scalar("Metrics_Grouping/accuracy", summary["grouping/accuracy"], step)

    def _log_debug_images(self, batch, data, gt_maps):
        """The reference's 7 debug panels (trainer.py:257-309), of the
        last validation batch's first image."""
        from .. import visualization as viz

        def hwc(t):
            return np.transpose(t[0].float().cpu().numpy(), (1, 2, 0))

        cfg, step = self.config, self.global_step
        image = batch["image"][0].cpu().numpy()
        gt_a, gt_p = viz.draw_heatmaps(hwc(gt_maps["anchor_hm"]), hwc(gt_maps["part_hm"]), cfg)
        self.writer.image("Heatmaps/Ground_Truth/Anchors", gt_a, step)
        self.writer.image("Heatmaps/Ground_Truth/Parts", gt_p, step)
        self.writer.image("Detections/Ground_Truth",
                          viz.draw(image, batch["annotation"][0], cfg), step)
        self.writer.image("Detections/Prediction",
                          viz.draw(image, data["annotation"][0], cfg), step)
        a_hm, p_hm = viz.draw_heatmaps(hwc(data["anchor_hm_sig"]), hwc(data["part_hm_sig"]), cfg)
        self.writer.image("Heatmaps/Predictions/Anchors", a_hm, step)
        self.writer.image("Heatmaps/Predictions/Parts", p_hm, step)
        self.writer.image("Other/Raw_Predictions",
                          viz.draw_kp_and_emb(image, np.asarray(data["anchors"][0]),
                                              np.asarray(data["parts"][0]), cfg), step)
        self.writer.image("Other/Raw_Embeddings",
                          viz.draw_embeddings(image, hwc(data["raw_embeddings"]), cfg), step)

    # -- resume ----------------------------------------------------------

    def resume(self) -> bool:
        """Restore the latest full state of this run's directory (and the
        EMA beside it)."""
        if not self.checkpoints.restore_state(self.state):
            return False
        self.global_step = self.state.step * self.config.batch_size
        if self.config.ema > 0:
            self.ema_params = self._param_copy()
            ema_file = self.save_dir / "ema_params.msgpack"
            if ema_file.exists():
                try:
                    sd = load_checkpoint(ema_file)
                    if self.partition is not None:
                        sd = self.partition.local_state_dict(sd)
                    for name, value in self.ema_params.items():
                        value.copy_(sd[name])
                except (OSError, ValueError, KeyError) as e:
                    # a file of an older build may be cut short: restart the
                    # average from the restored parameters instead
                    self.ema_params = self._param_copy()
                    print(f"Warning: could not load {ema_file} ({e}); restarting the "
                          "EMA from the restored params")
        return True
