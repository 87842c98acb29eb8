"""Checkpoints: the full train state for resume, and the 4 best models.

The port of `structuredetector_tpu/train/checkpoints.py`:

- `CheckpointManager` saves the whole `TrainState` (parameters, BN
  buffers, Adam's moments and step counts, the step) with `torch.save`
  into `<run dir>/state/`, each file written aside and moved into place
  with `os.replace`, keeping the 2 newest. The format is the port's own:
  the JAX package's Orbax run directories cannot be resumed by the port,
  nor the port's by the JAX package.
- `BestModelSaver` keeps the reference's 4 conditional snapshots per
  validation (`trainer.py:226-237`): model_best_loss / _csi / _classif /
  _kp_reg, written as the JAX package's `.msgpack`
  (`models.weights.save_msgpack`), so both packages' `evaluate
  --load_model` read them. The best metrics persist in
  `best_metrics.json` across `--resume`, with the epoch of each capture
  for the end-of-run staleness report.

Neither creates a directory before its first write, so a data-parallel
run builds both on every rank (`--resume` reads on every rank) and only
rank 0, which alone writes, makes the run directory. The files hold
whole tensors whatever the mesh (`TrainState.state_dict`).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Mapping, Optional

import torch

from ..models.weights import save_msgpack
from .state import TrainState

_STATE_FILE = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 2):
        self.directory = Path(directory).resolve() / "state"
        self.max_to_keep = max_to_keep

    def _steps(self):
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _STATE_FILE.fullmatch(p.name)))

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:012d}.pt"

    def save_state(self, step: int, state) -> Path:
        """Write `state`, a `TrainState` or its `state_dict()` (which under
        the model axis every rank gathers before rank 0 writes)."""
        path = self._path(step)
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(state.state_dict() if isinstance(state, TrainState) else state, tmp)
        os.replace(tmp, path)
        for old in self._steps()[: -self.max_to_keep]:
            self._path(old).unlink()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_state(self, state: TrainState, step: Optional[int] = None) -> bool:
        """Load the checkpoint of `step` (default the latest) into `state`,
        on its model's device. False when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return False
        device = next(state.model.parameters()).device
        state.load_state_dict(torch.load(self._path(step), map_location=device,
                                         weights_only=True))
        return True


class BestModelSaver:
    """Track the best loss / CSI / classif / keypoint F1 and snapshot the
    weights that reached each. The best values live in
    `best_metrics.json` beside the snapshots and are read back on
    construction, so a resumed run does not overwrite better snapshots
    taken before it was stopped."""

    _STATE_FILE = "best_metrics.json"
    KINDS = ("loss", "csi", "classif", "kp_reg")

    def __init__(self, save_dir):
        self.save_dir = Path(save_dir)
        self.best_loss = float("inf")
        self.best_csi = 0.0
        self.best_classif = 0.0
        self.best_kp_reg = 0.0
        # epoch each snapshot was captured at (-1 = never)
        self.captured_epoch = {k: -1 for k in self.KINDS}
        self._load()

    def _load(self):
        path = self.save_dir / self._STATE_FILE
        if not path.exists():
            return
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return  # a corrupt or partial file: start tracking afresh
        self.best_loss = float(data.get("best_loss", self.best_loss))
        self.best_csi = float(data.get("best_csi", self.best_csi))
        self.best_classif = float(data.get("best_classif", self.best_classif))
        self.best_kp_reg = float(data.get("best_kp_reg", self.best_kp_reg))
        for k, e in data.get("captured_epoch", {}).items():
            if k in self.captured_epoch:
                self.captured_epoch[k] = int(e)

    def _persist(self):
        path = self.save_dir / self._STATE_FILE
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps({
            "best_loss": self.best_loss,
            "best_csi": self.best_csi,
            "best_classif": self.best_classif,
            "best_kp_reg": self.best_kp_reg,
            "captured_epoch": self.captured_epoch,
        }))
        os.replace(tmp, path)

    def update(self, weights: Mapping[str, torch.Tensor], *, loss: float, csi_f1: float,
               classif_f1: float, kp_f1: float, epoch: int = -1) -> list:
        """Snapshot `weights` (a state_dict) under each metric it improves;
        returns the kinds saved."""
        better = {
            "loss": loss < self.best_loss,
            "csi": csi_f1 > self.best_csi,
            "classif": classif_f1 > self.best_classif,
            "kp_reg": kp_f1 > self.best_kp_reg,
        }
        if better["loss"]:
            self.best_loss = loss
        if better["csi"]:
            self.best_csi = csi_f1
        if better["classif"]:
            self.best_classif = classif_f1
        if better["kp_reg"]:
            self.best_kp_reg = kp_f1
        saved = [k for k in self.KINDS if better[k]]
        if saved:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        for k in saved:
            save_msgpack(weights, self.save_dir / f"model_best_{k}.msgpack")
            self.captured_epoch[k] = epoch
        if saved:
            self._persist()
        return saved

    def staleness_report(self, final_epoch: int, stale_after: int = 10) -> list:
        """Capture ages; a snapshot more than `stale_after` epochs older
        than the run's end is flagged STALE."""
        lines = []
        for k, e in self.captured_epoch.items():
            if e < 0:
                continue
            age = final_epoch - e
            flag = "  <-- STALE: metric froze early, prefer another snapshot" \
                if age > stale_after else ""
            lines.append(f"model_best_{k}.msgpack: captured at epoch {e} "
                         f"({age} epochs before the end){flag}")
        return lines
