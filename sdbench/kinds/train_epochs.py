"""`train_epochs`: the trainer's epochs back to back, as `cli.train` runs
them, without validation or saves.

Set-up renders a crop set from the seed (JPEGs with their annotations, in a
pool of processes, under the run's directory), builds one
`Trainer(config)` over it with the trainer's defaults (device augmentation,
the native loader, `num_workers` auto, the nine multi-scale buckets warmed
by `Trainer.prewarm()`, which steps a copy of the model) and loads the
seeded weights into its model. The window then runs `train_epoch(0)`,
`(1)`, ... on that trainer until `--seconds` have passed and at least two
epochs have run: whole epochs, loader restart and multi-scale re-roll
included; the card is synchronized at its end.

Traffic keys: `batch_size`, `images` (the crop set's size), `image_size`
(the crops' (w, h)), `learning_rate`, `epochs` and `lr_step` (the
trainer's StepLR schedule).

`train_img_per_s` counts the images stepped in the window over its
length. The check (`compare.train_gaps`) follows two sets of three steps
of the window, read as they run through the trainer's module-level
`train_step` and a forward hook on its model (`Steps`): the first three
steps of epoch 0, against the reference's from the seeded weights, and
the first three of the window's last epoch, against the reference's from
the program's own state at that epoch's start (parameters, BatchNorm
buffers and Adam's moments, snapshotted as the epoch begins): each step's
loss, the first step's output, the first gradient as Adam's first moment
holds it after one step, the parameters' change after three. The numbers
of the last epoch are named `late_<number>`. The control runs the same
window and puts the reference, with every convolution's operands in
float8, in the program's place: from the seeded weights in epoch 0, and
from the program's state at the start of the last epoch.
"""

from __future__ import annotations

import os
import time

import torch

from .. import render
from ..compare import train_gaps
from ..reference.sdnet import fp8_round
from ..reference.train import train_steps
from ..weights import make_state_dict

CHECK_STEPS = 3
MIN_EPOCHS = 2  # epoch 0 and a later one for the check
TERMS = ("hm_loss", "offset_loss", "embedding_loss")  # the step's stats the check reads


class State:
    pass


class Steps:
    """Reads the program's first `CHECK_STEPS` steps of each epoch as the
    window runs them, keeping those of epoch 0 and of the latest epoch.
    Everything is copied on the card as it is produced: no wait for the
    card inside the window."""

    def __init__(self, trainer):
        self.tr, self.records, self.current = trainer, {}, None

    def __enter__(self):
        import structuredetector_tpu_torch.train.trainer as trainer_mod

        self._mod, self._step = trainer_mod, trainer_mod.train_step
        trainer_mod.train_step = self._recording_step
        self._hook = self.tr.model.register_forward_hook(self._on_forward)
        self._want_head = False
        return self

    def __exit__(self, *exc):
        self._mod.train_step = self._step
        self._hook.remove()
        return False

    def _named(self):
        return list(self.tr.state.model.named_parameters())

    def _moments(self, key):
        opt = self.tr.state.optimizer
        return {k: (opt.state[p][key].detach().clone() if key in opt.state.get(p, {})
                    else torch.zeros_like(p)) for k, p in self._named()}

    def begin(self, epoch: int) -> None:
        """Epoch `epoch` starts: snapshot the state the reference follows
        it from (epoch 0's is the seeded weights, which the benchmark holds)."""
        for e in [e for e in self.records if e != 0]:
            del self.records[e]
        rec = {"epoch": epoch, "losses": []}
        if epoch > 0:
            rec["start"] = {k: v.detach().clone()
                            for k, v in self.tr.state.model.state_dict().items()}
            rec["m"], rec["v"] = self._moments("exp_avg"), self._moments("exp_avg_sq")
        self.records[epoch] = self.current = rec

    def _on_forward(self, module, args, output):
        if self._want_head:
            self.current["head"] = output.detach().clone()
            self._want_head = False

    def _recording_step(self, state, *args, **kwargs):
        rec = self.current
        i = len(rec["losses"]) if rec is not None else CHECK_STEPS
        if i >= CHECK_STEPS:
            return self._step(state, *args, **kwargs)
        if i == 0:
            rec["m0"] = rec.get("m")
            rec["p0"] = {k: p.detach().clone() for k, p in self._named()}
            self._want_head = True
        stats = self._step(state, *args, **kwargs)
        self._want_head = False
        rec["losses"].append({n: stats[n].detach().clone() for n in TERMS})
        if i == 0:
            rec["m1"] = self._moments("exp_avg")
        if i == CHECK_STEPS - 1:
            rec["p3"] = {k: p.detach().clone() for k, p in self._named()}
        return stats

    def result(self, epoch: int) -> dict:
        """Epoch `epoch`'s steps as `compare.train_gaps` takes them."""
        rec = self.records[epoch]
        if "p3" not in rec:  # fewer steps than the check needs
            return {"losses": [], "head": None, "grad": {}, "delta": {}}
        b1 = self.tr.state.optimizer.param_groups[0]["betas"][0]
        m0 = rec["m0"]
        grad = {k: (m1 - b1 * m0[k] if m0 is not None else m1) / (1.0 - b1)
                for k, m1 in rec["m1"].items()}
        return {"losses": [{n: float(v) for n, v in x.items()} for x in rec["losses"]],
                "head": rec.get("head"), "grad": grad,
                "delta": {k: rec["p3"][k] - rec["p0"][k] for k in rec["p3"]}}


def _ref_cfg(ctx) -> dict:
    c, t = ctx.config, ctx.traffic
    return {"seed": ctx.seed, "batch_size": t["batch_size"], "width": c["width"],
            "height": c["height"], "max_objects": c["max_objects"],
            "max_parts": c["max_parts"], "down_ratio": c["down_ratio"],
            "sigma_gauss": c["sigma_gauss"], "learning_rate": t["learning_rate"],
            "epochs": t["epochs"], "lr_step": t["lr_step"],
            "flip_prob": 0.5, "labels": {n: i for i, n in enumerate(c["labels"])},
            "parts": {n: i for i, n in enumerate(c["parts"])},
            "anchor_name": c["anchor_name"], "loss_weights": (1.0, 1e-3, 1e-3)}


def setup(ctx):
    from structuredetector_tpu_torch.train.trainer import Trainer

    s = State()
    s.ctx, t, c = ctx, ctx.traffic, ctx.config
    s.crops = render.crop_set(ctx.seed, t["images"], tuple(t["image_size"]),
                              ctx.run_dir / "crops", ctx.workers)
    s.files = sorted(s.crops.glob("*.json"))
    s.sd = make_state_dict(c["backbone"], c["fpn_depth"], ctx.n_out, ctx.seed, ctx.device)
    s.cwd = os.getcwd()
    os.chdir(ctx.run_dir)  # the trainer's trainings/<date> lands here
    cfg = ctx.port_config(train_dir=s.crops, valid_dir=s.crops, batch_size=t["batch_size"],
                          learning_rate=t["learning_rate"], epochs=t["epochs"],
                          lr_step=t["lr_step"])
    tr = Trainer(cfg, device=ctx.device, log=False)
    tr.model.load_state_dict(s.sd)
    tr.prewarm()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    s.trainer, s.cfg = tr, cfg
    return s


def window(s, seconds: float, rec) -> dict:
    t0 = rec.mark_start()
    tr, bs = s.trainer, s.cfg.batch_size
    epochs, epoch, images = [], 0, 0
    with Steps(tr) as steps:
        while epoch < MIN_EPOCHS or time.perf_counter() - t0 < seconds:
            size = tr.train_augmentation.current_size
            steps.begin(epoch)
            with rec.range("sdbench.epoch"):
                tr.train_epoch(epoch)
            n = len(tr.train_loader) * bs
            epochs.append((size, n))
            images += n
            epoch += 1
        if s.ctx.device.type == "cuda":
            torch.cuda.synchronize(s.ctx.device)
        elapsed = time.perf_counter() - t0
    s.steps = steps
    return {"start": t0, "seconds": elapsed, "images": images, "epochs": epochs,
            "attempted": images, "failed": 0, "metrics": {"train_img_per_s": images / elapsed}}


def check(s) -> dict:
    ctx, c = s.ctx, s.ctx.config
    cfg = _ref_cfg(ctx)
    backbone = c["backbone"]
    last = max(s.steps.records)
    program, late = s.steps.result(0), s.steps.result(last)
    rec = s.steps.records[last]
    start, adam = rec["start"], {"t": last * (len(s.files) // cfg["batch_size"]),
                                 "m": rec["m"], "v": rec["v"]}
    del s.trainer, s.steps
    os.chdir(s.cwd)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    def reference(sd, quant=None, **kw):
        return train_steps(sd, backbone, s.files, cfg, CHECK_STEPS, quant=quant, **kw)

    ref, late_ref = reference(s.sd), reference(start, epoch=last, adam=adam)
    if ctx.control:
        program = reference(s.sd, quant=fp8_round)
        late = reference(start, quant=fp8_round, epoch=last, adam=adam)
    numbers = train_gaps(program, ref)
    numbers.update({f"late_{k}": v for k, v in train_gaps(late, late_ref).items()})
    return numbers
