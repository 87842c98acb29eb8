"""`infer_stream`: a closed loop through the library entry users embed.

Frames that are already decoded (uint8 RGB at the network's size, as a
robot's camera hands them over) go to `Predictor.predict_batch_submit` in
batches, at depth 2: batch N+1 is submitted before batch N's annotations
are collected with `predict_batch_collect`, as the serving pipeline does.
HTTP and file decode are bypassed; host prep, the copy to the card, the
forward, the decode and the annotations are timed.

Traffic keys: `batch`, `frames` (a pool rendered from the seed, cycled),
`check_batches` (how many of the window's batches the check compares).

`infer_img_per_s` counts the images whose annotations came back in the
window over the window's length. The check compares the annotations of
`check_batches` batches drawn from the seed (among the window's first
eight a second) against the reference's maps of the same frames in
float32. The control (`control`) runs the same with
the program's int8 convolutions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import render
from ..compare import detection_gaps
from ..reference import decode as ref_decode
from ..reference.sdnet import infer_heads
from ..weights import make_state_dict


def annotations_to_objects(anns, cfg):
    """The program's `ImageAnnotation`s of frames at the network's size ->
    comparison objects (`compare.Obj`)."""
    return [[(cfg.labels[o.name], o.anchor.x, o.anchor.y, o.anchor.score,
              [(cfg.parts[p.kind], p.x, p.y, p.score) for p in o.parts]) for o in ann.objects]
            for ann in anns]


class State:
    pass


def make_predictor(ctx, sd):
    from structuredetector_tpu_torch.predictor import Predictor

    cfg = ctx.port_config(int8=bool(ctx.control))
    pred = Predictor(cfg, device=ctx.device)
    pred.model.load_state_dict(sd)
    return cfg, pred


def setup(ctx):
    from structuredetector_tpu_torch.predictor import PreparedImage

    s = State()
    s.ctx, t = ctx, ctx.traffic
    c = ctx.config
    size = (c["width"], c["height"])
    s.frames = render.frames(ctx.seed, t["frames"], size, ctx.workers)
    s.sd = make_state_dict(c["backbone"], c["fpn_depth"], ctx.n_out, ctx.seed, ctx.device)
    s.cfg, s.pred = make_predictor(ctx, s.sd)
    s.prepared = [PreparedImage(f, size) for f in s.frames]
    s.batch = t["batch"]
    n = len(s.prepared) // s.batch
    s.batches = [s.prepared[i * s.batch:(i + 1) * s.batch] for i in range(n)]
    for b in s.batches[:3]:  # the one shape this traffic uses
        s.pred.predict_batch(b)
    # the batches the check compares, drawn from the seed among the first
    # eight a second of the window: only their answers are kept, so the
    # window holds no more Python objects than a user's loop would
    rng = np.random.default_rng((ctx.seed, 1))
    span = max(t["check_batches"], int(8 * ctx.seconds))
    s.picks = set(rng.choice(span, t["check_batches"], replace=False).tolist())
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return s


def window(s, seconds: float, rec) -> dict:
    pred = s.pred
    decode = pred.decode

    def traced_decode(*args, **kwargs):
        with rec.range("sdbench.decode"):
            return decode(*args, **kwargs)

    pred.decode = traced_decode
    n, done, kept = len(s.batches), 0, {}
    t0 = rec.mark_start()
    pending = pred.predict_batch_submit(s.batches[0])
    while True:
        nxt = pred.predict_batch_submit(s.batches[(done + 1) % n])
        answer = pred.predict_batch_collect(pending)
        if done in s.picks:
            kept[done] = answer
        done, pending = done + 1, nxt
        if time.perf_counter() - t0 >= seconds:
            break
    answer = pred.predict_batch_collect(pending)
    if done in s.picks:
        kept[done] = answer
    done += 1
    elapsed = time.perf_counter() - t0
    pred.decode = decode
    images = done * s.batch
    s.kept = kept
    return {"start": t0, "seconds": elapsed, "images": images, "batch": s.batch,
            "attempted": images, "failed": sum(len(a) != s.batch for a in kept.values()),
            "metrics": {"infer_img_per_s": images / elapsed}}


def check(s) -> dict:
    ctx, c = s.ctx, s.ctx.config
    cfg = s.cfg
    del s.pred
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    n = len(s.batches)
    program, reference = [], []
    for j in sorted(s.kept):
        frames = np.stack([p.array for p in s.batches[j % n]])
        head = infer_heads(s.sd, c["backbone"], torch.from_numpy(frames).to(ctx.device))
        reference += ref_decode.maps(head, len(c["labels"]), max_objects=c["max_objects"],
                                     down=c["down_ratio"])
        program += annotations_to_objects(s.kept[j], cfg)
    return detection_gaps(program, reference, n_labels=len(c["labels"]))
