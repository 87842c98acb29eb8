"""`infer_swinv2`: `infer_stream`'s closed loop on SDNet with a Swin V2
encoder.

The window is `infer_stream.window`: decoded frames through
`Predictor.predict_batch_submit` in batches at depth 2, annotations
collected with `predict_batch_collect`. Set-up builds the program from
the configuration (`backbone` names the encoder) before anything else,
so a program without that encoder fails at once, then renders the frames
and loads the seeded Swin weights (`reference/swinv2.py`).

Traffic keys: `batch`, `frames` (a pool rendered from the seed, cycled),
`check_batches` (how many of the window's batches the check compares).

The check compares the annotations of `check_batches` batches drawn from
the seed against the float32 reference's maps of the same frames
(`compare.detection_gaps`). The control (`control`) puts in the
program's place the reference with every Linear's operands rounded to
float8 (`sdnet.fp8_round`), decoded by the reference's decode.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import render
from ..compare import detection_gaps
from ..reference import decode as ref_decode
from ..reference import swinv2
from ..reference.sdnet import fp8_round
from .infer_stream import State, annotations_to_objects, window  # noqa: F401


def setup(ctx):
    from structuredetector_tpu_torch.predictor import Predictor, PreparedImage

    s = State()
    s.ctx, t = ctx, ctx.traffic
    c = ctx.config
    s.cfg = ctx.port_config()
    s.pred = Predictor(s.cfg, device=ctx.device)
    size = (c["width"], c["height"])
    s.frames = render.frames(ctx.seed, t["frames"], size, ctx.workers)
    s.arch = swinv2.arch_of(c)
    s.sd = swinv2.make_state_dict(s.arch, c["fpn_depth"], ctx.n_out, ctx.seed, ctx.device)
    s.pred.model.load_state_dict(s.sd)
    s.prepared = [PreparedImage(f, size) for f in s.frames]
    s.batch = t["batch"]
    n = len(s.prepared) // s.batch
    s.batches = [s.prepared[i * s.batch:(i + 1) * s.batch] for i in range(n)]
    for b in s.batches[:3]:  # the one shape this traffic uses
        s.pred.predict_batch(b)
    rng = np.random.default_rng((ctx.seed, 1))
    span = max(t["check_batches"], int(8 * ctx.seconds))
    s.picks = set(rng.choice(span, t["check_batches"], replace=False).tolist())
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return s


def check(s) -> dict:
    ctx, c = s.ctx, s.ctx.config
    del s.pred
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    n, n_labels = len(s.batches), len(c["labels"])
    program, reference = [], []
    for j in sorted(s.kept):
        frames = torch.from_numpy(np.stack([p.array for p in s.batches[j % n]])).to(ctx.device)
        head = swinv2.infer_heads(s.sd, s.arch, frames)
        reference += ref_decode.maps(head, n_labels, max_objects=c["max_objects"],
                                     down=c["down_ratio"])
        if ctx.control:
            control = swinv2.infer_heads(s.sd, s.arch, frames, quant=fp8_round)
            program += ref_decode.decode(
                control, n_labels, len(c["parts"]), max_objects=c["max_objects"],
                max_parts=c["max_parts"], conf=c["conf_threshold"],
                dist_thresh=c["decoder_dist_thresh"], down=c["down_ratio"])
        else:
            program += annotations_to_objects(s.kept[j], s.cfg)
    return detection_gaps(program, reference, n_labels=n_labels)
