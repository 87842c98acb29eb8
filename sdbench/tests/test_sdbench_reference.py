"""The plain reference against the program on seeded weights at a small
size (64x64, `fpn_depth` 16), for both backbones: the forward, the decode,
and the first train steps from the files on disk. Float32 on both sides,
so they agree to rounding."""

import numpy as np
import pytest
import torch

from sdbench import render
from sdbench.reference import decode as ref_decode
from sdbench.reference.sdnet import infer_heads
from sdbench.tests.helpers import tiny_cell, tiny_run
from sdbench.weights import make_state_dict


def _port(backbone):
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.network import init_model

    cfg = Config(width=64, height=64, fpn_depth=16, backbone=backbone, use_amp=False,
                 anchor_name="stem")
    cfg.set_labels(["bean", "maize"], ["leaf"])
    cfg.finalize()
    model = init_model(cfg)
    model.load_state_dict(make_state_dict(backbone, 16, 7, 5, "cpu"))
    return cfg, model


@pytest.mark.parametrize("backbone", ["resnet34", "resnet50"])
def test_forward_and_decode_match_the_program(backbone):
    from structuredetector_tpu_torch.predictor import Predictor, PreparedImage

    cfg, model = _port(backbone)
    sd = make_state_dict(backbone, 16, 7, 5, "cpu")
    frames = np.stack(render.frames(3, 4, (64, 64), 1))
    pred = Predictor(cfg, device="cpu")
    pred.model.load_state_dict(sd)
    with torch.no_grad():
        head = pred.forward(torch.from_numpy(frames))
    ref = infer_heads(sd, backbone, torch.from_numpy(frames))
    torch.testing.assert_close(ref, head, rtol=1e-5, atol=1e-5)

    anns = pred.predict_batch([PreparedImage(f, (64, 64)) for f in frames])
    want = ref_decode.decode(head, 2, 1, max_objects=cfg.max_objects, max_parts=cfg.max_parts,
                             conf=cfg.conf_threshold, dist_thresh=cfg.decoder_dist_thresh)
    for ann, objects in zip(anns, want):
        got = [(cfg.labels[o.name], o.anchor.x, o.anchor.y, o.anchor.score,
                [(cfg.parts[p.kind], p.x, p.y, p.score) for p in o.parts]) for o in ann.objects]
        assert len(got) == len(objects)
        for g, w in zip(got, objects):
            assert g[0] == w[0] and len(g[4]) == len(w[4])
            np.testing.assert_allclose(g[1:4], w[1:4], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cell,size,tol", [("r34-train-b8", 64, 1e-4),
                                           ("r50-train-b32", 128, 5e-3)])
def test_train_steps_match_the_program(cell, size, tol):
    """The program's first three steps (loader, device augmentation, targets,
    forward, loss, backward, Adam) of epoch 0 and of the window's last
    epoch, at its rolled size and from the program's state, against the
    reference's, float32. Adam moves every weight by about the rate whatever
    its gradient, so the rounding of near-zero gradients shows in steps 2-3
    and in the update. At these sizes ResNet-50's C5 BatchNorm normalizes
    over 64 values, and float32 rounding grows through it: its bars are
    wider."""
    numbers = {}
    tiny_run(tiny_cell(cell, width=size, height=size), numbers_out=numbers)
    for prefix in ("", "late_"):
        for name in ("loss_gap", "grad_gap", "head_gap", "head_miss"):
            assert numbers[prefix + name] < tol, numbers
        assert numbers[prefix + "update_gap"] < 0.05, numbers
