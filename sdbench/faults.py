"""Faults planted in the program under test, to show that the check of a
cell fails them and to read their numbers (`sdbench.readings --fault`, the
CPU tests). Each is a context manager that patches one function of the
program for its duration. Never used by a benchmark run.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def altered_answers():
    """An answer altered where it is produced: every anchor score the host
    decode materializes moves down by 0.1."""
    from structuredetector_tpu_torch.data.decoders import Decoder

    def make(materialize):
        def altered(self, anchors, *args, **kwargs):
            anchors = anchors.copy()
            anchors[..., 2] -= 0.1
            return materialize(self, anchors, *args, **kwargs)
        return altered

    return _patched(Decoder, "materialize", make)


def half_batch_answers():
    """Half of each batch left out: its second half comes back with no
    detections."""
    from structuredetector_tpu_torch.data.decoders import Decoder

    def make(materialize):
        def half(self, *args, **kwargs):
            anns = materialize(self, *args, **kwargs)
            for a in anns[len(anns) // 2:]:
                a.objects = []
            return anns
        return half

    return _patched(Decoder, "materialize", make)


def state_unchanged():
    """A step that returns its state unchanged: no Adam update."""
    from structuredetector_tpu_torch.train.state import TrainState

    def make(_):
        def no_update(self):
            self.step += 1
        return no_update

    return _patched(TrainState, "apply_gradients", make)


def half_batch_step():
    """Half of the batch left out, the mean taken over the rest."""
    import structuredetector_tpu_torch.train.trainer as trainer_mod

    def make(step):
        def half(state, images, kp, *args, **kwargs):
            b = images.shape[0] // 2
            return step(state, images[:b], {k: v[:b] for k, v in kp.items()}, *args, **kwargs)
        return half

    return _patched(trainer_mod, "train_step", make)


FAULTS = {f.__name__: f for f in (altered_answers, half_batch_answers, state_unchanged,
                                  half_batch_step)}
