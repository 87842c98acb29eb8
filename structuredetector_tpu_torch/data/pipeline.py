"""Host <-> device bridge: annotations -> padded arrays -> batches on the card.

The port of `structuredetector_tpu/data/pipeline.py`:

- `flatten_annotation` turns one annotation into small padded keypoint
  arrays in grid coordinates (`FlatKeypoints`); the train step renders
  the dense targets on the device (`ops.encode.encode_targets`). The
  reference's selection is kept exactly (`transforms.py:157-191`):
  objects beyond `max_objects` are dropped, parts fill one global
  `max_parts` budget in object order, and the budget can cut an object's
  parts mid-iteration; coordinates are clipped to the input, then scaled
  into the grid;
- `collate` and `Loader` (shuffled by (seed, epoch), so a resumed run
  replays the batch order; a thread pool for the per-sample loads);
- `device_prefetch` stages batches on the device ahead of the consumer.

The JAX package's whole-batch native loader (`native_batch_fetch`,
`choose_batch_fetch`) and its multi-host slicing are not part of the
port: `--native_io` is accepted and ignored.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from ..annotations import ImageAnnotation, clip_annotation


class FlatKeypoints(NamedTuple):
    """Per-sample padded keypoint arrays (grid coordinates)."""

    anchors_xy: np.ndarray  # (O, 2) float32
    anchor_cls: np.ndarray  # (O,) int32
    anchor_mask: np.ndarray  # (O,) bool
    parts_xy: np.ndarray  # (P, 2) float32
    part_kind: np.ndarray  # (P,) int32
    part_owner_xy: np.ndarray  # (P, 2) float32
    part_mask: np.ndarray  # (P,) bool


def flatten_annotation(
    annotation: ImageAnnotation,
    *,
    labels: Dict[str, int],
    parts: Dict[str, int],
    max_objects: int,
    max_parts: int,
    in_size,
    out_size,
) -> FlatKeypoints:
    """Flatten one annotation, already in input-image space (after the
    resize), into padded grid-space arrays. The annotation is clipped in
    place to the input, like the reference's (`transforms.py:154`)."""
    in_w, in_h = in_size
    out_w, out_h = out_size
    sx, sy = out_w / in_w, out_h / in_h

    clip_annotation(annotation, (in_w, in_h))

    o, p = max_objects, max_parts
    anchors_xy = np.zeros((o, 2), np.float32)
    anchor_cls = np.zeros((o,), np.int32)
    anchor_mask = np.zeros((o,), bool)
    parts_xy = np.zeros((p, 2), np.float32)
    part_kind = np.zeros((p,), np.int32)
    part_owner_xy = np.zeros((p, 2), np.float32)
    part_mask = np.zeros((p,), bool)

    kp_idx = 0
    done = False
    for obj_idx, obj in enumerate(annotation.objects[:max_objects]):
        gx, gy = obj.x * sx, obj.y * sy
        anchors_xy[obj_idx] = (gx, gy)
        anchor_cls[obj_idx] = labels[obj.name]
        anchor_mask[obj_idx] = True

        for kp in obj.parts:
            parts_xy[kp_idx] = (kp.x * sx, kp.y * sy)
            part_kind[kp_idx] = parts[kp.kind]
            part_owner_xy[kp_idx] = (gx, gy)
            part_mask[kp_idx] = True
            kp_idx += 1
            if kp_idx == max_parts:
                done = True
                break
        if done:
            break

    return FlatKeypoints(
        anchors_xy, anchor_cls, anchor_mask, parts_xy, part_kind, part_owner_xy, part_mask
    )


def collate(samples: Sequence[dict]) -> dict:
    """Stack per-sample dicts into a batch dict of numpy arrays;
    `FlatKeypoints` stack field by field; 'annotation' stays a Python list
    (reference collate_fn, dataset.py:57-87)."""
    batch: dict = {}
    for key, value in samples[0].items():
        if key == "annotation":
            batch[key] = [s[key] for s in samples]
        elif isinstance(value, FlatKeypoints):
            batch[key] = FlatKeypoints(
                *(np.stack([getattr(s[key], f) for s in samples]) for f in value._fields))
        else:
            batch[key] = np.stack([s[key] for s in samples])
    return batch


PREFETCH_BATCHES = 4  # batches of sample loads in flight ahead of the consumer


class Loader:
    """Batches of `dataset[i]`.

    Without `shuffle` the order is the dataset's. With it, the order of
    an epoch is `np.random.default_rng((seed, epoch))`'s shuffle, a pure
    function of the epoch that `set_epoch` pins: a resumed run replays the
    batch order of the unbroken run with no random state saved.
    `drop_last` drops a last, smaller batch. With `num_workers > 0`,
    every sample load is a task on a thread pool of that size (PIL's
    decode and resize and the numpy work release the GIL), and up to
    `PREFETCH_BATCHES` batches of loads stay in flight."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0, seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order to (seed, epoch)."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        batches = [[int(i) for i in order[s : s + self.batch_size]]
                   for s in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self):
        batches = self._index_batches()
        if self.num_workers <= 0:
            for idxs in batches:
                yield collate([self.dataset[i] for i in idxs])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight: collections.deque = collections.deque()
            it = iter(batches)

            def stage_next():
                idxs = next(it, None)
                if idxs is not None:
                    inflight.append([pool.submit(self.dataset.__getitem__, i) for i in idxs])

            for _ in range(PREFETCH_BATCHES):
                stage_next()
            while inflight:
                futures = inflight.popleft()
                samples = [f.result() for f in futures]
                stage_next()
                yield collate(samples)


def keypoints_to_device(kp: FlatKeypoints, device) -> Dict[str, torch.Tensor]:
    """A batch's `FlatKeypoints` -> dict of tensors on `device`, the form
    the train and eval steps take."""
    return {f: _to_device(getattr(kp, f), device) for f in FlatKeypoints._fields}


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        # pinned + non_blocking: the copy queues on the stream behind the
        # running step instead of blocking this thread on it
        return t.pin_memory().to(device, non_blocking=True)
    return t


def device_prefetch(iterator, device, size: int = 2):
    """Stage up to `size` batches ahead on `device`: 'image' becomes a
    tensor, 'keypoints' a dict of tensors (`keypoints_to_device`), the
    rest stays on the host. On the card the copies are asynchronous, so
    batch N+1 moves while the card runs step N."""
    device = torch.device(device)

    def to_device(batch):
        out = dict(batch)
        out["image"] = _to_device(batch["image"], device)
        if "keypoints" in batch:
            out["keypoints"] = keypoints_to_device(batch["keypoints"], device)
        return out

    staged: collections.deque = collections.deque()
    for batch in iterator:
        staged.append(to_device(batch))
        if len(staged) >= size:
            yield staged.popleft()
    while staged:
        yield staged.popleft()
