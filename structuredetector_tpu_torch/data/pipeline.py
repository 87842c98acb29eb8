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
  replays the batch order; a thread pool for the per-sample loads, or a
  whole-batch `batch_fetch`; under data parallelism each rank loads its
  slice of every global batch, `parallel.multihost`);
- `native_batch_fetch` / `choose_batch_fetch`: the whole-batch native
  loader (`data/native.py`), which `--native_io` turns on where the host
  does no per-pixel augmentation;
- `device_prefetch` stages batches on the device ahead of the consumer.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from ..annotations import ImageAnnotation, clip_annotation
from ..parallel.multihost import process_slice
from ..tracing import span
from . import native


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


class Loader:
    """Batches of `dataset[i]`.

    Without `shuffle` the order is the dataset's. With it, the order of
    an epoch is `np.random.default_rng((seed, epoch))`'s shuffle, a pure
    function of the epoch that `set_epoch` pins: a resumed run replays the
    batch order of the unbroken run with no random state saved.
    `drop_last` drops a last, smaller batch. `collate_fn` makes a batch of
    its samples. With `num_workers > 0`, every sample load is a task on a
    thread pool of that size (PIL's decode and resize and the numpy work
    release the GIL), and up to `prefetch_batches` (at least 1) batches
    of loads stay in flight.

    With `batch_fetch`, a callable from a batch's indices to its collated
    dict (`native_batch_fetch`), whole batches are made on one
    coordinator thread, up to `prefetch_batches` ahead; the parallelism
    lives inside the call (the native loader's own threads).

    With `process_count` > 1, `batch_size` is the global batch: every
    rank draws the same global order and loads its contiguous slice of
    each global batch (`parallel.multihost.process_slice`, either route),
    and `len()` counts global batches."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0, seed: int = 0,
                 collate_fn=collate, batch_fetch=None, prefetch_batches: int = 4,
                 process_index: int = 0, process_count: int = 1):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if batch_size % process_count:
            raise ValueError(f"the global batch {batch_size} does not divide by the "
                             f"{process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.collate_fn = collate_fn
        self.batch_fetch = batch_fetch
        self.prefetch_batches = max(1, prefetch_batches)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order to (seed, epoch)."""
        self._epoch = int(epoch)

    def __len__(self):
        full, rest = divmod(len(self.dataset), self.batch_size)
        # a last, smaller batch is kept where it splits over the processes
        if rest and not self.drop_last and rest % self.process_count == 0:
            full += 1
        return full

    def _index_batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        batches = [[int(i) for i in order[s : s + self.batch_size]]
                   for s in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.process_count > 1:
            batches = [local for b in batches if (local := process_slice(
                b, self.process_index, self.process_count)) is not None]
        return batches

    def __iter__(self):
        # `sd.loader.wait`: the consumer waits for (or, without workers,
        # makes) the next batch
        with span("sd.loader.wait"):
            batches = self._index_batches()
        if self.batch_fetch is not None:
            yield from self._iter_batch_fetch(batches)
            return
        if self.num_workers <= 0:
            for idxs in batches:
                with span("sd.loader.wait"):
                    batch = self.collate_fn([self.dataset[i] for i in idxs])
                yield batch
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight: collections.deque = collections.deque()
            it = iter(batches)

            def stage_next():
                idxs = next(it, None)
                if idxs is not None:
                    inflight.append([pool.submit(self.dataset.__getitem__, i) for i in idxs])

            for _ in range(self.prefetch_batches):
                stage_next()
            while inflight:
                with span("sd.loader.wait"):
                    futures = inflight.popleft()
                    samples = [f.result() for f in futures]
                    stage_next()
                    batch = self.collate_fn(samples)
                yield batch

    def _iter_batch_fetch(self, batches):
        """Whole batches made ahead on a coordinator thread; an error
        there is raised here, at the batch it struck."""
        staged: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    staged.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for idxs in batches:
                    if not put(self.batch_fetch(idxs)):
                        return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
            put(done)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                with span("sd.loader.wait"):
                    item = staged.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early (break, an error) lets the
            # coordinator finish its batch and end
            stop.set()
            worker.join()


def native_batch_fetch(dataset, transform, n_threads: int = 4):
    """A `Loader(batch_fetch=...)` callable over the native library: the
    annotations are read on the coordinator thread without decoding the
    images, then one `native.load_batch` call decodes the whole batch on
    `n_threads` C++ threads outside the GIL."""

    def fetch(indices):
        pairs = [dataset.raw_item(i) for i in indices]
        return transform.native_batch_apply(
            [path for path, _ in pairs], [target for _, target in pairs],
            n_threads=n_threads)

    return fetch


def choose_batch_fetch(config, dataset, transform):
    """The whole-batch native loader where `--native_io` asks for it, the
    library is built and the transform's mode allows it (no per-pixel
    host augmentation); else None, the per-sample PIL path (JAX
    `pipeline.py:280-295`)."""
    if not config.native_io or not native.available():
        return None
    supports = getattr(transform, "supports_native_batch", None)
    if supports is None or not supports():
        return None
    return native_batch_fetch(dataset, transform,
                              n_threads=max(2, config.num_workers or 4))


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
        with span("sd.loader.h2d"):
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
