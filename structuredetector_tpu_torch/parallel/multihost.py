"""Multi-process input feeding.

The port of `structuredetector_tpu/parallel/multihost.py`. Every rank
loads only its slice of each global batch:

- the Loader's shuffle is seeded identically on every rank, so all ranks
  agree on the global order;
- each global batch is split contiguously: rank p takes
  `indices[p*L : (p+1)*L]` with L = global_batch // world;
- a global batch that does not split evenly is dropped on every rank.

The JAX package then stitches the slices into one globally sharded
array; here the global batch exists only as the union of the ranks'
slices, so a rank moves its own slice to its device and no more.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils import to_device


def process_slice(indices: List[int], process_index: int, process_count: int):
    """This process's contiguous slice of one global index batch, or
    None when the batch doesn't split evenly (dropped everywhere so all
    processes stay in step)."""
    if process_count <= 1:
        return indices
    if len(indices) % process_count != 0:
        return None
    local = len(indices) // process_count
    return indices[process_index * local : (process_index + 1) * local]


def global_batch_arrays(mesh, images: np.ndarray, kp) -> Tuple[torch.Tensor,
                                                               Dict[str, torch.Tensor]]:
    """A rank's slice of the global batch on its device: the train step's
    (images, keypoint dict) inputs. `kp` is a `FlatKeypoints` or a dict of
    arrays."""
    # imported here: `data.pipeline` imports `process_slice` from this module
    from ..data.pipeline import FlatKeypoints, keypoints_to_device

    if not isinstance(kp, FlatKeypoints):
        kp = FlatKeypoints(**kp)
    return to_device(np.asarray(images), mesh.device), keypoints_to_device(kp, mesh.device)
