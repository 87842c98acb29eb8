"""PyTorch/CUDA port of structuredetector_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports `torch` and
nothing of JAX or of `structuredetector_tpu`, and does what the JAX
package does:

- the SDNet (`models/`: resnet18/34/50 encoders, the 7x7 or the
  space-to-depth stem, the 1x1 or the hidden head; weights from and to
  reference `.pth` and JAX `.msgpack` files, a torchvision warm start)
  and its int8 inference with static scales;
- the decode with its three hand-written CUDA kernels (`ops/kernels`,
  sources in `csrc/`), the `Predictor`, `.sdz` artifacts (`export.py`)
  and the `ExportPredictor`, the micro-batching HTTP server (`serve.py`)
  and the `Evaluator`;
- training: targets, losses, device augmentation, the train step and
  the `Trainer`, across processes under torchrun on a ("data", "model")
  mesh (`parallel/`: data parallelism, output-channel tensor
  parallelism, row partitioning);
- the native input tier (`data/native.py`);
- the CLIs, `python -m structuredetector_tpu_torch.cli.{train,evaluate,
  detect,serve,convert_export,evaluate_export,benchmark}`.

Entry points run on CUDA unless the caller passes `device="cpu"`
(`--device cpu`).

The API is JAX `__init__.py`'s: `Config`, `Box`, `ImageAnnotation`,
`Keypoint` and `Object` here, `Predictor`, `ExportPredictor`,
`MicroBatcher`, `Evaluator`, `Trainer` and `SDNet` imported on first use,
so importing the package loads neither `ops/kernels/_build.py`, nor
`parallel/`, nor the server. `data`, `ops`, `models` and `train`
re-export the names of JAX's subpackages; where the port renamed one:

- `models.load_params` / `save_params`: `models.load_checkpoint` (a
  `.pth` or `.msgpack` to a state_dict; `load_weights` loads it into a
  model) / `models.save_msgpack`;
- `models.ResNet34Encoder`: `models.ResNetEncoder`;
- `models.torch_export.export_sdnet_state_dict`:
  `models.export_reference_state_dict` (from the port's model, not a
  JAX tree); `save_reference_pth` keeps its name;
- `train.make_train_step` / `make_eval_step`: `train.train_step` /
  `eval_step`, the steps themselves rather than factories of them;
- JAX `parallel.mesh`'s sharding helpers: `batch_sharding` is each rank's
  slice of the batch on the data axis (`parallel.multihost.
  global_batch_arrays`), `replicated_sharding` a model left whole,
  `spatial_sharding` `parallel.partition.RowPlan`, `param_shardings`
  `parallel.mesh.param_shardings` (the names that shard) and
  `shard_variables` `parallel.partition.shard_model`.
"""

__version__ = "0.1.0"

from .annotations import Box, ImageAnnotation, Keypoint, Object
from .config import Config

# the names resolved on first use, by the module that defines them
_LAZY = {"Predictor": ".predictor", "ExportPredictor": ".predictor",
         "MicroBatcher": ".serve", "Evaluator": ".evaluation", "Trainer": ".train",
         "SDNet": ".models"}

__all__ = ["Box", "Config", "ImageAnnotation", "Keypoint", "Object", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
