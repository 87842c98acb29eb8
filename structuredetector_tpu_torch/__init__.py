"""PyTorch/CUDA port of structuredetector_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports `torch` and
nothing of JAX or of `structuredetector_tpu`. This slice carries the
serving path: the resnet34 SDNet, the decode with its two hand-written
CUDA kernels (`ops/kernels`, sources in `csrc/`), the `Predictor` and
the micro-batching HTTP server (`python -m
structuredetector_tpu_torch.cli.serve`). Entry points run on CUDA
unless the caller passes `device="cpu"`.
"""
