"""PyTorch/CUDA port of structuredetector_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports `torch` and
nothing of JAX or of `structuredetector_tpu`. It carries the resnet34
SDNet (`.pth` and JAX `.msgpack` checkpoints), the decode with its three
hand-written CUDA kernels (`ops/kernels`, sources in `csrc/`), the
`Predictor`, the micro-batching HTTP server and the `evaluate`/`detect`
CLIs (`python -m structuredetector_tpu_torch.cli.{serve,evaluate,detect}`).
Entry points run on CUDA unless the caller passes `device="cpu"`.
"""
