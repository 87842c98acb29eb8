"""The benchmark of the PyTorch/CUDA port (`structuredetector_tpu_torch`):
one command runs one cell of `BENCHMARK.json` (`python3 -m sdbench.run`)."""
