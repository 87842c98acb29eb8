"""Tools of the port, each run as `python -m structuredetector_tpu_torch.tools.<name>`.

Measurement on the card: `bench_topk_variants` (the top-k variant
shootout) and `timing` (CUDA-event timing, the card's name and power
limit). The accuracy chain (the JAX repo's `tools/` scripts that prove
the system's output), each on `--device` (CUDA unless `--device cpu`):
`synthetic_dataset`, `supervise`, `accuracy_gate`, `oracle_grouping`,
`probe_anchor_conf`, `classif_ceiling`, `load_test` and `accuracy_run`,
which chains them.
"""
