"""Train an SDNet on an annotated set, on the port.

    python -m structuredetector_tpu_torch.cli.train --train_dir DIR \\
        --valid_dir DIR [--device cpu] [config flags]

The port of `structuredetector_tpu/cli/train.py` with the JAX package's
flags (`config.build_parser`), plus `--device`. The run writes
`trainings/<timestamp>/` under the working directory: the full state
under `state/` (for `--resume`), `model_best_{loss,csi,classif,kp_reg}
.msgpack` (read by both packages' `evaluate --load_model`), and, with
tensorboard installed, its scalars and debug panels. Runs on CUDA unless
`--device cpu` is given.

Data parallelism, one process a device:

    torchrun --nproc_per_node N -m structuredetector_tpu_torch.cli.train \
        --data_parallel N --train_dir DIR --valid_dir DIR [flags]

`--batch_size` is the global batch; each rank loads its slice, and the
step has the global batch's loss, gradients and BN statistics
(`parallel.mesh`). Rank 0 alone logs and writes `trainings/`. The
backend is NCCL when each rank has a card of its own, gloo when ranks
share a card or run on the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on ('cuda' or 'cpu').")
    args, rest = p.parse_known_args(argv)

    import torch.distributed as dist

    from ..config import config_from_args
    from ..parallel.mesh import maybe_initialize_distributed
    from ..train.trainer import Trainer
    from ..utils import set_build_dir

    # under torchrun, join the process group before the config is checked
    # (--data_parallel must equal its size); a group this call starts is
    # torn down at the end
    started = not dist.is_initialized() and maybe_initialize_distributed(args.device)
    try:
        config = config_from_args(rest)
        if config.compile_cache:
            # before the first build: the kernels and the native I/O library
            # are then built in, and reused from, this directory
            set_build_dir(config.compile_cache)
        if not config.train_dir:
            raise SystemExit("train requires --train_dir (annotated training samples)")
        if not config.valid_dir:
            raise SystemExit("train requires --valid_dir (annotated validation samples)")
        trainer = Trainer(config, device=args.device)
        trainer.train()
    finally:
        if started:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
