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
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on ('cuda' or 'cpu').")
    args, rest = p.parse_known_args(argv)

    from ..config import config_from_args
    from ..train.trainer import Trainer

    config = config_from_args(rest)
    if not config.train_dir:
        raise SystemExit("train requires --train_dir (annotated training samples)")
    if not config.valid_dir:
        raise SystemExit("train requires --valid_dir (annotated validation samples)")
    trainer = Trainer(config, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
