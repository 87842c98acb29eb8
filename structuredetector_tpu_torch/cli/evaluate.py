"""Evaluate a trained model on an annotated set, on the port.

    python -m structuredetector_tpu_torch.cli.evaluate --valid_dir DIR \\
        --load_model model.msgpack|model.pth [--device cpu] [config flags]

The port of `structuredetector_tpu/cli/evaluate.py`: each batch of
`--eval_batch_size` images is forwarded once on the device (bf16 autocast
unless `--no_amp`), then decoded by the `Decoder` (kernel A, sigmoid +
NMS) at each threshold of `--conf_sweep` (or at `--conf_threshold`), and
the detections accumulate into one `Evaluator` per threshold. Images
decode through the native library (`data/native.py`, byte-equal to
PIL) unless `--no_native_io` is given. Prints the
metric tables (the sweep's one-line readout with `--conf_sweep`); writes
the flat summary with `--save_summary` and the keypoint CSV with
`--save_csv_eval`. Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import torch


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to evaluate on ('cuda' or 'cpu').")
    args, rest = p.parse_known_args(argv)

    from ..config import config_from_args
    from ..data.augment import ValidationAugmentation
    from ..data.dataset import CropDataset
    from ..data.pipeline import Loader, choose_batch_fetch
    from ..evaluation import Evaluator
    from ..ops.decode import split_head_output
    from ..predictor import Predictor
    from ..utils import progress

    config = config_from_args(rest)
    if not config.valid_dir:
        raise SystemExit("evaluate requires --valid_dir (annotated validation samples)")
    if not config.pretrained_model:
        raise SystemExit("evaluate requires a trained model: pass --load_model <model_path>")

    augmentation = ValidationAugmentation(config)
    dataset = CropDataset(config, config.valid_dir, augmentation)
    loader = Loader(dataset, batch_size=config.eval_batch_size,
                    num_workers=config.num_workers,
                    batch_fetch=choose_batch_fetch(config, dataset, augmentation))
    # the host normalizes in float32, as the JAX evaluate feeds its forward
    predictor = Predictor(config, device=args.device, device_normalize=False)
    decoder = predictor.decoder

    # --conf_sweep: the forward runs once a batch; the decode and the
    # host metric accumulation repeat per threshold
    thresholds = config.conf_sweep or (config.conf_threshold,)
    evaluators = {t: Evaluator(config) for t in thresholds}

    with torch.inference_mode():
        for batch in progress(loader, len(loader), "Evaluation"):
            head = predictor.forward(predictor.to_device(batch["image"]))
            outputs = split_head_output(head, config.n_labels, config.n_parts)
            for t, evaluator in evaluators.items():
                data = decoder(outputs, conf_thresh=t, return_metadata=True)
                for i, annotation in enumerate(batch["annotation"]):
                    evaluator.accumulate(
                        data["annotation"][i],
                        annotation,
                        data["raw_parts"][i],
                        eval_csi=True,
                        eval_classif=True,
                    )

    evaluator = evaluators[thresholds[0]]
    if config.conf_sweep:
        summaries = {t: ev.scalar_summary() for t, ev in evaluators.items()}
        for t, s in summaries.items():
            print(
                f"conf={t:g}: "
                f"anchor F1 {s.get('anchor/f1_total', 0.0):.4f}  "
                f"part F1 {s.get('part/f1_total', 0.0):.4f}  "
                f"kps F1 {s.get('kps/f1_total', 0.0):.4f}  "
                f"csi F1 {s.get('csi/f1_total', 0.0):.4f}  "
                f"classif F1 {s.get('classif/f1_total', 0.0):.4f}"
            )
        # operating-point readout: the argmax per headline family; ties
        # go to the earliest threshold listed
        for fam in ("kps", "anchor"):
            best = max(thresholds,
                       key=lambda t: summaries[t].get(f"{fam}/f1_total", 0.0))
            print(f"best {fam} F1: "
                  f"{summaries[best].get(f'{fam}/f1_total', 0.0):.4f} "
                  f"at conf={best:g}")
    elif importlib.util.find_spec("rich") is not None:
        evaluator.pretty_print()
    else:  # the same tables as plain text
        print(evaluator)
    if config.csv_path is not None:
        evaluator.save_kps_csv(config.csv_path)
    if config.summary_path is not None:
        summary = (
            {f"{t:g}": ev.scalar_summary() for t, ev in evaluators.items()}
            if config.conf_sweep
            else evaluator.scalar_summary()
        )
        Path(config.summary_path).write_text(json.dumps(summary, indent=2))
    return evaluators


if __name__ == "__main__":
    main()
