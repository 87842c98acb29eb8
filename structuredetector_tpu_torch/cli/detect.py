"""Detect objects in a folder of unlabeled images, on the port.

    python -m structuredetector_tpu_torch.cli.detect --valid_dir DIR \\
        --load_model model.msgpack|model.pth [--device cpu] [--tiled] [config flags]

The port of `structuredetector_tpu/cli/detect.py`: writes one prediction
JSON (reference schema, original pixel coordinates) and one overlay image
per input into `predictions/` under the working directory. Images go
through `Predictor.predict_batch` in batches of `--eval_batch_size` (the
last batch pads by repetition, so one batch shape runs); on CUDA that is
the fast path, with sigmoid + NMS + top-k in kernel B. `--tiled` runs
sliding-window tiles at native resolution instead
(`Predictor.predict_tiled`). Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to detect on ('cuda' or 'cpu').")
    args, rest = p.parse_known_args(argv)

    from ..config import config_from_args
    from ..data.dataset import PredictionDataset
    from ..predictor import Predictor
    from ..utils import progress
    from ..visualization import draw

    config = config_from_args(rest)
    if not config.valid_dir:
        raise SystemExit("Specify the image directory with --valid_dir.")
    if not config.pretrained_model:
        raise SystemExit("No pretrained model specified. Use the option "
                         "'--load_model <model_path>'.")

    predictor = Predictor(config, device=args.device)
    dataset = PredictionDataset(config.valid_dir)
    out_dir = Path("predictions")
    out_dir.mkdir(exist_ok=True)

    def write(image, annotation, image_path):
        annotation.image_path = Path(image_path)
        annotation.save_json(out_dir)
        draw(image, annotation, config).save(out_dir / Path(image_path).name)

    if config.tiled:
        # the decoded RGB image feeds both the tiling and the overlay
        for i in progress(range(len(dataset)), len(dataset), "Prediction"):
            sample = dataset[i]
            annotation = predictor.predict_tiled(sample["img"], overlap=config.tile_overlap)
            write(sample["img"], annotation, sample["path"])
        return out_dir

    bs = config.eval_batch_size
    starts = range(0, len(dataset), bs)
    for start in progress(starts, len(starts), "Prediction"):
        samples = [dataset[i] for i in range(start, min(start + bs, len(dataset)))]
        images = [s["img"] for s in samples]
        n = len(images)
        annotations = predictor.predict_batch(images + [images[-1]] * (bs - n))
        for sample, annotation in zip(samples, annotations[:n]):
            write(sample["img"], annotation, sample["path"])
    return out_dir


if __name__ == "__main__":
    main()
