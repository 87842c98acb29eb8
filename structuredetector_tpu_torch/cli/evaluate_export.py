"""Evaluate an exported `.sdz` artifact on an annotated set, on the port.

    python -m structuredetector_tpu_torch.cli.evaluate_export model.sdz \\
        --valid_dir DIR [--save_summary S.json] [--device cpu]

The port of `structuredetector_tpu/cli/evaluate_export.py`: the config
(size, stride, labels, anchor name) comes from the artifact's metadata;
the feed is `ExportTransforms` (raw [0, 255]) for a `--norm` artifact,
else `ValidationAugmentation`, cast to uint8 for a uint8 artifact.
`ExportDecoder` decodes (sigmoid + NMS already ran in the program). A
ragged last batch against a static-batch artifact is padded with zero
images and only the real rows are scored. Runs on CUDA unless
`--device cpu` is given; the artifact must be traced for that device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", type=str, help="Path to the exported .sdz model.")
    p.add_argument("--valid_dir", type=str, required=True)
    p.add_argument("--anchor_name", "-s", type=str, default="anchor")
    p.add_argument("--max_objects", "-n", type=int, default=20)
    p.add_argument("--max_parts", "-k", type=int, default=40)
    p.add_argument("--sigma_gauss", type=float, default=0.1)
    p.add_argument("--conf_threshold", "-t", type=float, default=0.5)
    p.add_argument("--dist_threshold", "-d", type=float, default=0.05)
    p.add_argument("--decoder_dist_thresh", type=float, default=0.1)
    p.add_argument("--csi_threshold", type=float, default=0.75)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--save_summary", type=str, default=None,
                   help="Write the flat metric summary (scalar_summary) as JSON.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to evaluate on ('cuda' or 'cpu').")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from ..data.augment import ExportTransforms, ValidationAugmentation
    from ..data.dataset import CropDataset
    from ..data.decoders import ExportDecoder
    from ..data.pipeline import Loader
    from ..evaluation import Evaluator
    from ..export import config_from_metadata, load_exported
    from ..ops.decode import split_head_output
    from ..utils import progress

    call, meta = load_exported(Path(args.model).expanduser().resolve(), args.device)
    config = config_from_metadata(
        meta, anchor_name=args.anchor_name,
        max_objects=args.max_objects, max_parts=args.max_parts,
        sigma_gauss=args.sigma_gauss, conf_threshold=args.conf_threshold,
        dist_threshold=args.dist_threshold,
        decoder_dist_thresh=args.decoder_dist_thresh,
        csi_threshold=args.csi_threshold, num_workers=args.num_workers,
        valid_dir=Path(args.valid_dir).expanduser().resolve(),
    )

    evaluator = Evaluator(config)
    decoder = ExportDecoder(config)
    transform = (ExportTransforms(config) if meta.get("normalized")
                 else ValidationAugmentation(config))
    dataset = CropDataset(config, config.valid_dir, transform)
    loader = Loader(dataset, batch_size=meta.get("batch_size", 1),
                    num_workers=config.num_workers)

    static_batch = None if meta.get("dynamic_batch") else meta.get("batch_size", 1)
    for batch in progress(loader, len(loader), "Evaluation"):
        images = batch["image"]
        if static_batch is not None and images.shape[0] < static_batch:
            # ragged final batch against a static-shape program: pad with
            # zero images, score only the real rows below
            pad = np.zeros((static_batch - images.shape[0],) + images.shape[1:], images.dtype)
            images = np.concatenate([images, pad])
        outputs = split_head_output(call(images), config.n_labels, config.n_parts)
        data = decoder(outputs, return_metadata=True)
        for i, annotation in enumerate(batch["annotation"]):
            evaluator.accumulate(
                data["annotation"][i], annotation, data["raw_parts"][i],
                eval_csi=True, eval_classif=True,
            )

    if importlib.util.find_spec("rich") is not None:
        evaluator.pretty_print()
    else:  # the same tables as plain text
        print(evaluator)
    if args.save_summary:
        Path(args.save_summary).write_text(json.dumps(evaluator.scalar_summary(), indent=2))
    return evaluator


if __name__ == "__main__":
    main()
