"""Datasets over directories of JSON-annotated images.

The port's own copy of `structuredetector_tpu/data/dataset.py`:

- `CropDataset` over one or more directories of `.json` annotation
  files (sorted), images opened with PIL, true `img_size` stamped
  (reference `dataset.py:13-49`), a list of transforms composed; with `--native_io` and the device-augment feed an
  item decodes through the native library instead (`data/native.py`);
  `raw_item` gives the image path and annotation undecoded, the feed of
  the whole-batch native loader; `localize_image_names()` rewrites the
  JSONs so `image_path` points next to each (`dataset.py:51-55`), as the
  trainer asks; `part_count_histogram()` and altair's `histogram()`,
- `PredictionDataset` over unlabeled `.jpg`/`.jpeg`/`.png` images, each
  through an optional transform (`dataset.py:168-184`),
- `LabelStats`/`DatasetStats` summaries (`dataset.py:187-237`).
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import List

from ..annotations import ImageAnnotation, files_with_extension
from . import native
from .augment import Compose


def _open_rgb(path):
    from PIL import Image

    image = Image.open(path)
    if image.mode != "RGB":
        image = image.convert("RGB")
    return image


class CropDataset:
    def __init__(self, config, directories, transform=None):
        self.config = config
        self.transform = Compose(transform) if isinstance(transform, list) else transform
        if isinstance(directories, (str, Path)):
            directories = [directories]
        elif not isinstance(directories, list):
            raise ValueError(
                f"expected a directory path or a list of them, got "
                f"{type(directories).__name__}"
            )
        self.files = sorted(f for d in directories for f in files_with_extension(d, ".json"))

    def __len__(self):
        return len(self.files)

    def raw_item(self, index):
        """(image_path, annotation) without decoding the image: the whole-
        batch native loader decodes and stamps the original sizes itself."""
        annotation = ImageAnnotation.from_json(self.files[index], self.config.anchor_name)
        return annotation.image_path, annotation

    def __getitem__(self, index):
        annotation = ImageAnnotation.from_json(self.files[index], self.config.anchor_name)
        # the per-item native route is the device-augment feed's only:
        # host augmentation and --no_augmentation items decode with PIL
        if (self.config.native_io and getattr(self.transform, "device_augment", False)
                and native.available()):
            return self.transform.native_apply(annotation.image_path, annotation)
        image = _open_rgb(annotation.image_path)
        annotation.img_size = image.size
        if self.transform is not None:
            return self.transform(image, annotation)
        return image, annotation

    def localize_image_names(self):
        """Rewrite each annotation's image_path to sit next to its JSON
        (reference dataset.py:51-55; writes into the dataset directory)."""
        for file in self.files:
            annotation = ImageAnnotation.from_json(file, self.config.anchor_name)
            annotation.image_path = file.parent / annotation.image_name
            annotation.save_json(file.parent)

    def part_count_histogram(self):
        """Per-label part-count histogram as {label: {n_parts: count}}: the
        data behind the reference's altair `histogram()`
        (`dataset.py:133-165`)."""
        hist: dict = defaultdict(lambda: defaultdict(int))
        for file in self.files:
            annotation = ImageAnnotation.from_json(file, self.config.anchor_name)
            for obj in annotation.objects:
                hist[obj.name][obj.nb_parts] += 1
        return {k: dict(v) for k, v in hist.items()}

    def histogram(self):
        """Show the part-count histogram with altair, imported here as the
        reference does (`dataset.py:134-135`): it is not a dependency."""
        import altair as alt
        import pandas as pd

        data = [
            {"label": label, "parts": n, "count": c}
            for label, counts in self.part_count_histogram().items()
            for n, c in counts.items()
        ]
        df = pd.DataFrame(data)
        charts = [
            alt.Chart(df[df.label == label], width=600, height=400)
            .mark_rect()
            .encode(alt.X("parts:O"), alt.Y("count:Q"))
            for label in df.label.unique()
        ]
        combined = charts[0]
        for c in charts[1:]:
            combined = combined | c
        combined.show()

    def stats(self) -> "DatasetStats":
        s = DatasetStats()
        for file in self.files:
            annotation = ImageAnnotation.from_json(file, self.config.anchor_name)
            s.update(annotation.objects)
        return s

    def __repr__(self):
        return f"Images: {len(self)}\n{self.stats()}"


class PredictionDataset:
    def __init__(self, directory, transform=None, extensions=(".jpg", ".jpeg", ".png")):
        self.images: List[Path] = sorted(
            f
            for ext in extensions
            for f in files_with_extension(directory, ext)
        )
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        """{"img": the RGB image (through `transform` if any), "img_size":
        its original (w, h), "path"}."""
        path = self.images[index]
        img = _open_rgb(path)
        out = self.transform(img) if self.transform is not None else img
        return {"img": out, "img_size": img.size, "path": path}


class LabelStats:
    def __init__(self):
        self.count = 0
        self.parts = defaultdict(int)

    def __len__(self):
        return len(self.parts)

    def update(self, obj):
        self.count += 1
        for kp in obj.parts:
            self.parts[kp.kind] += 1

    def __repr__(self):
        parts = ", ".join(f"'{n}': {c}" for n, c in self.parts.items())
        return f"  count: {self.count}\n  part count: {{{parts}}}\n"


class DatasetStats:
    def __init__(self):
        self.stats = defaultdict(LabelStats)

    def __getitem__(self, label):
        return self.stats[label]

    def __len__(self):
        return len(self.stats)

    def items(self):
        return self.stats.items()

    def update(self, objects):
        if isinstance(objects, list):
            for obj in objects:
                self.stats[obj.name].update(obj)
        else:
            self.stats[objects.name].update(objects)

    def __repr__(self):
        return "".join(f"label: {label}\n{stats}" for label, stats in self.items())
