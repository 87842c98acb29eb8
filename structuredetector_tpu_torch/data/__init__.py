"""Host-side data handling of the port: datasets, transforms, the loader
and the decoders to annotations (JAX `data/__init__.py`'s names)."""

from .augment import (
    Compose,
    ExportTransforms,
    Normalize,
    PredictionTransformation,
    RandomColorJitter,
    RandomHorizontalFlip,
    RandomResize,
    RandomVerticalFlip,
    Resize,
    TrainAugmentation,
    ValidationAugmentation,
)
from .dataset import CropDataset, DatasetStats, LabelStats, PredictionDataset
from .decoders import Decoder, ExportDecoder, KeypointDecoder
from .pipeline import FlatKeypoints, Loader, collate, flatten_annotation

__all__ = [
    "Compose", "CropDataset", "DatasetStats", "Decoder", "ExportDecoder", "ExportTransforms",
    "FlatKeypoints", "KeypointDecoder", "LabelStats", "Loader", "Normalize",
    "PredictionDataset", "PredictionTransformation", "RandomColorJitter",
    "RandomHorizontalFlip", "RandomResize", "RandomVerticalFlip", "Resize",
    "TrainAugmentation", "ValidationAugmentation", "collate", "flatten_annotation",
]
