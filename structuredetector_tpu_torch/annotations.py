"""Annotation data model and JSON interchange format.

The port's own copy of `structuredetector_tpu/annotations.py`:
`Keypoint`, `Box`, `Object` and `ImageAnnotation`, with the reference's
public JSON schema, and the helpers evaluate and detect use
(`clip_annotation`, `files_with_extension`, `dict_grouping`,
`get_unique_color_map`):

```json
{
  "image_path": "...", "img_size": [W, H],
  "objects": [
    {"label": "...", "box": null | {x_min, y_min, x_max, y_max},
     "parts": [{"kind": "...", "location": {"x": .., "y": ..}, "score": null}, ...]}
  ]
}
```

An `Object`'s anchor keypoint is stored in JSON inside `parts` as the
keypoint whose `kind` equals the dataset's `anchor_name`; exactly one
such keypoint must exist per object.
"""

from __future__ import annotations

import copy
import json
import math
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class Keypoint:
    """A named 2-D point with an optional confidence score."""

    __slots__ = ("kind", "x", "y", "score")

    def __init__(self, kind: str, x: float, y: float, score: Optional[float] = None):
        self.kind = kind
        self.x = x
        self.y = y
        self.score = score

    def resize(self, in_size: Tuple[int, int], out_size: Tuple[int, int]) -> "Keypoint":
        (iw, ih), (ow, oh) = in_size, out_size
        self.x *= ow / iw
        self.y *= oh / ih
        return self

    def resized(self, in_size, out_size) -> "Keypoint":
        return copy.deepcopy(self).resize(in_size, out_size)

    def distance(self, other: "Keypoint") -> float:
        return math.hypot(self.x - other.x, self.y - other.y)

    def normalize(self, size: Tuple[int, int]) -> "Keypoint":
        self.x /= size[0]
        self.y /= size[1]
        return self

    def normalized(self, size) -> "Keypoint":
        return copy.deepcopy(self).normalize(size)

    def json_repr(self) -> dict:
        return {"kind": self.kind, "location": {"x": self.x, "y": self.y}, "score": self.score}

    @staticmethod
    def from_json(d: dict) -> "Keypoint":
        loc = d["location"]
        return Keypoint(d["kind"], loc["x"], loc["y"], d.get("score"))

    def __repr__(self):
        return f"Keypoint(kind: {self.kind}, x: {self.x}, y: {self.y}, score: {self.score})"


class Box:
    """Optional axis-aligned bounding box attached to an object."""

    __slots__ = ("x_min", "y_min", "x_max", "y_max")

    def __init__(self, x_min: float, y_min: float, x_max: float, y_max: float):
        self.x_min = x_min
        self.y_min = y_min
        self.x_max = x_max
        self.y_max = y_max

    @property
    def x_mid(self):
        return (self.x_max + self.x_min) / 2

    @property
    def y_mid(self):
        return (self.y_max + self.y_min) / 2

    @property
    def width(self):
        return abs(self.x_max - self.x_min)

    @property
    def height(self):
        return abs(self.y_max - self.y_min)

    def resize(self, in_size, out_size) -> "Box":
        (iw, ih), (ow, oh) = in_size, out_size
        rw, rh = ow / iw, oh / ih
        self.x_min *= rw
        self.y_min *= rh
        self.x_max *= rw
        self.y_max *= rh
        return self

    def resized(self, in_size, out_size) -> "Box":
        # NOTE: the reference's Box.resized is broken (calls `.reize`,
        # utils.py:97); here it works.
        return copy.deepcopy(self).resize(in_size, out_size)

    def normalize(self, size) -> "Box":
        self.x_min /= size[0]
        self.y_min /= size[1]
        self.x_max /= size[0]
        self.y_max /= size[1]
        return self

    def normalized(self, size) -> "Box":
        return copy.deepcopy(self).normalize(size)

    def standardize(self) -> "Box":
        if self.x_min > self.x_max:
            self.x_min, self.x_max = self.x_max, self.x_min
        if self.y_min > self.y_max:
            self.y_min, self.y_max = self.y_max, self.y_min
        return self

    def standardized(self) -> "Box":
        return copy.deepcopy(self).standardize()

    def json_repr(self) -> dict:
        return {"x_min": self.x_min, "y_min": self.y_min, "x_max": self.x_max, "y_max": self.y_max}

    @staticmethod
    def from_json(d: Optional[dict]) -> Optional["Box"]:
        if d is None:
            return None
        return Box(d["x_min"], d["y_min"], d["x_max"], d["y_max"])

    def __repr__(self):
        return (
            f"Box(x_min: {self.x_min}, y_min: {self.y_min}, "
            f"x_max: {self.x_max}, y_max: {self.y_max})"
        )


class Object:
    """One detected/annotated object: a label, an anchor keypoint, parts."""

    __slots__ = ("name", "anchor", "parts", "box")

    def __init__(
        self,
        name: str,
        anchor: Keypoint,
        parts: Optional[List[Keypoint]] = None,
        box: Optional[Box] = None,
    ):
        self.name = name
        self.anchor = anchor
        self.parts = parts or []
        self.box = box

    @property
    def x(self):
        return self.anchor.x

    @x.setter
    def x(self, v):
        self.anchor.x = v

    @property
    def y(self):
        return self.anchor.y

    @y.setter
    def y(self, v):
        self.anchor.y = v

    @property
    def nb_parts(self) -> int:
        return len(self.parts)

    def resize(self, in_size, out_size) -> "Object":
        self.anchor.resize(in_size, out_size)
        if self.box is not None:
            self.box.resize(in_size, out_size)
        for p in self.parts:
            p.resize(in_size, out_size)
        return self

    def resized(self, in_size, out_size) -> "Object":
        return copy.deepcopy(self).resize(in_size, out_size)

    def distance(self, other: "Object") -> float:
        return self.anchor.distance(other.anchor)

    def normalize(self, size) -> "Object":
        self.anchor.normalize(size)
        if self.box is not None:
            self.box.normalize(size)
        for p in self.parts:
            p.normalize(size)
        return self

    def normalized(self, size) -> "Object":
        return copy.deepcopy(self).normalize(size)

    def json_repr(self) -> dict:
        parts = [self.anchor.json_repr()]
        parts += [p.json_repr() for p in self.parts]
        return {
            "label": self.name,
            "box": self.box.json_repr() if self.box else None,
            "parts": parts,
        }

    @staticmethod
    def from_json(d: dict, anchor_name: str) -> "Object":
        anchor = None
        parts: List[Keypoint] = []
        for pd in d["parts"]:
            kp = Keypoint.from_json(pd)
            if kp.kind == anchor_name:
                if anchor is not None:
                    raise ValueError(
                        f"object has multiple keypoints of the anchor kind "
                        f"'{anchor_name}'; exactly one is required"
                    )
                anchor = kp
            else:
                parts.append(kp)
        if anchor is None:
            raise ValueError(
                f"object JSON is missing its anchor: no keypoint of kind "
                f"'{anchor_name}' in the 'parts' list"
            )
        return Object(d["label"], anchor, parts, Box.from_json(d.get("box")))

    def __repr__(self):
        return (
            f"Object(name: {self.name}, anchor: {self.anchor}, "
            f"parts: {self.parts}, box: {self.box})"
        )


class ImageAnnotation:
    """All objects annotated/detected in one image."""

    __slots__ = ("image_path", "objects", "img_size")

    def __init__(
        self,
        image_path,
        objects: Optional[List[Object]] = None,
        img_size: Optional[Tuple[int, int]] = None,
    ):
        self.image_path = Path(image_path)
        self.objects = objects or []
        self.img_size = img_size

    @property
    def image_name(self) -> str:
        return self.image_path.name

    @property
    def image_stem(self) -> str:
        return self.image_path.stem

    def __len__(self):
        return len(self.objects)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    @property
    def nb_parts(self) -> int:
        return sum(o.nb_parts for o in self.objects)

    def resize(self, in_size, out_size) -> "ImageAnnotation":
        for o in self.objects:
            o.resize(in_size, out_size)
        return self

    def resized(self, in_size, out_size) -> "ImageAnnotation":
        return copy.deepcopy(self).resize(in_size, out_size)

    def normalize(self, size=None) -> "ImageAnnotation":
        size = size or self.img_size
        assert size, f"Annotation for '{self.image_path}' does not have a size."
        for o in self.objects:
            o.normalize(size)
        return self

    def normalized(self, size=None) -> "ImageAnnotation":
        return copy.deepcopy(self).normalize(size)

    @staticmethod
    def from_json(file: Path, anchor_name: str) -> "ImageAnnotation":
        data = json.loads(Path(file).read_text())
        return ImageAnnotation(
            Path(data["image_path"]),
            [Object.from_json(o, anchor_name) for o in data["objects"]],
            data.get("img_size"),
        )

    def json_repr(self) -> dict:
        return {
            "image_path": str(self.image_path.expanduser().resolve()),
            "img_size": list(self.img_size) if self.img_size is not None else None,
            "objects": [o.json_repr() for o in self.objects],
        }

    def save_json(self, save_dir=None) -> Path:
        save_dir = Path(save_dir or "detections/")
        save_dir.mkdir(parents=True, exist_ok=True)
        out = save_dir / self.image_path.with_suffix(".json").name
        out.write_text(json.dumps(self.json_repr(), indent=2))
        return out

    def __repr__(self):
        return (
            f"ImageAnnotation(name: {self.image_name}, objects: {self.objects}, "
            f"img_size: {self.img_size})"
        )


# --- host-side helpers -------------------------------------------------


def clip_annotation(annotation: ImageAnnotation, img_size) -> ImageAnnotation:
    """Clip all coordinates into [0, size-1] (mutates, like the reference)."""
    w, h = img_size

    def _clip(v, hi):
        return min(max(v, 0), hi)

    for obj in annotation.objects:
        obj.x = _clip(obj.x, w - 1)
        obj.y = _clip(obj.y, h - 1)
        for p in obj.parts:
            p.x = _clip(p.x, w - 1)
            p.y = _clip(p.y, h - 1)
        if obj.box is not None:
            obj.box.x_min = _clip(obj.box.x_min, w - 1)
            obj.box.x_max = _clip(obj.box.x_max, w - 1)
            obj.box.y_min = _clip(obj.box.y_min, h - 1)
            obj.box.y_max = _clip(obj.box.y_max, h - 1)
    return annotation


def hflip_annotation(annotation: ImageAnnotation, img_size) -> ImageAnnotation:
    """Mirror x -> W - x - 1 (reference utils.py:384-398; mutates)."""
    w, _ = img_size
    for obj in annotation.objects:
        obj.x = w - obj.x - 1
        for p in obj.parts:
            p.x = w - p.x - 1
        if obj.box is not None:
            x_max = w - obj.box.x_min - 1
            x_min = w - obj.box.x_max - 1
            obj.box.x_min, obj.box.x_max = x_min, x_max
    return annotation


def vflip_annotation(annotation: ImageAnnotation, img_size) -> ImageAnnotation:
    """Mirror y -> H - y - 1 (reference utils.py:401-415; mutates)."""
    _, h = img_size
    for obj in annotation.objects:
        obj.y = h - obj.y - 1
        for p in obj.parts:
            p.y = h - p.y - 1
        if obj.box is not None:
            y_max = h - obj.box.y_min - 1
            y_min = h - obj.box.y_max - 1
            obj.box.y_min, obj.box.y_max = y_min, y_max
    return annotation


def files_with_extension(folder, extension: str) -> List[Path]:
    return [f for f in Path(folder).iterdir() if f.suffix == extension]


def dict_grouping(iterable: Iterable, key):
    from collections import defaultdict

    out = defaultdict(list)
    for el in iterable:
        out[key(el)].append(el)
    return out


_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh64_round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64_digest(data: bytes, seed: int = 0) -> bytes:
    """XXH64 of `data`, big-endian, as `xxhash.xxh64_digest` gives it: a
    plain-Python copy for label colours, so the port needs no xxhash."""
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        while i + 32 <= n:
            for j in range(4):
                v[j] = _xxh64_round(v[j], int.from_bytes(data[i : i + 8], "little"))
                i += 8
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for lane in v:
            h = ((h ^ _xxh64_round(0, lane)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _xxh64_round(0, int.from_bytes(data[i : i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= int.from_bytes(data[i : i + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    for byte in data[i:]:
        h ^= byte * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    h ^= h >> 32
    return h.to_bytes(8, "big")


def get_unique_color_map(labels: Sequence[str]) -> Dict[str, tuple]:
    """Deterministic per-label RGB from xxhash64, as the reference
    (utils.py:477-479)."""
    return {n: tuple(xxh64_digest(n.encode())[:3]) for n in labels}
