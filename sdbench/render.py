"""Procedural crop scenes: the benchmark's inputs, rendered from the seed.

A frozen copy of the renderer of `structuredetector_tpu_torch/tools/
synthetic_dataset.py` (the accuracy chain's data): a textured soil
background with stones and 2-5 bean or maize plants, each a stem whose
base is the anchor keypoint ("stem") and 1-6 leaves (part "leaf"), JSON
objects in the reference's schema. It is kept here so that a change to the
program never changes what the benchmark feeds it.

Image i of a run comes from `numpy.random.default_rng((seed, i))`, so the
images render in any order on a pool of processes (`spawn`) and each seed
gives the same pixels on every host. Imports numpy and PIL only.
"""

from __future__ import annotations

import json
import math
import multiprocessing as mp
from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw, ImageFilter

SIZE = 512
MIN_KP_DIST = 28.0


def _soil_background(rng: np.random.Generator) -> Image.Image:
    """Low-frequency brown-green mottle + high-frequency grain."""
    base = np.array(
        [rng.uniform(70, 110), rng.uniform(55, 90), rng.uniform(35, 60)], np.float32
    )
    # luminance-correlated mottle (clods, shadows), smoothly upsampled,
    # with a faint independent colour cast so it is not pure greyscale
    lum = rng.normal(0.0, 16.0, size=(16, 16)).astype(np.float32)
    lum = np.asarray(Image.fromarray(lum, mode="F").resize((SIZE, SIZE), Image.BILINEAR))
    cast = rng.normal(0.0, 4.0, size=(8, 8, 3)).astype(np.float32)
    cast = np.stack([
        np.asarray(Image.fromarray(cast[..., c], mode="F").resize((SIZE, SIZE), Image.BILINEAR))
        for c in range(3)
    ], axis=-1)
    fine = rng.normal(0.0, 6.0, size=(SIZE, SIZE, 1)).astype(np.float32)
    img = base[None, None] + lum[..., None] * np.array([1.0, 0.95, 0.8], np.float32) + cast + fine
    img = np.clip(img, 0, 255).astype(np.uint8)
    return Image.fromarray(img).filter(ImageFilter.GaussianBlur(0.8))


def _rot(x: float, y: float, a: float) -> tuple[float, float]:
    return x * math.cos(a) - y * math.sin(a), x * math.sin(a) + y * math.cos(a)


def _draw_leaf(d: ImageDraw.ImageDraw, cx, cy, angle, species, rng):
    """Leaf polygon centred at (cx, cy) pointing along `angle`."""
    if species == "bean":
        ln = rng.uniform(16, 30)  # round-ish
        wd = ln * rng.uniform(0.55, 0.8)
        col = (
            int(rng.uniform(25, 60)),
            int(rng.uniform(95, 140)),
            int(rng.uniform(25, 55)),
        )
    else:  # maize: long thin blade
        ln = rng.uniform(34, 60)
        wd = ln * rng.uniform(0.12, 0.22)
        col = (
            int(rng.uniform(95, 140)),
            int(rng.uniform(150, 195)),
            int(rng.uniform(40, 75)),
        )
    pts = []
    for t in np.linspace(0.0, 2.0 * math.pi, 12, endpoint=False):
        px = (ln / 2) * math.cos(t)
        py = (wd / 2) * math.sin(t)
        rx, ry = _rot(px, py, angle)
        pts.append((cx + rx, cy + ry))
    d.polygon(pts, fill=col, outline=tuple(max(0, c - 25) for c in col))


def _draw_stone(d: ImageDraw.ImageDraw, rng):
    cx, cy = rng.uniform(0, SIZE), rng.uniform(0, SIZE)
    r = rng.uniform(4, 14)
    g = int(rng.uniform(110, 170))
    col = (g, g, int(g * rng.uniform(0.9, 1.0)))
    d.ellipse([cx - r, cy - r * 0.8, cx + r, cy + r * 0.8], fill=col)


def _make_plant(d: ImageDraw.ImageDraw, rng, occupied, keypoints):
    """Draw one plant; returns its object dict, or None if no room."""
    for _ in range(30):
        ax = rng.uniform(48, SIZE - 48)
        ay = rng.uniform(72, SIZE - 32)
        if all((ax - ox) ** 2 + (ay - oy) ** 2 > 190.0**2 for ox, oy in occupied):
            break
    else:
        return None
    occupied.append((ax, ay))
    keypoints.append((ax, ay))

    species = "bean" if rng.random() < 0.5 else "maize"
    n_leaves = int(rng.integers(1, 7))
    stem_h = rng.uniform(50, 110)
    lean = rng.uniform(-0.35, 0.35)
    tipx, tipy = ax + stem_h * math.sin(lean), ay - stem_h * math.cos(lean)

    # species-distinct stem geometry at the anchor, as in real crops: the
    # anchor channels must tell the species at the stem base, not only
    # from leaves 50-150 px away; colour ranges overlap
    if species == "maize":
        stem_col = (int(rng.uniform(70, 100)), int(rng.uniform(110, 140)),
                    int(rng.uniform(35, 60)))
        w0 = rng.uniform(6, 9)  # thick stalk, slight taper
        for t0, t1 in ((0.0, 0.5), (0.5, 1.0)):
            d.line([ax + (tipx - ax) * t0, ay + (tipy - ay) * t0,
                    ax + (tipx - ax) * t1, ay + (tipy - ay) * t1],
                   fill=stem_col, width=int(w0 * (1.0 - 0.35 * t0)))
    else:
        stem_col = (int(rng.uniform(80, 110)), int(rng.uniform(75, 105)),
                    int(rng.uniform(30, 55)))
        # a quadratic bend whose control point swings sideways, 3-5 px wide
        bend = rng.uniform(-22, 22)
        nx, ny = math.cos(lean), math.sin(lean)  # stem normal
        pts = []
        for t in np.linspace(0.0, 1.0, 8):
            px = ax + (tipx - ax) * t + bend * 2 * t * (1 - t) * nx
            py = ay + (tipy - ay) * t + bend * 2 * t * (1 - t) * ny
            pts.append((px, py))
        d.line(pts, fill=stem_col, width=int(rng.uniform(3, 5)), joint="curve")
        # a cotyledon pair at the stem base (a dicot's seed leaves, which
        # maize never has): small and darker than the annotated leaves,
        # so they do not read as leaf keypoints
        cot_col = (int(rng.uniform(20, 45)), int(rng.uniform(75, 110)),
                   int(rng.uniform(20, 45)))
        for side in (-1.0, 1.0):
            coff = rng.uniform(8, 14)
            cx = ax + side * coff * nx + rng.uniform(-2, 2)
            cy = ay + side * coff * ny - rng.uniform(2, 7)
            cr = rng.uniform(4, 6)
            d.ellipse([cx - cr, cy - cr * 0.8, cx + cr, cy + cr * 0.8],
                      fill=cot_col,
                      outline=tuple(max(0, c - 20) for c in cot_col))

    def stem_point(t: float) -> tuple[float, float]:
        """Point on the drawn stem at parameter t (follows bean's bend)."""
        px = ax + (tipx - ax) * t
        py = ay + (tipy - ay) * t
        if species == "bean":
            px += bend * 2 * t * (1 - t) * nx
            py += bend * 2 * t * (1 - t) * ny
        return px, py

    parts = [{"kind": "stem", "location": {"x": round(ax, 1), "y": round(ay, 1)}, "score": None}]
    for i in range(n_leaves):
        # leaves fan out from points along the stem; a leaf is resampled
        # until its keypoint clears MIN_KP_DIST from every other one
        for _ in range(40):
            t = rng.uniform(0.35, 1.0)
            bx, by = stem_point(t)
            side = 1.0 if (i % 2 == 0) else -1.0
            ang = lean + side * rng.uniform(0.4, 1.6)
            reach = rng.uniform(26, 60)
            lx = bx + reach * math.sin(ang)
            ly = by - reach * math.cos(ang) * rng.uniform(0.2, 0.9)
            lx = float(np.clip(lx, 6, SIZE - 6))
            ly = float(np.clip(ly, 6, SIZE - 6))
            if all((lx - kx) ** 2 + (ly - ky) ** 2 >= MIN_KP_DIST**2
                   for kx, ky in keypoints):
                break
        else:
            continue  # no clear spot for this leaf: draw fewer
        keypoints.append((lx, ly))
        d.line([bx, by, lx, ly], fill=stem_col, width=2)
        _draw_leaf(d, lx, ly, ang + math.pi / 2 * rng.uniform(0.7, 1.3), species, rng)
        parts.append({"kind": "leaf", "location": {"x": round(lx, 1), "y": round(ly, 1)},
                      "score": None})

    # anchor marker: a dark node at the stem base, sized with the stem
    r = 5.5 if species == "maize" else 3.5
    d.ellipse([ax - r, ay - r, ax + r, ay + r],
              fill=tuple(max(0, c - 35) for c in stem_col))
    return {"label": species, "box": None, "parts": parts}


def render_image(rng: np.random.Generator):
    """One (PIL image, list of object dicts) from `rng`'s next draws."""
    img = _soil_background(rng)
    d = ImageDraw.Draw(img)
    for _ in range(int(rng.integers(3, 10))):
        _draw_stone(d, rng)

    objects = []
    occupied: list[tuple[float, float]] = []
    keypoints: list[tuple[float, float]] = []
    total_parts = 0
    for _ in range(int(rng.integers(2, 6))):
        obj = _make_plant(d, rng, occupied, keypoints)
        if obj is None:
            continue
        n_leaf = len(obj["parts"]) - 1
        if total_parts + n_leaf > 30:  # stay under the max_parts=40 budget
            break
        total_parts += n_leaf
        objects.append(obj)

    # illumination jitter + mild sensor noise
    arr = np.asarray(img).astype(np.float32)
    arr = arr * rng.uniform(0.85, 1.15) + rng.uniform(-12, 12)
    arr += rng.normal(0, 3.5, arr.shape)
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    return img, objects


def _scene(seed: int, index: int, size) -> tuple:
    """Scene `index` of `seed` at `size` (w, h): the PIL image and its
    objects, keypoints scaled with the image."""
    img, objects = render_image(np.random.default_rng((int(seed), int(index))))
    w, h = size
    if (w, h) != (SIZE, SIZE):
        img = img.resize((w, h), Image.BILINEAR)
        for obj in objects:
            for p in obj["parts"]:
                p["location"] = {"x": round(p["location"]["x"] * w / SIZE, 1),
                                 "y": round(p["location"]["y"] * h / SIZE, 1)}
    return img, objects


def _frame(args) -> np.ndarray:
    seed, index, size = args
    return np.asarray(_scene(seed, index, size)[0], np.uint8)


def _crop(args) -> None:
    seed, index, size, out = args
    img, objects = _scene(seed, index, size)
    stem = Path(out) / f"im_{index:04d}"
    img.save(stem.with_suffix(".jpg"), quality=92)
    stem.with_suffix(".json").write_text(json.dumps({
        "image_path": str(stem.with_suffix(".jpg")), "img_size": list(size),
        "objects": objects}))


def _pool_map(fn, jobs, workers: int):
    """`fn` over `jobs` on `workers` spawned processes; in this process when
    there are too few jobs to pay for starting them."""
    if workers <= 1 or len(jobs) < 8 * workers:
        return [fn(j) for j in jobs]
    with mp.get_context("spawn").Pool(workers) as pool:
        return pool.map(fn, jobs, chunksize=max(1, len(jobs) // (4 * workers)))


def frames(seed: int, n: int, size, workers: int) -> list:
    """`n` decoded RGB frames (h, w, 3) uint8 at `size` (w, h)."""
    return _pool_map(_frame, [(seed, i, tuple(size)) for i in range(n)], workers)


def crop_set(seed: int, n: int, size, out: Path, workers: int) -> Path:
    """`n` JPEGs (q92) with their JSON annotations in `out`."""
    out.mkdir(parents=True, exist_ok=True)
    _pool_map(_crop, [(seed, i, tuple(size), str(out)) for i in range(n)], workers)
    return out
