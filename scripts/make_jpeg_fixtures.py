#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's decoder tests and of ``chip_smoke.py``
(phase 22), one file per layout the decoder must match PIL on, with PIL from a
seed.  Needs PIL, so it runs where PIL is (the card machine has none; the
files are committed under ``tests/data/jpeg/``).

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg] [--seed 0]

``tests/test_torch_jpeg.py`` writes the same layouts afresh from other seeds
with ``write`` and checks that the committed files decode as PIL decodes them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# name -> (height, width, grey, PIL save options)
LAYOUTS = {
    "q50_420": (224, 224, False, {"quality": 50, "subsampling": 2}),
    "q75_420": (224, 224, False, {"quality": 75, "subsampling": 2}),
    "q95_420": (224, 224, False, {"quality": 95, "subsampling": 2}),
    "q75_422": (224, 224, False, {"quality": 75, "subsampling": 1}),
    "q75_444": (224, 224, False, {"quality": 75, "subsampling": 0}),
    "grey": (224, 224, True, {"quality": 75}),
    "optimized": (224, 224, False, {"quality": 75, "optimize": True}),
    "restart4": (224, 224, False, {"quality": 75, "restart_marker_blocks": 4}),
    "q75_420_100x60": (60, 100, False, {"quality": 75, "subsampling": 2}),
}
# the layouts of a bag: 224 x 224
BAG_LAYOUTS = tuple(k for k, (h, w, _, _) in LAYOUTS.items() if (h, w) == (224, 224))


def texture(rng: np.random.Generator, height: int, width: int, grey: bool) -> np.ndarray:
    """A tissue-like image: smooth colour waves of random phase, sharp-edged
    blobs and a little noise, so that every frequency and both chroma planes
    carry signal."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.empty((height, width, 3))
    for c in range(3):
        fx, fy, ph = rng.uniform(0.02, 0.25, 2).tolist() + [rng.uniform(0, 6.3)]
        img[..., c] = 128 + 90 * np.sin(fx * x + ph) * np.cos(fy * y - ph)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, height), rng.uniform(0, width), rng.uniform(4, 30)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def write(path: str, layout: str, rng: np.random.Generator) -> None:
    from PIL import Image

    height, width, grey, options = LAYOUTS[layout]
    Image.fromarray(texture(rng, height, width, grey)).save(path, format="JPEG", **options)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data", "jpeg"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    total = 0
    for layout in LAYOUTS:
        path = os.path.join(args.out, f"{layout}.jpg")
        write(path, layout, rng)
        total += os.path.getsize(path)
        print(f"{path}: {os.path.getsize(path)} bytes")
    print(f"{len(LAYOUTS)} files, {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
