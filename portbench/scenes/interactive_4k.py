"""benchmarks/run.py config 5 (run.py:192-527; examples.interactive_4k_scene
in coherence_tpu_torch/scene/examples.py:500-559), frozen: primitives and
Gaussian brush strokes drawn in run.py's order from
numpy.random.default_rng(seed), an animated blob and a white rectangle as
the blur filter's lens."""

import numpy as np

from ..reference import geometry as G
from .common import CRIMSON, DARKORANGE, WHITE, brush_object, dissolved, path_object


def describe(config: dict, seed: int) -> dict:
    width, height = config["width"], config["height"]
    rng = np.random.default_rng(seed % 2**64)
    objs = []
    for k in range(config["n_objects"]):
        cx = float(rng.integers(60, width - 60))
        cy = float(rng.integers(60, height - 60))
        alpha = 255 if k % 3 else 150
        rgba = dissolved(*(int(v) for v in rng.integers(0, 256, 3)), alpha)
        if k % 2 == 0:
            path = G.circle(cx, cy, float(rng.integers(6, 30)))
        else:
            path = G.rectangle(cx, cy, float(rng.integers(8, 56)), float(rng.integers(8, 56)))
        objs.append(path_object(path, rgba))
    margin = config["stroke_margin"]
    for _ in range(config["n_strokes"]):
        cx = float(rng.integers(margin, width - margin))
        cy = float(rng.integers(margin, height - margin))
        path = G.circle(cx, cy, float(rng.integers(60, 140)))
        objs.append(brush_object(config["brush_radius"], config["brush_opacity"], path, dissolved(*DARKORANGE, 185)))
    bx, by = config["blob_at"]
    lx, ly, lw, lh = config["lens_rect"]
    return {
        "width": width, "height": height, "background": WHITE, "objects": objs,
        "blob": path_object(G.circle(0.0, 0.0, float(config["blob_radius"])), dissolved(*CRIMSON, 170),
                            [("T", float(bx), float(by))]),
        "lens": path_object(G.rectangle(float(lx), float(ly), float(lw), float(lh)), WHITE),
        "blur_radius": config["blur_radius"], "atlas_cap": config["atlas_cap"],
    }
