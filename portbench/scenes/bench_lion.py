"""The scene that bench.py times (bench.py:53-160, examples.bench_scene in
coherence_tpu_torch/scene/examples.py:463-497), frozen: the lion's paths
(portbench/data/lion.json) fitted to the frame and flipped upright, a
translucent crimson blob and a white rectangle as the blur filter's lens.
The seed sets where the blob starts along the drag's path."""

import json
import os

from ..reference import geometry as G
from .common import CRIMSON, WHITE, dissolved, path_object

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "lion.json")


def lion_paths():
    """[(path, rgba)] of the lion, front to back, in page coordinates."""
    with open(_DATA) as f:
        doc = json.load(f)
    out = []
    for o in doc["objects"]:
        subpaths = [(bool(closed), [("S", (s[0], s[1]), (s[2], s[3])) for s in segs]) for _hole, closed, segs in
                    o["subpaths"]]
        out.append(((o["winding"], subpaths), tuple(o["rgba"])))
    return out


def describe(config: dict, seed: int) -> dict:
    width, height = config["width"], config["height"]
    lion = lion_paths()
    bounds = [G.bounds_polygon(p) for p, _ in lion]
    xmin, xmax = min(b[0] for b in bounds), max(b[1] for b in bounds)
    ymin, ymax = min(b[2] for b in bounds), max(b[3] for b in bounds)
    scale = min(width / (xmax - xmin), height / (ymax - ymin))
    fit = [("T", 0.0, float(height)), ("S", 0.0, 0.0, 1.0, -1.0), ("S", 0.0, 0.0, scale, scale),
           ("T", -xmin, -ymin)]
    bx, by = config["blob_at"]
    x0, y0, x1, y1 = config["lens_box"]
    return {
        "width": width, "height": height, "background": WHITE,
        "objects": [path_object(p, rgba, fit) for p, rgba in lion],
        "blob": path_object(G.circle(0.0, 0.0, float(config["blob_radius"])), dissolved(*CRIMSON, 170),
                            [("T", float(bx), float(by))]),
        "lens": path_object(G.rectangle(float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)), WHITE),
        "blur_radius": config["blur_radius"], "atlas_cap": config["atlas_cap"],
    }
