"""Tiny configurations and traffic for the CPU tests: the cells' scenes and
mixes at a size a CPU run holds, through the port's plain path."""

import torch

from portbench import bench, generator, kinds

TINY = {
    "lion_1080p_blurfilter": {"scene": "bench_lion", "width": 384, "height": 256, "blob_radius": 20,
                              "blob_at": [60, 60], "lens_box": [10, 40, 350, 240], "blur_radius": 3,
                              "atlas_cap": 256},
    "interactive_4k": {"scene": "interactive_4k", "width": 640, "height": 384, "n_objects": 40, "n_strokes": 1,
                       "stroke_margin": 150, "brush_radius": 12.0, "brush_opacity": 0.5, "blob_radius": 30,
                       "blob_at": [100, 100], "lens_rect": [40, 60, 500, 250], "blur_radius": 4,
                       "atlas_cap": 512},
}
CELLS = ["lion_1080p.drag", "interactive_4k.zoom", "interactive_4k.drag"]
# Mixes kept for a later cell: not in BENCHMARK.json, tested here as if they were.
KEPT = {"interactive_4k.slider": {"name": "interactive_4k.slider", "config": "interactive_4k", "traffic": "slider",
                                  "chips": 1}}


def small_traffic(monkeypatch):
    """Shorter drags (the tiny frames are small) and snapshots early in the window."""
    load = generator.load

    def small(name):
        d = dict(load(name))
        d["snapshots"] = {"count": 2, "within": 5 if d["kind"] == "zoom" else 12}
        if d["kind"] == "drag":
            d["reverse_every"] = 8
        return d

    monkeypatch.setattr(generator, "load", small)


def cell(name):
    if name in KEPT:
        return KEPT[name], TINY[KEPT[name]["config"]]
    c, cfg, _, _ = bench.cell_of(bench.load_benchmark(), name)
    return c, TINY[cfg["name"]]


def run(name, seconds=0.5, seed=9_876_543_210_123, trace=False):
    torch.set_num_threads(2)
    c, cfg = cell(name)
    return bench.run_cell(c, cfg, seed, seconds, trace, "cpu", 0.0)


def kind_of(name):
    """The event kind's module of the cell `name`."""
    c, _ = cell(name)
    return kinds.load(generator.load(c["traffic"])["kind"])
