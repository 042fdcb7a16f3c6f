"""Colours and object records shared by the scene generators.

A scene description is a dict: width, height, background (premultiplied
RGBA), objects (front to back), blob (the object a drag moves), lens (the
blur filter's geometry), blur_radius and atlas_cap.  An object is
{"kind": "path", "path", "rgba", "transform"} or {"kind": "brush", "radius",
"opacity", "path", "rgba", "transform"}, with paths and transform ops in
portbench/reference/geometry.py's form."""

from ..reference.raster import div255


def dissolved(r: int, g: int, b: int, delta: int) -> tuple:
    """An opaque colour dissolved to `delta`, premultiplied (colour.ml's
    dissolve: delta 0 is clear, 255 the colour itself)."""
    if delta == 0:
        return (0, 0, 0, 0)
    if delta == 255:
        return (r, g, b, 255)
    return tuple(div255(c * delta) for c in (r, g, b, 255))


WHITE = (255, 255, 255, 255)
CRIMSON = (220, 20, 60)
DARKORANGE = (255, 140, 0)


def path_object(path, rgba, transform=()) -> dict:
    return {"kind": "path", "path": path, "rgba": tuple(rgba), "transform": list(transform)}


def brush_object(radius: float, opacity: float, path, rgba, transform=()) -> dict:
    return {"kind": "brush", "radius": radius, "opacity": opacity, "path": path, "rgba": tuple(rgba),
            "transform": list(transform)}
