"""Scene checkpoint / resume.

The reference has no checkpointing (SURVEY.md §5.4: the only durable scene
format is the PDF reader/writer pair).  Here a full structural serializer:
scenes (paths, strokes, brushes, CPG, groups, convolutions, primitives,
fills, transforms, compops, and filters via their construction recipes)
round-trip through JSON; views save/load with their pages, background and
master update.  Object ids are regenerated on load (coherence-cache aliases
are per-session).

The PyTorch counterpart of ``coherence_tpu.scene.checkpoint``.  The JSON is
the carrier of scenes between the two packages: for the same scene both
write the same text (it holds no id and no tensor, only Python numbers and
strings), and either reads what the other wrote.  ``load_view`` takes the
device the view renders on."""

from __future__ import annotations

import json
from typing import Any

from .. import ident
from .. import transform as tr
from ..geometry import path as gpath
from ..geometry import shapes as gshapes
from ..raster import convolve as rconvolve
from ..raster import fills as rfills
from ..raster import region
from . import filters as F
from . import render as R

FORMAT_VERSION = 1


# --- transforms -----------------------------------------------------------


def _op_to_dict(op) -> dict:
    if isinstance(op, tr.Translate):
        return {"k": "translate", "dx": op.dx, "dy": op.dy}
    if isinstance(op, tr.Scale):
        return {"k": "scale", "c": list(op.centre), "sx": op.sx, "sy": op.sy}
    if isinstance(op, tr.Rotate):
        return {"k": "rotate", "c": list(op.centre), "a": op.angle}
    if isinstance(op, tr.ShearX):
        return {"k": "shearx", "c": list(op.centre), "a": op.a}
    if isinstance(op, tr.ShearY):
        return {"k": "sheary", "c": list(op.centre), "a": op.a}
    raise TypeError(op)


def _op_from_dict(d: dict):
    k = d["k"]
    if k == "translate":
        return tr.Translate(d["dx"], d["dy"])
    if k == "scale":
        return tr.Scale(tuple(d["c"]), d["sx"], d["sy"])
    if k == "rotate":
        return tr.Rotate(tuple(d["c"]), d["a"])
    if k == "shearx":
        return tr.ShearX(tuple(d["c"]), d["a"])
    return tr.ShearY(tuple(d["c"]), d["a"])


def _transform_to_list(t) -> list:
    return [_op_to_dict(op) for op in t]


def _transform_from_list(l) -> tuple:
    return tuple(_op_from_dict(d) for d in l)


# --- paths ------------------------------------------------------------------


def _path_to_dict(p: gpath.Path) -> dict:
    subs = []
    for sp in p.subpaths:
        segs = []
        for s in sp.segments:
            if isinstance(s, gpath.Straight):
                segs.append(["s", list(s.a), list(s.b)])
            else:
                segs.append(["b", list(s.p1), list(s.p2), list(s.p3), list(s.p4)])
        subs.append({"hole": sp.hole, "closed": sp.closed, "segs": segs})
    return {"winding": p.winding, "subpaths": subs}


def _path_from_dict(d: dict) -> gpath.Path:
    subs = []
    for sp in d["subpaths"]:
        segs = []
        for s in sp["segs"]:
            if s[0] == "s":
                segs.append(gpath.Straight(tuple(s[1]), tuple(s[2])))
            else:
                segs.append(
                    gpath.Bezier(tuple(s[1]), tuple(s[2]), tuple(s[3]), tuple(s[4]))
                )
        subs.append(gpath.Subpath(sp["hole"], sp["closed"], tuple(segs)))
    return gpath.Path(d["winding"], tuple(subs))


def _spec_to_dict(s: gshapes.StrokeSpec) -> dict:
    return {
        "startcap": s.startcap,
        "join": s.join,
        "endcap": s.endcap,
        "mitrelimit": s.mitrelimit,
        "linewidth": s.linewidth,
    }


def _spec_from_dict(d) -> gshapes.StrokeSpec:
    return gshapes.StrokeSpec(**d)


# --- fills --------------------------------------------------------------------


def _fill_to_dict(f: rfills.Fill) -> dict:
    if isinstance(f, rfills.GradientFill):
        return {
            "k": "gradient",
            "p0": list(f.p0),
            "p1": list(f.p1),
            "ext": [f.ext_s, f.ext_e],
            "cs": f.cs,
            "ce": f.ce,
        }
    if isinstance(f, rfills.RadialFill):
        return {
            "k": "radial",
            "c": list(f.c),
            "p": list(f.p),
            "p2": list(f.p2),
            "ext": [f.ext_s, f.ext_e],
            "cs": f.cs,
            "ce": f.ce,
        }
    if isinstance(f, rfills.PlainFill):
        return {"k": "plain", "colour": f.colour, "fancy": f.kind == rfills.FANCY}
    raise TypeError(f)


def _fill_from_dict(d) -> rfills.Fill:
    if d["k"] == "gradient":
        return rfills.gradient(tuple(d["p0"]), tuple(d["p1"]), d["ext"][0], d["ext"][1], d["cs"], d["ce"])
    if d["k"] == "radial":
        return rfills.radial(
            tuple(d["c"]), tuple(d["p"]), tuple(d["p2"]), d["ext"][0], d["ext"][1], d["cs"], d["ce"]
        )
    if d.get("fancy"):
        f = rfills._DummyFancy(d["colour"])
        return f
    return rfills.plain(d["colour"])


# --- kernels / brushes ----------------------------------------------------------


def _kernel_to_dict(k) -> dict:
    if isinstance(k, rconvolve.UnitKernel):
        return {"k": "unit", "r": k.radius}
    if isinstance(k, rconvolve.XYKernel):
        return {"k": "xy", "r": k.radius, "values": list(k.values)}
    return {"k": "full", "r": k.radius, "values": [list(row) for row in k.values]}


def _kernel_from_dict(d):
    if d["k"] == "unit":
        return rconvolve.mkunit(d["r"])
    if d["k"] == "xy":
        vals = d["values"]
        return rconvolve.XYKernel(d["r"], sum(vals), tuple(vals))
    rows = tuple(tuple(r) for r in d["values"])
    return rconvolve.FullKernel(d["r"], sum(map(sum, rows)), rows)


def _brushstroke_to_dict(bs) -> dict:
    (opacity, kind), path = bs
    return {
        "opacity": opacity,
        "kind": list(kind),
        "path": _path_to_dict(path),
    }


def _brushstroke_from_dict(d):
    kind = tuple(d["kind"])
    return ((d["opacity"], kind), _path_from_dict(d["path"]))


# --- basicshapes / geometry / objects ---------------------------------------------


def _basicshape_to_dict(b) -> dict:
    if isinstance(b, R.PathShape):
        return {"k": "path", "path": _path_to_dict(b.path)}
    if isinstance(b, R.StrokedPathShape):
        return {"k": "stroked", "path": _path_to_dict(b.path), "spec": _spec_to_dict(b.spec)}
    if isinstance(b, R.BrushStroke):
        return {"k": "brush", "stroke": _brushstroke_to_dict(b.brushstroke)}
    if isinstance(b, R.CPG):
        return {
            "k": "cpg",
            "op": b.op,
            "a": _basicshape_to_dict(b.a),
            "b": _basicshape_to_dict(b.b),
        }
    raise TypeError(b)


def _basicshape_from_dict(d):
    if d["k"] == "path":
        return R.PathShape(_path_from_dict(d["path"]))
    if d["k"] == "stroked":
        return R.StrokedPathShape(_path_from_dict(d["path"]), _spec_from_dict(d["spec"]))
    if d["k"] == "brush":
        return R.BrushStroke(_brushstroke_from_dict(d["stroke"]))
    return R.CPG(d["op"], _basicshape_from_dict(d["a"]), _basicshape_from_dict(d["b"]))


def _prim_to_dict(p) -> dict:
    if isinstance(p, R.HLine):
        return {"k": "hline", "v": [p.y, p.xmin, p.xmax]}
    if isinstance(p, R.VLine):
        return {"k": "vline", "v": [p.x, p.ymin, p.ymax]}
    return {"k": "rect", "v": [p.xmin, p.ymin, p.xmax, p.ymax]}


def _prim_from_dict(d):
    if d["k"] == "hline":
        return R.HLine(*d["v"])
    if d["k"] == "vline":
        return R.VLine(*d["v"])
    return R.RectanglePrim(*d["v"])


def _geometry_to_dict(g) -> dict:
    if isinstance(g, R.Basic):
        return {"k": "basic", "fill": _fill_to_dict(g.fill), "shape": _basicshape_to_dict(g.shape)}
    if isinstance(g, R.Group):
        return {"k": "group", "objs": [_obj_to_dict(o) for o in g.objects]}
    if isinstance(g, R.Convolved):
        return {"k": "convolved", "kernel": _kernel_to_dict(g.kernel), "geom": _geometry_to_dict(g.geometry)}
    if isinstance(g, R.Primitive):
        return {"k": "prim", "colour": g.colour, "prim": _prim_to_dict(g.prim)}
    if isinstance(g, R.FilterG):
        recipe = getattr(g, "recipe", None)
        if recipe is None:
            raise ValueError("filter without a checkpoint recipe")
        name, args = recipe
        ser = []
        for a in args:
            ser.append(_filter_arg_to_dict(a))
        return {"k": "filter", "name": name, "args": ser}
    raise TypeError(g)


def _filter_arg_to_dict(a) -> dict:
    if isinstance(a, (R.Basic, R.Group, R.Convolved, R.Primitive, R.FilterG)):
        return {"t": "geometry", "v": _geometry_to_dict(a)}
    if isinstance(a, gshapes.StrokeSpec):
        return {"t": "spec", "v": _spec_to_dict(a)}
    if isinstance(a, rfills.Fill):
        return {"t": "fill", "v": _fill_to_dict(a)}
    if isinstance(a, (rconvolve.UnitKernel, rconvolve.XYKernel, rconvolve.FullKernel)):
        return {"t": "kernel", "v": _kernel_to_dict(a)}
    if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], tuple):
        return {"t": "brushstroke", "v": _brushstroke_to_dict(a)}
    if isinstance(a, (list, tuple)) and all(
        isinstance(x, (tr.Translate, tr.Scale, tr.Rotate, tr.ShearX, tr.ShearY)) for x in a
    ):
        return {"t": "transform", "v": _transform_to_list(a)}
    if isinstance(a, str):
        return {"t": "str", "v": a}
    raise ValueError(f"unserializable filter argument {a!r}")


def _filter_arg_from_dict(d):
    t = d["t"]
    if t == "geometry":
        return _geometry_from_dict(d["v"])
    if t == "spec":
        return _spec_from_dict(d["v"])
    if t == "fill":
        return _fill_from_dict(d["v"])
    if t == "kernel":
        return _kernel_from_dict(d["v"])
    if t == "brushstroke":
        return _brushstroke_from_dict(d["v"])
    if t == "transform":
        return list(_transform_from_list(d["v"]))
    if t == "str":
        return d["v"]
    raise ValueError(t)


_FILTER_FACTORIES = {
    "hole": F.hole,
    "monochrome": F.monochrome,
    "blur": F.blur,
    "wireframe": F.wireframe,
    "affine": F.affine,
    "minus": F.minus,
    "smear": F.smear,
    "blendmode": F.blendmode,
}


def _geometry_from_dict(d):
    k = d["k"]
    if k == "basic":
        return R.Basic(_fill_from_dict(d["fill"]), _basicshape_from_dict(d["shape"]))
    if k == "group":
        return R.Group(tuple(_obj_from_dict(o) for o in d["objs"]))
    if k == "convolved":
        return R.Convolved(_kernel_from_dict(d["kernel"]), _geometry_from_dict(d["geom"]))
    if k == "prim":
        return R.Primitive(d["colour"], _prim_from_dict(d["prim"]))
    if k == "filter":
        factory = _FILTER_FACTORIES[d["name"]]
        args = [_filter_arg_from_dict(a) for a in d["args"]]
        return factory(*args)
    raise ValueError(k)


def _compop_to_dict(op) -> Any:
    if op == R.OVER:
        return "over"
    if op == R.NOCOVER:
        return "nocover"
    if isinstance(op, R.PreTrans):
        return {"k": "pretrans", "v": op.v, "op": _compop_to_dict(op.op)}
    raise TypeError(op)


def _compop_from_dict(d):
    if d == "over":
        return R.OVER
    if d == "nocover":
        return R.NOCOVER
    return R.PreTrans(d["v"], _compop_from_dict(d["op"]))


def _obj_to_dict(o: R.Obj) -> dict:
    return {
        "geom": _geometry_to_dict(o.geometry),
        "transform": _transform_to_list(o.transform),
        "compop": _compop_to_dict(o.compop),
    }


def _obj_from_dict(d) -> R.Obj:
    return R.Obj(
        ident.new_ids(),
        _geometry_from_dict(d["geom"]),
        _transform_from_list(d["transform"]),
        _compop_from_dict(d["compop"]),
    )


# --- public API -----------------------------------------------------------------


def scene_to_json(scene) -> str:
    return json.dumps(
        {"version": FORMAT_VERSION, "scene": [_obj_to_dict(o) for o in scene]}
    )


def scene_from_json(s: str):
    d = json.loads(s)
    assert d["version"] == FORMAT_VERSION
    return [_obj_from_dict(o) for o in d["scene"]]


def save_view(path: str, view: R.View) -> None:
    x0, y0, x1, y1 = (
        view.master_update.box if view.master_update is not None else (0, 0, 0, 0)
    )
    d = {
        "version": FORMAT_VERSION,
        "scene": [_obj_to_dict(o) for o in view.scene],
        "pages": [_obj_to_dict(o) for o in view.pages],
        "background": [_obj_to_dict(o) for o in view.background],
        "master_update": [x0, y0, x1, y1],
        "tool": view.tool,
    }
    with open(path, "w") as f:
        json.dump(d, f)


def load_view(path: str, device) -> R.View:
    with open(path) as f:
        d = json.load(f)
    assert d["version"] == FORMAT_VERSION
    mu = d["master_update"]
    return R.View(
        device=device,
        scene=[_obj_from_dict(o) for o in d["scene"]],
        pages=[_obj_from_dict(o) for o in d["pages"]],
        window=None,
        background=[_obj_from_dict(o) for o in d["background"]],
        selections=R.null_selection,
        master_update=region.shape_of_box(tuple(mu), device) if mu != [0, 0, 0, 0] else None,
        rubberband=None,
        tool=d.get("tool", "select"),
    )
