"""The port's batched raster (scene/fastframe.full_sprites_of_objects)
against its scalar pipeline and against the JAX package's, bit for bit.

The same scene, built on each side from its own modules, goes through both
packages' batched raster and scalar pipeline (``full_sprite_of_object``):
plain and translucent paths, a stroked path, an empty-minshape hairline,
a fancy fill and a thin frame-wide rectangle, which both packages send to
the scalar route (its bucket's coverage plane is over ``_MAX_T_ELEMS``).
Boxes, masks, colours and the coherence cache's seeded shape and minshape
entries (hazard H21: boxes and emptiness are part of the result) compare
equal, as does a run forced into one-member sub-batches.
"""

import pytest

from coherence_tpu.scene import fastframe as JF

from coherence_tpu_torch.scene import fastframe as TF

from _torch_general import JAX, PORT, SIDES, assert_same_shape, assert_same_sprite, both_sides  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def scene(side):
    R, C, gs, fills, tr = side.R, side.C, side.gshapes, side.fills, side.tr

    def obj(geom, t=()):
        return R.Obj(side.ident.new_ids(), geom, tuple(t), R.OVER)

    round_spec = gs.StrokeSpec(startcap=gs.RoundCap, join=gs.RoundJoin, endcap=gs.ButtCap, mitrelimit=10.0,
                               linewidth=3.0)
    hairline = gs.StrokeSpec(startcap=gs.ButtCap, join=gs.BevelJoin, endcap=gs.ButtCap, mitrelimit=10.0,
                             linewidth=0.6)
    return [
        obj(R.Basic(fills.plain(C.red), R.PathShape(gs.circle(30.0, 30.0, 20.0)))),
        obj(R.Basic(fills.plain(C.dissolve(C.blue, delta=120)), R.PathShape(gs.rectangle(5.0, 5.0, 40.0, 25.0)))),
        obj(R.Basic(fills.plain(C.green), R.StrokedPathShape(gs.circle(60.0, 40.0, 15.0), round_spec))),
        obj(R.Basic(fills.gradient((0.0, 0.0), (50.0, 0.0), True, True, C.red, C.blue),
                    R.PathShape(gs.rectangle(10.0, 10.0, 30.0, 30.0)))),
        obj(R.Basic(fills.plain(C.black), R.PathShape(gs.circle(90.0, 90.0, 35.0))), [tr.Rotate((90.0, 90.0), 0.3)]),
        obj(R.Basic(fills.plain(C.red), R.StrokedPathShape(gs.circle(30.0, 30.0, 12.0), hairline))),
        obj(R.Basic(fills.plain(C.dissolve(C.gold, delta=200)), R.PathShape(gs.circle(33.5, 70.25, 19.0)))),
        obj(R.Basic(fills.plain(C.teal), R.PathShape(gs.rectangle(2.5, 100.0, 600.0, 140.0)))),
    ]


def batched(side, objs):
    return JF.full_sprites_of_objects(objs) if side is JAX else TF.full_sprites_of_objects(objs, "cpu")


def scalar(side, o):
    return JF.full_sprite_of_object(o) if side is JAX else TF.full_sprite_of_object(o, "cpu")


def test_batch_build_matches_scalar_and_jax(both_sides):
    got = {}
    for side in SIDES:
        objs = scene(side)
        side.cache.clear()
        batch = batched(side, objs)
        seeded = [side.cache.getshape(o.idset) for o in objs]
        side.cache.clear()
        ref = [scalar(side, o) for o in objs]
        for i, (a, b) in enumerate(zip(batch, ref)):
            assert (a is None) == (b is None), (side.name, i)
            if a is not None:
                assert a.box == b.box, (side.name, i)
                assert (side.np_sprite(a)[1] == side.np_sprite(b)[1]).all(), (side.name, i)
                assert (side.np_sprite(a)[2] == side.np_sprite(b)[2]).all(), (side.name, i)
        got[side.name] = (batch, seeded)
    (jb, js), (pb, ps) = got["jax"], got["port"]
    for i, (a, b) in enumerate(zip(jb, pb)):
        assert_same_sprite(a, b, f"object {i}")
    for i, (a, b) in enumerate(zip(js, ps)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert_same_shape(a[0], b[0], f"object {i} seeded shape")
            assert_same_shape(a[1], b[1], f"object {i} seeded minshape")
    # The hairline's interior is empty: its minshape is seeded as NULL_SHAPE.
    assert js[5][1] is None and ps[5][1] is None
    assert ps[0][1] is not None
    # The wide rectangle's bucket holds a coverage plane over the limit.
    w, h = pb[7].wh
    hb, wb = PORT.region.bucket_hw(h, w)
    assert (16 * hb + 16) * (16 * wb + 16) > TF._MAX_T_ELEMS


def test_sub_batches_change_no_value(both_sides, monkeypatch):
    whole = TF.full_sprites_of_objects(scene(PORT), "cpu")
    monkeypatch.setattr(TF, "_SUB_BATCH_SAMPLES", 1)
    PORT.cache.clear()
    alone = TF.full_sprites_of_objects(scene(PORT), "cpu")
    for i, (a, b) in enumerate(zip(whole, alone)):
        assert PORT.np_sprite(a)[0] == PORT.np_sprite(b)[0], i
        assert (PORT.np_sprite(a)[2] == PORT.np_sprite(b)[2]).all(), i


@pytest.mark.parametrize("n_members", [2, 5])
def test_group_sprite_batched_matches_jax(n_members, both_sides):
    """A group of n members through each package's group_sprite_batched over
    a window shape; equal sprites."""
    got = []
    for side in SIDES:
        members = scene(side)[:n_members]
        members = [o for o in members if JF._batch_extract(o) is not None] if side is JAX else \
            [o for o in members if TF._batch_extract(o) is not None]
        shp = side.shape_of_box((3, 2, 110, 100))
        got.append(JF.group_sprite_batched(members, shp) if side is JAX
                   else TF.group_sprite_batched(members, shp, "cpu"))
    assert_same_sprite(got[0], got[1], f"{n_members} members")
