"""Frame-to-frame coherence cache (parity: reference ``cache.ml``).

The port's copy of ``coherence_tpu.scene.cache``, whole: host bookkeeping
over the port's shapes and sprites.  The cache is module state, as in the
reference; it holds tensors of whatever device rendered them, so ``clear()``
it before rendering the same objects on another device.

Memoises per-object shapes (shape, minshape) and partial sprites keyed by
object idset, with **translation aliases**: an object that is a whole-pixel
translation of a cached one stores only (dx, dy, target) and reuses the
target's rasters (``cache.ml:57-59``, ``TranslatedObject``) — translation of
our dense rasters is an O(1) box shift (region.translate_*).

Size-bounded: entries account their bytes; when full, ``drophalf`` evicts,
preferring sprites over shapes (shapes are smaller and more reusable,
``cache.ml:242-271``).  Hit/miss statistics mirror ``cache.ml:24-38``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import ident
from ..raster import region

# The calling program can turn the cache off (cache.ml:10).
usecache = True


@dataclass
class Metrics:
    spritesize: int = 0
    shapesize: int = 0
    lastused: int = 0
    entry: int = 0


@dataclass
class CacheStats:
    shphit: int = 0
    shpmis: int = 0
    sprhit: int = 0
    sprmis: int = 0


cachestats = CacheStats()


@dataclass
class CacheObject:
    copied: List[ident.IdSet] = field(default_factory=list)
    shape: Optional[Tuple[object, object]] = None  # (shape, minshape)
    sprite: Optional[Tuple[object, object]] = None  # (sprite, partial shape)
    metrics: Metrics = field(default_factory=Metrics)


@dataclass
class TranslatedObject:
    dx: int
    dy: int
    target: ident.IdSet


@dataclass
class Properties:
    cachemaxsize: int = 50 * 1024 * 1024
    cachesize: int = 0
    cachetimer: int = 0


properties = Properties()

_cache: Dict[ident.Id, object] = {}


def _advance_time():
    properties.cachetimer += 1


def _findobj(idset: ident.IdSet):
    return _cache.get(idset[0])


def clear():
    _cache.clear()
    properties.cachesize = 0


def string_of_cachestate() -> str:
    """Debug summary (cache.ml:157-185)."""
    lines = [
        f"Maximum size: {properties.cachemaxsize}, Current size: "
        f"{properties.cachesize}, Cache time: {properties.cachetimer}",
        "oid\tshp?\tspr?\ttr?\tshp\tspr\tin\tlast",
    ]
    for oid, obj in _cache.items():
        if isinstance(obj, TranslatedObject):
            t = _cache.get(obj.target[0])
            hasshp = isinstance(t, CacheObject) and t.shape is not None
            hasspr = isinstance(t, CacheObject) and t.sprite is not None
            m = t.metrics if isinstance(t, CacheObject) else Metrics()
            tr = "Y"
        else:
            hasshp = obj.shape is not None
            hasspr = obj.sprite is not None
            m = obj.metrics
            tr = "N"
        lines.append(
            f"{oid}\t{'Y' if hasshp else 'N'}\t{'Y' if hasspr else 'N'}\t{tr}"
            f"\t{m.shapesize}\t{m.spritesize}\t\t{m.entry}\t\t{m.lastused}"
        )
    return "\n".join(lines) + "\n"


def _dropobject(idset: ident.IdSet):
    obj = _cache.pop(idset[0], None)
    if isinstance(obj, CacheObject):
        for c in obj.copied:
            _cache.pop(c[0], None)


def _dropshape(idset: ident.IdSet):
    obj = _cache.get(idset[0])
    if obj is None or isinstance(obj, TranslatedObject):
        return
    if obj.shape is not None and obj.sprite is not None:
        obj.shape = None
        obj.metrics.shapesize = 0
    elif obj.shape is not None:
        _dropobject(idset)


def _dropsprite(idset: ident.IdSet):
    obj = _cache.get(idset[0])
    if obj is None or isinstance(obj, TranslatedObject):
        return
    if obj.shape is not None and obj.sprite is not None:
        obj.sprite = None
        obj.metrics.spritesize = 0
    elif obj.sprite is not None:
        _dropobject(idset)


def dropfromcache(n: int):
    """Drop at least n bytes, sprites before shapes (cache.ml:242-267)."""
    sizes = [
        ((oid, getattr(o, "metrics", None)), o)
        for oid, o in list(_cache.items())
        if isinstance(o, CacheObject)
    ]
    removed = 0
    for (oid, m), o in sizes:
        if removed >= n:
            break
        removed += m.spritesize
        _dropsprite((oid, 0))
    for (oid, m), o in sizes:
        if removed >= n:
            break
        removed += m.shapesize
        _dropshape((oid, 0))
    properties.cachesize -= removed


def drophalf():
    dropfromcache(properties.cachesize // 2)


def setsize(n: int):
    """Set the cache size bound, evicting if needed (cache.ml:274-276)."""
    dropfromcache(properties.cachemaxsize - n)
    properties.cachemaxsize = n


def addshape(idset: ident.IdSet, shp, minshp):
    """Add shape+minshape; keeps any existing shape (cache.ml:280-324)."""
    if not usecache:
        return
    size = region.shapesize(shp) + region.shapesize(minshp)
    if size > properties.cachemaxsize // 2:
        return
    if properties.cachesize + size > properties.cachemaxsize:
        drophalf()
    obj = _findobj(idset)
    if isinstance(obj, TranslatedObject):
        # Store untranslated on the target.
        target = _cache.get(obj.target[0])
        if isinstance(target, CacheObject) and target.shape is None:
            tshp = region.translate_shape(-obj.dx, -obj.dy, shp)
            tmin = region.translate_shape(-obj.dx, -obj.dy, minshp)
            properties.cachesize += size - target.metrics.spritesize
            target.shape = (tshp, tmin)
            target.metrics.shapesize = size
            target.metrics.lastused = properties.cachetimer
    elif isinstance(obj, CacheObject):
        if obj.shape is None:
            properties.cachesize += size
            obj.shape = (shp, minshp)
            obj.metrics.shapesize = size
            obj.metrics.lastused = properties.cachetimer
    else:
        properties.cachesize += size
        _cache[idset[0]] = CacheObject(
            shape=(shp, minshp),
            metrics=Metrics(
                shapesize=size,
                lastused=properties.cachetimer,
                entry=properties.cachetimer,
            ),
        )
    _advance_time()


def addsprite(idset: ident.IdSet, spr, shp):
    """Add/extend a partial sprite; replaces what exists (cache.ml:328-367)."""
    if not usecache:
        return
    size = region.spritesize(spr) + region.shapesize(shp)
    if size > properties.cachemaxsize // 2:
        return
    if properties.cachesize + size > properties.cachemaxsize:
        drophalf()
    obj = _findobj(idset)
    if isinstance(obj, TranslatedObject):
        target = _cache.get(obj.target[0])
        if isinstance(target, CacheObject):
            properties.cachesize += size - target.metrics.spritesize
            target.sprite = (
                region.translate_sprite(-obj.dx, -obj.dy, spr),
                region.translate_shape(-obj.dx, -obj.dy, shp),
            )
            target.metrics.spritesize = size
            target.metrics.lastused = properties.cachetimer
    elif isinstance(obj, CacheObject):
        properties.cachesize += size - obj.metrics.spritesize
        obj.sprite = (spr, shp)
        obj.metrics.spritesize = size
        obj.metrics.lastused = properties.cachetimer
    else:
        properties.cachesize += size
        _cache[idset[0]] = CacheObject(
            sprite=(spr, shp),
            metrics=Metrics(
                spritesize=size,
                lastused=properties.cachetimer,
                entry=properties.cachetimer,
            ),
        )
    _advance_time()


def getshape(idset: ident.IdSet):
    """Shape lookup following translation aliases (cache.ml:370-387)."""
    if not usecache:
        return None
    obj = _findobj(idset)
    if obj is None:
        cachestats.shpmis += 1
        return None
    if isinstance(obj, TranslatedObject):
        got = getshape(obj.target)
        if got is None:
            return None
        shp, minshp = got
        return (
            region.translate_shape(obj.dx, obj.dy, shp),
            region.translate_shape(obj.dx, obj.dy, minshp),
        )
    _advance_time()
    if obj.shape is None:
        cachestats.shpmis += 1
    else:
        cachestats.shphit += 1
    obj.metrics.lastused = properties.cachetimer
    return obj.shape


def getsprite(idset: ident.IdSet):
    """Partial-sprite lookup following translations (cache.ml:390-407)."""
    if not usecache:
        return None
    obj = _findobj(idset)
    if obj is None:
        cachestats.sprmis += 1
        return None
    if isinstance(obj, TranslatedObject):
        got = getsprite(obj.target)
        if got is None:
            return None
        spr, shp = got
        return (
            region.translate_sprite(obj.dx, obj.dy, spr),
            region.translate_shape(obj.dx, obj.dy, shp),
        )
    _advance_time()
    if obj.sprite is None:
        cachestats.sprmis += 1
    else:
        cachestats.sprhit += 1
    obj.metrics.lastused = properties.cachetimer
    return obj.sprite


def addtranslation(idset: ident.IdSet, target_idset: ident.IdSet, dx: int, dy: int):
    """Register idset as a (dx, dy) translation of target (cache.ml:423-436).

    Chained translations compose onto the base object."""
    if not usecache:
        return
    _advance_time()
    target = _findobj(target_idset)
    if target is None:
        return
    if isinstance(target, TranslatedObject):
        base = target.target
        _cache[idset[0]] = TranslatedObject(dx + target.dx, dy + target.dy, base)
        baseobj = _cache.get(base[0])
        if isinstance(baseobj, CacheObject):
            baseobj.copied.append(idset)
    else:
        _cache[idset[0]] = TranslatedObject(dx, dy, target_idset)
        target.copied.append(idset)
