"""Affine transforms (parity: camlpdf's ``Pdftransform`` as used by the reference).

The port's copy of ``coherence_tpu.transform``, without the unused
identity list ``i``.

A *transform* is a list of transform ops, with the **first element applied
last** (outermost), matching camlpdf: ``compose op t`` prepends, ``append``
concatenates.  A *matrix* is the PDF 6-tuple (a, b, c, d, e, f) where
``x' = a*x + c*y + e`` and ``y' = b*x + d*y + f``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple, Union

Point = Tuple[float, float]
Matrix = Tuple[float, float, float, float, float, float]


@dataclass(frozen=True)
class Translate:
    dx: float
    dy: float


@dataclass(frozen=True)
class Scale:
    centre: Point
    sx: float
    sy: float


@dataclass(frozen=True)
class Rotate:
    centre: Point
    angle: float  # radians, counterclockwise in y-up coordinates


@dataclass(frozen=True)
class ShearX:
    centre: Point
    a: float


@dataclass(frozen=True)
class ShearY:
    centre: Point
    a: float


TransformOp = Union[Translate, Scale, Rotate, ShearX, ShearY]
Transform = List[TransformOp]

IDENTITY_MATRIX: Matrix = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def matmul(m: Matrix, n: Matrix) -> Matrix:
    """m ∘ n (apply n first, then m)."""
    a, b, c, d, e, f = m
    a2, b2, c2, d2, e2, f2 = n
    return (
        a * a2 + c * b2,
        b * a2 + d * b2,
        a * c2 + c * d2,
        b * c2 + d * d2,
        a * e2 + c * f2 + e,
        b * e2 + d * f2 + f,
    )


def _about(cx: float, cy: float, m: Matrix) -> Matrix:
    return matmul((1, 0, 0, 1, cx, cy), matmul(m, (1, 0, 0, 1, -cx, -cy)))


def matrix_of_op(op: TransformOp) -> Matrix:
    if isinstance(op, Translate):
        return (1.0, 0.0, 0.0, 1.0, op.dx, op.dy)
    if isinstance(op, Scale):
        cx, cy = op.centre
        return _about(cx, cy, (op.sx, 0.0, 0.0, op.sy, 0.0, 0.0))
    if isinstance(op, Rotate):
        cx, cy = op.centre
        ca, sa = math.cos(op.angle), math.sin(op.angle)
        return _about(cx, cy, (ca, sa, -sa, ca, 0.0, 0.0))
    if isinstance(op, ShearX):
        cx, cy = op.centre
        return _about(cx, cy, (1.0, 0.0, op.a, 1.0, 0.0, 0.0))
    if isinstance(op, ShearY):
        cx, cy = op.centre
        return _about(cx, cy, (1.0, op.a, 0.0, 1.0, 0.0, 0.0))
    raise TypeError(f"not a transform op: {op!r}")


def _as_oplist(t) -> Transform:
    if isinstance(t, (Translate, Scale, Rotate, ShearX, ShearY)):
        return [t]
    return list(t)


def matrix_of_transform(t) -> Matrix:
    """First list element is outermost (applied last)."""
    m = IDENTITY_MATRIX
    for op in _as_oplist(t):
        m = matmul(m, matrix_of_op(op))
    return m


def transform_matrix(m: Matrix, p: Point) -> Point:
    a, b, c, d, e, f = m
    x, y = p
    return (a * x + c * y + e, b * x + d * y + f)


def transform(t, p: Point) -> Point:
    """Apply a transform (op list) to a point."""
    return transform_matrix(matrix_of_transform(t), p)


def compose(op, t) -> Transform:
    """Apply op after everything in t (prepend; camlpdf ``compose``)."""
    return _as_oplist(op) + _as_oplist(t)


def append(t, t2) -> Transform:
    """t applied after t2 (camlpdf ``append``)."""
    return _as_oplist(t) + _as_oplist(t2)


def decompose(m: Matrix) -> Tuple[float, float, float, float, float, float]:
    """Decompose into (scale, aspect, rotation, shear, tx, ty).

    Only ``scale`` is consumed by the reference (``render.ml:191-195``, to
    scale stroke linewidths); computed as sqrt(|det|)."""
    a, b, c, d, e, f = m
    det = a * d - b * c
    scale = math.sqrt(abs(det))
    aspect = math.sqrt(abs(a / d)) if d not in (0, 0.0) and a * d > 0 else 1.0
    rotation = math.atan2(b, a)
    shear = 0.0
    return scale, aspect, rotation, shear, e, f


def invert_matrix(m: Matrix) -> Matrix:
    a, b, c, d, e, f = m
    det = a * d - b * c
    if det == 0:
        raise ZeroDivisionError("singular transform")
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return (ia, ib, ic, id_, -(ia * e + ic * f), -(ib * e + id_ * f))


def mktranslate(dx: float, dy: float) -> Transform:
    return [Translate(dx, dy)]
