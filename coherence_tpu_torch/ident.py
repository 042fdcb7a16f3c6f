"""Unique object identifiers (parity: reference ``id.ml``).

The port's copy of ``coherence_tpu.ident``, trimmed to what the port uses.
An id is a tuple of ints (the reference uses an int64 list); combining two
ids concatenates them deterministically (``id.ml:56-58``), which filters
use to reparent objects.  An idset pairs the id with a precomputed hash key
for cache lookups (``id.ml:47-53``).
The counter is the port's own: ids drawn here and in the JAX package come
from two sources.

(Named ``ident`` because ``id`` is a Python builtin.)
"""

from __future__ import annotations

from typing import Tuple

Id = Tuple[int, ...]
IdSet = Tuple[Id, int]

_counter = 0


def new_id() -> Id:
    """Draw a fresh id from the unique source (id.ml:33-35)."""
    global _counter
    _counter += 1
    return (_counter - 1,)


def set_eq(a: IdSet, b: IdSet) -> bool:
    return a == b


def calc_hash(i: Id) -> int:
    # The reference uses OCaml Hashtbl.hash_param; any deterministic hash of
    # the full id works — Python's tuple hash walks the whole structure.
    return hash(i)


def new_ids() -> IdSet:
    i = new_id()
    return i, calc_hash(i)


def combine(a: IdSet, b: IdSet) -> IdSet:
    """Deterministically combine two idsets (id.ml:56-58)."""
    i = a[0] + b[0]
    return i, calc_hash(i)


def string_of_idset(s: IdSet) -> str:
    return "".join(f"{e};" for e in s[0])
