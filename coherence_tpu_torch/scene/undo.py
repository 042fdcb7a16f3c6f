"""Undo and redo (the reference's ``undo.ml`` documents the intent but ships
no code; this implements it).

* **Linear undo/redo**: previous (scene, selections) states live in a history
  list; undo pops into a redo list; redo pops back (undo.ml:3-14's design).
* **Selective undo**: restore only the objects in the current selection to
  their prior state, leaving everything else at the present (undo.ml:15-18).

States are cheap: scenes are lists of immutable renderobjects whose rasters
live in the coherence cache, so snapshots share everything.

The PyTorch counterpart of ``coherence_tpu.scene.undo``: host code over the
port's ``render.View``, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from . import render as R


@dataclass
class UndoState:
    scene: list
    selections: tuple


@dataclass
class UndoManager:
    history: List[UndoState] = field(default_factory=list)
    redo_list: List[UndoState] = field(default_factory=list)
    limit: int = 256

    def record(self, view: R.View) -> None:
        """Snapshot the view state before a mutation; clears the redo list."""
        self.history.append(UndoState(list(view.scene), view.selections))
        if len(self.history) > self.limit:
            self.history.pop(0)
        self.redo_list.clear()

    def can_undo(self) -> bool:
        return bool(self.history)

    def can_redo(self) -> bool:
        return bool(self.redo_list)

    def undo(self, view: R.View) -> Optional[UndoState]:
        """Restore the last recorded state; returns it (or None)."""
        if not self.history:
            return None
        self.redo_list.append(UndoState(list(view.scene), view.selections))
        state = self.history.pop()
        return state

    def redo(self, view: R.View) -> Optional[UndoState]:
        if not self.redo_list:
            return None
        self.history.append(UndoState(list(view.scene), view.selections))
        state = self.redo_list.pop()
        return state

    def undo_selective(self, view: R.View) -> Optional[list]:
        """Selective undo: rebuild the scene with only the *selected* objects
        restored to their previous versions (matched positionally by scene
        slot through the history's id pairing)."""
        if not self.history:
            return None
        prev = self.history[-1]
        selected_ids = {o.idset for o in view.selections[1][0]}
        # Map current idset -> previous object occupying the same slot where
        # lengths agree; otherwise fall back to id identity.
        out = []
        prev_by_id = {o.idset: o for o in prev.scene}
        pairs = {}
        if len(prev.scene) == len(view.scene):
            pairs = {c.idset: p for c, p in zip(view.scene, prev.scene)}
        for o in view.scene:
            if o.idset in selected_ids:
                out.append(prev_by_id.get(o.idset) or pairs.get(o.idset, o))
            else:
                out.append(o)
        return out
