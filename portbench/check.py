"""The check that decides `correct`: what the timed path produced at the
sampled events, held to the reference (portbench/reference/), which works it
out again from the scene description and the events alone, folded by the
traffic's kind (portbench/kinds/).

Numbers compared, each summed over the sampled events, each with the limit
0 (the renderer's colour arithmetic is integer and exact, so an answer is
right or wrong; PERF.md gives the readings the limits rest on):
  content_px_off  packed content-frame pixels that differ;
  display_px_off  displayed pixels (after the blur's blend) that differ in any channel;
  piece_px_off    (kinds with PIECES, the zoom) atlas-piece pixels that differ, each object's piece at each
                  tile, plus 64 x 128 for each tile in one piece list and not the other.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from .reference.render import Reference, shifted

LIMITS = {"content_px_off": 0, "display_px_off": 0, "piece_px_off": 0}
TILE_PIXELS = 64 * 128


class Snapshot(NamedTuple):
    index: int  # the event's index, warm-up included
    content: torch.Tensor  # (ph, pw) packed
    display: torch.Tensor  # (H, W, 4)
    pieces: Optional[list]  # each object's [(tile, slot)], in the view's order (kinds with PIECES)
    atlas: Optional[torch.Tensor]


def states(traffic, events, indices):
    """The reference's state after each event in `indices`, folded by the
    traffic's kind from the events alone."""
    kind = traffic.module
    want = sorted(set(indices))
    out, k, state = {}, 0, kind.INITIAL
    for i, ev in enumerate(events):
        if k == len(want):
            break
        state = kind.fold(state, ev)
        if i == want[k]:
            out[i] = state
            k += 1
    return out


def _pieces_off(ref: Reference, layers, pieces, atlas) -> int:
    off = 0
    slots, want = [], []
    for lay, plist in zip(layers, pieces):
        mine = {t: s for t, s in plist}
        theirs = lay.tiles if lay is not None else frozenset()
        off += TILE_PIXELS * len(set(mine) ^ set(theirs))
        for t in set(mine) & set(theirs):
            slots.append(mine[t])
            want.append(ref.piece(lay, t))
    if slots:
        got = atlas[torch.as_tensor(slots, device=atlas.device)].to(ref.device)
        off += int((got != torch.stack(want)).sum())
    return off


def blob_outputs(ref: Reference, desc: dict, moved, radius: int, memo: dict):
    """(content, display, None) of the scene with the blob moved by `moved`
    and the blur at `radius`.  `memo` keeps what every such state shares: the
    scene's content without the blob, and the blob's layer where it began."""
    static = ref.layers(desc["objects"])
    if not memo:
        memo.update(content=ref.content(static), blob=ref.layer(desc["blob"]))
    blob = shifted(memo["blob"], *moved)
    content = memo["content"]
    if blob is not None:
        h, w = blob.packed.shape
        y0, y1 = max(0, blob.y0), min(ref.ph, blob.y0 + h)
        x0, x1 = max(0, blob.x0), min(ref.pw, blob.x0 + w)
        if y0 < y1 and x0 < x1:
            content = ref.content([blob] + static, base=content, region=(y0, y1, x0, x1))
    return content, ref.display(content, radius), None


def judge(desc: dict, traffic, events, snaps: List[Snapshot], device) -> dict:
    """{"correct", "numbers": {name: {"value", "limit"}}, "answers"}."""
    kind = traffic.module
    ref = Reference(desc, device)
    at = states(traffic, events, [s.index for s in snaps])
    numbers = {"content_px_off": 0, "display_px_off": 0}
    if kind.PIECES:
        numbers["piece_px_off"] = 0
    memo = {}
    for s in snaps:
        content, display, layers = kind.outputs(ref, desc, at[s.index], memo)
        numbers["content_px_off"] += int((s.content.to(ref.device) != content).sum())
        numbers["display_px_off"] += int((s.display.to(ref.device) != display).any(-1).sum())
        if layers is not None:
            numbers["piece_px_off"] += _pieces_off(ref, layers, s.pieces, s.atlas)
    out = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return {"correct": bool(snaps) and all(v["value"] <= v["limit"] for v in out.values()), "numbers": out,
            "answers": len(snaps)}
