"""One staged upload of a frame's host lists.

The JAX package hands a frame's small host arrays (shatter offsets, the
dirty-tile coords, spans and slot lists) to its one device program as
arguments.  The port's counterpart is ``stage``: every array goes into one
int32 buffer, each segment padded to a multiple of 4 words so that every
view of it starts on 16 bytes (the kernel wrappers' alignment check), and
the buffer crosses to the card in one copy.  The arrays come back as int32
views of one device tensor, each with its array's shape.

On a CUDA device the host side is a small ring of pinned buffers per
device: the copy is ``non_blocking`` on the device's current stream (the
stream the kernels launch on), so the host never waits for the card, and a
CUDA event recorded behind each copy says when its pinned buffer may be
written again.  A buffer whose copy has not run yet is never reused; the
ring grows instead (it stays as deep as the host runs ahead of the card).
The device tensor is new each time, from PyTorch's caching allocator, so a
view the caller keeps is never overwritten by a later upload.  On the CPU
the same layout is built in host memory: the CPU path and the tests see the
views the card sees.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

WORDS = 4  # int32 words in 16 bytes
# At most this many pinned buffers per device.  The card's launch queue
# (about a thousand entries) stops the host long before a ring this deep is
# full; if it ever is, the oldest buffer's copy is waited for.
MAX_RING = 1024


def layout(sizes: Sequence[int]) -> Tuple[List[int], int]:
    """(offsets, words): each segment's offset in int32 words, each padded
    to a multiple of WORDS, and the buffer's length."""
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += -(-n // WORDS) * WORDS
    return offsets, at


def _int32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.int32:
        if a.size and (a.min() < -(2**31) or a.max() >= 2**31):
            raise ValueError("stage: a value does not fit in int32")
        a = a.astype(np.int32)
    return a


class _Ring:
    """Pinned host buffers of one device, each with the event recorded
    behind its last copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: List[torch.Tensor] = []
        self.events: List[torch.cuda.Event] = []
        self.next = 0
        self.lock = threading.Lock()

    def _free_slot(self) -> int:
        n = len(self.host)
        for i in range(n):
            j = (self.next + i) % n
            if self.events[j].query():
                return j
        if n < MAX_RING:
            self.host.append(torch.empty(0, dtype=torch.int32))
            self.events.append(torch.cuda.Event())
            return n
        j = self.next % n
        self.events[j].synchronize()
        return j

    def upload(self, arrays: List[np.ndarray], offsets: List[int], words: int) -> torch.Tensor:
        with self.lock:
            j = self._free_slot()
            if self.host[j].numel() < words:
                self.host[j] = torch.empty(max(words, 2 * self.host[j].numel(), 256), dtype=torch.int32,
                                           pin_memory=True)
            buf = self.host[j].numpy()
            for a, o in zip(arrays, offsets):
                buf[o : o + a.size] = a.reshape(-1)
            out = torch.empty(words, dtype=torch.int32, device=self.device)
            out.copy_(self.host[j][:words], non_blocking=True)
            self.events[j].record(torch.cuda.current_stream(self.device))
            self.next = j + 1
            return out


_rings: Dict[torch.device, _Ring] = {}
_rings_lock = threading.Lock()


def _ring(device: torch.device) -> _Ring:
    with _rings_lock:
        ring = _rings.get(device)
        if ring is None:
            ring = _rings[device] = _Ring(device)
        return ring


def stage(device, *arrays) -> List[torch.Tensor]:
    """The host arrays (numpy arrays or lists of ints, each fitting int32)
    as int32 tensors on `device`, views of one buffer that crossed in one
    copy, every view 16-byte aligned and shaped as its array."""
    device = torch.device(device)
    arrays = [_int32(a) for a in arrays]
    offsets, words = layout([a.size for a in arrays])
    words = max(words, WORDS)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        flat = _ring(device).upload(arrays, offsets, words)
    else:
        buf = np.zeros(words, np.int32)
        for a, o in zip(arrays, offsets):
            buf[o : o + a.size] = a.reshape(-1)
        flat = torch.from_numpy(buf).to(device)
    return [flat[o : o + a.size].view(a.shape) for a, o in zip(arrays, offsets)]
