"""Row-band meshes: one process, an ordered list of devices, one per band.

The PyTorch counterpart of ``coherence_tpu.parallel.mesh``.  The JAX
package shards the frame's tile rows over a ``jax.sharding.Mesh`` and lets
one controller run one program per device (``shard_map``); XLA inserts the
halo exchange of the blur.  The port keeps the single controller: one
process owns the scene and builds every band's lists, and a ``Mesh`` is an
ordered list of ``torch.device``s, band d on ``devices[d]``, along one axis
("y").  A device may hold several bands, but they must be contiguous, so
that each device holds one contiguous run of rows: its bands' rows are one
tensor, and a kernel launches once per device over all of them.  The only
data that crosses bands is the blur's halo, which the port copies
explicitly (``RowSharded.window``).

A device list that repeats a device is the counterpart of the JAX
package's virtual CPU devices: ``["cpu"] * 8`` in the CPU tests, or
``["cuda:0"] * 2`` on a machine with one card.  CPU devices with distinct
indices (``"cpu:0"``, ``"cpu:1"``, ...) are distinct devices of a mesh, and
their tensors all live in host memory.

The blur here is exact int32 shifted sums (``raster.convolve``), not
``F.conv2d``, which cuDNN may run in TF32: the JAX package's float32
convolution of these integers is exact below 2**24, so the two agree.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import colour as C
from ..raster.convolve import _conv1d_exact


class Mesh:
    """An ordered list of devices, one per row band, along axis "y"."""

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # (device, first band, end band) of each device's contiguous run.
        groups: List[Tuple[torch.device, int, int]] = []
        for b, dev in enumerate(self.devices):
            if groups and groups[-1][0] == dev:
                groups[-1] = (dev, groups[-1][1], b + 1)
            elif any(g[0] == dev for g in groups):
                raise ValueError(f"mesh {self.devices}: the bands of {dev} are not contiguous")
            else:
                groups.append((dev, b, b + 1))
        self.groups = groups

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int, devices: Optional[Sequence] = None) -> Mesh:
    """An `n_devices`-band mesh.  With `devices` None it takes the first
    n_devices CUDA cards and raises if there are fewer: it never downsizes,
    since a smaller mesh would pass multi-band checks vacuously.  An
    explicit list (its first n_devices entries) may repeat a device."""
    if devices is None:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(
                f"make_mesh: {n_devices} devices requested but only {have} CUDA devices are available; "
                "pass an explicit device list to put several bands on one device"
            )
        devices = [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) < n_devices:
        raise ValueError(f"make_mesh: {n_devices} devices requested but only {len(devices)} given")
    return Mesh(list(devices)[:n_devices])


class RowSharded:
    """A plane split by rows over a mesh: band d holds rows [d * band_rows,
    (d + 1) * band_rows) of the plane (fewer, or none, where the plane ends
    early).  parts[g] holds the rows of mesh.groups[g]'s bands, one tensor
    on that group's device."""

    def __init__(self, mesh: Mesh, band_rows: int, parts: List[torch.Tensor]):
        self.mesh, self.band_rows, self.parts = mesh, band_rows, parts

    @classmethod
    def scatter(cls, plane: torch.Tensor, mesh: Mesh, band_rows: int) -> "RowSharded":
        """A copy of `plane` split into `band_rows`-row bands over `mesh`."""
        if band_rows * mesh.size < plane.shape[0]:
            raise ValueError(f"{mesh.size} bands of {band_rows} rows do not cover {plane.shape[0]} rows")
        return cls(mesh, band_rows, [plane[b0 * band_rows : b1 * band_rows].to(dev, copy=True).contiguous()
                                     for dev, b0, b1 in mesh.groups])

    def _row0(self, g: int) -> int:
        return self.mesh.groups[g][1] * self.band_rows

    def band(self, d: int) -> torch.Tensor:
        """Band d's rows: a view into its device's part."""
        for g, (_, b0, b1) in enumerate(self.mesh.groups):
            if b0 <= d < b1:
                return self.parts[g][(d - b0) * self.band_rows : (d - b0 + 1) * self.band_rows]
        raise IndexError(d)

    def gather(self, device) -> torch.Tensor:
        """The whole plane on `device`."""
        return torch.cat([p.to(device) for p in self.parts])

    def window(self, r0: int, r1: int, c0: int, c1: int, device) -> torch.Tensor:
        """Rows [r0, r1) and columns [c0, c1) of the plane, copied from the
        bands that hold them onto `device`; rows outside the plane are
        zero (the blur's SAME padding at the frame's outer edges)."""
        first = self.parts[0]
        out = torch.zeros((r1 - r0, c1 - c0) + tuple(first.shape[2:]), dtype=first.dtype, device=device)
        for g, part in enumerate(self.parts):
            lo = self._row0(g)
            a, b = max(r0, lo), min(r1, lo + int(part.shape[0]))
            if a < b:
                out[a - r0 : b - r0].copy_(part[a - lo : b - lo, c0:c1])
        return out

    def write_window(self, r0: int, c0: int, win: torch.Tensor) -> None:
        """Write `win` back at row r0, column c0, each row into its band."""
        r1, c1 = r0 + int(win.shape[0]), c0 + int(win.shape[1])
        for g, part in enumerate(self.parts):
            lo = self._row0(g)
            a, b = max(r0, lo), min(r1, lo + int(part.shape[0]))
            if a < b:
                part[a - lo : b - lo, c0:c1].copy_(win[a - r0 : b - r0])


def composite_step(frame, open_mask, rgba, mask):
    """One front-to-back composite step (the device core of
    render.ml:1291-1308): `frame` is the accumulated premultiplied int32
    RGBA, `open_mask` the not-yet-opaque plane; the layer (rgba, mask)
    paints only open pixels, and pixels it makes opaque close.  Pointwise,
    so any row split needs no communication."""
    paint = mask & open_mask
    new_frame = torch.where(paint[..., None], C.over_rgba(frame, rgba), frame)
    newly_opaque = paint & (new_frame[..., 3] == 255)
    return new_frame, open_mask & ~newly_opaque


def blur_pass(frame: torch.Tensor, weights, axis: int) -> torch.Tensor:
    """One separable integer blur pass (convolve.ml XYKernel semantics):
    SAME zero-padded correlation along `axis` (0 = rows), floor-divided by
    the weights' total."""
    return _conv1d_exact(frame, tuple(int(w) for w in weights), axis) // int(np.sum(weights))


def sharded_blur(mesh: Mesh, frame, weights) -> RowSharded:
    """blur_pass along rows, then along columns, band by band.  A band's
    row pass reads the `pad` rows beyond each of its edges from the
    neighbouring bands (copied to its device), and zeros only beyond the
    frame's outer edges; the column pass is band-local.  Equal to the
    unsharded blur.  `frame` is a tensor whose rows divide over the mesh,
    or a RowSharded plane."""
    if isinstance(frame, torch.Tensor):
        if frame.shape[0] % mesh.size:
            raise ValueError(f"{frame.shape[0]} rows do not divide over {mesh.size} bands")
        frame = RowSharded.scatter(frame, mesh, frame.shape[0] // mesh.size)
    pad = (len(weights) - 1) // 2
    out = RowSharded(mesh, frame.band_rows, [torch.empty_like(p) for p in frame.parts])
    width = int(frame.parts[0].shape[1])
    for d, dev in enumerate(mesh.devices):
        rows = out.band(d)
        if not rows.shape[0]:
            continue
        r0 = d * frame.band_rows
        halo = frame.window(r0 - pad, r0 + rows.shape[0] + pad, 0, width, dev)
        by_rows = blur_pass(halo, weights, 0)[pad : pad + rows.shape[0]]
        rows.copy_(blur_pass(by_rows, weights, 1))
    return out


def sharded_render_step(mesh: Mesh):
    """A full frame step over the mesh: composite a stack of layers front
    to back with early-closing occupancy, band by band, then the sharded
    separable blur.  Returns (step_fn, make_example_args(h, w, n_layers,
    key)); step_fn(frame, open_mask, layers_rgba, layers_mask) takes the
    frame and occupancy as RowSharded planes and the layers whole, and
    returns (blurred frame, occupancy), both RowSharded."""
    blur_weights = (1, 2, 4, 2, 1)

    def step(frame: RowSharded, open_mask: RowSharded, layers_rgba, layers_mask):
        frames, opens = [], []
        for g, (dev, b0, _) in enumerate(mesh.groups):
            lo = b0 * frame.band_rows
            hi = lo + int(frame.parts[g].shape[0])
            fr, op = frame.parts[g], open_mask.parts[g]
            rgba, masks = layers_rgba[:, lo:hi].to(dev), layers_mask[:, lo:hi].to(dev)
            for k in range(rgba.shape[0]):
                fr, op = composite_step(fr, op, rgba[k], masks[k])
            frames.append(fr)
            opens.append(op)
        composed = RowSharded(mesh, frame.band_rows, frames)
        return sharded_blur(mesh, composed, blur_weights), RowSharded(mesh, frame.band_rows, opens)

    def make_example_args(h: int = 64, w: int = 256, n_layers: int = 3, key: int = 0):
        """The JAX package's example draws: (frame, open_mask) split over
        the mesh, (layers_rgba, layers_mask) whole on the first device."""
        if h % mesh.size:
            raise ValueError(f"{h} rows do not divide over {mesh.size} bands")
        rng = np.random.default_rng(key)
        a = rng.integers(0, 256, size=(n_layers, h, w, 1))
        rgb = (rng.integers(0, 256, size=(n_layers, h, w, 3)) * a) // 255
        dev = mesh.devices[0]
        layers_rgba = torch.from_numpy(np.concatenate([rgb, a], -1).astype(np.int32)).to(dev)
        layers_mask = torch.from_numpy(rng.random((n_layers, h, w)) < 0.7).to(dev)
        band = h // mesh.size
        frame = RowSharded.scatter(torch.zeros((h, w, 4), dtype=torch.int32), mesh, band)
        open_mask = RowSharded.scatter(torch.ones((h, w), dtype=torch.bool), mesh, band)
        return frame, open_mask, layers_rgba, layers_mask

    return step, make_example_args
