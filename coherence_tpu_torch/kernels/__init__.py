"""Hand-written Hopper kernels: build, binding and launch counters.

Every CUDA source in ``csrc/`` is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, ``build/kernels/libcomposite.so``
at the root of the checkout: on first use, and again whenever any file in
``csrc/`` is newer than the library.
The library is loaded with ``ctypes``; every pointer and the stream
(PyTorch's current stream) pass as ``c_void_p``.  Each entry point returns
``cudaGetLastError()`` after its launch, and the wrapper raises on a
nonzero value.

``launches`` counts, per kernel, the launches made through its wrapper;
``launch_floor``, an empty kernel for measuring what a launch costs, is
not counted.

Nothing here runs at import: the CPU tests import this module on machines
with no CUDA toolkit and no card.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "kernels")
LIBRARY = os.path.join(BUILD_DIR, "libcomposite.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_ptr, _i32, _u32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
# entry point -> argument types
_ENTRY_POINTS = {
    "composite_dirty": [_ptr] * 6 + [_i32] * 2 + [_ptr],
    "composite_full": [_ptr] * 5 + [_i32] * 2 + [_ptr],
    "composite_runs": [_ptr] * 4 + [_i32] * 2 + [_ptr],
    "composite_layers": [_ptr] * 3 + [_i32] * 3 + [_ptr],
    "composite_full_banded": [_ptr] * 5 + [_i32] * 5 + [_ptr],
    "composite_dirty_banded": [_ptr] * 6 + [_i32] * 6 + [_ptr],
    "fold_layers": [_ptr] * 7 + [_i32] * 3 + [_ptr],
    "blur_blend": [_ptr] + [_i32] * 4 + [_ptr] + [_i32] * 3 + [_ptr] + [_i32] * 3 + [_ptr] + [_i32, _u32] + [_i32] * 16
                  + [_ptr],
    "shatter_into": [_ptr, _i32, _i32, _ptr, _ptr, _i32, _i32, _ptr, _i32, _i32, _ptr],
    "brush_stamp": [_ptr] * 7 + [_i32] * 5 + [_ptr],
    "smear_walk": [_ptr, _i32, _i32, _ptr, _ptr, _ptr, _ptr] + [_i32] * 4 + [_ptr],
    "tile_raster": [_ptr] * 6 + [_i32] * 2 + [_ptr],
    "sprite_raster": [_ptr] * 6 + [_i32] * 3 + [_ptr],
    "caf": [_ptr] * 10,
    "tight_bounds": [_ptr] * 5,
    "box_morph": [_ptr] * 4 + [_i32, _ptr],
    "convolve_canvas": [_ptr] * 6,
}

# entry point -> argument types, of those that launch nothing
_QUERIES = {"fold_layers_tile": [_i32], "tile_raster_blocks_per_sm": [], "brush_stamp_blocks_per_sm": [_i32] * 2,
            "sprite_raster_blocks_per_sm": [], "mapped_pointer": [_ptr] * 2,
            "convolve_staged_smem": [_i32]}
# entry point -> argument types, of those that launch a later pass of a
# kernel of _ENTRY_POINTS, counted under that kernel's name
_PASSES = {"box_morph_cols": [_ptr] * 5}
# entry point -> argument types, of those that launch a kernel doing none of
# the program's work (not counted in `launches`)
_PROBES = {"launch_floor": [_ptr]}

launches = {name: 0 for name in _ENTRY_POINTS}

# fold_layers.cu's LayerRecord: two 64-bit pointers, then int32 hs, ws, dy, dx.
LAYER_RECORD = np.dtype([("rgba", "<u8"), ("mask", "<u8"), ("hs", "<i4"), ("ws", "<i4"), ("dy", "<i4"), ("dx", "<i4")])

_lock = threading.Lock()
_fns: Optional[Dict[str, ctypes._CFuncPtr]] = None


def _nvcc() -> str:
    """nvcc from PATH, else from the toolkit at $CUDA_HOME (by default
    /usr/local/cuda, the toolkit's standard location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    under_home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(under_home):
        return under_home
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> str:
    """Compile every ``csrc/*.cu`` into the library if it is missing or
    older than any file in ``csrc/``: one ``nvcc`` per source, in parallel,
    then one link.  Returns nvcc's output (ptxas register and spill
    counts), or "" when the library was up to date."""
    inputs = sorted(glob.glob(os.path.join(_CSRC, "*")))
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= max(os.path.getmtime(p) for p in inputs):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    sources = [p for p in inputs if p.endswith(".cu")]
    objects = [os.path.join(BUILD_DIR, f"{os.path.basename(p)}.{tag}.o") for p in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for src, obj in zip(sources, objects)]
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(sources, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)} ({p.returncode}):\n{log}")
    tmp = f"{LIBRARY}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objects], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    for obj in objects:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stdout}")
    os.replace(tmp, LIBRARY)
    return "".join(logs)


def load() -> Dict[str, ctypes._CFuncPtr]:
    """Every entry point by name, the library built first if need be, with
    its argument types declared."""
    global _fns
    with _lock:
        if _fns is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            fns = {}
            for entry, argtypes in {**_ENTRY_POINTS, **_PASSES, **_QUERIES, **_PROBES}.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = _i32
                fns[entry] = fn
            _fns = fns
        return _fns


def _check(name: str, t: torch.Tensor, device: torch.device, shape=None) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous int32 tensor on {device}, got {t.dtype} on {t.device}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_planes(background, atlas):
    device = atlas.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA compositor needs tensors on a CUDA device, got {device}")
    ph, pw = background.shape
    if ph % 64 or pw % 128:
        raise ValueError(f"plane {ph}x{pw} is not tile-aligned")
    _check("atlas", atlas, device, (atlas.shape[0], 64, 128))
    _check("background", background, device)
    return device, ph, pw


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def composite_dirty(coords, spans, idxs, background, frame, atlas, n_slots: int) -> torch.Tensor:
    """Launch ``composite_dirty``: one block per 4-row stripe of each slot
    of the compacted dirty list (flat (2 * n_slots,) int32 coords and
    spans), in place in `frame` on the current stream."""
    device, ph, pw = _check_planes(background, atlas)
    _check("coords", coords, device, (2 * n_slots,))
    _check("spans", spans, device, (2 * n_slots,))
    _check("idxs", idxs, device, (idxs.shape[0],))
    _check("frame", frame, device, (ph, pw))
    rc = load()["composite_dirty"](
        coords.data_ptr(), spans.data_ptr(), idxs.data_ptr(), background.data_ptr(),
        frame.data_ptr(), atlas.data_ptr(), n_slots, pw,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on("composite_dirty", rc)
    launches["composite_dirty"] += 1
    return frame


def composite_full(starts, idxs, background, atlas, nty: int, ntx: int) -> torch.Tensor:
    """Launch ``composite_full``: one block per 4-row stripe of each tile,
    into a new frame."""
    device, ph, pw = _check_planes(background, atlas)
    if (ph, pw) != (nty * 64, ntx * 128):
        raise ValueError(f"plane {ph}x{pw} does not match the {nty}x{ntx} tile grid")
    _check("starts", starts, device, (nty * ntx + 1,))
    _check("idxs", idxs, device, (idxs.shape[0],))
    out = torch.empty_like(background)
    rc = load()["composite_full"](
        starts.data_ptr(), idxs.data_ptr(), background.data_ptr(), out.data_ptr(),
        atlas.data_ptr(), nty, ntx, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on("composite_full", rc)
    launches["composite_full"] += 1
    return out


def composite_runs(starts, background, runs, nty: int, ntx: int) -> torch.Tensor:
    """Launch ``composite_runs``: one block per 4-row stripe of each tile
    over the tile-major piece runs (tile t's pieces are
    runs[starts[t]:starts[t+1]]), into a new frame."""
    device, ph, pw = _check_planes(background, runs)
    if (ph, pw) != (nty * 64, ntx * 128):
        raise ValueError(f"plane {ph}x{pw} does not match the {nty}x{ntx} tile grid")
    _check("starts", starts, device, (nty * ntx + 1,))
    out = torch.empty_like(background)
    rc = load()["composite_runs"](
        starts.data_ptr(), background.data_ptr(), out.data_ptr(), runs.data_ptr(), nty, ntx,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on("composite_runs", rc)
    launches["composite_runs"] += 1
    return out


def composite_layers(background, layers) -> torch.Tensor:
    """Launch ``composite_layers``: one block per 4-row stripe of each tile
    over a dense (K, H, W) stack, layer 0 topmost, into a new frame."""
    device = layers.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA compositor needs tensors on a CUDA device, got {device}")
    if layers.dim() != 3:
        raise ValueError(f"layers: need a (K, H, W) stack, got shape {tuple(layers.shape)}")
    k, ph, pw = layers.shape
    if ph % 64 or pw % 128:
        raise ValueError(f"plane {ph}x{pw} is not tile-aligned")
    _check("layers", layers, device)
    _check("background", background, device, (ph, pw))
    out = torch.empty_like(background)
    rc = load()["composite_layers"](
        background.data_ptr(), layers.data_ptr(), out.data_ptr(), k, ph // 64, pw // 128,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on("composite_layers", rc)
    launches["composite_layers"] += 1
    return out


def _check_banded(background, atlas):
    """(device, n_bands, band_rows, pw) of a device's band stack."""
    device = atlas.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA compositor needs tensors on a CUDA device, got {device}")
    if atlas.dim() != 4 or tuple(atlas.shape[2:]) != (64, 128):
        raise ValueError(f"atlas: need an (n_bands, local_cap, 64, 128) stack, got shape {tuple(atlas.shape)}")
    _check("atlas", atlas, device)
    _check("background", background, device)
    n_bands = atlas.shape[0]
    ph, pw = background.shape
    if ph % (64 * n_bands) or pw % 128:
        raise ValueError(f"background {ph}x{pw} is not {n_bands} tile-aligned bands")
    return device, n_bands, ph // n_bands, pw


def composite_full_banded(starts, idxs, background, atlas, band_ty: int, ntx: int) -> torch.Tensor:
    """Launch ``composite_full_banded``: block (x, b) composites stripe
    x % 16 of band-local tile x // 16 of band b of the stack from
    starts[b], idxs[b] and atlas[b], one launch for every band, into new
    rows."""
    device, n_bands, band_rows, pw = _check_banded(background, atlas)
    if (band_rows, pw) != (band_ty * 64, ntx * 128):
        raise ValueError(f"band {band_rows}x{pw} does not match the {band_ty}x{ntx} tile grid")
    _check("starts", starts, device, (n_bands, band_ty * ntx + 1))
    _check("idxs", idxs, device, (n_bands, idxs.shape[1]))
    out = torch.empty_like(background)
    with torch.cuda.device(device):  # a mesh's bands may sit on other cards than the current one
        rc = load()["composite_full_banded"](
            starts.data_ptr(), idxs.data_ptr(), background.data_ptr(), out.data_ptr(), atlas.data_ptr(),
            n_bands, band_ty * ntx, ntx, idxs.shape[1], atlas.shape[1],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("composite_full_banded", rc)
    launches["composite_full_banded"] += 1
    return out


def composite_dirty_banded(coords, spans, idxs, background, frame, atlas, n_slots: int) -> torch.Tensor:
    """Launch ``composite_dirty_banded``: block (x, b) recomposites stripe
    x % 16 of slot x // 16 of band b (band-local tile coordinates) in place
    in `frame`, one launch for every band."""
    device, n_bands, _, pw = _check_banded(background, atlas)
    _check("coords", coords, device, (n_bands, 2 * n_slots))
    _check("spans", spans, device, (n_bands, 2 * n_slots))
    _check("idxs", idxs, device, (n_bands, idxs.shape[1]))
    _check("frame", frame, device, tuple(background.shape))
    with torch.cuda.device(device):
        rc = load()["composite_dirty_banded"](
            coords.data_ptr(), spans.data_ptr(), idxs.data_ptr(), background.data_ptr(), frame.data_ptr(),
            atlas.data_ptr(), n_bands, n_slots, pw, background.shape[0] // n_bands, idxs.shape[1],
            atlas.shape[1], torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("composite_dirty_banded", rc)
    launches["composite_dirty_banded"] += 1
    return frame


def _check_mask(name: str, t: torch.Tensor, device: torch.device, shape) -> None:
    if t.device != device or t.dtype != torch.bool or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous bool tensor on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _layer_fault(rgba: int, mask: int, hs: int, ws: int, dy: int, dx: int) -> Optional[str]:
    """What keeps one record out of fold_layers' table, or None."""
    if not (0 <= rgba < 2**64 and 0 <= mask < 2**64):
        return "a pointer outside [0, 2^64)"
    if not (0 <= hs < 2**31 and 0 <= ws < 2**31) or hs * ws >= 2**31:
        return f"{hs}x{ws} is not a layer of fewer than 2^31 pixels"
    if not all(-(2**31) <= v < 2**31 for v in (dy, dx, dy + hs, dx + ws)):
        return f"its box at ({dy}, {dx}) does not fit in int32"
    return None


def pack_layer_records(records) -> np.ndarray:
    """fold_layers' layer table: one LAYER_RECORD (32 bytes) per (rgba
    pointer, mask pointer, hs, ws, dy, dx), in the given order.  Raises
    ValueError, naming the first layer at fault, where a value does not fit:
    a pointer outside [0, 2^64); hs or ws outside [0, 2^31), or hs * ws of
    2^31 or more (the kernel indexes a layer's pixels in int32); dy, dx,
    dy + hs or dx + ws outside int32 (its box tests).  The checks run on
    whole columns; only a table at fault is scanned layer by layer."""
    table = np.zeros(len(records), LAYER_RECORD)
    if not len(records):
        return table
    rgba, mask, *geometry = zip(*records)
    ptrs = rgba + mask
    try:
        geom = np.array(geometry, np.int64)
    except OverflowError:  # beyond int64: the scan below names the layer
        geom = None
    if geom is not None and min(ptrs) >= 0 and max(ptrs) < 2**64 and geom.min() >= -(2**31) and geom.max() < 2**31:
        sizes, origins = geom[:2], geom[2:]  # every value in int32: the sums and products are exact
        if sizes.min() >= 0 and (sizes[0] * sizes[1]).max() < 2**31 and (origins + sizes).max() < 2**31:
            table["rgba"], table["mask"] = rgba, mask
            for name, column in zip(("hs", "ws", "dy", "dx"), geom):
                table[name] = column
            return table
    k, what = next((k, what) for k, r in enumerate(records) if (what := _layer_fault(*(int(v) for v in r))))
    raise ValueError(f"layer {k}: {what}")


@functools.lru_cache(maxsize=None)
def fold_tile() -> tuple:
    """fold_layers.cu's tile, (rows, columns) of the window per block, as
    the built library gives it."""
    query = load()["fold_layers_tile"]
    return query(0), query(1)


def fold_layers(offs, layers, acc, open_mask, covered):
    """Launch ``fold_layers``: one block per 8x32 tile of the (hb, wb)
    window folds the layers front to back into the carry (int32 (hb, wb, 4)
    acc, bool (hb, wb) open_mask and covered), each tile walking only the
    layers whose boxes meet it.  `layers` is a sequence of (rgba, mask)
    pairs, contiguous int32 (hs, ws, 4) and bool (hs, ws) on the carry's
    device; `offs` their (dy, dx) origins in window coordinates.  The
    layers pass as one small device table of records
    (pack_layer_records), not one launch each.  Returns the new (acc,
    open_mask, covered)."""
    device = acc.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA fold needs tensors on a CUDA device, got {device}")
    if open_mask.dim() != 2 or open_mask.numel() == 0:
        raise ValueError(f"open_mask: need a non-empty (hb, wb) window, got shape {tuple(open_mask.shape)}")
    hb, wb = open_mask.shape
    if -(-hb // fold_tile()[0]) > 65535 or wb >= 2**31:
        raise ValueError(f"open_mask: a {hb}x{wb} window is beyond the kernel's grid")
    _check("acc", acc, device, (hb, wb, 4))
    _check_mask("open_mask", open_mask, device, (hb, wb))
    _check_mask("covered", covered, device, (hb, wb))
    if len(offs) != len(layers):
        raise ValueError(f"{len(offs)} offsets for {len(layers)} layers")
    records = []
    for (dy, dx), (rgba, mask) in zip(offs, layers):
        hs, ws = mask.shape
        rgba_ptr = rgba.data_ptr()
        # One test for the usual case; the checks name what is wrong.
        if not (rgba.dtype is torch.int32 and mask.dtype is torch.bool and rgba.device == device
                and mask.device == device and rgba.shape == (hs, ws, 4) and rgba_ptr % 16 == 0
                and rgba.is_contiguous() and mask.is_contiguous()):
            _check("layer rgba", rgba, device, (hs, ws, 4))
            _check_mask("layer mask", mask, device, (hs, ws))
        records.append((rgba_ptr, mask.data_ptr(), hs, ws, dy, dx))
    # From pinned memory the upload is queued on the stream like the
    # launch: the host does not wait for the card (the pinned block is held
    # until the copy has run).
    table = torch.from_numpy(pack_layer_records(records).view(np.uint8)).pin_memory().to(device, non_blocking=True)
    out = (torch.empty_like(acc), torch.empty_like(open_mask), torch.empty_like(covered))
    with torch.cuda.device(device):
        rc = load()["fold_layers"](
            table.data_ptr(), acc.data_ptr(), open_mask.data_ptr(), covered.data_ptr(),
            *(t.data_ptr() for t in out), len(records), hb, wb, torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("fold_layers", rc)
    launches["fold_layers"] += 1
    return out


# blur_blend.cu's tile: (rows, columns) of the window per block.
BLUR_TILE = (16, 32)

# The blur's weights on each device, uploaded once per (device, weights,
# total), with the total's divider.
_weights: Dict[tuple, tuple] = {}


def blur_divider(total: int) -> tuple:
    """(magic, shift) with floor(n / total) == magic * n >> shift for every
    0 <= n < 2^31 and 0 < total < 2^31: with l = ceil(log2(total)), shift =
    31 + l and magic = ceil(2^shift / total) < 2^32 (Granlund and
    Montgomery, PLDI 1994, theorem 4.2 at 31 bits).  blur_blend.cu divides
    a signed sum s by its sign's mask m = s >> 31 as m ^ ((s ^ m) / total),
    which is the floor for every int32 s."""
    shift = 31 + (total - 1).bit_length()
    return -(-(1 << shift) // total), shift


def _weights_on(device: torch.device, weights, total: int) -> tuple:
    """(weights tensor on `device`, magic, shift)."""
    key = (device, tuple(int(v) for v in weights), total)
    got = _weights.get(key)
    if got is None:
        if len(key[1]) % 2 == 0 or not all(0 <= v < 2**31 for v in key[1]):
            raise ValueError("blur weights: need an odd count of values in [0, 2^31)")
        if not 0 < total < 2**31:
            raise ValueError(f"blur total {total} is outside (0, 2^31)")
        got = _weights[key] = (torch.tensor(key[1], dtype=torch.int32, device=device), *blur_divider(total))
    return got


def blur_launch_rect(hb: int, wb: int, ry0: int, rx0: int, h: int, w: int, d_box, radius: int) -> tuple:
    """(y0, x0, y1, x1), half-open, of the pixels that window mode can
    change: bloat(d_box, radius) & the logical window [ry0, ry0 + h) x
    [rx0, rx0 + w) & the hb x wb window, all in window coordinates (d_box
    inclusive).  Empty (y1 <= y0 or x1 <= x0) where none can change."""
    d0, d1, d2, d3 = d_box
    return (max(0, ry0, d0 - radius), max(0, rx0, d1 - radius),
            min(hb, ry0 + h, d2 + radius + 1), min(wb, rx0 + w, d3 + radius + 1))


def _check_plane_at(name: str, t: torch.Tensor, device, at, hb: int, wb: int, channels: bool) -> None:
    """`t` a contiguous aligned int32 plane, (rows, cols) or (rows, cols, 4)
    with `channels`, holding the hb x wb window at `at` = (row, col)."""
    if t.dim() != (3 if channels else 2) or (channels and t.shape[2] != 4):
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not a {'(rows, cols, 4)' if channels else '(rows, cols)'} plane")
    _check(name, t, device)
    y, x = at
    if y < 0 or x < 0 or y + hb > t.shape[0] or x + wb > t.shape[1] or t.shape[1] >= 2**31:
        raise ValueError(f"{name}: the {hb}x{wb} window at {tuple(at)} is outside its {t.shape[0]}x{t.shape[1]} plane")


def _blur_blend(content, content_at, f_alpha, dst, at, hb, wb, weights, total, grid, geometry) -> None:
    """One blur_blend launch over `grid` = (y0, x0, y1, x1) of the window,
    in rect mode where `geometry` is None; none where `grid` is empty."""
    device = f_alpha.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA blur needs tensors on a CUDA device, got {device}")
    if hb <= 0 or wb <= 0 or -(-hb // BLUR_TILE[0]) > 65535:
        raise ValueError(f"a {hb}x{wb} window is beyond the kernel's grid")
    _check_plane_at("content", content, device, content_at, hb, wb, content.dim() == 3)
    _check_plane_at("f_alpha", f_alpha, device, at, hb, wb, False)
    _check_plane_at("display", dst, device, at, hb, wb, True)
    w, magic, shift = _weights_on(device, weights, total)
    y0, x0, y1, x1 = grid
    if y1 <= y0 or x1 <= x0:
        return
    with torch.cuda.device(device):
        rc = load()["blur_blend"](
            content.data_ptr(), int(content.dim() == 2), content.shape[1], *content_at,
            f_alpha.data_ptr(), f_alpha.shape[1], *at, dst.data_ptr(), dst.shape[1], *at,
            w.data_ptr(), len(weights) // 2, magic, shift, hb, wb, y0, x0, y1 - y0, x1 - x0,
            int(geometry is None), *(geometry or (0,) * 8), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("blur_blend", rc)
    launches["blur_blend"] += 1


def blur_blend_window(content, content_at, f_alpha, display, at, hb: int, wb: int, ry0: int, rx0: int, h: int,
                      w: int, d_box, weights, total: int) -> torch.Tensor:
    """Launch ``blur_blend`` in window mode: the hb x wb window of `display`
    ((H, W, 4) int32) at `at` = (oy, ox) takes, where it changes, the blend
    of the exact blur of the content window (a packed (rows, cols) int32
    plane or unpacked (rows, cols, 4), its window at `content_at`) by
    `f_alpha` ((H, W) int32, read at `at`), in place.  The logical window is
    [ry0, ry0 + h) x [rx0, rx0 + w) and d_box the dirty rect (row0, col0,
    row1, col1 inclusive), both in window coordinates.  The launch covers
    only blur_launch_rect's pixels, and none where that is empty."""
    if tuple(f_alpha.shape) != tuple(display.shape[:2]):
        raise ValueError(f"f_alpha {tuple(f_alpha.shape)} and display {tuple(display.shape)} differ in size")
    d0, d1, d2, d3 = (int(v) for v in d_box)
    radius = len(weights) // 2
    _blur_blend(content, tuple(content_at), f_alpha, display, tuple(at), hb, wb, weights, total,
                blur_launch_rect(hb, wb, ry0, rx0, h, w, (d0, d1, d2, d3), radius), (ry0, rx0, h, w, d0, d1, d2, d3))
    return display


def blur_blend_rect(content, f_alpha, weights, total: int) -> torch.Tensor:
    """Launch ``blur_blend`` in rect mode: the whole (H, W) frame (the top
    left of `content`, packed (rows, cols) or unpacked (rows, cols, 4) int32)
    blurred and blended by `f_alpha` ((H, W) int32) where it is positive,
    the content elsewhere, into a new (H, W, 4) plane."""
    hb, wb = f_alpha.shape
    out = torch.empty((hb, wb, 4), dtype=torch.int32, device=f_alpha.device)
    _blur_blend(content, (0, 0), f_alpha, out, (0, 0), hb, wb, weights, total, (0, 0, hb, wb), None)
    return out


def shatter_into(atlas, rgba, oys, oxs, base: int) -> torch.Tensor:
    """Launch ``shatter_into``: the packed (hs, ws, 4) int32 raster `rgba`
    cut into n 64x128 pieces written in place at slots [base, base + n) of
    `atlas`: piece j at (oys[j], oxs[j]) in the raster, zero outside it.
    (n,) int32 offsets write a (cap, 64, 128) atlas; (n_bands, n) offsets a
    stack of band atlases (n_bands, cap, 64, 128), band b from row b."""
    device = atlas.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA shatter needs tensors on a CUDA device, got {device}")
    banded = atlas.dim() == 4
    if atlas.dim() not in (3, 4) or tuple(atlas.shape[-2:]) != (64, 128):
        raise ValueError(f"atlas: need a (cap, 64, 128) atlas or an (n_bands, cap, 64, 128) stack, got {tuple(atlas.shape)}")
    _check("atlas", atlas, device)
    n_bands, cap = (atlas.shape[0], atlas.shape[1]) if banded else (1, atlas.shape[0])
    if rgba.dim() != 3 or rgba.shape[2] != 4:
        raise ValueError(f"rgba: need an (hs, ws, 4) raster, got shape {tuple(rgba.shape)}")
    _check("rgba", rgba, device)
    n = oys.shape[-1]
    shape = (n_bands, n) if banded else (n,)
    _check("oys", oys, device, shape)
    _check("oxs", oxs, device, shape)
    if base < 0 or base + n > cap or n_bands > 65535:
        raise ValueError(f"slots [{base}, {base + n}) of {n_bands} band(s) do not fit an atlas of {cap}")
    if n == 0:
        return atlas
    with torch.cuda.device(device):
        rc = load()["shatter_into"](
            rgba.data_ptr(), rgba.shape[0], rgba.shape[1], oys.data_ptr(), oxs.data_ptr(), n, n_bands,
            atlas.data_ptr(), cap, base, torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("shatter_into", rc)
    launches["shatter_into"] += 1
    return atlas


# brush_stamp.cu's atlas piece; the (rows, columns) of output one block
# owns: a strip of a plane, or an eighth of a piece; and the bin whose lists
# a block reads: its piece, or the plane's 64x128 tile around its strip.
BRUSH_TILE = (64, 128)
BRUSH_BLOCK = (8, 128)
BRUSH_BIN = BRUSH_TILE
# brush_stamp.cu's kStrokeWords and kPatchSmemMax (a cropped patch that
# needs more shared memory, brush_patch_bytes, is read from device memory).
STROKE_WORDS = 12
BRUSH_PATCH_SMEM = 229376
# The smear's passes over its steps: the reference smears twice (brush.ml:308).
SMEAR_PASSES = 2


def _stroke_table(brushes: np.ndarray, radii=None, fills=None) -> tuple:
    """(strokes, patches) of BrushLists for (s, bhb, bwb) `brushes` (the
    native library's brush_stroke_table), the radii and fills written in
    where given; raises ValueError where a texel lies outside 0..255."""
    from .. import native_lib

    if brushes.dtype != np.int32 and brushes.size and (brushes.min() < 0 or brushes.max() > 255):
        raise ValueError("brush_stamp: a brush texel lies outside 0..255")
    strokes = np.zeros((brushes.shape[0], STROKE_WORDS), np.int32)
    patches = native_lib.brush_stroke_table(np.ascontiguousarray(brushes, np.int32), strokes)
    if radii is not None:
        strokes[:, 4:6] = radii
    if fills is not None:
        strokes[:, 8:12] = fills
    return strokes, patches


def _stamp_arrays(brushes, offsets, valid) -> tuple:
    brushes, offsets, valid = np.asarray(brushes), np.asarray(offsets), np.asarray(valid, bool)
    s = brushes.shape[0]
    if offsets.ndim != 3 or offsets.shape[::2] != (s, 2) or valid.shape != offsets.shape[:2]:
        raise ValueError(f"brush_stamp: offsets {offsets.shape} and valid {valid.shape} are not (s, n, 2) and "
                         f"(s, n) for {s} strokes")
    return brushes, offsets, valid


def _outside(si: int, i: int, offsets, bhb: int, bwb: int, hp: int, wp: int) -> ValueError:
    return ValueError(f"brush_stamp: stroke {si}'s stamp {i} at {tuple(int(v) for v in offsets[si, i])} puts its "
                      f"{bhb}x{bwb} patch outside the {hp}x{wp} plane")


class BrushLists(NamedTuple):
    """brush_stamp's host lists for one launch (brush_plane_lists,
    brush_piece_lists).  Block b owns one BRUSH_BLOCK strip of output: in
    plane mode strip (b // tiles_x) % strips_y, b % tiles_x of plane b //
    (strips_y * tiles_x); in piece mode strip b % 8 of piece b // 8.  It
    reads the lists of its BRUSH_BIN bin: in plane mode the plane's 64x128
    tile around its strip, in piece mode its piece.

      * ranges (blocks, 4): block b's stamp entries are stamps[ranges[b, 0] :
        ranges[b, 1]], its point entries points[ranges[b, 2] : ranges[b, 3]]
        (the blocks of one bin, and of pieces that repeat a window as
        padding pieces do, share the lists);
      * stamps: the valid stamps whose patch extent touches the bin, in stamp
        order, each the extent's top-left corner relative to the bin, packed
        as row & 0xFFFF | col << 16;
      * points (piece mode): the stamp points in the plane whose (2 hr + 1) x
        (2 wr + 1) window touches the bin, in order, each the point relative
        to the bin, packed the same way;
      * strokes (s, STROKE_WORDS): the nonzero extent (ky0, kx0, kh, kw) of
        the stroke's patch, the rows and columns that hold a nonzero texel
        (all 0 where none does), its mask radii (wr, hr), the byte offset of
        its cropped patch in `patches`, 0, its fill's four channels;
      * patches: the strokes' cropped patches as bytes (int32 words), each
        distinct patch once, each starting on 16 bytes and padded to a
        multiple of 16 (the kernel stages a patch 16 bytes a copy);
      * meta: the pieces (piece mode);
      * patch_smem: the bytes of shared memory a block holds its patch in,
        the most brush_patch_bytes of a stroke's patch up to
        BRUSH_PATCH_SMEM (a patch that needs more is read from device
        memory)."""

    piece: bool
    shape: tuple
    hp: int
    wp: int
    ranges: np.ndarray
    stamps: np.ndarray
    points: np.ndarray
    strokes: np.ndarray
    patches: np.ndarray
    meta: np.ndarray
    patch_smem: int


def _int32(a, what: str) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.int32:
        if a.size and (a.min() < -(2**31) or a.max() >= 2**31):
            raise ValueError(f"brush_stamp: {what} do not fit in int32")
        a = a.astype(np.int32)
    return np.ascontiguousarray(a)


def _brush_lists(piece: bool, shape: tuple, brushes, offsets, valid, hp: int, wp: int, points=None, fills=None,
                 radii=None, meta=None) -> BrushLists:
    from .. import native_lib

    brushes, offsets, valid = _stamp_arrays(brushes, offsets, valid)
    s, bhb, bwb = brushes.shape
    corners = _int32(offsets, "stamp corners")
    if points is not None:
        points = _int32(points, "stamp points")
        if points.shape != corners.shape:
            raise ValueError(f"brush_stamp: points {points.shape} are not shaped as the stamps {corners.shape}")
    strokes, patches = _stroke_table(brushes, radii, fills)
    if s and 2 * int(strokes[:, 2:6].max()) + 1 >= 2**15 - 256:  # kh, kw; the mask window 2 wr + 1, 2 hr + 1
        raise ValueError("brush_stamp: a patch or mask window is too large for the kernel's 16-bit entries")
    sh, sw = BRUSH_BLOCK
    blocks = BRUSH_TILE[0] // sh * len(meta) if piece else s * -(-hp // sh) * -(-wp // sw)
    if blocks >= 2**31:
        raise ValueError(f"brush_stamp: {shape} is beyond the kernel's grid")
    ranges = np.empty((blocks, 4), np.int32)
    stamps, point_entries, bad = native_lib.brush_strip_lists(corners, np.ascontiguousarray(valid), points, strokes,
                                                              bhb, bwb, meta, hp, wp, ranges)
    if bad is not None:
        raise _outside(*bad, corners, bhb, bwb, hp, wp)
    need = [brush_patch_bytes(int(kh), int(kw)) for kh, kw in strokes[:, 2:4] if kh]
    patch_smem = max([n for n in need if n <= BRUSH_PATCH_SMEM], default=0)
    return BrushLists(piece, shape, hp, wp, ranges, stamps, point_entries, strokes, patches,
                      np.zeros((0, 3), np.int32) if meta is None else meta, patch_smem)


def brush_patch_bytes(kh, kw):
    """brush_stamp.cu's patch_bytes: the shared memory a (kh, kw) patch
    takes, with 8 zero rows above and below it (each pad rounded up to 16
    bytes), so that a fold reads rows past its edges without a test."""
    return 2 * (-(-8 * kw // 16) * 16) + -(-kh * kw // 16) * 16


def brush_plane_lists(brushes, offsets, valid, hp: int, wp: int) -> BrushLists:
    """brush_stamp's plane-mode lists: s (hp, wp) alpha planes of the
    strokes of `brushes` (s, bhb, bwb) int32 in 0..255 stamped at `offsets`
    (s, n, 2) where `valid` (s, n) holds.  Raises ValueError where a valid
    stamp's (bhb, bwb) patch leaves the plane (the JAX package would clamp
    it; the host never makes one) or a texel lies outside 0..255."""
    if not (0 <= hp and 0 <= wp and hp * wp < 2**31):
        raise ValueError(f"brush_stamp: planes of {hp}x{wp} are beyond the kernel's grid")
    return _brush_lists(False, (len(brushes), hp, wp), brushes, offsets, valid, hp, wp)


def brush_piece_lists(brushes, offsets, valid, points, fills, radii, meta, hp: int, wp: int) -> BrushLists:
    """brush_stamp's piece-mode lists: the (pieces, 64, 128) packed block of
    the windows `meta` (pieces, 3) = (stroke, row, col) of the strokes'
    (hp, wp) planes (brush_stamp_pieces says what each piece holds; the
    refusals are brush_plane_lists')."""
    meta = np.asarray(meta, np.int64).reshape(-1, 3)
    s = len(brushes)
    th, tw = BRUSH_TILE
    bad = (meta[:, 0] < 0) | (meta[:, 0] >= s) | (meta[:, 1] < 0) | (meta[:, 1] + th > hp) | (meta[:, 2] < 0) \
        | (meta[:, 2] + tw > wp)
    if bad.any():
        j = int(np.nonzero(bad)[0][0])
        raise ValueError(f"brush_stamp: piece {j} {tuple(meta[j])} is not a {th}x{tw} window of one of the {s} "
                         f"{hp}x{wp} planes")
    if hp * wp >= 2**31:
        raise ValueError(f"brush_stamp: {len(meta)} pieces of {hp}x{wp} planes are beyond the kernel's grid")
    return _brush_lists(True, (len(meta), th, tw), brushes, offsets, valid, hp, wp, points, fills, radii,
                        meta.astype(np.int32))


def brush_list_stats(lists: BrushLists) -> dict:
    """The blocks of a launch and the entries each reads: the longest and
    mean stamp list, and the same of the point lists in piece mode."""
    lengths = lists.ranges[:, 1::2] - lists.ranges[:, 0::2]
    out = {"blocks": len(lengths), "stamp_list_max": int(lengths[:, 0].max(initial=0)),
           "stamp_list_mean": float(lengths[:, 0].mean()) if len(lengths) else 0.0}
    if lists.piece:
        out.update(point_list_max=int(lengths[:, 1].max(initial=0)),
                   point_list_mean=float(lengths[:, 1].mean()) if len(lengths) else 0.0)
    return out


def _cuda_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA device, got {device}")
    return torch.device("cuda", torch.cuda.current_device()) if device.index is None else device


def stage_brush_lists(lists: BrushLists, device) -> list:
    """A launch's lists on the card in one staged copy: int32 views
    (ranges, stamps, points, strokes, patches, meta)."""
    from ..raster.staging import stage

    return stage(_cuda_device(device, "brush_stamp"), lists.ranges, lists.stamps, lists.points, lists.strokes,
                 lists.patches, lists.meta)


def brush_stamp(lists: BrushLists, staged) -> torch.Tensor:
    """Launch ``brush_stamp`` over `lists` staged on the card (`staged`,
    stage_brush_lists'): one block a strip of the output, which is
    returned ((s, hp, wp) planes, or the (pieces, 64, 128) block)."""
    ranges, stamps, points, strokes, patches, meta = staged
    device = ranges.device
    if device.type != "cuda":
        raise ValueError(f"brush_stamp needs its lists on a CUDA device, got {device}")
    out = torch.empty(lists.shape, dtype=torch.int32, device=device)
    blocks = len(lists.ranges)
    if blocks == 0 or out.numel() == 0:
        return out
    with torch.cuda.device(device):
        rc = load()["brush_stamp"](
            ranges.data_ptr(), stamps.data_ptr(), points.data_ptr(), strokes.data_ptr(), patches.data_ptr(),
            meta.data_ptr(), out.data_ptr(), int(lists.piece), blocks, lists.hp, lists.wp, lists.patch_smem,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("brush_stamp", rc)
    launches["brush_stamp"] += 1
    return out


def brush_stamp_blocks_per_sm(piece: bool, patch_smem: int) -> int:
    """The blocks of a brush_stamp launch one SM holds with `patch_smem`
    bytes of dynamic shared memory (the occupancy calculator)."""
    n = load()["brush_stamp_blocks_per_sm"](int(piece), patch_smem)
    if n < 0:
        raise RuntimeError(f"brush_stamp_blocks_per_sm: CUDA error {-n}")
    return n


def brush_stamp_planes(brushes, offsets, valid, hp: int, wp: int, device) -> torch.Tensor:
    """Launch ``brush_stamp`` in plane mode: the (s, hp, wp) int32 alpha
    planes of s strokes, each stroke's valid stamps alpha_over-ing its
    (bhb, bwb) patch of `brushes` at `offsets` (s, n, 2) in order (the
    plain version is raster/brush.py _stamp_alpha_torch).  The host lists
    (brush_plane_lists; it raises on a valid stamp whose patch leaves the
    plane) cross in one staged copy."""
    device = _cuda_device(device, "brush_stamp")
    lists = brush_plane_lists(brushes, offsets, valid, hp, wp)
    return brush_stamp(lists, stage_brush_lists(lists, device))


def brush_stamp_pieces(brushes, offsets, valid, points, fills, radii, meta, hp: int, wp: int, device) -> torch.Tensor:
    """Launch ``brush_stamp`` in piece mode: a brush-tile group's (pieces,
    64, 128) packed int32 block.  Piece j is the 64x128 window at (row,
    col) = meta[j, 1:] of stroke meta[j, 0]'s (hp, wp) plane: the stroke's
    fill (fills, (s, 4)) dissolved by its stamped alpha where the stroke's
    mask holds (a stamp point of `points` (s, n, 2) within its (wr, hr) of
    `radii` (s, 2)), zero elsewhere (the plain version is
    raster/brush_tiles.py BrushTileBuild._group_block_torch).  The host
    lists (brush_piece_lists) cross in one staged copy."""
    device = _cuda_device(device, "brush_stamp")
    lists = brush_piece_lists(brushes, offsets, valid, points, fills, radii, meta, hp, wp)
    return brush_stamp(lists, stage_brush_lists(lists, device))


def smear_steps(offsets, dirs, bh: int, bw: int, height: int, width: int) -> np.ndarray:
    """smear_walk's (n, 4) int32 step records (row, col, dx, dy) from the
    patch corners `offsets` (row, col) and directions `dirs` (dx, dy).
    Raises ValueError, naming the first step at fault, where a direction is
    not a unit step (a component outside -1..1: find_smear_directions gives
    signs) or a step's (bh, bw) patch or its source, shifted by -dir, leaves
    the (height, width) canvas (the JAX package would clamp it; smear's host
    filter never makes one)."""
    steps = np.zeros((len(offsets), 4), np.int64)
    if len(offsets):
        steps[:, :2], steps[:, 2:] = np.asarray(offsets).reshape(-1, 2), np.asarray(dirs).reshape(-1, 2)
    r, c, dx, dy = steps.T
    unit = (np.abs(dx) <= 1) & (np.abs(dy) <= 1)
    if not unit.all():
        j = int(np.nonzero(~unit)[0][0])
        raise ValueError(f"smear_walk: step {j} {tuple(steps[j])} has a direction that is not a unit step")
    bad = (np.minimum(r, r - dy) < 0) | (np.maximum(r, r - dy) + bh > height) \
        | (np.minimum(c, c - dx) < 0) | (np.maximum(c, c - dx) + bw > width)
    if bad.any():
        j = int(np.nonzero(bad)[0][0])
        raise ValueError(f"smear_walk: step {j} {tuple(steps[j])} moves a {bh}x{bw} patch outside the "
                         f"{height}x{width} canvas")
    return steps.astype(np.int32)


def smear_walk(cv, opac, offsets, dirs, bh: int, bw: int, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``smear_walk``: the smear's SMEAR_PASSES passes over the (H,
    W, 4) int32 canvas `cv`, in place, in one launch: at each step the (bh, bw) patch
    at offsets[i] (row, col) takes the opacity-weighted mix of itself and
    the patch shifted by -dirs[i] (dx, dy) (the plain version is
    raster/brush.py _smear_walk_torch).  `opac` is the (bh, bw) int32
    opacity plane on cv's device; the steps cross in one staged copy.  The
    kernel picks its mode by the patch's size (smear.cu window_shape).
    `stats`, a (4,) int32 tensor on cv's device, receives what the launch
    did: its shared-memory window's rows and columns (0, 0 in global mode),
    the window's loads, and the step (of len(offsets) * SMEAR_PASSES) from
    which the walk ran in device memory (0 in global mode; all of them
    where the window walk reached the end)."""
    from ..raster.staging import stage

    device = cv.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA smear needs tensors on a CUDA device, got {device}")
    if cv.dim() != 3 or cv.shape[2] != 4:
        raise ValueError(f"smear_walk: need an (H, W, 4) canvas, got shape {tuple(cv.shape)}")
    _check("canvas", cv, device)
    _check("opac", opac, device, (bh, bw))
    if stats is not None:
        _check("stats", stats, device, (4,))
    height, width = cv.shape[:2]
    if not SMEAR_PASSES * len(offsets) < 2**31 or width >= 2**31 // 4:
        raise ValueError(f"smear_walk: {len(offsets)} steps over a {height}x{width} canvas are beyond the kernel")
    steps = smear_steps(offsets, dirs, bh, bw, height, width)
    if not len(steps) or not bh * bw:
        return cv
    (steps_d,) = stage(device, steps)
    # The new values of the patch pixels that a thread cannot keep in registers between a step's reads and writes,
    # where the walk runs in device memory.
    spill = torch.empty((bh * bw, 4), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = load()["smear_walk"](
            cv.data_ptr(), height, width, opac.data_ptr(), steps_d.data_ptr(), spill.data_ptr(),
            None if stats is None else stats.data_ptr(), len(steps), SMEAR_PASSES, bh, bw,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("smear_walk", rc)
    launches["smear_walk"] += 1
    return cv


# tile_raster.cu's planes, (rows, columns) of one piece's span lists: the 1x
# coverage and crossing masks, and the 16x AA t-plane (16 * 64 + 16 rows,
# 16 * 128 + 16 columns; raster/tile_raster.py _TTH, _TTW).  A unit, one
# block of the launch, is one of an edge item's TILE_BANDS bands of 16 pixel
# rows, or a whole interior item (mode TILE_WHOLE).
TILE_PLANE = (64, 128)
AA_PLANE = (1040, 2064)
TILE_BANDS = 4
TILE_WHOLE = 4
_NO_SPANS = (np.zeros(0, np.int64),) * 3


def tile_span_lists(spans, h: int, w: int, base: int = 0, out=None) -> tuple:
    """tile_raster's host lists of one span family of n items, each item a
    (rows, starts, ends) triple of inclusive spans over an (h, w) plane:
    (rows, cols, offsets), int32 numpy arrays.

      * rows, cols: one entry a span, each item's spans in their order and
        the items in theirs (nothing is grouped: the kernel bins the rows
        it needs), cols start | (end + 1) << 16;
      * offsets (n + 1,): item i's spans are [offsets[i] - base,
        offsets[i + 1] - base) (offsets count from `base`, the family's
        place in the kernel's one span list).

    `out`, a pair of int32 arrays of the family's length, receives rows and
    cols (and is returned) in place of new arrays.  A span on a row outside
    0..h-1 is kept and touches nothing: the kernel reads only its plane's
    rows, as the scatter of the JAX package drops the others (raster/aa.py
    mask_of_spans).  Raises ValueError where a span on a row of the plane
    has its start or end + 1 outside 0..w (the plain version's scatter
    refuses those too) or a value does not fit in int32.  The checks run on
    each family's whole columns."""
    n = len(spans)
    lens = np.fromiter((len(sp[0]) for sp in spans), np.int64, n)
    offsets = np.full(n + 1, base, np.int64)
    np.cumsum(lens, out=offsets[1:])
    offsets[1:] += base
    if offsets[-1] >= 2**31:
        raise ValueError(f"tile_raster: {int(offsets[-1])} spans are beyond the kernel's int32 offsets")
    total = int(offsets[-1] - base)
    rows_out, cols_out = out if out is not None else (np.empty(total, np.int32), np.empty(total, np.int32))
    if not total:
        return rows_out, cols_out, offsets.astype(np.int32)
    rows, starts, stops = (np.concatenate([sp[k] for sp in spans], dtype=np.int64) for k in range(3))
    if min(rows.min(), starts.min(), stops.min()) < -(2**31) or max(rows.max(), starts.max(), stops.max()) >= 2**31 - 1:
        raise ValueError("tile_raster: a span's row or column does not fit in int32")
    stops += 1
    if min(starts.min(), stops.min()) < 0 or max(starts.max(), stops.max()) > w:
        bad = (rows >= 0) & (rows < h) & ((starts < 0) | (starts > w) | (stops < 0) | (stops > w))
        if bad.any():
            j = int(np.nonzero(bad)[0][0])
            i = int(np.searchsorted(offsets, base + j, side="right")) - 1
            raise ValueError(f"tile_raster: item {i}'s span on row {int(rows[j])} from {int(starts[j])} to "
                             f"{int(stops[j]) - 1} leaves the {w} columns of its plane")
    stops <<= 16
    stops |= starts
    np.copyto(rows_out, rows, casting="unsafe")
    np.copyto(cols_out, stops, casting="unsafe")
    return rows_out, cols_out, offsets.astype(np.int32)


def tile_raster_lists(blocks) -> tuple:
    """TR1's host lists for one launch over `blocks`, each (cov, cross, aa,
    fills, nb): n items' per-item (rows, starts, ends) span triples of the
    1x coverage and crossing masks and of the 16x AA t-plane (cov and aa
    None for a block of interior items), their (n, 4) int32 premultiplied
    fills, and the block's nb >= n slots, the blocks' slots one after
    another.  Returns (rows, cols, offsets, fills, units, n_items, slots):

      * rows, cols: every item's coverage spans (tile_span_lists), then
        every item's crossing spans, then every item's AA spans;
      * offsets (3, n_items + 1): item i's spans of family f are
        [offsets[f, i], offsets[f, i + 1]);
      * fills (n_items, 4);
      * units (U, 2), one a block of the launch: (slot, item << 3 | band)
        for each of an edge item's TILE_BANDS bands, the items with the
        most AA spans first; (slot, item << 3 | TILE_WHOLE) for each
        interior item; (slot, -1) for each slot that no item owns.

    Raises ValueError where a block's families or fills do not hold n items,
    n > nb, a fill does not fit in int32, or tile_span_lists refuses a
    family."""
    fams, fills, slot_of, edge, pads, slots = ([], [], []), [], [], [], [], 0
    for cov, cross, aa, block_fills, nb in blocks:
        block_fills = np.asarray(block_fills, np.int64).reshape(-1, 4)
        n = len(block_fills)
        if (cov is None) != (aa is None) or any(f is not None and len(f) != n for f in (cov, cross, aa)):
            raise ValueError(f"tile_raster: need {n} items' spans in every family")
        if not 0 <= n <= nb:
            raise ValueError(f"tile_raster: {n} items do not fit a block of {nb} slots")
        for fam, spans in zip(fams, (cov, cross, aa)):
            fam.extend([_NO_SPANS] * n if spans is None else spans)
        fills.append(block_fills)
        slot_of.append(np.arange(slots, slots + n))
        edge.append(np.full(n, cov is not None))
        pads.append(np.arange(slots + n, slots + nb))
        slots += nb
    n_items = len(fams[1])
    if n_items >= 2**28:
        raise ValueError(f"tile_raster: {n_items} items are beyond the kernel's unit codes")
    fills = np.concatenate(fills) if fills else np.zeros((0, 4), np.int64)
    if fills.size and (fills.min() < -(2**31) or fills.max() >= 2**31):
        raise ValueError("tile_raster: a fill does not fit in int32")
    sizes = [sum(len(sp[0]) for sp in fam) for fam in fams]
    rows, cols = np.empty(sum(sizes), np.int32), np.empty(sum(sizes), np.int32)
    offsets, base = [], 0
    for fam, (h, w), size in zip(fams, (TILE_PLANE, TILE_PLANE, AA_PLANE), sizes):
        offsets.append(tile_span_lists(fam, h, w, base, (rows[base : base + size], cols[base : base + size]))[2])
        base += size
    offsets = np.stack(offsets)
    slot_of = np.concatenate(slot_of) if slot_of else np.zeros(0, np.int64)
    edge = np.concatenate(edge) if edge else np.zeros(0, bool)
    items = np.nonzero(edge)[0]
    items = items[np.argsort(offsets[2, items] - offsets[2, items + 1], kind="stable")]  # most AA spans first
    bands = np.empty((len(items), TILE_BANDS, 2), np.int64)
    bands[..., 0] = slot_of[items, None]
    bands[..., 1] = (items[:, None] << 3) | np.arange(TILE_BANDS)
    whole = np.nonzero(~edge)[0]
    pads = np.concatenate(pads) if pads else np.zeros(0, np.int64)
    units = np.concatenate([bands.reshape(-1, 2), np.stack([slot_of[whole], (whole << 3) | TILE_WHOLE], 1),
                            np.stack([pads, np.full(len(pads), -1)], 1)])
    return rows, cols, offsets, fills.astype(np.int32), units.astype(np.int32), n_items, slots


def stage_tile_lists(blocks, device) -> tuple:
    """tile_raster_lists(blocks) on the CUDA `device`, in one staged copy:
    (rows, cols, offsets, fills, units, n_items, slots)."""
    from ..raster.staging import stage

    device = _cuda_device(device, "tile_raster")
    *arrays, n_items, slots = tile_raster_lists(blocks)
    return (*stage(device, *arrays), n_items, slots)


def tile_raster(lists) -> torch.Tensor:
    """Launch ``tile_raster``: a new (slots, 64, 128) int32 tensor from
    stage_tile_lists' `lists`, one block a unit: each item's packed piece
    in its slot (an edge item's raster/tile_raster.py _edge_impl, an
    interior item's _interior_impl), every other slot zero."""
    rows, cols, offsets, fills, units, n_items, slots = lists
    device = units.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA tile rasterizer needs tensors on a CUDA device, got {device}")
    n_units = units.shape[0]
    if n_units >= 2**31 or tuple(offsets.shape) != (3, n_items + 1) or tuple(fills.shape) != (n_items, 4):
        raise ValueError(f"tile_raster: lists for {n_items} items over {n_units} units are not stage_tile_lists'")
    out = torch.empty((slots, 64, 128), dtype=torch.int32, device=device)
    if n_units == 0:
        return out
    with torch.cuda.device(device):
        rc = load()["tile_raster"](
            rows.data_ptr(), cols.data_ptr(), offsets.data_ptr(), fills.data_ptr(), units.data_ptr(),
            out.data_ptr(), n_items, n_units, torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on("tile_raster", rc)
    launches["tile_raster"] += 1
    return out


def tile_raster_blocks_per_sm() -> int:
    """The blocks of tile_raster that one SM of the current device holds at
    once, as the CUDA occupancy calculator gives them for the built
    library."""
    got = load()["tile_raster_blocks_per_sm"]()
    if got < 0:
        raise RuntimeError(f"tile_raster_blocks_per_sm: CUDA error {-got}")
    return got


# sprite_raster.cu's lists.  Each span is one uint64, (row & 511) << 54 |
# start << 27 | (end + 1), in its member's plane: the 1x box (h x w) or the
# 16x AA t-plane (16 h + 16 x 16 w + 16, its origin at 16 y0 - 32, 16 x0 -
# 32).  A row off its plane is not packed and columns are clipped to the
# plane's 0..width (the JAX package's scatter drops the one and clips the
# other).  Each family of each member is sorted by 16-row groups, so that a
# band's rows are one range: a 1x band's 16 rows, or an AA band's 272
# t-rows (the next band's first 16 among them).  A unit, one block of the
# launch, is a band of SPRITE_BAND pixel rows of a member and a strip of
# SPRITE_STRIP columns; it reads only its band's ranges, and a row's low 9
# bits give its place in them (a range spans fewer than 512 rows).  So a
# box fits while its t-plane's columns fit 27 bits, 16 w + 16 < 2^27, and
# its t-rows int32, 16 h + 16 < 2^31 (H61).
SPRITE_ROW_BITS, SPRITE_COL_BITS = 9, 27
SPRITE_BAND, SPRITE_STRIP = 16, 128
SPRITE_SCALE = 16  # the AA t-plane's scale (raster/aa.py _H)


class SpriteLists(NamedTuple):
    """One sprite_raster launch's host lists (sprite_raster_lists,
    sprite_opacity_lists):

      * spans (S, 2) int32: each span's uint64 as its low and high words,
        every member's coverage spans, then every member's crossing spans,
        then every member's AA spans, each member's by 16-row groups;
      * bands (B, 8): per band of each member, its coverage, crossing and
        AA ranges [lo, hi) of spans, then two zeros;
      * fills (n, 4): premultiplied plain fills (zero in opacity mode);
      * members (n, 8): h, w, and the offsets in 16-byte units of its mask,
        minshape mask and RGBA (opacity mode: its int32 opacity) in the
        output buffer, then three zeros;
      * units (U, 4): (member, band, strip, its row of bands), the units
        that read the most spans first;
      * out_bytes: the output buffer's bytes; opacity: the mode."""

    spans: np.ndarray
    bands: np.ndarray
    fills: np.ndarray
    members: np.ndarray
    units: np.ndarray
    out_bytes: int
    opacity: bool


def _check_packing(w: int, h: int) -> None:
    """Raise ValueError where a box of w x h pixels is beyond the span
    packing: its t-plane's columns in 27 bits, its t-rows in int32 (H61)."""
    sc = SPRITE_SCALE
    if sc * w + sc >= 1 << SPRITE_COL_BITS or sc * h + sc >= 2**31:
        raise ValueError(f"sprite_raster: a box of {w} x {h} pixels is beyond the span packing (16 w + 16 < "
                         f"2^{SPRITE_COL_BITS}, 16 h + 16 < 2^31)")


def sprite_raster_lists(boxes, fills, cov, cross, aa) -> SpriteLists:
    """SR1's host lists for one launch in group mode over n members: boxes
    (n, 4) [x0, y0, w, h] (the member's pixel box), fills (n, 4) int32
    premultiplied plain fills, and per member its 1x coverage and crossing
    spans and its 16x AA spans (absolute (rows, starts, ends) triples with
    inclusive ends; an AA family may be None).  Raises ValueError where a
    box is empty or too large for the packing (16 w + 16 >= 2^27 or
    16 h + 16 >= 2^31), a family does not hold n members, a fill does not
    fit in int32 or the lists outgrow int32 offsets."""
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    x0, y0, w, h = boxes.T
    n = len(boxes)
    if n and (w.min() < 1 or h.min() < 1):
        raise ValueError("sprite_raster: a member's box is empty")
    sc = SPRITE_SCALE
    if n:
        _check_packing(int(w.max()), int(h.max()))
    fams = (cov, cross, aa)
    if any(len(f) != n for f in fams):
        raise ValueError(f"sprite_raster: need {n} members' spans in every family")
    from .. import native_lib

    box = np.stack([y0, h, x0, w], 1)  # each plane: origin row, height, origin column, width
    t_plane = np.stack([sc * y0 - 2 * sc, sc * h + sc, sc * x0 - 2 * sc, sc * w + sc], 1)
    packed, firsts = zip(*(native_lib.sprite_band_spans(f, plane) for f, plane in zip(fams, (box, box, t_plane))))
    base = np.cumsum([0, *(len(p) for p in packed)])
    if base[-1] >= 2**31:
        raise ValueError(f"sprite_raster: {int(base[-1])} spans are beyond the kernel's int32 offsets")
    # Each band's ranges from its family's 16-row groups: a 1x band is one
    # group, an AA band groups 16 b .. 16 b + 16 of its t-plane's h + 1.
    n_bands = -(-h // SPRITE_BAND)
    band_start = np.cumsum(n_bands) - n_bands
    member = np.repeat(np.arange(n), n_bands)
    b = np.arange(int(n_bands.sum()), dtype=np.int64) - band_start[member]
    groups_1x = n_bands + 1  # per member: its groups' firsts and their end
    groups_aa = h + 2
    at_1x = (np.cumsum(groups_1x) - groups_1x)[member] + b
    at_aa = (np.cumsum(groups_aa) - groups_aa)[member]
    bands = np.zeros((len(b), 8), np.int64)
    for f in range(2):
        bands[:, 2 * f], bands[:, 2 * f + 1] = firsts[f][at_1x] + base[f], firsts[f][at_1x + 1] + base[f]
    bands[:, 4] = firsts[2][at_aa + SPRITE_BAND * b] + base[2]
    bands[:, 5] = firsts[2][at_aa + np.minimum(SPRITE_BAND * b + SPRITE_BAND + 1, h[member] + 1)] + base[2]
    # The outputs: a member's mask and minshape mask (each padded to 16 bytes), then its RGBA.
    pixels = h * w
    mask16 = -(-pixels // 16)
    sizes = np.stack((mask16, mask16, pixels), 1)
    ends = np.cumsum(sizes.reshape(-1)).reshape(n, 3)
    members = np.zeros((n, 8), np.int64)
    members[:, 0], members[:, 1], members[:, 2:5] = h, w, ends - sizes
    out_16 = int(ends[-1, -1]) if n else 0
    if out_16 >= 2**31:
        raise ValueError(f"sprite_raster: {16 * out_16} bytes of output are beyond the kernel's offsets")
    # One unit a band of a strip, those that read the most spans first.
    strips = (-(-w // SPRITE_STRIP))[member]
    row = np.repeat(np.arange(len(b)), strips)
    units = np.zeros((len(row), 4), np.int64)
    units[:, 0], units[:, 1], units[:, 3] = member[row], b[row], row
    units[:, 2] = np.arange(len(row)) - np.repeat(np.cumsum(strips) - strips, strips)
    reads = (bands[:, 1:6:2] - bands[:, 0:6:2]).sum(1)
    units = units[np.argsort(-reads[row], kind="stable")]
    fills = np.asarray(fills, np.int64).reshape(n, 4)
    if fills.size and (fills.min() < -(2**31) or fills.max() >= 2**31):
        raise ValueError("sprite_raster: a fill does not fit in int32")
    spans = np.concatenate(packed).view(np.int32).reshape(-1, 2)
    return SpriteLists(spans, bands.astype(np.int32), fills.astype(np.int32), members.astype(np.int32),
                       units.astype(np.int32), 16 * out_16, False)


def sprite_opacity_lists(box, scaled) -> SpriteLists:
    """SR1's host lists for one launch in opacity mode: the AA opacity of
    the pixel box (x0, y0, x1, y1) from its 16x spans `scaled` (rows,
    starts, ends) in absolute scaled coordinates, or None.  Any box of
    fewer than 2^23 - 1 columns and 2^27 - 1 rows (H61)."""
    x0, y0, x1, y1 = (int(v) for v in box)
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if w < 1 or h < 1:
        raise ValueError("sprite_raster: a member's box is empty")
    _check_packing(w, h)
    from .. import native_lib

    # One member, no 1x spans: its bands' AA ranges alone (a matte is one
    # call, and a fold-route rebuild makes 132 of them).
    sc = SPRITE_SCALE
    packed, first = native_lib.sprite_band_spans([scaled], [[sc * y0 - 2 * sc, sc * h + sc, sc * x0 - 2 * sc,
                                                               sc * w + sc]])
    n_bands, strips = -(-h // SPRITE_BAND), -(-w // SPRITE_STRIP)
    b = np.arange(n_bands)
    bands = np.zeros((n_bands, 8), np.int32)
    bands[:, 4], bands[:, 5] = first[SPRITE_BAND * b], first[np.minimum(SPRITE_BAND * b + SPRITE_BAND + 1, h + 1)]
    units = np.zeros((n_bands * strips, 4), np.int32)
    units[:, 1] = units[:, 3] = np.repeat(np.argsort(bands[:, 4] - bands[:, 5], kind="stable"), strips)
    units[:, 2] = np.tile(np.arange(strips), n_bands)
    out_16 = -(-4 * h * w // 16)
    if out_16 >= 2**31 or len(packed) >= 2**31:
        raise ValueError(f"sprite_raster: a matte of {w} x {h} pixels is beyond the kernel's offsets")
    return SpriteLists(packed.view(np.int32).reshape(-1, 2), bands, np.zeros((1, 4), np.int32),
                       np.array([[h, w, 0, 0, 0, 0, 0, 0]], np.int32), units, 16 * out_16, True)


def stage_sprite_lists(lists: SpriteLists, device) -> list:
    """`lists` on the CUDA `device` in one staged copy: int32 views (spans,
    bands, fills, members, units)."""
    from ..raster.staging import stage

    return stage(_cuda_device(device, "sprite_raster"), lists.spans, lists.bands, lists.fills, lists.members,
                 lists.units)


def sprite_raster(lists: SpriteLists, staged):
    """Launch ``sprite_raster`` over `lists` staged on the card (`staged`,
    stage_sprite_lists'): one block a unit.  Group mode returns each
    member's (bool (h, w) shape mask, bool (h, w) minshape mask, int32 (h,
    w, 4) RGBA) as views of one output buffer, each contiguous and on 16
    bytes (the JAX package's _build_group_kernel over the member's own box;
    the plain version is scene/fastframe.py _raster_members); opacity mode
    the box's int32 (h, w) opacity (raster/aa.py coverage_opacity_torch)."""
    spans, bands, fills, members, units = staged
    device = units.device
    if device.type != "cuda":
        raise ValueError(f"sprite_raster needs its lists on a CUDA device, got {device}")
    n = len(lists.members)
    if tuple(bands.shape) != lists.bands.shape or tuple(units.shape) != lists.units.shape:
        raise ValueError(f"sprite_raster: staged lists of {n} members are not stage_sprite_lists' of these lists")
    out = torch.empty(lists.out_bytes, dtype=torch.uint8, device=device)
    if len(lists.units):
        with torch.cuda.device(device):
            rc = load()["sprite_raster"](
                spans.data_ptr(), bands.data_ptr(), fills.data_ptr(), members.data_ptr(), units.data_ptr(),
                out.data_ptr(), n, len(lists.units), int(lists.opacity), torch.cuda.current_stream(device).cuda_stream,
            )
        _raise_on("sprite_raster", rc)
        launches["sprite_raster"] += 1
    return sprite_views(lists, out)


def sprite_views(lists: SpriteLists, out: torch.Tensor):
    """The planes of `lists`' members in their uint8 output buffer `out`,
    as sprite_raster returns them: each a contiguous view at a multiple of
    16 bytes into the buffer."""
    words, flags = out.view(torch.int32), out.view(torch.bool)
    views = []
    for h, w, mask, minmask, rgba, *_ in lists.members.tolist():
        if lists.opacity:
            return words.as_strided((h, w), (w, 1), 4 * rgba)
        views.append((flags.as_strided((h, w), (w, 1), 16 * mask), flags.as_strided((h, w), (w, 1), 16 * minmask),
                      words.as_strided((h, w, 4), (4 * w, 4, 1), 4 * rgba)))
    return views


def sprite_raster_blocks_per_sm() -> int:
    """The blocks of sprite_raster that one SM of the current device holds
    at once (the occupancy calculator)."""
    got = load()["sprite_raster_blocks_per_sm"]()
    if got < 0:
        raise RuntimeError(f"sprite_raster_blocks_per_sm: CUDA error {-got}")
    return got


def sprite_raster_opacity(box, scaled, device) -> torch.Tensor:
    """Launch ``sprite_raster`` in opacity mode: the int32 (h, w) AA opacity
    of the pixel box (x0, y0, x1, y1) from 16x spans in absolute scaled
    coordinates (or None), on the CUDA `device`, its lists in one staged
    copy (the plain version is raster/aa.py coverage_opacity_torch).  Any
    box of fewer than 2^23 - 1 columns and 2^27 - 1 rows (H61); past them
    ValueError."""
    lists = sprite_opacity_lists(box, scaled)
    return sprite_raster(lists, stage_sprite_lists(lists, device))


# region_ops.cu's caf operators: the four built-in codes, and the code of a
# composed plane given by the caller (any other operator).
CAF_OPS = {"over": 0, "alpha_over": 1, "plus": 2, "nocover": 3}
CAF_GIVEN = 4
# caf's union boxes of at most this many pixels read every colour over its
# box beside the masks, in one round trip; larger ones read the masks, then
# only the colours the result takes (on an NVIDIA H100 80GB HBM3 at 700 W,
# profile_region.py: one round trip is the faster at the 133 x 151 caf, two
# at the 1080 x 689 one, whose unset pixels' colours cost more than a round
# trip).
CAF_ONE_TRIP_PIXELS = 1 << 16
# box_morph's output tile (rows, columns) a block of the staged launch; the
# shared memory of a block of the staged route, at most, and of any block on
# sm_90 (the second route's row pass).
MORPH_TILE = (32, 128)
MORPH_SMEM = 48 * 1024
MORPH_SMEM_MAX = 232448


class CafPlane(NamedTuple):
    """An operand of caf: its box's offset (y0, x0) in the union box, its
    bool (h, w) mask (None for a composed plane) and int32 (h, w, 4) RGBA,
    each a view with any strides."""

    y0: int
    x0: int
    mask: Optional[torch.Tensor]
    rgba: torch.Tensor


def _as_i64(values) -> ctypes.Array:
    return (_i64 * len(values))(*values)


def _caf_geometry(h: int, w: int, plane: Optional[CafPlane], device: torch.device) -> list:
    """caf's 10 values of one plane (y0, x0, h, w, mask strides, RGBA
    strides, one 16-byte load a pixel), zeros for an absent plane; raises
    ValueError on a plane the kernel does not take."""
    if plane is None:
        return [0] * 10
    y0, x0, mask, rgba = plane
    if rgba.device != device or rgba.dtype != torch.int32 or rgba.dim() != 3 or rgba.shape[2] != 4:
        raise ValueError(f"caf: an RGBA plane must be int32 (h, w, 4) on {device}, got {rgba.dtype} "
                         f"{tuple(rgba.shape)} on {rgba.device}")
    ph, pw = rgba.shape[:2]
    if mask is not None and (mask.device != device or mask.dtype != torch.bool or tuple(mask.shape) != (ph, pw)):
        raise ValueError(f"caf: a mask must be bool {(ph, pw)} on {device}, got {mask.dtype} {tuple(mask.shape)} "
                         f"on {mask.device}")
    if ph == 0 or pw == 0 or y0 < 0 or x0 < 0 or y0 + ph > h or x0 + pw > w:
        raise ValueError(f"caf: a {ph}x{pw} plane at {(y0, x0)} is not inside the {h}x{w} union box")
    msy, msx = mask.stride() if mask is not None else (0, 0)
    rsy, rsx, rsc = rgba.stride()
    vec = int(rsc == 1 and rsx == 4 and rsy % 4 == 0 and rgba.data_ptr() % 16 == 0)
    return [y0, x0, ph, pw, msy, msx, rsy, rsx, rsc, vec]


def caf_one_trip(h: int, w: int) -> bool:
    """Whether caf over an h x w union box reads every operand's colours
    over its box beside the masks (one round trip), not after them."""
    return h * w <= CAF_ONE_TRIP_PIXELS


def caf(h: int, w: int, op: int, a: CafPlane, b: Optional[CafPlane] = None, composed: Optional[CafPlane] = None,
        f_only: bool = False):
    """Launch ``caf`` (CF1) over the h x w union box of operands `a` and `b`
    (b None: one operand): where both masks are set the colour of the
    built-in operator `op` (CAF_OPS) of a's over b's, or with CAF_GIVEN the
    `composed` plane's (a view over the intersection of the boxes; None
    where they do not meet), else the set operand's colour, else 0.
    Returns new planes (int32 (h, w, 4) RGBA, bool mask, bool f = mask &
    (alpha == 255)), or with `f_only` the f plane alone (the one-operand
    caf: the result is that operand).  One launch; its colours read in one
    round trip with the masks or after them (caf_one_trip).  The plain
    version is raster/region.py caf_torch."""
    device = a.rgba.device
    if device.type != "cuda":
        raise ValueError(f"caf needs tensors on a CUDA device, got {device}")
    if op not in (*CAF_OPS.values(), CAF_GIVEN) or (composed is not None and op != CAF_GIVEN):
        raise ValueError(f"caf: operator code {op} with {'a' if composed is not None else 'no'} composed plane")
    if not (0 < h < 2**31 and 0 < w < 2**31) or -(-w // 128) >= 2**31:
        raise ValueError(f"caf: a {h}x{w} union box is beyond the kernel's grid")
    if a.mask is None or (b is not None and b.mask is None) or (composed is not None and composed.mask is not None):
        raise ValueError("caf: an operand needs a mask, the composed plane has none")
    geom = _as_i64([h, w, op, int(caf_one_trip(h, w))] + _caf_geometry(h, w, a, device)
                   + _caf_geometry(h, w, b, device) + _caf_geometry(h, w, composed, device))
    f = torch.empty((h, w), dtype=torch.bool, device=device)
    rgba = None if f_only else torch.empty((h, w, 4), dtype=torch.int32, device=device)
    mask = None if f_only else torch.empty((h, w), dtype=torch.bool, device=device)
    planes = [a.mask, a.rgba, None if b is None else b.mask, None if b is None else b.rgba,
              None if composed is None else composed.rgba, rgba, mask, f]
    with torch.cuda.device(device):
        rc = load()["caf"](ctypes.addressof(geom), *(None if t is None else t.data_ptr() for t in planes),
                           torch.cuda.current_stream(device).cuda_stream)
    _raise_on("caf", rc)
    launches["caf"] += 1
    return f if f_only else (rgba, mask, f)


# tight_bounds' partials and ticket, per (device, stream), for its ticket
# route: the ticket is 0 when the buffer is made and each launch leaves it
# 0.
_bounds_scratch: Dict[tuple, torch.Tensor] = {}
# A thread's loads a round, all issued before any is used (region_ops.cu
# kTbLoads); a block's warps; the ticket route's blocks at most
# (kTbMaxBlocks, the scratch's partials).
TIGHT_BOUNDS_LOADS = 8
TIGHT_BOUNDS_WARPS = 8
TIGHT_BOUNDS_MAX_BLOCKS = 528
# tight_bounds_route's routes and layouts, as region_ops.cu numbers them.
BOUNDS_ONE, BOUNDS_TICKET = 0, 1
BOUNDS_GRANULES, BOUNDS_BYTES = 0, 1


class BoundsRoute(NamedTuple):
    """How tight_bounds runs at a shape: `route` BOUNDS_ONE (one block) or
    BOUNDS_TICKET (`blocks` blocks and the self-resetting ticket); `layout`
    BOUNDS_GRANULES (a lane a 16-byte granule of a row) or BOUNDS_BYTES (a
    lane a cell); `segs` a row's warp segments of 32 units; `rows` a
    block's rows."""

    route: int
    layout: int
    segs: int
    rows: int
    blocks: int


def tight_bounds_route(h: int, w: int, sy: int, sx: int) -> BoundsRoute:
    """tight_bounds' route for an h x w mask of element strides (sy, sx),
    from the shape alone: the granule layout where a row's cells are
    adjacent and rows do not overlap, else the byte layout; one block where
    every row fits one round of one block (TIGHT_BOUNDS_WARPS warps, each
    TIGHT_BOUNDS_LOADS items of a row segment), else the ticket route over
    blocks of one round each, at most TIGHT_BOUNDS_MAX_BLOCKS of them
    (their rows a multiple of the warps)."""
    layout = BOUNDS_GRANULES if sx == 1 and (h == 1 or sy >= w) else BOUNDS_BYTES
    units = (w + 30) // 16 if layout == BOUNDS_GRANULES else w  # granules a row spans, at most
    segs = -(-units // 32)
    warps = TIGHT_BOUNDS_WARPS
    a_round = warps * max(1, TIGHT_BOUNDS_LOADS // segs)  # a block's rows in one round
    if h <= a_round:
        return BoundsRoute(BOUNDS_ONE, layout, segs, h, 1)
    rows = warps * -(-h // (warps * min(-(-h // a_round), TIGHT_BOUNDS_MAX_BLOCKS)))
    return BoundsRoute(BOUNDS_TICKET, layout, segs, rows, -(-h // rows))


class BoundsWord(NamedTuple):
    """A pinned int32 (4,) host tensor that tight_bounds writes through
    `address`, its mapped device address."""

    host: torch.Tensor
    address: int


_bounds_words: Dict[tuple, BoundsWord] = {}


def bounds_word(device) -> BoundsWord:
    """The pinned host word of the CUDA `device`'s current stream and the
    calling thread, made on first use: tight_bounds writes its result
    there, so that the caller reads it after a stream synchronize, with no
    copy issued."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream, threading.get_ident())
    word = _bounds_words.get(key)
    if word is None:
        host = torch.zeros(4, dtype=torch.int32, pin_memory=True)
        address = ctypes.c_void_p()
        with torch.cuda.device(device):
            _raise_on("mapped_pointer", load()["mapped_pointer"](host.data_ptr(), ctypes.byref(address)))
        word = _bounds_words[key] = BoundsWord(host, address.value)
    return word


def _check_bool_plane(what: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA device, got {t.device}")
    if t.dtype != torch.bool or t.dim() != 2 or not (0 < t.shape[0] < 2**31 and 0 < t.shape[1] < 2**31):
        raise ValueError(f"{what}: need a non-empty bool (h, w) mask, got {t.dtype} {tuple(t.shape)}")
    return t.device


def tight_bounds(mask: torch.Tensor, word: Optional[BoundsWord] = None) -> torch.Tensor:
    """Launch ``tight_bounds`` (TB1) on the route tight_bounds_route gives:
    the int32 (4,) (x0, y0, x1, y1) of the set cells of the bool (h, w)
    `mask` (any strides), (w, h, -1, -1) where there is none.  Without
    `word` a new tensor on the card, which the caller reads back; with a
    BoundsWord (bounds_word) the kernel writes its pinned host tensor,
    returned, which holds the result once the stream has reached it.  The
    plain version is raster/region.py _tight_bounds_torch."""
    device = _check_bool_plane("tight_bounds", mask)
    h, w = mask.shape
    sy, sx = mask.stride()
    route = tight_bounds_route(h, w, sy, sx)
    if route.layout == BOUNDS_GRANULES and h == 1:
        sy = w  # the kernel takes a byte's row from its offset over sy
    fns = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch = None
    if route.route == BOUNDS_TICKET:
        scratch = _bounds_scratch.get((device, stream))
        if scratch is None:
            scratch = _bounds_scratch[device, stream] = torch.zeros(4 * TIGHT_BOUNDS_MAX_BLOCKS + 4, dtype=torch.int32,
                                                                    device=device)
    out = torch.empty(4, dtype=torch.int32, device=device) if word is None else word.host
    geom = _as_i64([h, w, sy, sx, route.layout, route.route, route.segs, route.rows, route.blocks])
    with torch.cuda.device(device):
        rc = fns["tight_bounds"](ctypes.addressof(geom), mask.data_ptr(),
                                 None if scratch is None else scratch.data_ptr(),
                                 out.data_ptr() if word is None else word.address, stream)
    _raise_on("tight_bounds", rc)
    launches["tight_bounds"] += 1
    return out


def box_morph_geometry(h: int, w: int, rx: int, ry: int, erode: bool) -> tuple:
    """((H, W) of box_morph's output, (dx0, dx1, dy0, dy1): the window of
    output cell (Y, X) in source rows [Y + dy0, Y + dy1] and columns [X +
    dx0, X + dx1]) for an h x w mask: bloat's output is nbox's, (h + 2ry, w
    + 2rx), whose cell (Y, X) lies at source (Y - ry, X - rx); erode's the
    mask's own.  Raises ValueError where the output is past 2^31 - 1 rows
    or columns."""
    if rx < 0 or ry < 0:
        raise ValueError(f"box_morph: radii ({rx}, {ry}) must be at least 0")
    H, W = (h, w) if erode else (h + 2 * ry, w + 2 * rx)
    if not (0 < W < 2**31 and 0 < H < 2**31):
        raise ValueError(f"box_morph: a {H}x{W} output is beyond the kernel's grid")
    return (H, W), ((-rx, rx, -ry, ry) if erode else (-2 * rx, 0, -2 * ry, 0))


class MorphRoute(NamedTuple):
    """How box_morph runs at a shape: `launches` 1 (the staged route: a
    block stages its 32 x 128 tile's reach and writes the tile) or 2 (a row
    pass of the same kernel over `tile_rows` source rows a block into a bit
    plane, then the column pass); the staged launch's source rows a block
    at most (`rows`), words a staged row (`words`) and dynamic shared memory
    in bytes (`smem`)."""

    launches: int
    tile_rows: int
    rows: int
    words: int
    smem: int


def _morph_smem(rows: int, words: int) -> int:
    """region_ops.cu box_morph_kernel's shared memory: the staged bits and
    their prefix counts, the row pass's 4 words a staged row, the tile's 32
    x 4 output words."""
    return 4 * (2 * rows * words + MORPH_TILE[1] // 32 * (rows + MORPH_TILE[0]))


def box_morph_route(h: int, w: int, rx: int, ry: int, erode: bool) -> MorphRoute:
    """box_morph's route for an h x w mask at radii (rx, ry), from the shape
    alone: the staged route where a tile's reach (its rows and columns
    clipped to the mask) fits MORPH_SMEM bytes, else the second route, its
    row pass over 32 source rows a block, or one where 32 rows' reach is
    past MORPH_SMEM_MAX.  Raises ValueError where one row's is (a mask over
    about 900,000 columns wide at rx over about 450,000), or on the
    geometry's refusals."""
    (H, W), (dx0, dx1, dy0, dy1) = box_morph_geometry(h, w, rx, ry, erode)
    words = -(-(min(MORPH_TILE[1] + dx1 - dx0, w) + 31) // 32) + 1
    rows = min(MORPH_TILE[0] + dy1 - dy0, h)
    if _morph_smem(rows, words) <= MORPH_SMEM:
        return MorphRoute(1, MORPH_TILE[0], rows, words, _morph_smem(rows, words))
    for tile_rows in (MORPH_TILE[0], 1):
        rows = min(tile_rows, h)
        if _morph_smem(rows, words) <= MORPH_SMEM_MAX:
            return MorphRoute(2, tile_rows, rows, words, _morph_smem(rows, words))
    raise ValueError(f"box_morph: a row's reach of {words} words at ({rx}, {ry}) is past a block's shared memory")


def box_morph(mask: torch.Tensor, rx: int, ry: int, erode: bool) -> torch.Tensor:
    """Launch ``box_morph`` (MR1) over the bool (h, w) `mask` (any strides):
    bloat (erode False) returns the (h + 2ry, w + 2rx) mask of cells whose
    (2rx+1) x (2ry+1) window holds a set cell of `mask` (placed at (ry,
    rx)); erode returns the (h, w) mask of cells whose window lies inside
    the plane and holds no unset cell.  Any radius: one launch on the
    staged route, two on the second (box_morph_route), each counted.  The
    plain versions are raster/region.py dilate_torch and erode_torch."""
    device = _check_bool_plane("box_morph", mask)
    h, w = mask.shape
    (H, W), (dx0, dx1, dy0, dy1) = box_morph_geometry(h, w, rx, ry, erode)
    route = box_morph_route(h, w, rx, ry, erode)
    sy, sx = mask.stride()
    vec = int(sx == 1 and sy % 4 == 0 and mask.data_ptr() % 4 == 0)
    out = torch.empty((H, W), dtype=torch.bool, device=device)
    fns = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    tiling = [vec, route.tile_rows, route.rows, route.words]
    with torch.cuda.device(device):
        if route.launches == 1:
            geom = _as_i64([h, w, sy, sx, H, W, dx0, dx1, dy0, dy1, int(erode), rx, ry, *tiling, 0])
            _raise_on("box_morph", fns["box_morph"](ctypes.addressof(geom), mask.data_ptr(), out.data_ptr(), None,
                                                    route.smem, stream))
            launches["box_morph"] += 1
            return out
        ww = -(-W // 32)
        words = torch.empty((h, ww), dtype=torch.int32, device=device)
        geom = _as_i64([h, w, sy, sx, h, W, dx0, dx1, 0, 0, int(erode), rx, ry, *tiling, ww])
        _raise_on("box_morph", fns["box_morph"](ctypes.addressof(geom), mask.data_ptr(), None, words.data_ptr(),
                                                route.smem, stream))
        launches["box_morph"] += 1
        scratch = torch.empty((H, ww), dtype=torch.int32, device=device)
        geom = _as_i64([h, w, sy, sx, H, W, dx0, dx1, dy0, dy1, int(erode), rx, ry, vec, 0, 0, 0, ww])
        _raise_on("box_morph", fns["box_morph_cols"](ctypes.addressof(geom), words.data_ptr(), scratch.data_ptr(),
                                                     out.data_ptr(), stream))
        launches["box_morph"] += 1
    return out


# convolve.cu's modes: the first design's passes and 2D pass, the staged route's one launch.
CONV_PASS_X, CONV_PASS_Y, CONV_FULL, CONV_STAGED = 0, 1, 2, 3
# The staged route's output tile (rows, columns) a block, and its shared
# memory at most: two blocks an SM (radius 22 and under).
CONV_TILE = (16, 64)
CONV_SMEM = 113 * 1024
CONV_ROW_TILES_MAX = 65535


def convolve_plan(kind: str, weights, total: int, radius: int) -> tuple:
    """(weights, total, clamp) of convolve_canvas for a kernel of `kind`
    ("full": (2r+1)^2 weights row by row; "xy": 2r+1 weights, an x pass and
    a y pass, each clamped; "unit": every weight 1, total 2r+1, two passes,
    no clamp); convolve_route gives the launches.  Raises ValueError on another kind,
    a radius under 1, another count of weights, or (as blur_blend) a weight
    outside [0, 2^31) or a total outside (0, 2^31)."""
    if radius < 1 or radius >= 2**15:
        raise ValueError(f"convolve_canvas: radius {radius} is outside [1, 2^15)")
    n = 2 * radius + 1
    if kind == "unit":
        weights, total = (1,) * n, n
    elif kind not in ("full", "xy"):
        raise ValueError(f"convolve_canvas: no kernel kind {kind!r}")
    weights = tuple(int(v) for v in weights)
    if len(weights) != (n * n if kind == "full" else n):
        raise ValueError(f"convolve_canvas: {len(weights)} weights for a {kind} kernel of radius {radius}")
    if not all(0 <= v < 2**31 for v in weights):
        raise ValueError("convolve_canvas: need weights in [0, 2^31)")
    if not 0 < total < 2**31:
        raise ValueError(f"convolve_canvas: total {total} is outside (0, 2^31)")
    return weights, total, int(kind == "xy")


def convolve_staged_smem(radius: int) -> int:
    """convolve.cu's StagedLayout: the staged route's shared memory at
    `radius`, in bytes: the canvas tile and its halo (16 + 2r rows and a
    pad row, an odd pitch of at least 64 + 2r + 1 pixels; the x pass
    overwrites its tile columns), the weights, the mask bytes of the
    tile's columns, the copy's 8-byte barrier, and 128 bytes to align the
    tile for the tensor copy."""
    rows = CONV_TILE[0] + 2 * radius
    pitch = (CONV_TILE[1] + 2 * radius + 1) | 1
    bar = -(-(16 * (rows + 1) * pitch + 4 * (2 * radius + 1) + rows * CONV_TILE[1]) // 8) * 8
    return bar + 8 + 128


class ConvRoute(NamedTuple):
    """How convolve_canvas runs: `modes`, one launch each (CONV_STAGED
    alone, the first design's CONV_PASS_X then CONV_PASS_Y, or CONV_FULL),
    and the staged launch's dynamic shared memory (`smem`, else 0)."""

    modes: tuple
    smem: int

    @property
    def launches(self) -> int:
        return len(self.modes)


def convolve_route(kind: str, H: int, W: int, radius: int) -> ConvRoute:
    """convolve_canvas' route for an H x W canvas, from the shape, the kind
    and the radius alone: `full` one 2D launch; `xy` and `unit` the staged
    route's one launch where its shared memory fits CONV_SMEM and its row
    tiles the grid, else the two passes."""
    if kind == "full":
        return ConvRoute((CONV_FULL,), 0)
    smem = convolve_staged_smem(radius)
    if smem <= CONV_SMEM and -(-H // CONV_TILE[0]) <= CONV_ROW_TILES_MAX:
        return ConvRoute((CONV_STAGED,), smem)
    return ConvRoute((CONV_PASS_X, CONV_PASS_Y), 0)


def convolve_canvas(kind: str, weights, total: int, radius: int, canvas: torch.Tensor, mask: torch.Tensor):
    """Launch ``convolve_canvas`` (CV1) on convolve_route's route: the int32
    (H, W, 4) `canvas` (contiguous) convolved inside the top-left (H, W) of
    the bool `mask` (any strides), into a new plane; one launch on the
    staged route, else the x pass into a scratch plane and the y pass, or
    one 2D launch (`full`); each launch counted.  The plain version is
    raster/convolve.py convolve_canvas_torch."""
    weights, total, clamp = convolve_plan(kind, weights, total, radius)
    device = canvas.device
    if device.type != "cuda":
        raise ValueError(f"convolve_canvas needs tensors on a CUDA device, got {device}")
    if canvas.dim() != 3 or canvas.shape[2] != 4:
        raise ValueError(f"convolve_canvas: need an (H, W, 4) canvas, got shape {tuple(canvas.shape)}")
    _check("canvas", canvas, device)
    H, W = canvas.shape[:2]
    if not (0 < H < 2**31 and 0 < W < 2**31):
        raise ValueError(f"convolve_canvas: an empty or oversized {H}x{W} canvas")
    if mask.device != device or mask.dtype != torch.bool or mask.dim() != 2 or mask.shape[0] < H or mask.shape[1] < W:
        raise ValueError(f"convolve_canvas: need a bool mask of at least {(H, W)} on {device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    w, magic, shift = _weights_on(device, weights, total)
    src = canvas
    with torch.cuda.device(device):
        for mode in convolve_route(kind, H, W, radius).modes:
            dst = torch.empty_like(canvas)
            geom = _as_i64([H, W, *mask.stride(), radius, mode, clamp, magic, shift])
            rc = load()["convolve_canvas"](ctypes.addressof(geom), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
                                           w.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
            _raise_on("convolve_canvas", rc)
            launches["convolve_canvas"] += 1
            src = dst
    return src


def launch_floor(device) -> None:
    """Launch ``launch_floor``, an empty kernel, on the current stream of
    the CUDA `device`: the least time a launch through this module takes,
    beside which each kernel's time is read.  Not counted in `launches`: it
    does none of the program's work."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor needs a CUDA device, got {device}")
    with torch.cuda.device(device):
        rc = load()["launch_floor"](torch.cuda.current_stream(device).cuda_stream)
    _raise_on("launch_floor", rc)
