#!/usr/bin/env python3
"""blur_blend (B1) at the shapes the program gives it, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 profile_blur.py [--against DIR ...]

The shapes are those ``chip_smoke.py`` times (``animated_kernels``,
``blur_rect_row``): the window of the lion's first animated step (bench.py
at 1920x1080, radius 5) over FilteredDisplay's packed content, the same
window over FrameBuffer's unpacked content, the window of config 5's first
step (3840x2160, radius 4), and rect mode over the lion's whole 1080p
frame; then, to show what holds the kernel, the lion's window launched over
one tile (its dirty box one pixel at the logical window's centre) and rect
mode at radii 1 and 8 and over an all-zero alpha (a copy of the frame
only).  For each it prints one JSON line: the launch's blocks, bit for bit
against the plain version, then CUDA events, median of 25 calls, cold L2,
each queued behind a device-side wait (``chip_smoke.event_ms``), beside its
bound (``chip_smoke.blur_bound``).  With ``--against DIR`` (repeatable)
the wrapper of the checkout at DIR (its ``kernels`` module loaded beside
this one, its library built in its own ``build/``) is held to the plain
version too and timed in turns with this one on the same inputs (DIR's,
this, this, DIR's; with several, each in the order given, this twice, then
back; ``chip_smoke.in_turns``), as ``<DIR's name>_ms``.  Then the launch floor (an empty kernel
through this checkout's ctypes path, timed the same way), the ptxas lines
of blur_blend.cu's kernels from this checkout's build, and last the card's
name and power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import chip_smoke as cs


def shapes(torch, dev):
    """name -> (content, content_at, f_alpha, at, geometry, radius) of the
    lion's and config 5's first animated step and of the lion's full frame
    (content_at and at None: rect mode); then what holds the kernel: the
    lion's window launched over one tile (its dirty box one pixel), and
    rect mode at radii 1 and 8 and with an all-zero alpha (a copy only)."""
    from coherence_tpu_torch.raster import convolve
    from coherence_tpu_torch.raster.compositor import unpack_rgba

    out = {}
    for name, (view, disp, key, *_), step in (("lion", cs.build_scene(dev), cs.delta(0)),
                                              ("config5", cs.build_interactive(dev), cs.delta4(0))):
        _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = disp.stage_animated(key, *step)[3]
        k = disp.kernel
        geometry = (hb, wb, ry0, rx0, h, w, d_box, k.values, k.total)
        out[f"{name}_window"] = (view.frame, (oy, ox), disp.f_alpha, (oy, ox), geometry, k.radius)
        if name == "lion":
            window = unpack_rgba(view.frame[oy : oy + hb, ox : ox + wb]).contiguous()
            out["lion_window_unpacked"] = (window, (0, 0), disp.f_alpha, (oy, ox), geometry, k.radius)
            out["lion_rect_1080p"] = (view.frame, None, disp.f_alpha, None, (k.values, k.total), k.radius)
            lion = view, disp, (oy, ox), geometry
    view, disp, at, (hb, wb, ry0, rx0, h, w, d_box, values, total) = lion
    centre = ((ry0 + h // 2, rx0 + w // 2) * 2)
    out["lion_window_one_tile"] = (view.frame, at, disp.f_alpha, at, (hb, wb, ry0, rx0, h, w, centre, values, total),
                                   disp.kernel.radius)
    for radius in (1, 8):
        k = convolve.mkgaussian(radius)
        out[f"lion_rect_1080p_r{radius}"] = (view.frame, None, disp.f_alpha, None, (k.values, k.total), radius)
    out["lion_rect_1080p_copy_only"] = (view.frame, None, torch.zeros_like(disp.f_alpha), None, (values, total),
                                        disp.kernel.radius)
    return out


def shape_row(torch, dev, scrub, mods, shape) -> dict:
    from coherence_tpu_torch.raster import framepath
    from coherence_tpu_torch.raster.compositor import unpack_rgba

    content, content_at, f_alpha, at, geometry, radius = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    height, width = f_alpha.shape
    if at is None:  # rect mode
        weights, total = geometry
        want = framepath.apply_blur_rect(unpack_rgba(content[:height, :width]), f_alpha, weights, total)
        calls = {who: (lambda m=m: m.blur_blend_rect(content, f_alpha, weights, total)) for who, m in mods.items()}
        outs = {who: call() for who, call in calls.items()}
        bound = cs.blur_bound(torch, f_alpha, content.shape[1], 0, 0, 0, 0, height, width, None, height, width,
                              radius, rect=True)
        blocks = {"this": -(-height // 16) * -(-width // 32), "whole_window_32x32": -(-height // 32) * -(-width // 32)}
    else:
        hb, wb, ry0, rx0, h, w, d_box, weights, total = geometry
        noise = torch.randint(0, 256, (height, width, 4), generator=gen, device=dev, dtype=torch.int32)
        want = framepath.blur_blend_into_torch(noise.clone(), content, content_at, f_alpha, at, hb, wb, ry0, rx0, h,
                                               w, d_box, weights, total)
        displays = {who: noise.clone() for who in mods}
        calls = {who: (lambda m=m, d=displays[who]: m.blur_blend_window(content, content_at, f_alpha, d, at, hb, wb,
                                                                         ry0, rx0, h, w, d_box, weights, total))
                 for who, m in mods.items()}
        outs = {who: call() for who, call in calls.items()}
        # blur_bound counts packed content: the unpacked window's row is timed beside the packed one's.
        bound = None if content.dim() == 3 else cs.blur_bound(torch, f_alpha, content.shape[1], *at, ry0, rx0, h, w,
                                                              d_box, hb, wb, radius)
        y0, x0, y1, x1 = mods["this"].blur_launch_rect(hb, wb, ry0, rx0, h, w, tuple(int(v) for v in d_box), radius)
        blocks = {"rect": [y0, x0, y1, x1], "this": -(-(y1 - y0) // 16) * -(-(x1 - x0) // 32),
                  "whole_window_32x32": -(-hb // 32) * -(-wb // 32)}
    torch.cuda.synchronize()
    for who, got in outs.items():
        cs.require(torch.equal(got, want), f"{who}'s blur_blend differs from the plain version")
    turns = cs.in_turns(torch, calls["this"], scrub, wait_ms=cs.ANIMATED_WAIT_MS,
                        **{who: call for who, call in calls.items() if who != "this"})
    row = {"equal_plain": True, "blocks": blocks, **turns}
    if bound is not None:
        row.update({k: bound[k] for k in ("window", "radius", "changed_pixels", "bytes", "operations", "bound_ms",
                                          "bound_by")})
        row["share"] = bound["bound_ms"] / turns["ms"]
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR", action="append", default=[],
                    help="also time the blur wrapper of the checkout at DIR, in turns (repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_blur: no CUDA device", file=sys.stderr)
        return 1
    from coherence_tpu_torch import kernels

    dev = "cuda"
    logs = {"this": kernels.build()}
    kernels.load()
    mods = {"this": kernels}
    for tree in args.against:
        name = os.path.basename(os.path.normpath(tree))
        spec = importlib.util.spec_from_file_location(
            f"{name}_kernels", os.path.join(tree, "coherence_tpu_torch", "kernels", "__init__.py"))
        against = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(against)
        logs[name] = against.build()
        against.load()
        mods[name] = against
    scrub = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB, past the 50 MB L2
    for name, shape in shapes(torch, dev).items():
        cs.emit({"shape": name, **shape_row(torch, dev, scrub, mods, shape)})
    floor_ms = cs.event_ms(torch, lambda: kernels.launch_floor(dev), scrub, wait_ms=cs.ANIMATED_WAIT_MS, queued=True)
    ptxas = {}
    for who, log in logs.items():
        function = ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln or "Function properties for" in ln:
                function = ln.split()[-1].strip("'") if "properties" in ln else ln.split("'")[1]
            elif ("registers" in ln or "spill" in ln) and "blur_blend_kernel" in function:
                ptxas.setdefault(who, []).append(f"{function[-30:]}: {ln.strip()}")
    print(json.dumps({"launch_floor_ms": floor_ms, "ptxas_blur_blend": ptxas, "retaken": cs.RETAKEN[0]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
