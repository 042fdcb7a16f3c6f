#!/usr/bin/env python3
"""Profile the port's PDF path on one CUDA card: where page 3 of
``chip_smoke.py``'s document (over 2,000 glyphs of text) spends its time,
and what the AES-256 copy costs.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 profile_pdf.py [--out build/profile_pdf]

It builds ``chip_smoke.pdf_document`` at 1920 x 1080 and times, on the
host clock after ``torch.cuda.synchronize()``: writing the file, reading
it, ``graphic_of_page`` of page 3 (the content stream), ``scene_of_graphic``
(fonts, glyph outlines, sub-scenes) and ``render_simple_scene`` over the
page (cold cache); then the same file sealed with AES-256 (R6) written and
read back.  Under --out it writes:

  * page3_cprofile.txt: cProfile of one more conversion and render;
  * page3_profile.txt: a ``torch.profiler`` window of one more render: the
    device time of its kernels and copies (device rows only) and the table.

It prints, last, one JSON line with those seconds, the device time and
busy share of the profiled render, its launches and copies, and the
card's name and power limit.  The profiler slows the host, so the
unprofiled lines are the times and the window gives counts and shares.
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_pdf", help="directory for the profile files")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_pdf: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from profile_general import device_rows, launch_calls

    from coherence_tpu_torch.io import pdf as P
    from coherence_tpu_torch.io import pdfgraphics as PG
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache, pdfscene
    from coherence_tpu_torch.scene import render as R

    os.makedirs(args.out, exist_ok=True)
    dev, (w, h) = "cuda", (chip_smoke.W, chip_smoke.H)
    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    stats = {}
    doc = P.Pdf(*chip_smoke.pdf_document(P, w, h, stats=stats))
    data = timed("write", lambda: P.pdf_to_bytes(doc))
    pdf = timed("read", lambda: P.pdf_of_bytes(data))
    page = pdf.pages()[2]
    graphic = timed("graphic_of_page", lambda: PG.graphic_of_page(pdf, page))
    box = (1, 1, w, h)

    def convert():
        return list(reversed(pdfscene.scene_of_graphic(pdf, graphic, dev)))

    def render(scene):
        return R.render_simple_scene(scene, region.shape_of_box(box, dev), dev)

    cache.clear()
    scene = timed("scene_of_graphic", convert)
    cache.clear()
    syncs0 = region.syncs
    timed("render", lambda: render(scene))
    syncs = region.syncs - syncs0

    cache.clear()
    prof = cProfile.Profile()
    prof.enable()
    render(convert())
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(40)
    with open(os.path.join(args.out, "page3_cprofile.txt"), "w") as f:
        f.write(text.getvalue())

    cache.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        t0 = time.perf_counter()
        render(scene)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    rows = device_rows(tp)
    device_s = sum(e.self_device_time_total for e in rows) / 1e6
    with open(os.path.join(args.out, "page3_profile.txt"), "w") as f:
        f.write(f"device s {device_s} in a {window_s} s window\n")
        f.write(tp.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    cache.clear()

    sealed = timed("seal_aes256", lambda: P.pdf_to_bytes(doc, modern=True, encrypt={"revision": 6, "owner_pw": b"o"}))
    timed("open_aes256", lambda: P.pdf_of_bytes(sealed))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"page": [w, h], "glyphs_painted": stats["glyphs"], "objects": len(scene), "seconds": seconds,
                      "render_syncs": syncs, "profiled_render": {"window_s": window_s, "device_s": device_s,
                                                                 "busy_share": device_s / window_s,
                                                                 "launches_and_copies": launch_calls(tp)},
                      "file_bytes": len(data), "sealed_bytes": len(sealed),
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
