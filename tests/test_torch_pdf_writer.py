"""The port's PDF writer, encryption and debug pages against the JAX
package's: the same bytes for the same ``Pdf`` and the same random source
(classic and modern cross-references, and ``encrypt=`` at revisions 2-6);
each package reads the other's encrypted files to the same objects; the
same ``page_of_graphic`` and ``transform_graphic`` results for every PDF in
assets/ and for chip_smoke.py's document; the same debug-PDF bytes for
test_utils.py's two scenarios; and the port's ``utils.trace``.

Each side builds its own objects from the same numbers; bytes and
canonical trees (``_torch_pdf.canon``) are compared, tolerance 0.
"""

import glob
import os
import sys
import types

import pytest

from coherence_tpu import colour as j_C
from coherence_tpu import ident as j_ident
from coherence_tpu import transform as j_tr
from coherence_tpu.geometry import shapes as j_gshapes
from coherence_tpu.io import pdf as JP
from coherence_tpu.io import pdfcrypt as JPC
from coherence_tpu.io import pdfgraphics as JPG
from coherence_tpu.raster import fills as j_fills
from coherence_tpu.raster import region as j_region
from coherence_tpu.scene import cache as j_cache
from coherence_tpu.scene import filters as j_filters
from coherence_tpu.scene import render as j_R
from coherence_tpu import utils as j_utils

from coherence_tpu_torch import colour as t_C
from coherence_tpu_torch import ident as t_ident
from coherence_tpu_torch import transform as t_tr
from coherence_tpu_torch import utils as t_utils
from coherence_tpu_torch.geometry import shapes as t_gshapes
from coherence_tpu_torch.io import pdf as TP
from coherence_tpu_torch.io import pdfcrypt as TPC
from coherence_tpu_torch.io import pdfgraphics as TPG
from coherence_tpu_torch.raster import fills as t_fills
from coherence_tpu_torch.raster import region as t_region
from coherence_tpu_torch.scene import cache as t_cache
from coherence_tpu_torch.scene import filters as t_filters
from coherence_tpu_torch.scene import pdfscene as TS
from coherence_tpu_torch.scene import render as t_R

from _torch_general import PORT, both_sides, same_raster  # noqa: F401
from _torch_pdf import canon, page_results
from _torch_threads import one_torch_thread  # noqa: F401
from test_pdf_encrypted import _BINARY, _DetRand

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ASSETS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "assets", "*.pdf")))
CONTENT = b"1 0 0 rg 10 10 50 50 re f"


def sample(P):
    """test_pdf_encrypted.py's sample: a page, and an /Info dictionary of
    strings with every byte value and the escapes."""
    pdf = P.mkpage(CONTENT, mediabox=(0, 0, 100, 100))
    pdf.objects[5] = {"Title": b"Top (Secret) Title", "Blob": _BINARY}
    pdf.trailer["Info"] = P.Ref(5)
    return pdf


def smoke_document(P):
    import chip_smoke

    return P.Pdf(*chip_smoke.pdf_document(P, 480, 270, image_wh=(64, 48)))


DOCUMENTS = {"sample": sample, "chip_smoke": smoke_document}
# R6's key derivation (Algorithm 2.B, pure Python) takes seconds a call, so
# it is written with the modern cross-reference only, as pdf_pages seals.
WRITES = [("classic", None), ("modern", None)] + [
    (layout, revision) for revision in (2, 3, 4, 5) for layout in ("classic", "modern")] + [("modern", 6)]
# The sample in every layout and revision; chip_smoke.py's document plain
# and as its pdf_pages phase seals it.
CASES = [("sample",) + w for w in WRITES] + [
    ("chip_smoke", "classic", None), ("chip_smoke", "modern", None), ("chip_smoke", "modern", 6)]
_written = {}


def written(P, doc: str, layout: str, revision):
    """The bytes of document `doc` built and written by the pdf module P
    (the random source seeded by the revision), memoised per side."""
    key = (P.__name__, doc, layout, revision)
    if key not in _written:
        encrypt = None if revision is None else {
            "revision": revision, "user_pw": b"", "owner_pw": b"hunter2", "rand": _DetRand(revision)}
        _written[key] = P.pdf_to_bytes(DOCUMENTS[doc](P), modern=layout == "modern", encrypt=encrypt)
    return _written[key]


def read_back(P, data):
    """The objects and trailer a reader gives for `data`, canonical."""
    pdf = P.pdf_of_bytes(data)
    return canon(pdf.objects), canon(pdf.trailer)


@pytest.mark.parametrize("doc,layout,revision", CASES)
def test_written_bytes_match_jax(doc, layout, revision):
    a, b = written(JP, doc, layout, revision), written(TP, doc, layout, revision)
    assert a == b
    if revision is not None:
        assert b"Encrypt" in b and b"Secret" not in b


@pytest.mark.parametrize("layout,revision", [w for w in WRITES if w[1] is not None])
def test_each_package_reads_the_others_encrypted_file(layout, revision):
    """The port's reader on the JAX package's file and the reverse: the
    same decrypted objects as each reader on its own file, and the
    plaintext the sample was built from."""
    j_file, t_file = written(JP, "sample", layout, revision), written(TP, "sample", layout, revision)
    got = {(r.__name__, w): read_back(r, f) for r in (JP, TP) for w, f in (("jax", j_file), ("port", t_file))}
    assert len({repr(v) for v in got.values()}) == 1
    pdf = TP.pdf_of_bytes(j_file)
    assert pdf.page_content(pdf.pages()[0]) == CONTENT
    assert pdf.resolve(pdf.trailer["Info"])["Blob"] == _BINARY


def test_encrypted_document_renders_its_pages_as_the_plain_one(both_sides):
    """chip_smoke.py's document, AES-256 (R6) with a modern xref: the port
    reads the same page contents from it as from the plain file, and
    renders the same scenes and sprites (the trees differ only in the
    streams' /Length, which AES pads)."""
    plain, sealed = written(TP, "chip_smoke", "classic", None), written(TP, "chip_smoke", "modern", 6)
    a, b = TP.pdf_of_bytes(plain), TP.pdf_of_bytes(sealed)
    assert len(b.pages()) == 3
    assert [b.page_content(p) for p in b.pages()] == [a.page_content(p) for p in a.pages()]
    got = [page_results(PORT, TP, TPG, TS, lambda _P, data=data: data) for data in (plain, sealed)]
    for pa, pb in zip(*got):
        assert pb[1] == pa[1] and same_raster(pa[2], pb[2])


@pytest.mark.parametrize("revision", [4, 5])
def test_owner_password_and_rewrite_match_jax(revision):
    """The handler opened with the owner password has the same key on both
    sides, and a decrypted file written without ``encrypt`` is plaintext
    (no /Encrypt)."""
    id0 = bytes(range(16))
    keys = []
    for PC in (JPC, TPC):
        enc, handler = PC.build_encryption(id0=id0, user_pw=b"u", owner_pw=b"ownerpw", revision=revision,
                                           rand=_DetRand(9))
        keys.append((handler.key, PC.StandardSecurityHandler(enc, id0, b"ownerpw").key))
    assert keys[0] == keys[1]
    out = TP.pdf_to_bytes(TP.pdf_of_bytes(written(TP, "sample", "classic", 4)))
    assert b"Encrypt" not in out and out == JP.pdf_to_bytes(JP.pdf_of_bytes(written(JP, "sample", "classic", 4)))


def _pages(P, PG, data_or_path):
    pdf = P.pdf_of_file(data_or_path) if isinstance(data_or_path, str) else P.pdf_of_bytes(data_or_path)
    return pdf, [PG.graphic_of_page(pdf, page) for page in pdf.pages()]


def _round_trip(P, PG, tr, source):
    """For each page: transform_graphic under a scale and a translation,
    and page_of_graphic of the transformed graphic with the source
    document, written and read back."""
    pdf, graphics = _pages(P, PG, source)
    out = []
    for g in graphics:
        moved = PG.transform_graphic([tr.Translate(3.5, -2.0), tr.Scale((0.0, 0.0), 0.5, 0.75)], g)
        page = PG.page_of_graphic(moved, mediabox=(0, 0, 480, 270), pdf=pdf)
        data = P.pdf_to_bytes(page)
        back = P.pdf_of_bytes(data)
        out.append((canon(moved.elements), data, canon(PG.graphic_of_page(back, back.pages()[0]).elements)))
    return out


@pytest.mark.parametrize("source", ASSETS + ["chip_smoke"])
def test_page_of_graphic_matches_jax(source):
    if source == "chip_smoke":
        a_src, b_src = written(JP, "chip_smoke", "classic", None), written(TP, "chip_smoke", "classic", None)
    else:
        a_src = b_src = os.path.join(ROOT, "assets", source)
    a, b = _round_trip(JP, JPG, j_tr, a_src), _round_trip(TP, TPG, t_tr, b_src)
    assert len(a) == len(b) and b
    for i, (pa, pb) in enumerate(zip(a, b)):
        assert pb[0] == pa[0], f"page {i}: transformed trees differ"
        assert pb[1] == pa[1], f"page {i}: written bytes differ"
        assert pb[2] == pa[2], f"page {i}: the re-read trees differ"


# --- debug pages ------------------------------------------------------------------


def _debug_sprites(U, region, fills, C, dev):
    U.clear_debug()
    spr = region.fillshape(region.shape_of_box((10, 10, 40, 30), *dev), fills.plain(C.blue))
    U.add_debug_sprite(spr)
    U.add_debug_shape(region.shape_of_box((50, 50, 70, 60), *dev), dx=5)
    U.write_debug_page("page one")


def _debug_filter(U, R, region, fills, C, gshapes, filters, ident, cache, dev):
    cache.clear()
    U.clear_debug()
    R.pdf_filter_debug_active = True
    try:
        below = R.Obj(ident.new_ids(), R.Basic(fills.plain(C.red), R.PathShape(gshapes.circle(30.0, 30.0, 10.0))),
                      (), R.OVER)
        mono = R.Obj(ident.new_ids(), filters.monochrome(R.Basic(fills.plain(C.white), R.rectangle(20, 20, 20, 20))),
                     (), R.OVER)
        R.render_simple_scene([mono, below], region.shape_of_box((1, 1, 60, 60), *dev), *dev)
    finally:
        R.pdf_filter_debug_active = False


def _debug_final(U, R, region, fills, C, gshapes, filters, ident, cache, dev):
    """render_scene's "Final result" page, with pdf_debug_active."""
    cache.clear()
    U.clear_debug()
    R.pdf_debug_active = True
    try:
        objs = [R.Obj(ident.new_ids(), R.Basic(fills.plain(c), R.PathShape(gshapes.circle(x, 30.0, 14.0))), (), R.OVER)
                for c, x in ((C.red, 20.0), (C.dissolve(C.blue, delta=128), 35.0))]
        R.render_simple_scene(objs, region.shape_of_box((1, 1, 60, 60), *dev), *dev)
    finally:
        R.pdf_debug_active = False


@pytest.mark.parametrize("scenario", ["sprites", "filter", "final"])
def test_debug_pdf_bytes_match_jax(scenario, tmp_path):
    """test_utils.py:70 (a sprite and a shape on a page), :92 (the filter
    page of render.ml:1117-1130) and render_scene's final-result page: the
    same file bytes; the port reads its file back with a page that images
    a fragment."""
    files = []
    for name, U, R, region, fills, C, gshapes, filters, ident, cache, dev in (
            ("jax", j_utils, j_R, j_region, j_fills, j_C, j_gshapes, j_filters, j_ident, j_cache, ()),
            ("port", t_utils, t_R, t_region, t_fills, t_C, t_gshapes, t_filters, t_ident, t_cache, ("cpu",))):
        if scenario == "sprites":
            _debug_sprites(U, region, fills, C, dev)
        else:
            (_debug_filter if scenario == "filter" else _debug_final)(
                U, R, region, fills, C, gshapes, filters, ident, cache, dev)
        path = str(tmp_path / f"{name}.pdf")
        U.write_debug_pdf(path)
        cache.clear()
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    pdf = TP.pdf_of_file(str(tmp_path / "port.pdf"))
    assert pdf.pages() and any(b"Do" in pdf.page_content(p) for p in pdf.pages())


def test_debug_fragment_is_one_readback():
    """A sprite fragment reads its colour and coverage back in one host
    copy; a shape fragment in one."""
    t_utils.clear_debug()
    spr = t_region.fillshape(t_region.shape_of_box((3, 3, 9, 7), "cpu"), t_fills.plain(t_C.green))
    before = t_region.syncs
    t_utils.add_debug_sprite(spr)
    t_utils.add_debug_shape(t_region.shape_of_box((1, 1, 4, 4), "cpu"))
    assert t_region.syncs - before == 2
    t_utils.clear_debug()


def test_utils_export_the_jax_names_and_trace(tmp_path):
    """The two packages' utils export the same names; the port's trace
    records a torch.profiler trace file into log_dir."""
    import torch

    def exported(U):
        return sorted(n for n in dir(U) if not n.startswith("_") and not isinstance(getattr(U, n), types.ModuleType))

    assert exported(t_utils) == exported(j_utils) and "trace" in exported(t_utils)
    assert isinstance(t_utils.flags, types.ModuleType)
    with t_utils.trace(str(tmp_path / "trace")):
        torch.ones(64).add_(1)
    assert glob.glob(str(tmp_path / "trace" / "*.json"))
