"""The host modules of each side of a parity test: the JAX package's
``ident``, ``transform``, ``geometry.path`` and ``geometry.shapes``, and the
port's own copies of them.

A test builds the JAX side's objects from ``JAX`` and the port's from
``PORT``, from the same numbers, so that no object of one package reaches
the other.  Each side draws its ids from its own counter: compare ids only
within a side.
"""

from types import SimpleNamespace

from coherence_tpu import ident as j_ident
from coherence_tpu import transform as j_tr
from coherence_tpu.geometry import path as j_gpath
from coherence_tpu.geometry import shapes as j_gshapes

from coherence_tpu_torch import ident as t_ident
from coherence_tpu_torch import transform as t_tr
from coherence_tpu_torch.geometry import path as t_gpath
from coherence_tpu_torch.geometry import shapes as t_gshapes

JAX = SimpleNamespace(ident=j_ident, tr=j_tr, gpath=j_gpath, gshapes=j_gshapes)
PORT = SimpleNamespace(ident=t_ident, tr=t_tr, gpath=t_gpath, gshapes=t_gshapes)


def ops(host, spec):
    """A transform of `host` from a spec of (op name, *arguments) pairs,
    e.g. (("Translate", 1.0, 2.0), ("Scale", (0.0, 0.0), 2.0, 2.0))."""
    return tuple(getattr(host.tr, name)(*args) for name, *args in spec)
