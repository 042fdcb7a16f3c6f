"""Fixed-point subpixel coordinate system (parity: reference ``coord.ml``).

The port's copy of ``coherence_tpu.coord``, trimmed to what the port uses:
32 subpixel bins per pixel; subpixel bins never straddle pixel bins, so all
boundary decisions happen on ingress (``coord.ml:3-12``).
"""

from __future__ import annotations

import math

import numpy as np

# Number of subpixel bins per pixel bin; must be a power of two (coord.ml:23).
ipspacing = 32
halfips = ipspacing // 2

ipspacing_fl = float(ipspacing)
halfips_fl = float(halfips)


def pix_of_sub(n: int) -> int:
    """Pixel bin containing subpixel bin n (coord.ml:44): ceil(n / 32).

    OCaml ``(n + ipspacing - 1) / ipspacing`` truncates toward zero, which for
    negative n is NOT floor division; we reproduce that exactly.
    """
    v = n + ipspacing - 1
    return -((-v) // ipspacing) if v < 0 else v // ipspacing


def sub_of_float(f: float) -> int:
    """Subpixel bin containing float f (coord.ml:47): toint(ceil(f*32 - 16)).

    OCaml ``int_of_float`` truncates toward zero; after ``ceil`` the value is
    integral so truncation direction is irrelevant.
    """
    return int(math.ceil(f * ipspacing_fl - halfips_fl))


def pix_of_float(f: float) -> int:
    return pix_of_sub(sub_of_float(f))


def sub_of_float_np(f: np.ndarray) -> np.ndarray:
    return np.ceil(np.asarray(f, dtype=np.float64) * ipspacing_fl - halfips_fl).astype(
        np.int64
    )


def pix_of_sub_np(n: np.ndarray) -> np.ndarray:
    v = np.asarray(n, dtype=np.int64) + (ipspacing - 1)
    # OCaml division truncates toward zero.
    return (np.sign(v) * (np.abs(v) // ipspacing)).astype(np.int64)
