"""The fold kernel's layer table, packed on the host: no card needed.

``kernels.pack_layer_records`` lays out one 32-byte record per layer as
``fold_layers.cu`` reads it (two 64-bit pointers, then int32 hs, ws, dy,
dx), keeps the layers' order, and raises where a value does not fit the
kernel's 32-bit geometry.  The pointers here are those of CPU tensors,
plain integers as a CUDA tensor's are.
"""

import struct

import numpy as np
import pytest
import torch

from coherence_tpu_torch import kernels

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def test_a_record_is_the_kernel_s_32_bytes():
    rec = kernels.LAYER_RECORD
    assert rec.itemsize == 32
    assert [rec.fields[name][1] for name in ("rgba", "mask", "hs", "ws", "dy", "dx")] == [0, 8, 16, 20, 24, 28]


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 7), (2, 300)])
def test_fields_and_order_of_cpu_layers(seed, k):
    rng = np.random.default_rng(seed)
    records = []
    keep = []
    for _ in range(k):
        hs, ws = (int(v) for v in rng.integers(1, 40, 2))
        rgba, mask = torch.zeros((hs, ws, 4), dtype=torch.int32), torch.zeros((hs, ws), dtype=torch.bool)
        keep.append((rgba, mask))
        records.append((rgba.data_ptr(), mask.data_ptr(), hs, ws, int(rng.integers(-500, 500)),
                        int(rng.integers(-500, 500))))
    raw = kernels.pack_layer_records(records).tobytes()
    assert len(raw) == 32 * k
    assert [struct.unpack_from("<QQiiii", raw, 32 * i) for i in range(k)] == records


def test_values_at_the_limits_fit():
    records = [(0, 2**64 - 1, 0, 0, I32_MIN, I32_MAX),
               (16, 32, 1, 2**31 - 1, I32_MAX - 1, 0),
               (48, 64, 46340, 46340, I32_MIN, I32_MAX - 46340)]
    raw = kernels.pack_layer_records(records).tobytes()
    assert [struct.unpack_from("<QQiiii", raw, 32 * i) for i in range(3)] == records
    assert kernels.pack_layer_records([]).shape == (0,)


@pytest.mark.parametrize("bad", [
    (-16, 0, 4, 4, 0, 0),                  # a pointer below 0
    (0, 2**64, 4, 4, 0, 0),                # a pointer past 2^64
    (0, 0, -1, 4, 0, 0),                   # a negative height
    (0, 0, 2**16, 2**15, 0, 0),            # 2^31 pixels
    (0, 0, 4, 4, I32_MIN - 1, 0),          # dy below int32
    (0, 0, 4, 4, 0, I32_MAX + 1),          # dx past int32
    (0, 0, 4, 10, 0, I32_MAX - 9),         # dx + ws past int32
    (0, 0, 3, 4, I32_MAX - 2, 0),          # dy + hs past int32
    (0, 0, 2**31, 0, -8, 0),               # a height past int32 on a layer of no pixels
    (0, 0, 4, 4, 2**70, 0),                # dy past 64 bits
], ids=["pointer_negative", "pointer_64_bits", "height_negative", "pixels_2_31", "dy_low", "dx_high",
        "dx_plus_ws", "dy_plus_hs", "height_2_31_width_0", "dy_past_int64"])
def test_a_value_out_of_range_raises(bad):
    good = (0, 0, 4, 4, 0, 0)
    with pytest.raises(ValueError, match="layer 1"):
        kernels.pack_layer_records([good, bad])


def test_the_wrapper_raises_on_cpu_tensors():
    acc = torch.zeros((4, 4, 4), dtype=torch.int32)
    flag = torch.zeros((4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.fold_layers([], [], acc, flag, flag)


def test_the_first_layer_at_fault_is_named():
    """Faults of different kinds in layers 2 and 3: the error names layer 2
    and its own fault, whichever check would catch layer 3 first."""
    good = (0, 0, 4, 4, 0, 0)
    with pytest.raises(ValueError, match=r"layer 2: its box at \(0, 2147483645\)"):
        kernels.pack_layer_records([good, good, (0, 0, 4, 4, 0, I32_MAX - 2), (-16, 0, 4, 4, 0, 0)])
