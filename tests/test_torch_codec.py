"""lynsedb_tpu_torch.storage._msgpack against msgpack itself.

The port writes its WAL, id map and field store through a pure-Python codec
so that it needs no msgpack package; a root directory written by either
package must open in the other. Tolerance: none — packed bytes are identical
to ``msgpack.packb(obj, use_bin_type=True)`` and unpacking agrees with
``msgpack.unpackb(data, raw=False, strict_map_key=False)``.
"""

from __future__ import annotations

import msgpack
import numpy as np
import pytest

from lynsedb_tpu_torch.storage import _msgpack

SCALARS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
    0.0, -0.0, 1.5, -2.25e300, float("inf"), float("-inf"),
    "", "a", "a" * 31, "a" * 32, "é" * 100, "漢字" * 40000, b"", b"\x00" * 255, b"x" * 256,
    b"y" * 70000,
]


def _rng_payloads():
    rng = np.random.default_rng(0)
    vec = rng.normal(size=(7, 5)).astype(np.float32)
    fields = [{"bucket": i % 10, "name": f"doc-{i}", "score": float(i) / 3, "tags": ["a", "b"],
               "ok": i % 2 == 0, "none": None} for i in range(20)]
    return {
        # the shapes wal.py, idmap.py and field_store.py write
        "wal_add": {"iids": list(range(1000, 1007)), "dim": 5, "eids": [1, "x", 2**40, "é", 5, 6, 7],
                    "fields": fields[:7], "vec": vec.tobytes()},
        "wal_add_meta_only": {"iids": list(range(20)), "dim": 5, "eids": list(range(20)),
                              "fields": None},
        "wal_upsert": {"iids": [3, 1], "vec": vec[:2].tobytes(), "dim": 5, "fields": [None, {"a": 1}]},
        "wal_delete": {"iids": list(range(0, 70000, 7))},
        "idmap_record": [0, "doc-7", 7],
        "idmap_range": [2, list(range(100, 20100)), 100],
        "idmap_snapshot": [[i, i] for i in range(20)] + [["s", 99]],
        "field_record": [12, fields[3]],
        "field_snapshot": fields + [None] * 3,
        "big_map": {str(i): i for i in range(70000)},
        "int_keys": {1: "a", -5: [1.0, None]},
    }


@pytest.mark.parametrize("value", SCALARS, ids=lambda v: repr(v)[:20])
def test_scalars_pack_identically(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value, use_bin_type=True) == packed
    ours = _msgpack.unpackb(packed, raw=False, strict_map_key=False)
    theirs = msgpack.unpackb(packed, raw=False, strict_map_key=False)
    assert type(ours) is type(theirs) and (ours == theirs or ours != ours)


@pytest.mark.parametrize("name", sorted(_rng_payloads()))
def test_storage_payloads_round_trip(name):
    value = _rng_payloads()[name]
    packed = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value, use_bin_type=True) == packed
    assert _msgpack.unpackb(packed, raw=False, strict_map_key=False) == msgpack.unpackb(
        packed, raw=False, strict_map_key=False)
    assert _msgpack.unpackb(_msgpack.packb(value), strict_map_key=False) == msgpack.unpackb(
        packed, raw=False, strict_map_key=False)


def test_rejects_what_msgpack_rejects():
    for bad in (np.int64(3), object(), {1, 2}):
        with pytest.raises(TypeError):
            _msgpack.packb(bad)
    with pytest.raises(OverflowError):
        _msgpack.packb(2**64)
    with pytest.raises(ValueError):
        _msgpack.unpackb(_msgpack.packb({1: 2}))  # int keys need strict_map_key=False
    with pytest.raises(ValueError):
        _msgpack.unpackb(_msgpack.packb([1, 2])[:-1])  # truncated
    with pytest.raises(ValueError):
        _msgpack.unpackb(b"\xc1")  # never used by msgpack
