"""Zarr v2 arrays on a key-value store (a ``{key: bytes}`` dict, as
:func:`.ocdbt.read_store` returns and :func:`.ocdbt.write_store` takes).

An array ``name`` is ``name/.zarray`` (JSON: dtype, shape, chunks, order,
compressor, fill value, filters) and one value a chunk, keyed by the chunk's
grid index joined by the dimension separator (``name/0.0``; ``name/0`` for a
0-d array).  :func:`read_array` reads compressor ``zstd`` or none, C or F
order, and fills missing chunks with the fill value; filters, other
compressors and dtypes numpy cannot hold without extensions (``bfloat16``)
are refused by name.  :func:`array_items` writes one chunk per array with the
metadata that orbax gives it (``{"id": "zstd", "level": 1}``, ``"."``, C
order), the chunk a zstd frame of raw blocks.
"""

from __future__ import annotations

import itertools
import json
from typing import Dict

import numpy as np

from . import zstd

_ORBAX_COMPRESSOR = {"id": "zstd", "level": 1}


class ZarrError(ValueError):
    """An array this reader does not read."""


def _fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(value, value)
    return value


def read_array(store: Dict[bytes, bytes], name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    key = f"{name}/.zarray".encode()
    if key not in store:
        raise ZarrError(f"no zarr array {name!r} ({key.decode()} missing)")
    meta = json.loads(store[key])
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise ZarrError(f"{name}: filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ZarrError(f"{name}: compressor {comp.get('id')!r} (only zstd or none is read)")
    if not isinstance(meta["dtype"], str) or meta["dtype"] == "bfloat16":
        raise ZarrError(f"{name}: dtype {meta['dtype']!r} is not read")
    dtype = np.dtype(meta["dtype"])
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ZarrError(f"{name}: order {order!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype), dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if ckey not in store:
            continue
        raw = store[ckey]
        if comp is not None:
            raw = zstd.decompress(raw)
        want = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
        if len(raw) != want:
            raise ZarrError(f"{ckey.decode()}: {len(raw)} bytes, a chunk holds {want}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def array_items(name: str, array) -> Dict[bytes, bytes]:
    """The store values of ``array`` as the zarr v2 array ``name``: its
    metadata and one chunk."""
    arr = np.asarray(array)
    arr = np.asarray(arr, dtype=arr.dtype.newbyteorder("<"), order="C")  # 0-d stays 0-d
    meta = {"chunks": [max(d, 1) for d in arr.shape], "compressor": _ORBAX_COMPRESSOR,
            "dimension_separator": ".", "dtype": arr.dtype.str, "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    out = {f"{name}/.zarray".encode(): json.dumps(meta, sort_keys=True,
                                                   separators=(",", ":")).encode()}
    if arr.size:
        ckey = ".".join("0" for _ in arr.shape) or "0"
        out[f"{name}/{ckey}".encode()] = zstd.compress_raw(arr.tobytes())
    return out
