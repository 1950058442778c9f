"""How fast the port reads an orbax checkpoint directory.

    python -m <package>.ckpt_format.rate DIR [DIR ...]

For each directory: its files' bytes, the seconds to read the OCDBT store
(manifest, B-tree nodes, values), then every zarr chunk's zstd frame decoded
on its own: the compressed and decoded bytes, the seconds and the decode
rate in MB/s of decoded bytes.  One JSON line a directory.  Host only: numpy
and the standard library.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict

from . import ocdbt, zstd


def measure(path: str) -> Dict[str, float]:
    file_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(path) for f in files)
    t = time.perf_counter()
    store = ocdbt.read_store(path)
    store_s = time.perf_counter() - t
    frames = []
    for key, value in store.items():
        if key.endswith(b"/.zarray"):
            compressor = json.loads(value).get("compressor")
            if compressor and compressor.get("id") == "zstd":
                prefix = key[:-len(b".zarray")]
                frames += [v for k, v in store.items()
                           if k.startswith(prefix) and not k.endswith(b"/.zarray")]
    t = time.perf_counter()
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    decode_s = time.perf_counter() - t
    return {"path": path, "file_bytes": file_bytes, "keys": len(store), "store_s": store_s,
            "chunks": len(frames), "compressed_bytes": sum(map(len, frames)),
            "decoded_bytes": decoded, "decode_s": decode_s,
            "decode_mb_s": decoded / decode_s / 1e6 if decode_s > 0 else float("inf")}


def main(argv=None) -> int:
    for path in (argv if argv is not None else sys.argv[1:]):
        print(json.dumps(measure(path)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
