"""The port's readers and writers of an orbax checkpoint's file formats
(``ckpt_format/``), against the libraries that define them.

* zstd: the decoder against ``zstandard`` (imported here only, never by the
  port) on hypothesis-drawn inputs at levels 1, 3 and 19, with and without
  the content checksum, inputs past 128 KiB (several blocks) and float32
  arrays like a checkpoint's; the raw-block writer's frames decoded by
  ``zstandard``; a frame that needs a dictionary, a bad checksum and a
  reserved block type refused.
* CRC-32C against the known vectors (RFC 3720 B.4).
* OCDBT: the reader against tensorstore on a store that the JAX package's
  orbax save writes (its values held by reference in ``ocdbt.process_0/``)
  and on a B-tree of height > 0 (uncompressed and zstd nodes); the writer's
  store read by tensorstore; a bad CRC, a bad magic number and the numbered
  manifest refused.
* zarr v2: arrays tensorstore writes (several chunks, a missing chunk and its
  fill value, F order, no compressor) read bitwise; the writer's arrays read
  by tensorstore; filters, other compressors and bfloat16 refused by name.
* In a subprocess that blocks orbax, tensorstore, zstandard, jax, flax,
  optax and the JAX package: every ``ckpt_format`` module imports, and the
  port's orbax save and load round-trip a tree.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import tensorstore as ts
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
zstd = importlib.import_module(PORT + ".ckpt_format.zstd")
crc = importlib.import_module(PORT + ".ckpt_format.crc32c")
ocdbt = importlib.import_module(PORT + ".ckpt_format.ocdbt")
zarr2 = importlib.import_module(PORT + ".ckpt_format.zarr2")
jck = importlib.import_module(TPU + ".train.checkpoint")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# inputs with the repeats an LZ77 stage finds: runs, copies of earlier bytes
_chunks = st.one_of(st.binary(max_size=300),
                    st.tuples(st.binary(min_size=1, max_size=8), st.integers(1, 200))
                    .map(lambda t: t[0] * t[1]))
_data = st.lists(_chunks, max_size=12).map(b"".join)


def _zstd(data: bytes, level: int, checksum: bool) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)


@settings(max_examples=40, deadline=None)
@given(data=_data, level=st.sampled_from([1, 3, 19]), checksum=st.booleans())
def test_zstd_decodes_zstandard_frames(data, level, checksum):
    assert zstd.decompress(_zstd(data, level, checksum)) == data


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_zstd_decodes_several_blocks_and_checkpoint_arrays(level, checksum):
    rng = np.random.default_rng(level)
    text = open(os.path.join(ROOT, "ROADMAP.md"), "rb").read()[:60000] * 3  # past 128 KiB
    arrays = [rng.normal(size=50000).astype(np.float32),  # a kernel, float32
              np.zeros(40000, np.float32),  # fresh moments
              (rng.normal(size=30000) ** 2 * 1e-6).astype(np.float32)]  # second moments
    for data in [text] + [a.tobytes() for a in arrays]:
        assert zstd.decompress(_zstd(data, level, checksum)) == data
    frames = _zstd(b"first", level, checksum) + _zstd(text[:1000], level, checksum)
    assert zstd.decompress(frames) == b"first" + text[:1000]


@settings(max_examples=25, deadline=None)
@given(data=st.one_of(_data, st.integers(0, 300000).map(lambda n: os.urandom(n))))
def test_raw_block_frames_decode_in_zstandard(data):
    frame = zstd.compress_raw(data)
    assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(data) + 1) == data
    assert zstd.decompress(frame) == data


def test_zstd_refusals():
    # a frame header with a one-byte dictionary id (7), then an empty raw block
    with pytest.raises(zstd.ZstdError, match="dictionary 7"):
        zstd.decompress(bytes.fromhex("28b52ffd") + bytes([0x01, 0x58, 7]) + bytes([1, 0, 0]))
    frame = bytearray(_zstd(b"checksummed content" * 10, 3, True))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    with pytest.raises(zstd.ZstdError, match="reserved block"):
        zstd.decompress(bytes.fromhex("28b52ffd") + bytes([0x20, 0]) + bytes([7, 0, 0]))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"PK\x03\x04 not zstd")


def test_crc32c_known_vectors():
    assert crc.crc32c(b"123456789") == 0xE3069283
    assert crc.crc32c(bytes(32)) == 0x8A9136AA
    assert crc.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert crc.crc32c(bytes(range(32))) == 0x46DD794E
    assert crc.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C
    assert crc.crc32c(b"56789", crc.crc32c(b"1234")) == 0xE3069283


def _ts_kv(root, **spec):
    return ts.KvStore.open({"driver": "ocdbt", "base": "file://" + str(root), **spec}).result()


def _ts_items(root):
    kv = _ts_kv(root)
    return {k: kv.read(k).result().value for k in kv.list().result()}


@pytest.fixture(scope="module")
def jax_orbax(tmp_path_factory):
    """An orbax directory written by the JAX package's save: a small tree of
    float32, int32 and bool arrays, a large one held by reference, and an
    optax-like NamedTuple with an empty state."""
    import optax

    rng = np.random.default_rng(0)
    params = {"params": {"a": {"kernel": rng.normal(size=(40, 30)).astype(np.float32),
                               "bias": np.zeros(30, np.float32)},
                         "scan": rng.normal(size=(2, 5, 7)).astype(np.float64)}}
    opt_state = optax.ApplyIfFiniteState(np.asarray(1, np.int32), np.asarray(True),
                                         np.asarray(2, np.int32),
                                         (optax.EmptyState(), {"count": np.asarray(3, np.int32)}))
    root = tmp_path_factory.mktemp("jax")
    return jck.save_checkpoint(str(root), params, opt_state, 4, {"p": 0.5}, backend="orbax")


def test_ocdbt_reader_matches_tensorstore_on_an_orbax_store(jax_orbax):
    got = ocdbt.read_store(jax_orbax)
    assert got == _ts_items(jax_orbax) and len(got) > 10
    assert os.path.isdir(os.path.join(jax_orbax, "ocdbt.process_0"))


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 5}])
def test_ocdbt_reader_walks_interior_nodes(tmp_path, compression, monkeypatch):
    config = {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 20}
    if compression:
        config["compression"] = compression
    kv = _ts_kv(tmp_path, config=config)
    txn = ts.Transaction()
    rng = np.random.default_rng(1)
    for i in range(120):
        kv.with_transaction(txn)[f"params.layer_{i % 7}/w{i:03d}"] = rng.bytes(int(i * 3 % 50))
    txn.commit_async().result()
    heights = []
    walk = ocdbt._Store.walk

    def recording(self, ref, height, prefix, out):
        heights.append(height)
        return walk(self, ref, height, prefix, out)

    monkeypatch.setattr(ocdbt._Store, "walk", recording)
    got = ocdbt.read_store(str(tmp_path))
    assert got == _ts_items(tmp_path) and len(got) == 120
    assert max(heights) >= 2 and heights.count(0) > 5  # interior nodes above the leaves


def test_ocdbt_writer_is_read_by_tensorstore(tmp_path):
    rng = np.random.default_rng(2)
    items = {f"k{i:03d}/.zarray".encode(): rng.bytes(i * 11 % 1400) for i in range(80)}
    items[b"big"] = rng.bytes(200000)
    items[b""[:0] + b"empty"] = b""
    written = ocdbt.write_store(str(tmp_path), items)
    assert _ts_items(tmp_path) == items == ocdbt.read_store(str(tmp_path))
    assert written == sum(os.path.getsize(os.path.join(d, f))
                          for d, _, fs in os.walk(tmp_path) for f in fs)


def test_ocdbt_refusals(tmp_path):
    ocdbt.write_store(str(tmp_path / "a"), {b"x": b"1"})
    path = tmp_path / "a" / "manifest.ocdbt"
    blob = bytearray(path.read_bytes())
    blob[20] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(ocdbt.OcdbtError, match="CRC"):
        ocdbt.read_store(str(tmp_path / "a"))
    blob[20] ^= 0xFF
    blob[0] = 0x0D
    path.write_bytes(bytes(blob))
    with pytest.raises(ocdbt.OcdbtError, match="magic"):
        ocdbt.read_store(str(tmp_path / "a"))
    kv = _ts_kv(tmp_path / "n", config={"manifest_kind": "numbered"})
    kv.write("x", b"1").result()
    with pytest.raises(ocdbt.OcdbtError, match="numbered"):
        ocdbt.read_store(str(tmp_path / "n"))
    with pytest.raises(ocdbt.OcdbtError, match="no manifest"):
        ocdbt.read_store(str(tmp_path))


def _ts_zarr(root, name, metadata, array):
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": "file://" + str(root),
                                               "path": name},
                 "metadata": metadata, "create": True}).result()
    t.write(array).result()
    return t


def test_zarr_reader_matches_tensorstore(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(10, 7, 3)).astype(np.float32)
    _ts_zarr(tmp_path, "chunked", {"chunks": [4, 3, 3], "compressor": {"id": "zstd", "level": 3},
                                   "dtype": "<f4", "shape": [10, 7, 3]}, a)
    b = rng.integers(-5, 5, size=(6, 5)).astype(np.int64)
    _ts_zarr(tmp_path, "fortran", {"chunks": [4, 2], "compressor": None, "order": "F",
                                   "dtype": "<i8", "shape": [6, 5]}, b)
    sparse = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                    "base": "file://" + str(tmp_path),
                                                    "path": "sparse"},
                      "metadata": {"chunks": [2], "dtype": "<f8", "shape": [6],
                                   "fill_value": 1.5, "compressor": {"id": "zstd"}},
                      "create": True}).result()
    sparse[0:2].write(np.asarray([3.0, 4.0])).result()
    store = ocdbt.read_store(str(tmp_path))
    assert np.array_equal(zarr2.read_array(store, "chunked"), a)
    assert np.array_equal(zarr2.read_array(store, "fortran"), b)
    got = zarr2.read_array(store, "sparse")
    assert np.array_equal(got, sparse.read().result()) and got[-1] == 1.5


def test_zarr_writer_is_read_by_tensorstore(tmp_path):
    rng = np.random.default_rng(4)
    arrays = {"params.k": rng.normal(size=(3, 16, 8)).astype(np.float32),
              "opt.count": np.asarray(7, np.int32), "opt.last": np.asarray(False),
              "x64": rng.normal(size=(5,)), "empty": np.zeros((0, 3), np.float32)}
    items = {}
    for name, arr in arrays.items():
        items.update(zarr2.array_items(name, arr))
    meta = json.loads(items[b"params.k/.zarray"])
    assert meta["compressor"] == {"id": "zstd", "level": 1} and meta["chunks"] == [3, 16, 8]
    assert items[b"opt.count/.zarray"].startswith(b'{"chunks":[],"compressor":{"id":"zstd"')
    ocdbt.write_store(str(tmp_path), items)
    store = ocdbt.read_store(str(tmp_path))
    for name, arr in arrays.items():
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                   "base": "file://" + str(tmp_path),
                                                   "path": name}}).result()
        theirs, mine = t.read().result(), zarr2.read_array(store, name)
        assert theirs.dtype == mine.dtype == arr.dtype and np.array_equal(theirs, arr), name
        assert np.array_equal(mine, arr), name


@pytest.mark.parametrize("change, match", [
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, "blosc"),
    ({"dtype": "bfloat16"}, "bfloat16"),
    ({"zarr_format": 3}, "zarr_format 3"),
])
def test_zarr_refusals(change, match):
    items = zarr2.array_items("a", np.ones(3, np.float32))
    meta = json.loads(items[b"a/.zarray"])
    meta.update(change)
    items[b"a/.zarray"] = json.dumps(meta).encode()
    with pytest.raises(zarr2.ZarrError, match=match):
        zarr2.read_array(items, "a")


_BLOCKED = r"""
import importlib.abc, sys
BLOCK = ("orbax", "tensorstore", "zstandard", "jax", "jaxlib", "flax", "optax",
         "ml_dtypes", %r)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
P = %r
import importlib
for m in ("ckpt_format", "ckpt_format.zstd", "ckpt_format.crc32c", "ckpt_format.ocdbt",
          "ckpt_format.zarr2", "train.checkpoint", "train.trainer", "train.restore"):
    importlib.import_module(P + "." + m)
ck = importlib.import_module(P + ".train.checkpoint")
params = {"params": {"k": np.arange(6, dtype=np.float32).reshape(2, 3)}}
opt = ck.ApplyIfFiniteState(np.asarray(0, np.int32), np.asarray(True), np.asarray(0, np.int32),
                            (ck.EmptyState(), (ck.ScaleByAdamState(np.asarray(1, np.int32),
                                                                    params, params),
                                               ck.EmptyState(),
                                               ck.ScaleByScheduleState(np.asarray(1, np.int32)))))
path = ck.save_checkpoint(sys.argv[1], params, opt, 3, {"a": 1.0}, backend="orbax")
back = ck.load_checkpoint(path)
assert np.array_equal(back["params"]["params"]["k"], params["params"]["k"])
assert back["opt_state"]["inner_state"][0] is None and back["step_count"] == 3
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print("OK")
"""


def test_the_port_needs_none_of_the_checkpoint_libraries(tmp_path):
    code = _BLOCKED % (TPU, PORT)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-2000:]
