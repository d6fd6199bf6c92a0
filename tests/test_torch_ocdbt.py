"""The port's OCDBT store (``seldon_tpu_torch/servers/ocdbt.py``) and
zarr v2 reader (``servers/zarr_v2.py``) against tensorstore.

``list`` and ``read`` equal tensorstore's on the committed JAX-written
fixtures (the merged top-level tree and the per-process tree) and on
stores tensorstore writes here: interior nodes (small
``max_decoded_node_bytes``), many generations (version-tree nodes),
uncompressed nodes with values both in the node and stored elsewhere,
a tree merged from a per-process store as orbax merges it, and a store
whose newest generation is empty. A flipped byte in a node or the
manifest raises, and so does a data-file path that leaves the store. The port's writer is read back by tensorstore, and a
tensorstore commit on top of it by the port. zarr arrays tensorstore
writes with a chunk grid (edge chunks, several chunks per axis) read
equal, whole and by columns; what the reader does not read is refused
by name."""

import json
import os
import shutil

import numpy as np
import pytest

from seldon_tpu_torch.servers import ocdbt, zarr_v2, zstd

ts = pytest.importorskip("tensorstore")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _write_store(root, values):
    w = ocdbt.StoreWriter(root)
    for key, value in values.items():
        w.put(key, value)
    w.commit()


def _ts_items(root):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    return {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}


def _write(root, config, commits, keys, size=50, delete=False):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    for c in range(commits):
        tx = ts.Transaction()
        for i in range(keys):
            kv.with_transaction(tx)[f"k{c % 3}/key{i:04d}"] = (
                bytes([(i + c) % 256]) * (size + i % 9))
        tx.commit_async().result()
    if delete:
        kv.delete_range(ts.KvStore.KeyRange()).result()


def _merged(root):
    """A per-process store under ``ocdbt.process_0`` with interior nodes,
    copied into a top-level store at ``root`` (orbax's merge)."""
    ctx = ts.Context({"cache_pool#ocdbt": {"total_bytes_limit": 1 << 26}})

    def spec(path, **kw):
        return dict({"driver": "ocdbt", "base": {"driver": "file",
                                                 "path": path},
                     "cache_pool": "cache_pool#ocdbt"}, **kw)

    child = ts.KvStore.open(spec(f"{root}/ocdbt.process_0", config={
        "max_decoded_node_bytes": 300, "max_inline_value_bytes": 40}),
        context=ctx).result()
    tx = ts.Transaction()
    for i in range(80):
        child.with_transaction(tx)[f"arr{i % 5}/c{i:03d}"] = (
            bytes([i]) * (20 + i))
    tx.commit_async().result()
    child = ts.KvStore.open(spec(f"{root}/ocdbt.process_0"),
                            context=ctx).result()
    parent = ts.KvStore.open(spec(root, config={
        "max_decoded_node_bytes": 300}), context=ctx).result()
    tx = ts.Transaction(atomic=True)
    child.experimental_copy_range_to(parent.with_transaction(tx)).result()
    tx.commit_async().result()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("ocdbt")
    out = {
        "fixture_bf16": os.path.join(DATA, "torch_orbax_tiny_bf16", "params"),
        "fixture_bf16_process": os.path.join(
            DATA, "torch_orbax_tiny_bf16", "params", "ocdbt.process_0"),
        "fixture_int8": os.path.join(DATA, "torch_orbax_tiny_int8", "params"),
    }
    made = {
        "interior": ({"max_decoded_node_bytes": 300,
                      "compression": {"id": "zstd"}}, 1, 60, 50),
        "generations": ({"compression": {"id": "zstd"}}, 40, 2, 50),
        # Values of 26-34 bytes across a 30-byte inline limit.
        "uncompressed_mixed": ({"compression": None,
                                "max_inline_value_bytes": 30,
                                "max_decoded_node_bytes": 200}, 3, 20, 26),
        "deleted": ({}, 2, 5, 50),
    }
    for name, (config, commits, keys, size) in made.items():
        root = str(base / name)
        _write(root, config, commits, keys, size, delete=name == "deleted")
        out[name] = root
    out["merged"] = str(base / "merged")
    _merged(out["merged"])
    return out


CASES = ["fixture_bf16", "fixture_bf16_process", "fixture_int8", "interior",
         "generations", "uncompressed_mixed", "deleted", "merged"]


@pytest.mark.parametrize("name", CASES)
def test_list_and_read_equal_tensorstore(stores, name):
    root = stores[name]
    want = _ts_items(root)
    r = ocdbt.OcdbtReader(root)
    assert r.list() == sorted(want)
    for k, v in want.items():
        assert r.read(k) == v, k
        assert r.view(k).tobytes() == v
    if name == "deleted":
        assert want == {} and r.generation >= 3
    else:
        assert want
    with pytest.raises(KeyError):
        r.read("no/such/key")


def test_tree_shapes_reached(stores):
    """The stores reach what they were made for: interior nodes, a
    version tree, values stored outside nodes, an uncompressed config."""
    heights = []
    orig = ocdbt.OcdbtReader._walk

    def walk(self, ref, height, prefix):
        heights.append(height)
        return orig(self, ref, height, prefix)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ocdbt.OcdbtReader, "_walk", walk)
        ocdbt.OcdbtReader(stores["interior"])
        assert max(heights) >= 2
        heights.clear()
        ocdbt.OcdbtReader(stores["merged"])
        assert max(heights) >= 1
    r = ocdbt.OcdbtReader(stores["generations"])
    assert r.generation > 16  # more than one version node's worth
    r = ocdbt.OcdbtReader(stores["uncompressed_mixed"])
    assert r.config["compression"] is None
    kinds = {v.inline is None for v in r._index.values()}
    assert kinds == {True, False}
    r = ocdbt.OcdbtReader(stores["fixture_bf16"])
    assert r.config["max_inline_value_bytes"] == 1024
    assert any(v.file is not None and v.file.base == "ocdbt.process_0/"
               for v in r._index.values())


def test_list_prefix(stores):
    r = ocdbt.OcdbtReader(stores["fixture_bf16"])
    assert r.list("blocks.wq/") == ["blocks.wq/.zarray", "blocks.wq/0.0.0"]
    assert r.list("embed") == ["embed/.zarray", "embed/0.0"]
    assert r.list("nothing") == []


def _node_files(root):
    out = []
    for d in (os.path.join(root, "d"),):
        for f in os.listdir(d):
            with open(os.path.join(d, f), "rb") as fh:
                if fh.read(4) == bytes.fromhex("0cdb20de"):
                    out.append(os.path.join(d, f))
    return out


@pytest.mark.parametrize("where", ["node", "manifest", "truncated"])
def test_flipped_byte_raises(tmp_path, where):
    root = str(tmp_path / "params")
    shutil.copytree(os.path.join(DATA, "torch_orbax_tiny_bf16", "params"),
                    root)
    path = (os.path.join(root, "manifest.ocdbt") if where != "node"
            else _node_files(root)[0])
    raw = bytearray(open(path, "rb").read())
    if where == "truncated":
        raw = raw[:-5]
    else:
        raw[len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError,
                       match="CRC-32C" if where != "truncated" else "states"):
        ocdbt.OcdbtReader(root)


def test_writer_read_by_tensorstore_and_back(tmp_path):
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, 3000, np.uint8).tobytes()
    want = {"a/.zarray": b"x" * 100, "a/0.0": rng.bytes(5000), "b/0": b"",
            "bb/1": big, "c": b"y" * 1024, "c2": b"z" * 1025}
    values = dict(want, **{"bb/1": (len(big), [big[:1000], big[1000:]])})
    root = str(tmp_path / "store")
    _write_store(root, values)
    assert _ts_items(root) == want
    r = ocdbt.OcdbtReader(root)
    assert {k: r.read(k) for k in r.list()} == want
    assert r.generation == 1
    # Out-of-line values (over 1024 bytes) each in their own data file.
    assert len(os.listdir(os.path.join(root, "d"))) == 4
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    tx = ts.Transaction()
    kv.with_transaction(tx)["c"] = b"new"
    kv.with_transaction(tx).delete_range(ts.KvStore.KeyRange("b/0", "b/1"))
    tx.commit_async().result()
    r = ocdbt.OcdbtReader(root)
    assert r.generation > 1 and r.read("c") == b"new"
    assert r.list() == sorted(set(want) - {"b/0"})
    with pytest.raises(ValueError, match="said"):
        _write_store(str(tmp_path / "bad"), {"k": (5000, [b"x"])})


@pytest.mark.parametrize("escape", ["../", "d/../../", "/"])
def test_data_file_outside_the_store_refused(tmp_path, escape):
    # A node whose data-file table names a path out of the store (one the
    # checkpoint's bytes could name) is refused before any file is mapped,
    # though a file lies there.
    root = str(tmp_path / "store")
    _write_store(root, {"k": b"v" * 5000})
    (node,) = _node_files(root)
    (data,) = set(os.listdir(os.path.join(root, "d"))) - {
        os.path.basename(node)}
    old = f"d/{data}".encode()
    new = (escape + "o" * (len(old) - len(escape))).encode()
    if not escape.startswith("/"):
        with open(os.path.normpath(os.path.join(root, new.decode())),
                  "wb") as fh:
            fh.write(b"x" * 5000)
    raw = bytearray(open(node, "rb").read())
    assert raw.count(old) == 1
    raw = raw.replace(old, new)
    raw[-4:] = zstd.crc32c(bytes(raw[:-4])).to_bytes(4, "little")
    open(node, "wb").write(bytes(raw))
    r = ocdbt.OcdbtReader(root)
    assert r.list() == ["k"]
    with pytest.raises(ocdbt.OcdbtError, match="outside the store"):
        r.read("k")


# -- zarr v2 -------------------------------------------------------------


@pytest.fixture(scope="module")
def zarr_store(tmp_path_factory):
    """Arrays tensorstore writes with a chunk grid on an OCDBT store:
    bf16 [5, 7, 13] in [2, 3, 4] chunks (edge chunks on every axis),
    f32 [9, 10] in [4, 10] chunks, int8 [6] in one chunk, uncompressed
    f32 [3, 5] in [2, 2] chunks."""
    root = str(tmp_path_factory.mktemp("zarr"))
    rng = np.random.default_rng(11)
    arrays = {
        "w.bf16": (rng.standard_normal((5, 7, 13)).astype(np.float32),
                   "bfloat16", [2, 3, 4], {"id": "zstd", "level": 3}),
        "w.f32": (rng.standard_normal((9, 10)).astype(np.float32), "<f4",
                  [4, 10], {"id": "zstd", "level": 1}),
        "w.i8": (rng.integers(-127, 128, 6).astype(np.int8), "|i1", [6],
                 {"id": "zstd", "level": 1}),
        "w.raw": (rng.standard_normal((3, 5)).astype(np.float32), "<f4",
                  [2, 2], None),
    }
    want = {}
    for name, (arr, dtype, chunks, comp) in arrays.items():
        t = ts.open({"driver": "zarr",
                     "kvstore": {"driver": "ocdbt",
                                 "base": f"file://{root}/", "path": name},
                     "metadata": {"shape": list(arr.shape), "chunks": chunks,
                                  "dtype": dtype, "compressor": comp,
                                  "fill_value": None}},
                    create=True).result()
        t.write(arr.astype(t.dtype.numpy_dtype)).result()
        got = t.read().result()
        want[name] = (got.view(np.uint16) if dtype == "bfloat16" else got)
    return root, want


def test_zarr_grid_equals_tensorstore(zarr_store):
    root, want = zarr_store
    store = zarr_v2.ZarrStore(ocdbt.OcdbtReader(root))
    for name, arr in want.items():
        got = store.read(name)
        assert got.dtype == arr.dtype and np.array_equal(got, arr), name
        n = arr.shape[-1]
        for lo, hi in ((0, n), (0, n // 2), (n // 3, n), (1, 2), (n, n)):
            cols = store.read(name, (lo, hi))
            assert np.array_equal(cols, arr[..., lo:hi]), (name, lo, hi)
    meta = store.meta("w.bf16")
    assert meta.grid() == (3, 3, 4) and meta.compressed
    assert not store.meta("w.raw").compressed


BASE = {"chunks": [2, 2], "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": "<f4", "fill_value": None,
        "filters": None, "order": "C", "shape": [4, 4], "zarr_format": 2}


@pytest.mark.parametrize("change,word", [
    ({"zarr_format": 3}, "zarr_format"),
    ({"dtype": "<f8"}, "dtype"),
    ({"dtype": "<f2"}, "dtype"),
    ({"order": "F"}, "order"),
    ({"dimension_separator": "/"}, "dimension_separator"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"fill_value": 0.0}, "fill_value"),
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, "compressor"),
])
def test_zarray_refused_by_name(change, word):
    with pytest.raises(zarr_v2.ZarrError, match=word):
        zarr_v2.parse_zarray("a", json.dumps(dict(BASE, **change)).encode())


def test_zarray_writer_matches_orbax():
    """The port's ``.zarray`` is byte for byte what tensorstore wrote for
    the fixture's ``embed``."""
    r = ocdbt.OcdbtReader(os.path.join(DATA, "torch_orbax_tiny_bf16",
                                       "params"))
    assert zarr_v2.zarray((256, 64), "bfloat16") == r.read("embed/.zarray")
    assert zarr_v2.zarray((2, 64), "<f4") == r.read(
        "blocks.attn_norm/.zarray")


def test_zarr_missing_or_short_chunk_raises(tmp_path):
    root = str(tmp_path / "s")
    doc = json.dumps(dict(BASE, compressor=None)).encode()
    _write_store(root, {"a/.zarray": doc, "a/0.0": bytes(16),
                             "a/0.1": bytes(15), "a/1.0": bytes(16)})
    store = zarr_v2.ZarrStore(ocdbt.OcdbtReader(root))
    with pytest.raises(zarr_v2.ZarrError, match="holds 15 bytes"):
        store.read("a")
    assert np.array_equal(store.read("a", (0, 2)), np.zeros((4, 2)))
    _write_store(root, {"a/.zarray": doc, "a/0.0": bytes(16)})
    with pytest.raises(zarr_v2.ZarrError, match="missing"):
        zarr_v2.ZarrStore(ocdbt.OcdbtReader(root)).read("a")
