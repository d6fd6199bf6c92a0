"""seldon_tpu_torch.servers.storage against seldon_tpu.servers.storage:
the same URIs give the same local directories, the same errors and, from
bucket listings served by in-process fakes of the gs and s3 clients, the
same files. No test reaches a network: the http / Azure paths are held
to the JAX module's error with ``requests`` unavailable."""

import os
import sys
import types

import pytest

from seldon_tpu.servers import storage as jst
from seldon_tpu_torch.servers import storage as tst

MODS = {"jax": jst, "torch": tst}


@pytest.fixture(autouse=True)
def model_dir(tmp_path, monkeypatch):
    """Both modules' shared model directory under the test's tmp dir."""
    root = tmp_path / "models"
    for mod in MODS.values():
        monkeypatch.setattr(mod, "_DOWNLOAD_DIR", str(root))
    return root


def _raises_alike(fn_j, fn_t):
    with pytest.raises(Exception) as want:
        fn_j()
    with pytest.raises(Exception) as got:
        fn_t()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    return got.value


def test_local_paths_and_file_scheme(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    for uri in (str(d), "file://" + str(d), "file:///no/such/dir"):
        assert tst.download(uri) == jst.download(uri)
    assert tst.download(str(d)) == str(d)
    assert tst.download("file://" + str(d)) == str(d)


def test_missing_uri_raises_alike(tmp_path):
    err = _raises_alike(lambda: jst.download(str(tmp_path / "nope")),
                        lambda: tst.download(str(tmp_path / "nope")))
    assert isinstance(err, ValueError)


@pytest.mark.parametrize("uri,blocked", [
    ("gs://bucket/models/llama", "google.cloud.storage"),
    ("s3://bucket/models/llama", "boto3"),
    ("https://example.invalid/model.bin", "requests"),
    ("http://example.invalid/m/model.bin", "requests"),
    ("azure://acct/container/prefix", "requests"),
    ("https://acct.blob.core.windows.net/container/prefix", "requests"),
])
def test_gated_schemes_without_library_raise_alike(uri, blocked, monkeypatch,
                                                   tmp_path):
    # None in sys.modules makes the import fail, whether or not the
    # library is installed here; a package attribute left by an earlier
    # import would bypass it.
    monkeypatch.setitem(sys.modules, blocked, None)
    parent, _, leaf = blocked.rpartition(".")
    if parent in sys.modules:
        monkeypatch.delattr(sys.modules[parent], leaf, raising=False)
    err = _raises_alike(lambda: jst.download(uri, str(tmp_path / "j")),
                        lambda: tst.download(uri, str(tmp_path / "t")))
    if blocked != "requests":
        assert "mount the model or use file://" in str(err)


RELATIVE = [
    ("models/a/config.json", "models/a"),
    ("models/a/sub/w.safetensors", "models/a/"),
    ("models/ab/config.json", "models/a"),
    ("models/a", "models/a"),
    ("models/a/", "models/a"),
    ("models/a/dir/", "models/a"),
    ("config.json", ""),
    ("models/a/../../etc/passwd", "models/a"),
    ("models/a//abs", "models/a"),
    ("models/a/x\\y", "models/a"),
    ("other/config.json", "models/a"),
    ("", ""),
]


@pytest.mark.parametrize("key,prefix", RELATIVE)
def test_relative_key_equals_jax(key, prefix):
    assert tst._relative_key(key, prefix) == jst._relative_key(key, prefix)


@pytest.mark.parametrize("uri", ["gs://b/m", "s3://b/m", "s3://b/m/",
                                 "azure://a/c/p", ""])
def test_uri_dir_and_target_dir_equal_jax(uri, model_dir, tmp_path):
    got, want = tst._uri_dir(uri), jst._uri_dir(uri)
    assert got == want and got.startswith(str(model_dir))
    out = str(tmp_path / "out" / uri.replace("/", "_"))
    assert tst._target_dir(out) == jst._target_dir(out) == out
    assert os.path.isdir(out)


def test_uri_dir_unwritable_is_none(monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    for mod in MODS.values():
        monkeypatch.setattr(mod, "_DOWNLOAD_DIR", str(blocker / "models"))
    assert tst._uri_dir("gs://b/m") is None is jst._uri_dir("gs://b/m")


@pytest.mark.parametrize("env", [
    {},
    {"AWS_ENDPOINT_URL": "http://minio:9000", "S3_ENDPOINT": "x:1"},
    {"S3_ENDPOINT": "minio:9000", "S3_USE_HTTPS": "0"},
    {"S3_ENDPOINT": "minio:9000", "S3_VERIFY_SSL": "0",
     "AWS_REGION": "eu-west-1"},
])
def test_s3_client_kwargs_equal_jax(env):
    assert tst._s3_client_kwargs(env) == jst._s3_client_kwargs(env)


# Object keys of a fake bucket: files under the prefix, a sibling prefix
# that must not match, directory markers and traversal attempts.
OBJECTS = {
    "models/llama/config.json": b'{"a": 1}',
    "models/llama/model-00001.safetensors": b"\x01\x02",
    "models/llama/sub/tokenizer.json": b"{}",
    "models/llama/": b"",
    "models/llama/dir/": b"",
    "models/llamas/config.json": b"nope",
    "models/llama/../../escape": b"bad",
}


def _fake_gcs():
    class Blob:
        def __init__(self, name):
            self.name = name

        def download_to_filename(self, dst):
            with open(dst, "wb") as f:
                f.write(OBJECTS[self.name])

    class Bucket:
        def list_blobs(self, prefix):
            return [Blob(k) for k in OBJECTS if k.startswith(prefix)]

    class Client:
        def bucket(self, name):
            assert name == "bkt"
            return Bucket()

    mod = types.ModuleType("google.cloud.storage")
    mod.Client = Client
    return mod


def _fake_boto3():
    class Paginator:
        def paginate(self, Bucket, Prefix):
            keys = [k for k in OBJECTS if k.startswith(Prefix)]
            return [{"Contents": [{"Key": k} for k in keys[:3]]},
                    {"Contents": [{"Key": k} for k in keys[3:]]}]

    class S3:
        def get_paginator(self, name):
            assert name == "list_objects_v2"
            return Paginator()

        def download_file(self, bucket, key, dst):
            with open(dst, "wb") as f:
                f.write(OBJECTS[key])

    mod = types.ModuleType("boto3")
    mod.client = lambda service, **kw: S3()
    return mod


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_bucket_downloads_equal_jax(scheme, monkeypatch, tmp_path):
    if scheme == "gs":
        import google.cloud

        monkeypatch.setattr(google.cloud, "storage", _fake_gcs(),
                            raising=False)
        monkeypatch.setitem(sys.modules, "google.cloud.storage",
                            google.cloud.storage)
    else:
        monkeypatch.setitem(sys.modules, "boto3", _fake_boto3())
    uri = f"{scheme}://bkt/models/llama"
    got = tst.download(uri, str(tmp_path / "t"))
    want = jst.download(uri, str(tmp_path / "j"))
    assert _tree(got) == _tree(want) == {
        "config.json": b'{"a": 1}',
        "model-00001.safetensors": b"\x01\x02",
        os.path.join("sub", "tokenizer.json"): b"{}",
    }


def test_main_equals_jax(tmp_path, capsys):
    assert tst.main([]) == jst.main([]) == 2
    err = capsys.readouterr().err
    assert "seldon_tpu_torch.servers.storage" in err
    d = tmp_path / "m"
    d.mkdir()
    assert tst.main([str(d), str(tmp_path / "o")]) == 0
    assert capsys.readouterr().out.strip() == str(d)
