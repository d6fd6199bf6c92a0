"""Model artifact download: a ``modelUri`` to a local directory.

Copy of ``seldon_tpu/servers/storage.py`` (the port keeps its own so that
it never imports the JAX package; tests/test_torch_storage.py holds the
two against each other). Reference: python/seldon_core/storage.py:38-164
and the kfserving model-initializer initContainer,
operator/controllers/model_initializer_injector.go:65-228.

Supported URIs: local paths and file:// always; https:// (direct file
fetch) and azure:// / https://*.blob.core.windows.net (Azure Blob REST,
anonymous or SAS — no SDK needed) through ``requests``; gs:// via
google.cloud.storage and s3:// via boto3/minio only if those clients
exist in the image (they are not baked in — gated, with a clear error
instead of an import crash). Each client library is imported only when
its scheme is asked for."""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile

logger = logging.getLogger(__name__)

_DOWNLOAD_DIR = os.environ.get("SELDON_TPU_MODEL_DIR", "/mnt/models")


def download(uri: str, out_dir: str | None = None) -> str:
    """Fetch `uri` into a local directory; returns the local path.
    Local paths pass through untouched."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if uri.startswith("gs://"):
        return _download_gcs(uri, out_dir or _uri_dir(uri))
    if uri.startswith("s3://"):
        return _download_s3(uri, out_dir or _uri_dir(uri))
    if uri.startswith("azure://") or ".blob.core.windows.net" in uri:
        return _download_azure_blob(uri, out_dir or _uri_dir(uri))
    if uri.startswith(("http://", "https://")):
        return _download_http(uri, out_dir or _uri_dir(uri))
    if os.path.exists(uri):
        return uri
    raise ValueError(f"unsupported or missing model uri: {uri!r}")


def _uri_dir(uri: str) -> str | None:
    """Per-URI subdirectory under the shared model dir, so two models in one
    pod never overwrite each other's files."""
    digest = hashlib.sha256(uri.encode()).hexdigest()[:16]
    try:
        os.makedirs(_DOWNLOAD_DIR, exist_ok=True)
        return os.path.join(_DOWNLOAD_DIR, digest)
    except OSError:
        return None


def _target_dir(out_dir: str | None) -> str:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        return out_dir
    return tempfile.mkdtemp(prefix="seldon-tpu-model-")


def _relative_key(key: str, prefix: str) -> str | None:
    """Path of `key` under `prefix`, or None if key is outside it (guards
    against 'models/a' string-matching 'models/ab/...').

    Also rejects keys whose relative path would escape the download dir
    (absolute components or `..` segments) — bucket listings are remote
    input, and `os.path.join(target, rel)` must never write outside
    `target` even against a hostile/compromised storage account. All
    three listing backends (gs/s3/azure) route through here."""
    if not prefix:
        rel = key
    else:
        p = prefix.rstrip("/")
        if key == p:
            rel = os.path.basename(key)
        elif key.startswith(p + "/"):
            rel = key[len(p) + 1:]
        else:
            return None
    # Empty rel and trailing-slash rels are directory markers (console
    # -created 'folder' placeholders) — skip, or the per-blob open() on a
    # directory path aborts the whole download.
    if not rel or rel.endswith("/"):
        return None
    parts = rel.split("/")
    if rel.startswith("/") or ".." in parts or any("\\" in s for s in parts):
        logger.warning("skipping traversal-unsafe object key %r", key)
        return None
    return rel


def _download_gcs(uri: str, out_dir: str | None) -> str:
    try:
        from google.cloud import storage as gcs
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "gs:// model uris need google-cloud-storage, not present in "
            "this image; mount the model or use file://"
        ) from e
    bucket_name, _, prefix = uri[len("gs://"):].partition("/")
    target = _target_dir(out_dir)
    client = gcs.Client()
    for blob in client.bucket(bucket_name).list_blobs(prefix=prefix):
        rel = _relative_key(blob.name, prefix)
        if rel is None:
            continue
        dst = os.path.join(target, rel)
        os.makedirs(os.path.dirname(dst) or target, exist_ok=True)
        blob.download_to_filename(dst)
    return target


def _download_http(uri: str, out_dir: str | None) -> str:
    """Plain https file fetch (reference storage.py supports URL models)."""
    import requests

    target = _target_dir(out_dir)
    name = os.path.basename(uri.split("?", 1)[0]) or "model"
    dst = os.path.join(target, name)
    with requests.get(uri, stream=True, timeout=300) as r:
        r.raise_for_status()
        with open(dst, "wb") as f:
            for chunk in r.iter_content(1 << 20):
                f.write(chunk)
    return target


def _download_azure_blob(uri: str, out_dir: str | None) -> str:
    """Azure Blob container prefix download over the raw REST API
    (reference python/seldon_core/storage.py azure path used the SDK; the
    List Blobs + GET endpoints need none for anonymous/SAS access).

    Accepts `azure://account/container/prefix` or
    `https://account.blob.core.windows.net/container/prefix[?sas]`.
    A SAS token can ride the URI query or env AZURE_SAS_TOKEN."""
    import re as _re
    import xml.etree.ElementTree as ET

    import requests

    query = ""
    if uri.startswith("azure://"):
        rest = uri[len("azure://"):]
        rest, _, query = rest.partition("?")  # SAS may ride azure:// too
        account, _, tail = rest.partition("/")
        base = f"https://{account}.blob.core.windows.net"
    else:
        m = _re.match(r"(https?://[^/]+)/(.*)$", uri)
        if m is None:
            raise ValueError(f"unparseable blob uri: {uri!r}")
        base, tail = m.group(1), m.group(2)
        tail, _, query = tail.partition("?")
    container, _, prefix = tail.partition("/")
    sas = query or os.environ.get("AZURE_SAS_TOKEN", "").lstrip("?")

    def with_sas(url: str, extra: str = "") -> str:
        parts = [p for p in (extra, sas) if p]
        return url + ("?" + "&".join(parts) if parts else "")

    target = _target_dir(out_dir)
    names: list[str] = []
    marker = ""
    try:
        while True:  # List Blobs pages at 5000 entries (NextMarker)
            extra = f"restype=container&comp=list&prefix={prefix}"
            if marker:
                extra += f"&marker={marker}"
            r = requests.get(
                with_sas(f"{base}/{container}", extra), timeout=60
            )
            r.raise_for_status()
            root = ET.fromstring(r.content)
            names.extend(b.findtext("Name") for b in root.iter("Blob"))
            marker = root.findtext("NextMarker") or ""
            if not marker:
                break
    except requests.HTTPError:
        # Single-blob URL with a read-only SAS (no list permission — the
        # common single-file grant): fall back to a direct GET.
        return _download_http(uri, out_dir)
    if not names:
        raise ValueError(f"no blobs under {uri!r}")
    for name in names:
        rel = _relative_key(name, prefix)
        if rel is None:
            continue
        dst = os.path.join(target, rel)
        os.makedirs(os.path.dirname(dst) or target, exist_ok=True)
        blob = requests.get(
            with_sas(f"{base}/{container}/{name}"), timeout=300, stream=True
        )
        blob.raise_for_status()
        with open(dst, "wb") as f:
            for chunk in blob.iter_content(1 << 20):
                f.write(chunk)
    return target


def _s3_client_kwargs(env) -> dict:
    """boto3 client kwargs from the operator-injected credential env
    (operator/credentials.py; reference s3_secret.go env contract).
    AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY are read by boto3 itself;
    this handles the endpoint/SSL knobs: AWS_ENDPOINT_URL wins, else
    S3_ENDPOINT + S3_USE_HTTPS compose one, and S3_VERIFY_SSL=0 disables
    certificate verification (self-hosted minio with self-signed TLS)."""
    kwargs: dict = {}
    endpoint = env.get("AWS_ENDPOINT_URL")
    if not endpoint and env.get("S3_ENDPOINT"):
        scheme = "http" if env.get("S3_USE_HTTPS") == "0" else "https"
        endpoint = f"{scheme}://{env['S3_ENDPOINT']}"
    if endpoint:
        kwargs["endpoint_url"] = endpoint
    if env.get("S3_VERIFY_SSL") == "0":
        kwargs["verify"] = False
    if env.get("AWS_REGION"):
        kwargs["region_name"] = env["AWS_REGION"]
    return kwargs


def _download_s3(uri: str, out_dir: str | None) -> str:
    try:
        import boto3
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "s3:// model uris need boto3, not present in this image; "
            "mount the model or use file://"
        ) from e
    bucket_name, _, prefix = uri[len("s3://"):].partition("/")
    target = _target_dir(out_dir)
    s3 = boto3.client("s3", **_s3_client_kwargs(os.environ))
    paginator = s3.get_paginator("list_objects_v2")
    for page in paginator.paginate(Bucket=bucket_name, Prefix=prefix):
        for obj in page.get("Contents", []):
            rel = _relative_key(obj["Key"], prefix)
            if rel is None:
                continue
            dst = os.path.join(target, rel)
            os.makedirs(os.path.dirname(dst) or target, exist_ok=True)
            s3.download_file(bucket_name, obj["Key"], dst)
    return target


def main(argv=None) -> int:
    """Model-initializer initContainer entrypoint:
    `python -m seldon_tpu_torch.servers.storage <uri> <out_dir>` (the
    operator's _model_initializer emits the JAX package's twin of this
    command; credentials arrive via the injected env —
    operator/credentials.py)."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 2:
        print("usage: python -m seldon_tpu_torch.servers.storage <uri> "
              "<out_dir>", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO)
    local = download(args[0], args[1])
    print(local)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
