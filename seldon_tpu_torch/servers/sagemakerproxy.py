"""SageMaker invoke-endpoint proxy — copy of
``seldon_tpu/servers/sagemakerproxy.py`` (reference
integrations/sagemaker/SagemakerProxy.py:1-33 — a boto3
`invoke_endpoint` bridge); host code, its request bytes and SigV4
signatures equal the JAX package's.

boto3 is not in this image, so the proxy signs SageMaker runtime REST
calls itself: AWS Signature V4 is ~50 lines of hmac/hashlib, which also
makes the auth path visible and testable (the reference's is hidden in
botocore). Credentials come from the standard AWS env vars the operator's
s3-secret injection already provides (model_initializer_injector.go
credential flow).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
from typing import Dict, Iterable, List, Optional
from urllib.parse import quote

import numpy as np


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    url_host: str,
    url_path: str,
    body: bytes,
    region: str,
    service: str,
    access_key: str,
    secret_key: str,
    session_token: str = "",
    now: Optional[datetime.datetime] = None,
) -> Dict[str, str]:
    """AWS Signature V4 for a single request (no query params)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(body).hexdigest()

    headers = {
        "host": url_host,
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
    }
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed_names = ";".join(sorted(headers))
    canonical_headers = "".join(
        f"{k}:{headers[k]}\n" for k in sorted(headers)
    )
    canonical_request = "\n".join([
        method,
        quote(url_path, safe="/-_.~"),
        "",  # query string
        canonical_headers,
        signed_names,
        payload_hash,
    ])
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256",
        amz_date,
        scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    k = _hmac(("AWS4" + secret_key).encode(), date_stamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    return headers


class SagemakerProxy:
    """SeldonComponent bridging SeldonMessage ndarray payloads to a
    SageMaker endpoint (CSV or JSON content types, mirroring the
    reference's `predict`)."""

    def __init__(self, endpoint_name: str = "", region: str = "",
                 content_type: str = "application/json",
                 endpoint_url: str = ""):
        self.endpoint_name = endpoint_name or os.environ.get(
            "SAGEMAKER_ENDPOINT_NAME", ""
        )
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.content_type = content_type
        # Override for tests / VPC endpoints.
        self.endpoint_url = endpoint_url or os.environ.get(
            "SAGEMAKER_RUNTIME_URL", ""
        )

    def _url(self) -> str:
        if self.endpoint_url:
            return (
                f"{self.endpoint_url}/endpoints/{self.endpoint_name}"
                "/invocations"
            )
        return (
            f"https://runtime.sagemaker.{self.region}.amazonaws.com"
            f"/endpoints/{self.endpoint_name}/invocations"
        )

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None):
        import requests

        X = np.asarray(X)
        if self.content_type == "text/csv":
            body = "\n".join(
                ",".join(str(v) for v in row) for row in np.atleast_2d(X)
            ).encode()
        else:
            body = json.dumps({"instances": X.tolist()}).encode()

        url = self._url()
        from urllib.parse import urlparse

        parsed = urlparse(url)
        headers = sigv4_headers(
            "POST", parsed.netloc, parsed.path, body,
            region=self.region, service="sagemaker",
            access_key=os.environ.get("AWS_ACCESS_KEY_ID", ""),
            secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY", ""),
            session_token=os.environ.get("AWS_SESSION_TOKEN", ""),
        )
        headers["content-type"] = self.content_type
        r = requests.post(url, data=body, headers=headers, timeout=60)
        if r.status_code != 200:
            raise RuntimeError(
                f"sagemaker invoke failed {r.status_code}: {r.text[:200]}"
            )
        out = r.json()
        if isinstance(out, dict) and "predictions" in out:
            return np.asarray(out["predictions"])
        return np.asarray(out)

    def tags(self) -> Dict:
        return {"proxy": "sagemaker", "endpoint": self.endpoint_name}
