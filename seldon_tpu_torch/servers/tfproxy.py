"""TensorFlow-Serving proxy — copy of ``seldon_tpu/servers/tfproxy.py``
(reference integrations/tfserving/TfServingProxy.py:20-126: SeldonMessage
<-> TF-Serving bridge); host code, its request bytes equal the JAX
package's.

REST-only implementation — the reference's gRPC path needs the TF proto
stack, which is not in this image; the REST `/v1/models/{m}:predict` API
covers the same sidecar the operator injects for TENSORFLOW_SERVER."""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, Iterable, Optional

import numpy as np


class TFServingProxy:
    def __init__(
        self,
        rest_endpoint: str = "http://localhost:2001",
        model_name: str = "model",
        signature_name: str = "",
        model_input: str = "",
        model_output: str = "",
    ):
        self.rest_endpoint = rest_endpoint.rstrip("/")
        self.model_name = model_name
        self.signature_name = signature_name
        self.model_input = model_input
        self.model_output = model_output

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None):
        body: Dict = {"instances": np.asarray(X).tolist()}
        if self.signature_name:
            body["signature_name"] = self.signature_name
        if self.model_input:
            body["inputs"] = {self.model_input: np.asarray(X).tolist()}
            body.pop("instances")
        url = f"{self.rest_endpoint}/v1/models/{self.model_name}:predict"
        req = urllib.request.Request(
            url,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        if "predictions" in out:
            return np.asarray(out["predictions"])
        outputs = out.get("outputs")
        if isinstance(outputs, dict):
            key = self.model_output or next(iter(outputs))
            return np.asarray(outputs[key])
        return np.asarray(outputs)

    def tags(self) -> Dict:
        return {"server": "tfserving-proxy"}
