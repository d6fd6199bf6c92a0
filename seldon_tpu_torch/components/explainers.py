"""Explainers: feature attributions for served models — port of
``seldon_tpu/components/explainers.py``.

Reference: the operator deploys `seldonio/alibiexplainer` against the
predictor's endpoint (seldondeployment_explainers.go:33-194) — anchors
over a remote model. Two methods:

 * `IntegratedGradients` — when the model is a torch function living in
   the same process (the sklearn server's ``LinearHead``, a scoring
   head), exact gradient-path attributions are cheaper AND
   deterministic: ``torch.func.grad`` vmapped over every (row, step) of
   the interpolation path in one batched call on the device. This is the
   capability alibi's black-box anchors approximate from outside.
 * `OcclusionExplainer` — model-agnostic fallback for remote predictors
   (the deployed `-explainer` pod): per-feature baseline substitution,
   batched into ONE predict call per explained row, so a remote
   explanation costs O(features/batch) round trips, not O(features).

`ExplainerServer` is the SeldonComponent the explainer Deployment runs:
it wraps OcclusionExplainer around the predictor service the reconciler
points it at (`--predictor-host`), and serves attributions through the
standard unit protocol — `predict` returns the attribution matrix.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


class IntegratedGradients:
    """IG for a differentiable torch model fn: attr_i = (x_i - b_i) *
    integral of d f / d x_i along the straight path from baseline to x,
    approximated with `steps` midpoint samples — the completeness axiom
    (sum(attr) ~= f(x) - f(b)) is checked in tests. ``model_fn`` maps
    ``[B, F]`` f32 rows on the explainer's device to ``[B]`` or
    ``[B, C]``; each path point is scored alone (a batch of one), as the
    JAX explainer's per-row ``grad`` does."""

    def __init__(self, model_fn: Callable, steps: int = 64,
                 output_index: Optional[int] = None,
                 device: DeviceLike = None):
        self.model_fn = model_fn
        self.steps = int(steps)
        self.output_index = output_index
        self.device = resolve_device(device)

    def _scalar_out(self, x: torch.Tensor) -> torch.Tensor:
        y = self.model_fn(x[None])[0]
        if y.ndim == 0:
            return y
        return (y[self.output_index] if self.output_index is not None
                else torch.max(y))

    def _ig(self, X: torch.Tensor, baseline: torch.Tensor) -> torch.Tensor:
        # Midpoint rule over alphas in (0, 1).
        steps = self.steps
        alphas = (torch.arange(steps, dtype=torch.float32,
                               device=X.device) + 0.5) / steps
        B, F = X.shape
        path = baseline[:, None] + alphas[None, :, None] * (X - baseline)[
            :, None]
        grads = torch.func.vmap(torch.func.grad(self._scalar_out))(
            path.reshape(B * steps, F)).reshape(B, steps, F)
        return (X - baseline) * grads.mean(dim=1)

    def explain(self, X: np.ndarray,
                baseline: Optional[np.ndarray] = None) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float32))
        if baseline is None:
            baseline = np.zeros_like(X)
        else:
            baseline = np.broadcast_to(
                np.asarray(baseline, np.float32), X.shape
            )
        dev = self.device
        Xd = torch.tensor(X, device=dev)
        bd = torch.tensor(baseline, device=dev)
        return self._ig(Xd, bd).detach().cpu().numpy()


class OcclusionExplainer:
    """Model-agnostic: attribution_i = f(x) - f(x with feature i set to
    the baseline). One batched predict call per explained row."""

    def __init__(self, predict_fn: Callable[[np.ndarray], np.ndarray],
                 output_index: Optional[int] = None):
        self.predict_fn = predict_fn
        self.output_index = output_index

    def _scalar(self, out: np.ndarray) -> np.ndarray:
        out = np.asarray(out, np.float32)
        if out.ndim == 1:
            return out
        return (out[:, self.output_index] if self.output_index is not None
                else out.max(axis=-1))

    def explain(self, X: np.ndarray,
                baseline: Optional[np.ndarray] = None) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float32))
        n, f = X.shape
        if baseline is None:
            baseline = np.zeros_like(X)
        else:
            baseline = np.broadcast_to(
                np.asarray(baseline, np.float32), X.shape
            )
        attrs = np.zeros_like(X)
        for i in range(n):
            # Row 0: the original; rows 1..f: feature j occluded.
            batch = np.tile(X[i], (f + 1, 1))
            for j in range(f):
                batch[j + 1, j] = baseline[i, j]
            scores = self._scalar(self.predict_fn(batch))
            attrs[i] = scores[0] - scores[1:]
        return attrs


class ExplainerServer:
    """The deployed explainer unit: explains a REMOTE predictor.

    Parameters (PREDICTIVE_UNIT_PARAMETERS or kwargs):
      predictor_host  host:port of the predictor service (engine REST)
      output_index    optional class index to explain
    """

    def __init__(self, predictor_host: str = "",
                 output_index: Optional[int] = None):
        self.predictor_host = predictor_host or os.environ.get(
            "PREDICTOR_HOST", ""
        )
        self.output_index = output_index
        self._explainer: Optional[OcclusionExplainer] = None

    def _remote_predict(self, X: np.ndarray) -> np.ndarray:
        import requests

        url = f"http://{self.predictor_host}/api/v0.1/predictions"
        r = requests.post(
            url,
            json={"data": {"ndarray": np.asarray(X).tolist()}},
            timeout=60,
        )
        r.raise_for_status()
        out = r.json()
        data = out.get("data", {})
        if "ndarray" in data:
            return np.asarray(data["ndarray"], np.float32)
        if "tensor" in data:
            t = data["tensor"]
            return np.asarray(t["values"], np.float32).reshape(t["shape"])
        raise ValueError(f"predictor returned no dense data: {out}")

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None) -> np.ndarray:
        if self._explainer is None:
            if not self.predictor_host:
                raise RuntimeError(
                    "ExplainerServer needs predictor_host (or "
                    "PREDICTOR_HOST env)"
                )
            self._explainer = OcclusionExplainer(
                self._remote_predict, output_index=self.output_index
            )
        return self._explainer.explain(np.asarray(X, np.float32))

    def tags(self) -> Dict:
        return {"explainer": "occlusion",
                "predictor": self.predictor_host}


def main(argv=None) -> None:  # pragma: no cover - container entrypoint
    """Entry matching the reconciler's explainer container args
    (build_explainer_manifests): --model-name --predictor-host
    --protocol --http-port <type>."""
    import argparse

    from seldon_tpu_torch.runtime import microservice

    parser = argparse.ArgumentParser()
    parser.add_argument("--model-name", default="explainer")
    parser.add_argument("--predictor-host", required=True)
    parser.add_argument("--protocol", default="seldon.http")
    parser.add_argument("--http-port", type=int, default=9000)
    parser.add_argument("--storage-uri", default="")
    parser.add_argument("explainer_type", nargs="?",
                        default="occlusion")
    args = parser.parse_args(argv)

    os.environ["PREDICTOR_HOST"] = args.predictor_host
    os.environ["PREDICTIVE_UNIT_SERVICE_PORT"] = str(args.http_port)
    microservice.main([
        "seldon_tpu_torch.components.explainers.ExplainerServer",
        "--api-type", "REST,GRPC",
        "--service-type", "MODEL",
    ])


if __name__ == "__main__":  # pragma: no cover
    main()
