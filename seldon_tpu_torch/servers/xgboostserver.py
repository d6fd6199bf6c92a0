"""XGBoost parity server — port of ``seldon_tpu/servers/xgboostserver.py``
(reference servers/xgboostserver/xgboostserver/XGBoostServer.py:10-26:
Booster(model_file='model.bst') -> DMatrix predict).

The model ships as ``model.json`` (an xgboost
``get_dump(dump_format='json')`` array, optionally wrapped with objective/
base_score) and runs through the tree traversal of ``ops/trees.py`` on
the server's device, the arrays uploaded once at load. A native
``model.bst`` loads only through xgboost, when it is installed, as in the
JAX package."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.ops import trees
from seldon_tpu_torch.servers.storage import download


class XGBoostServer:
    def __init__(self, model_uri: str = "", objective: str = "",
                 device: DeviceLike = None):
        self.model_uri = model_uri
        self.objective = objective
        self.device = resolve_device(device)
        self.booster = None
        self.ensemble: Optional[trees.TreeEnsemble] = None
        self._trees: Optional[trees.DeviceTrees] = None

    def load(self) -> None:
        local = download(self.model_uri)
        json_path = os.path.join(local, "model.json")
        bst_path = os.path.join(local, "model.bst")
        if os.path.exists(json_path):
            with open(json_path) as f:
                doc = json.load(f)
            if isinstance(doc, dict):  # wrapped form
                dump = doc["trees"]
                self.objective = self.objective or doc.get("objective", "reg")
                base = float(doc.get("base_score", 0.0))
                # xgboost stores base_score for logistic objectives in
                # PROBABILITY space (default 0.5 == margin 0); traversal sums
                # margins, so convert to margin space via logit.
                if "logistic" in (self.objective or "") and 0.0 < base < 1.0:
                    base = float(np.log(base / (1.0 - base)))
            else:
                dump = doc
                base = 0.0
            self.ensemble = trees.from_xgboost_json(dump, base_score=base)
            self._trees = trees.DeviceTrees(self.ensemble, self.device)
        elif os.path.exists(bst_path):
            try:
                import xgboost as xgb
            except ImportError as e:
                raise RuntimeError(
                    "model.bst needs xgboost (not in this image); export the "
                    "booster with get_dump(dump_format='json') to model.json"
                ) from e
            self.booster = xgb.Booster(model_file=bst_path)
        else:
            raise FileNotFoundError(f"no model.json or model.bst under {local}")

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None):
        if self.booster is None and self.ensemble is None:
            self.load()
        X = np.asarray(X, dtype=np.float32)
        if self._trees is not None:
            obj = "binary" if "logistic" in (self.objective or "") else "reg"
            return trees.predict(self._trees, X, objective=obj).cpu().numpy()
        import xgboost as xgb

        return self.booster.predict(xgb.DMatrix(X))

    def tags(self) -> Dict:
        return {"server": "xgboostserver",
                "backend": ("torch-trees" if self._trees is not None
                            else "xgboost")}
