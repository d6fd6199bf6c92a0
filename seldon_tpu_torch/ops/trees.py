"""Tree-ensemble inference — port of ``seldon_tpu/ops/trees.py``.

An ensemble is compiled on the host to flat arrays (feature, threshold,
left, right, value, missing) per node, as in the JAX package (the host
code here is a copy of it). Traversal is ``max_depth`` rounds of gathers
over ``[batch, n_trees]`` node cursors: branchless and static-shaped, the
same walk the JAX package runs under ``fori_loop``, here as plain torch
on the arrays' device. :class:`DeviceTrees` uploads the arrays once, at
construction (the JAX function re-uploads them with ``jnp.asarray`` on
every call; the results are the same). Cursors are int64, as
``torch.gather`` wants; the comparison ``x < threshold`` stays f32, so
the cursors equal the JAX walk's bit for bit."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Sequence, Union

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class TreeEnsemble:
    """Flat ensemble: arrays [n_trees, max_nodes]."""

    feature: np.ndarray  # int32; -1 = leaf
    threshold: np.ndarray  # f32
    left: np.ndarray  # int32 child index (within tree)
    right: np.ndarray
    value: np.ndarray  # f32 leaf value (0 on internal nodes)
    missing: np.ndarray  # int32 child for NaN features (xgboost 'missing')
    max_depth: int
    base_score: float = 0.0

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


def _pad_trees(trees: List[Dict[str, List]], max_depth_cap: int = 64):
    """trees: list of dicts with per-node parallel lists."""
    max_nodes = max(len(t["feature"]) for t in trees)
    n = len(trees)

    def arr(key, fill, dtype):
        out = np.full((n, max_nodes), fill, dtype=dtype)
        for i, t in enumerate(trees):
            out[i, : len(t[key])] = t[key]
        return out

    return (
        arr("feature", -1, np.int32),
        arr("threshold", 0.0, np.float32),
        arr("left", 0, np.int32),
        arr("right", 0, np.int32),
        arr("value", 0.0, np.float32),
        arr("missing", 0, np.int32),
    )


def from_xgboost_json(dump: Sequence[str] | str, base_score: float = 0.0
                      ) -> TreeEnsemble:
    """Build from `Booster.get_dump(dump_format='json')` (list of per-tree
    JSON strings) or a JSON array of trees."""
    if isinstance(dump, str):
        tree_objs = json.loads(dump)
    else:
        tree_objs = [json.loads(t) if isinstance(t, str) else t for t in dump]

    trees = []
    max_depth = 1
    for obj in tree_objs:
        nodes: Dict[int, Dict[str, Any]] = {}

        def walk(node, depth=0):
            nonlocal max_depth
            max_depth = max(max_depth, depth + 1)
            nid = node["nodeid"]
            if "leaf" in node:
                nodes[nid] = {"feature": -1, "threshold": 0.0, "left": nid,
                              "right": nid, "missing": nid,
                              "value": float(node["leaf"])}
                return
            feat = node["split"]
            fidx = int(feat[1:]) if isinstance(feat, str) and feat.startswith("f") else int(feat)
            nodes[nid] = {
                "feature": fidx,
                "threshold": float(node["split_condition"]),
                "left": int(node["yes"]),
                "right": int(node["no"]),
                # xgboost routes NaN to the learned missing-direction child
                # (defaults to 'yes' when the dump omits it).
                "missing": int(node.get("missing", node["yes"])),
                "value": 0.0,
            }
            for child in node.get("children", []):
                walk(child, depth + 1)

        walk(obj)
        # Re-index to dense 0..n-1 (xgboost node ids can be sparse).
        ids = sorted(nodes)
        remap = {old: new for new, old in enumerate(ids)}
        tree = {"feature": [], "threshold": [], "left": [], "right": [],
                "value": [], "missing": []}
        for old in ids:
            nd = nodes[old]
            tree["feature"].append(nd["feature"])
            tree["threshold"].append(nd["threshold"])
            tree["left"].append(remap[nd["left"]])
            tree["right"].append(remap[nd["right"]])
            tree["value"].append(nd["value"])
            tree["missing"].append(remap[nd["missing"]])
        trees.append(tree)

    f, t, l, r, v, m = _pad_trees(trees)
    return TreeEnsemble(f, t, l, r, v, m, max_depth=max_depth,
                        base_score=base_score)


class DeviceTrees(torch.nn.Module):
    """A :class:`TreeEnsemble`'s arrays on one device, uploaded once.
    Index arrays are int64 (``torch.gather``'s index type); thresholds
    and leaf values stay f32."""

    def __init__(self, ensemble: TreeEnsemble, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        for name in ("feature", "left", "right", "missing"):
            self.register_buffer(name, torch.as_tensor(
                getattr(ensemble, name).astype(np.int64), device=dev))
        for name in ("threshold", "value"):
            self.register_buffer(name, torch.as_tensor(
                getattr(ensemble, name).astype(np.float32), device=dev))
        self.max_depth = int(ensemble.max_depth)
        self.base_score = float(ensemble.base_score)
        self.n_trees = ensemble.n_trees

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def leaves(self, X: torch.Tensor) -> torch.Tensor:
        """X [B, F] f32 -> the final node cursor of every (row, tree),
        [B, T] int64, after ``max_depth`` rounds."""
        B, T = X.shape[0], self.n_trees
        n_nodes = self.feature.shape[1]
        # Flat offsets of each tree's row: node (t, j) is t * n_nodes + j.
        base = torch.arange(T, device=X.device)[None, :] * n_nodes
        feature = self.feature.reshape(-1)
        threshold = self.threshold.reshape(-1)
        left = self.left.reshape(-1)
        right = self.right.reshape(-1)
        missing = self.missing.reshape(-1)
        node = torch.zeros((B, T), dtype=torch.int64, device=X.device)
        for _ in range(self.max_depth):
            flat = base + node
            feat = feature[flat]  # [B, T]
            is_leaf = feat < 0
            x = torch.gather(X, 1, feat.clamp(min=0))
            nxt = torch.where(x < threshold[flat], left[flat], right[flat])
            # NaN features take the learned missing-direction child (x < thr
            # is False for NaN, which would silently route right otherwise).
            nxt = torch.where(torch.isnan(x), missing[flat], nxt)
            node = torch.where(is_leaf, node, nxt)
        return node

    def leaf_values(self, X: torch.Tensor) -> torch.Tensor:
        """X [B, F] -> the value of every (row, tree)'s final node, [B, T]."""
        node = self.leaves(X)
        n_nodes = self.value.shape[1]
        base = torch.arange(self.n_trees, device=X.device)[None, :] * n_nodes
        return self.value.reshape(-1)[base + node]

    def margins(self, X: torch.Tensor) -> torch.Tensor:
        """X [B, F] -> summed leaf margins [B], plus the base score."""
        return self.leaf_values(X).sum(dim=1) + self.base_score


Trees = Union[TreeEnsemble, DeviceTrees]


def _on_device(ensemble: Trees, X) -> tuple:
    """(DeviceTrees, X as f32 on its device). A host ensemble is uploaded
    to X's device when X is a tensor, else to the default device."""
    if isinstance(ensemble, TreeEnsemble):
        dev = X.device if isinstance(X, torch.Tensor) else None
        ensemble = DeviceTrees(ensemble, dev)
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X, np.float32))
    return ensemble, X.to(device=ensemble.device, dtype=torch.float32)


def predict_margin(ensemble: Trees, X) -> torch.Tensor:
    """X [B, F] -> summed leaf margins [B] (add sigmoid/softmax outside)."""
    ensemble, X = _on_device(ensemble, X)
    return ensemble.margins(X)


def predict(ensemble: Trees, X, objective: str = "reg") -> torch.Tensor:
    """objective: 'reg' (raw), 'binary' (sigmoid), 'binary:raw'."""
    m = predict_margin(ensemble, X)
    if objective == "binary":
        return torch.sigmoid(m)
    return m
