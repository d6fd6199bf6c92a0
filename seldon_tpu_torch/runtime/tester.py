"""Contract tester — port of ``seldon_tpu/runtime/tester.py``: fuzz a
unit microservice (or a deployed engine) from a contract.json feature
spec, validating each response against the contract's targets.

contract.json shape:
{
  "features": [
    {"name": "x1", "dtype": "FLOAT", "ftype": "continuous", "range": [0, 1]},
    {"name": "c",  "dtype": "INT", "ftype": "categorical", "values": [0,1,2]},
    ... optionally "shape": [2, 3] for tensor features, "repeat": N
  ],
  "targets": [ ...same shape, validated against responses... ]
}

Run it as ``python -m seldon_tpu_torch.runtime.tester contract.json host
port [--grpc] [--api --deployment NAME]``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from seldon_tpu_torch.client import SeldonClient


class ContractError(Exception):
    pass


def _gen_feature(spec: Dict, rng: np.random.Generator):
    dtype = spec.get("dtype", "FLOAT")
    ftype = spec.get("ftype", "continuous")
    shape = spec.get("shape", [1])
    if ftype == "categorical":
        vals = spec["values"]
        out = rng.choice(vals, size=shape)
        return out.astype(np.int64 if dtype == "INT" else object)
    lo, hi = spec.get("range", [0.0, 1.0])
    lo = -1e3 if lo in ("-inf", None) else float(lo)
    hi = 1e3 if hi in ("inf", None) else float(hi)
    out = rng.uniform(lo, hi, size=shape)
    if dtype == "INT":
        out = np.floor(out).astype(np.int64)
    return out


def generate_batch(contract: Dict, batch_size: int,
                   rng: Optional[np.random.Generator] = None,
                   field: str = "features") -> Tuple[np.ndarray, List[str]]:
    rng = rng or np.random.default_rng(0)
    cols, names = [], []
    for spec in contract[field]:
        for r in range(int(spec.get("repeat", 1))):
            arr = np.stack(
                [np.ravel(_gen_feature(spec, rng)) for _ in range(batch_size)]
            )
            # STRING categoricals stay object dtype (serialized as the
            # ndarray wire form, matching the reference tester).
            if arr.dtype.kind in "fiub":
                arr = arr.astype(np.float64)
            cols.append(arr)
            base = spec["name"]
            width = arr.shape[1]
            names.extend(
                [base] if width == 1 and spec.get("repeat", 1) == 1
                else [f"{base}:{r}:{i}" for i in range(width)]
            )
    return np.concatenate(cols, axis=1), names


def validate_response(contract: Dict, arr: np.ndarray) -> List[str]:
    """Check response values against the `targets` specs. Returns problems."""
    problems: List[str] = []
    targets = contract.get("targets")
    if not targets or not isinstance(arr, np.ndarray):
        return problems
    width = sum(
        int(np.prod(t.get("shape", [1]))) * int(t.get("repeat", 1))
        for t in targets
    )
    if arr.ndim != 2 or arr.shape[1] != width:
        problems.append(
            f"response shape {arr.shape} != (batch, {width}) from targets"
        )
        return problems
    col = 0
    for t in targets:
        n = int(np.prod(t.get("shape", [1]))) * int(t.get("repeat", 1))
        sub = arr[:, col: col + n]
        col += n
        if t.get("ftype") == "categorical":
            allowed = set(t["values"])
            bad = set(np.unique(sub)) - allowed
            if bad:
                problems.append(f"target {t['name']}: values {bad} not in {allowed}")
        elif "range" in t:
            lo, hi = t["range"]
            if np.any(sub < lo) or np.any(sub > hi):
                problems.append(f"target {t['name']}: out of range [{lo},{hi}]")
    return problems


def run_contract_test(
    contract_path: str,
    host: str = "localhost",
    port: int = 9000,
    grpc_port: int = 0,
    transport: str = "rest",
    n_requests: int = 10,
    batch_size: int = 2,
    method: str = "predict",
    payload_kind: str = "dense",
    seed: int = 0,
) -> Dict[str, Any]:
    with open(contract_path) as f:
        contract = json.load(f)
    rng = np.random.default_rng(seed)
    client = SeldonClient(
        host=host, port=port, grpc_port=grpc_port or port, transport=transport
    )
    failures = []
    for i in range(n_requests):
        X, names = generate_batch(contract, batch_size, rng)
        kind = payload_kind if X.dtype.kind in "fiub" else "ndarray"
        r = client.microservice(
            data=X, method=method, names=names, payload_kind=kind
        )
        if not r.success:
            failures.append(f"request {i}: {r.error}")
            continue
        problems = validate_response(contract, r.data)
        failures.extend(f"request {i}: {p}" for p in problems)
    client.close()
    return {
        "requests": n_requests,
        "failures": failures,
        "ok": not failures,
    }


def run_api_test(
    contract_path: str,
    host: str = "localhost",
    port: int = 8000,
    grpc_port: int = 0,
    transport: str = "rest",
    n_requests: int = 10,
    batch_size: int = 2,
    deployment: str = "",
    namespace: str = "default",
    with_feedback: bool = False,
    payload_kind: str = "ndarray",
    seed: int = 0,
) -> Dict[str, Any]:
    """Contract-fuzz a DEPLOYED endpoint — the engine's external API,
    optionally through an ingress gateway: predict + send-feedback
    against a running SeldonDeployment, not a bare microservice. Set `deployment` to route via the gateway:
    REST uses the /seldon/{ns}/{name} path prefix, gRPC the
    seldon/namespace routing metadata."""
    with open(contract_path) as f:
        contract = json.load(f)
    rng = np.random.default_rng(seed)
    client = SeldonClient(
        host=host, port=port, grpc_port=grpc_port or port,
        transport=transport, deployment=deployment, namespace=namespace,
    )
    prefix = (
        SeldonClient.gateway_prefix(namespace, deployment)
        if deployment else ""
    )
    failures = []
    for i in range(n_requests):
        X, names = generate_batch(contract, batch_size, rng)
        kind = payload_kind if X.dtype.kind in "fiub" else "ndarray"
        r = client.predict(
            data=X, names=names, payload_kind=kind, gateway_prefix=prefix
        )
        if not r.success:
            failures.append(f"request {i}: {r.error}")
            continue
        failures.extend(
            f"request {i}: {p}" for p in validate_response(contract, r.data)
        )
        if not r.msg.meta.puid:
            failures.append(f"request {i}: response missing meta.puid")
        if with_feedback:
            fr = client.feedback(
                response_msg=r.msg, reward=1.0, gateway_prefix=prefix
            )
            if not fr.success:
                failures.append(f"feedback {i}: {fr.error}")
    client.close()
    return {
        "requests": n_requests,
        "failures": failures,
        "ok": not failures,
    }


def main(argv=None):  # pragma: no cover - CLI
    import argparse

    p = argparse.ArgumentParser(prog="seldon-tpu-torch-tester")
    p.add_argument("contract")
    p.add_argument("host")
    p.add_argument("port", type=int)
    p.add_argument("--grpc", action="store_true")
    p.add_argument("-n", "--n-requests", type=int, default=10)
    p.add_argument("-b", "--batch-size", type=int, default=2)
    p.add_argument("--method", default="predict")
    # Deployed-endpoint mode: fuzz the engine / ingress instead of a
    # bare microservice.
    p.add_argument("--api", action="store_true",
                   help="target a deployed engine/ingress, not a unit")
    p.add_argument("--deployment", default="",
                   help="route via gateway prefix /seldon/<ns>/<name>")
    p.add_argument("--namespace", default="default")
    p.add_argument("--feedback", action="store_true",
                   help="send reward feedback after each prediction")
    args = p.parse_args(argv)
    if args.api or args.deployment:
        result = run_api_test(
            args.contract, args.host, args.port,
            transport="grpc" if args.grpc else "rest",
            n_requests=args.n_requests, batch_size=args.batch_size,
            deployment=args.deployment, namespace=args.namespace,
            with_feedback=args.feedback,
        )
    else:
        result = run_contract_test(
            args.contract, args.host, args.port,
            transport="grpc" if args.grpc else "rest",
            n_requests=args.n_requests, batch_size=args.batch_size,
            method=args.method,
        )
    print(json.dumps(result, indent=1))
    return 0 if result["ok"] else 1


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
