"""The port stands alone: seldon_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, checked in a fresh interpreter that
runs the tiny server (generate, generate_stream and predict), the int8
W8A8 server on the sparse leg with sampled noise from models/prng.py,
tiny-moe, and the whole-batch generate on the flash path, then imports
the serving runtime (wrapper, CLI, fast lane, persistence), and in the
source text. Serving itself loads no transport library: TorchServer and
everything it imports run without aiohttp, grpc and protobuf."""

import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import json, sys
# Only what the port imports counts (an interpreter start-up hook may
# have loaded modules before this line).
before = set(sys.modules)
import dataclasses
import torch
from seldon_tpu_torch.models import prng, quantize
from seldon_tpu_torch.models.generate import generate
from seldon_tpu_torch.servers.torchserver import TorchServer
srv = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                  prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                  device="cpu")
out = srv.generate({"prompt": "abc", "max_new_tokens": 3,
                    "temperature": 0.0})
streamed = [t for c in srv.generate_stream(
    {"prompt": "abc", "max_new_tokens": 3, "temperature": 0.0})
    if c is not None for t in c["token_ids"]]
metrics = srv.metrics()
srv.stop()
extra = []
for kw in (dict(preset="tiny", weight_dtype="int8", act_dtype="int8",
                ragged_kernel="sparse"),
           dict(preset="tiny-moe", ragged_kernel="pallas")):
    s2 = TorchServer(max_slots=2, max_seq_len=64, prefill_chunk=16,
                     ragged=1, device="cpu", **kw)
    extra.append(s2.generate({"prompt": "abc", "max_new_tokens": 3,
                              "temperature": 0.8, "seed": 5})["token_ids"])
    s2.stop()
assert quantize.is_quantized(s2.params) is False
assert prng.key(torch.tensor([3])).tolist() == [[0, 3]]
nll = srv.predict([[5, 6, 7, 8], [9, 10, 11, 12]], names=[])
cfg = dataclasses.replace(srv.cfg, attn_impl="flash")
toks, lens = generate(srv.params, torch.tensor([[5, 6, 7], [8, 9, 0]]),
                      torch.tensor([3, 2]), torch.Generator().manual_seed(0),
                      torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                      torch.ones(2), cfg, 4)
def loaded(prefixes):
    return sorted(m for m in set(sys.modules) - before
                  if m in prefixes or m.startswith(tuple(p + "." for p in
                                                         prefixes)))
transports = loaded(("aiohttp", "grpc", "google.protobuf"))
import seldon_tpu_torch.runtime.fastpath
import seldon_tpu_torch.runtime.microservice
import seldon_tpu_torch.runtime.persistence
import seldon_tpu_torch.runtime.wrapper
from seldon_tpu_torch.core import openapi, payloads
bad = loaded(("jax", "jaxlib", "seldon_tpu"))
print(json.dumps({"tokens": out["token_ids"], "nll": nll.tolist(),
                  "generated": toks.tolist(), "extra": extra,
                  "streamed": streamed, "transports": transports,
                  "runtime": "grpc" in sys.modules, "bad": bad}))
"""


def test_runtime_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["tokens"], res
    assert len(res["nll"]) == 2
    assert [len(row) for row in res["generated"]] == [4, 4]
    assert all(1 <= len(t) <= 3 for t in res["extra"]), res["extra"]
    assert res["streamed"] == res["tokens"]
    assert res["transports"] == [], res["transports"]
    assert res["runtime"]
    assert res["bad"] == [], res["bad"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    files = sorted((ROOT / "seldon_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for sub in ("proto/prediction_pb2.py", "proto/prediction_grpc.py",
                "core/payloads.py", "core/http.py", "core/tracing.py",
                "core/openapi.py", "core/metrics.py",
                "runtime/wrapper.py", "runtime/microservice.py",
                "runtime/seldon_methods.py", "runtime/user_model.py",
                "runtime/metrics_server.py", "runtime/fastpath.py",
                "runtime/persistence.py"):
        assert f"seldon_tpu_torch/{sub}" in names, sub
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "seldon_tpu"), (path, mod)
