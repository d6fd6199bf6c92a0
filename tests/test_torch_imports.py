"""The port stands alone: seldon_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, checked in a fresh interpreter that
runs the tiny server (generate, generate_stream and predict; its waves
as the converged engine's programs, servers/wave_program and
ops/host_hooks), the
bucketed engines (the JAX server's defaults: the dense slab; paged with
speculative decoding on the kernel leg, n-gram and model drafters:
models/spec_decode and servers/spec_decode), the int8
W8A8 server on the sparse leg with sampled noise from models/prng.py,
tiny-moe, and the whole-batch generate on the flash path, then imports
the serving runtime (wrapper, CLI, fast lane, persistence) and the
orchestrator (spec, units, client, walker, batcher, request logger,
engine server, with native and core.annotations) and walks a hardcoded
graph, then serves the tiny weights with the prefix cache from an HF
checkpoint written by chip_smoke's writer (servers/prefix_cache,
storage, tokenizer and hf_loader, with neither the safetensors nor the
transformers package loaded), then from an orbax directory the port's
save_checkpoint wrote and from the committed JAX-written fixture
(servers/checkpoint, ocdbt, zarr_v2, zstd, with neither zstandard,
tensorstore nor orbax loaded), then serves the tiny weights with every
ledger of the observatory armed and its lattice warmed (shape_lattice,
compile_ledger, flight_recorder, hbm_ledger, cost_model, sched_ledger,
controller), then serves it with supervised recovery and fault injection
armed (servers/supervisor, servers/chaos) and imports the client, the
load generator, the contract tester and the graph components, then
scores an XGBoost model.json (ops/trees, servers/xgboostserver) and a
fitted isolation forest (components/outliers_learned), imports the other
prepackaged servers, proxies and explainers, serves the tiny weights
with the runtime sanitizer armed (servers/graftsan, lock_order) and at
tp=2 on two spawned CPU ranks (models/tp_sharding, parallel/*,
servers/mesh_engine), and in the source text. Serving itself loads no transport
library: TorchServer and everything it imports run without aiohttp,
grpc and protobuf."""

import ast
import json
import os

import numpy as np
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
# The converged engine's waves ran as its programs (servers/wave_program).
from seldon_tpu_torch.servers import wave_program
program_runs = srv.engine._programs.runs
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
# The prefix cache, and checkpoint loading from a model_uri: the tiny
# weights written as an HF checkpoint by chip_smoke's own writer.
import os
import chip_smoke
from seldon_tpu_torch.servers import hf_loader, prefix_cache, storage
ckpt = os.environ["PROBE_CKPT_DIR"]
chip_smoke.write_hf_checkpoint(srv.params, srv.cfg, ckpt)
s3 = TorchServer(model_uri="file://" + ckpt, max_slots=2, max_seq_len=64,
                 prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                 prefix_cache=1, device="cpu")
prompt = {"prompt_token_ids": list(range(5, 23)), "max_new_tokens": 3,
          "temperature": 0.0}
warm = [s3.generate(prompt)["token_ids"] for _ in range(2)]
s3.stop()
same_weights = all(torch.equal(a, b) for a, b in zip(
    s3.params.parameters(), srv.params.parameters()))
prefix_hits = s3.engine.stats.snapshot()["prefix_hits"]
# An orbax checkpoint directory: the tiny weights saved by the port's
# save_checkpoint, then the committed JAX-written fixture (its own
# zstd, OCDBT and zarr readers; no zstandard, tensorstore or orbax).
from seldon_tpu_torch.servers import checkpoint, ocdbt, zarr_v2, zstd
odir = os.path.join(ckpt, "orbax")
checkpoint.save_checkpoint(odir, srv.params, srv.cfg)
fixture = os.environ["PROBE_ORBAX_FIXTURE"]
with open(os.path.join(fixture, "record.json")) as f:
    record = json.load(f)
orbax_tokens = []
for d, p in ((odir, prompt["prompt_token_ids"]),
             ("file://" + fixture, record["prompts"][0])):
    s9 = TorchServer(model_uri=d, max_slots=2, max_seq_len=64,
                     prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                     device="cpu")
    orbax_tokens.append(s9.generate(dict(prompt, prompt_token_ids=p,
                                         max_new_tokens=8))["token_ids"])
    if d == odir:
        orbax_same = all(torch.equal(a, b) for a, b in zip(
            s9.params.parameters(), srv.params.parameters()))
    s9.stop()
assert prng.key(torch.tensor([3])).tolist() == [[0, 3]]
nll = srv.predict([[5, 6, 7, 8], [9, 10, 11, 12]], names=[])
cfg = dataclasses.replace(srv.cfg, attn_impl="flash")
toks, lens = generate(srv.params, torch.tensor([[5, 6, 7], [8, 9, 0]]),
                      torch.tensor([3, 2]), prng.key(torch.tensor(0)),
                      torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                      torch.ones(2), cfg, 4)
# The bucketed engines and speculative decoding.
from seldon_tpu_torch.models import spec_decode
from seldon_tpu_torch.servers import spec_decode as spec_host
bucketed = []
for kw in (dict(), dict(spec=1, ragged_kernel="pallas"),
           dict(spec=1, spec_draft="tiny")):
    s4 = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                     device="cpu", **kw)
    bucketed.append(s4.generate({"prompt": "abcabcabc", "max_new_tokens": 4,
                                 "temperature": 0.0})["token_ids"])
    s4.stop()
# The observatory: every ledger armed, the lattice warmed.
knobs = ("FLIGHT_RECORDER", "COMPILE_LEDGER", "DISPATCH_TIMING",
         "HBM_LEDGER", "SCHED_LEDGER", "ROOF_LEDGER", "PILOT")
os.environ.update({k: "1" for k in knobs})
s5 = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                 prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                 warmup=1, device="cpu")
s5.generate({"prompt": "abc", "max_new_tokens": 3, "temperature": 0.0})
observed = sorted(k for k in ("timeline", "compile", "hbm", "sched",
                              "pilot", "roof")
                  if getattr(s5, "debug_" + k)() is not None)
retraces = s5.debug_compile()["live_retrace_count"]
s5.stop()
for k in knobs:
    del os.environ[k]
# Supervised recovery under injected dispatch faults.
heal_knobs = {"HEAL": "1", "CHAOS": "1", "CHAOS_DISPATCH_FAIL": "0.2"}
os.environ.update(heal_knobs)
s6 = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                 prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                 device="cpu")
healed = s6.generate({"prompt": "abc", "max_new_tokens": 3,
                      "temperature": 0.0})["token_ids"]
heal_enabled = s6.debug_health()["enabled"]
s6.stop()
for k in heal_knobs:
    del os.environ[k]
def loaded(prefixes):
    return sorted(m for m in set(sys.modules) - before
                  if m in prefixes or m.startswith(tuple(p + "." for p in
                                                         prefixes)))
transports = loaded(("aiohttp", "grpc", "google.protobuf"))
readers = loaded(("safetensors", "transformers", "zstandard", "tensorstore",
                  "orbax"))
import seldon_tpu_torch.runtime.fastpath
import seldon_tpu_torch.runtime.microservice
import seldon_tpu_torch.runtime.persistence
import seldon_tpu_torch.runtime.wrapper
from seldon_tpu_torch.core import openapi, payloads
import seldon_tpu_torch.native
from seldon_tpu_torch.core import annotations
from seldon_tpu_torch.orchestrator import (batcher, client, reqlogger, server,
                                           spec, units, walker)
graph = spec.load_predictor_spec(env_var="NO_SUCH_ENV",
                                 fallback_path="/nonexistent")
answer = walker.PredictorEngine(graph).predict_sync(
    payloads.build_message([[1.0, 2.0]]))
orchestrated = list(answer.meta.requestPath)
from seldon_tpu_torch import client as sdk_client, components, loadtester
from seldon_tpu_torch.runtime import tester
from seldon_tpu_torch.servers import chaos, supervisor
# The prepackaged servers and learned components: an XGBoost model.json
# and a fitted isolation forest scored, the sanitizer armed on an engine.
import numpy as np
from seldon_tpu_torch.components import (IsolationForestDetector,
                                         explainers, outliers_learned)
from seldon_tpu_torch.ops import trees
from seldon_tpu_torch.servers import (graftsan, lock_order, mlflowserver,
                                      sagemakerproxy, sklearnserver, tfproxy,
                                      xgboostserver)
xdir = os.path.join(ckpt, "xgb")
os.makedirs(xdir)
with open(os.path.join(xdir, "model.json"), "w") as f:
    json.dump({"objective": "binary:logistic", "base_score": 0.5,
               "trees": [{"nodeid": 0, "split": "f1", "split_condition": 1.0,
                          "yes": 1, "no": 2, "children": [
                              {"nodeid": 1, "leaf": 0.5},
                              {"nodeid": 2, "leaf": -0.5}]}]}, f)
xgb = xgboostserver.XGBoostServer(model_uri=xdir, device="cpu")
xgb_out = xgb.predict(np.array([[0.0, 0.0], [0.0, 2.0]], np.float32),
                      []).tolist()
rows = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
forest = IsolationForestDetector(n_trees=10, seed=0, device="cpu").fit(rows)
forest_out = forest.predict(rows[:3], []).tolist()
os.environ["GRAFTSAN"] = "1"
s7 = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                 prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                 device="cpu")
sanitized = s7.generate({"prompt": "abc", "max_new_tokens": 3,
                         "temperature": 0.0})["token_ids"]
san_clean = s7.engine._san is not None and not s7.engine._san.violations
s7.stop()
del os.environ["GRAFTSAN"]
# Exact tensor parallelism on two spawned CPU ranks (gloo), and the
# rank-group modules beside it.
from seldon_tpu_torch.models import tp_sharding
from seldon_tpu_torch.parallel import distributed, mesh, ring_attention
from seldon_tpu_torch.servers import mesh_engine
s8 = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                 prefill_chunk=16, ragged=1, ragged_kernel="pallas", tp=2,
                 device="cpu")
tp_tokens = s8.generate({"prompt": "abc", "max_new_tokens": 3,
                         "temperature": 0.0})["token_ids"]
tp_route = s8.engine.mesh_info()["route"]
s8.stop()
bad = loaded(("jax", "jaxlib", "seldon_tpu"))
print(json.dumps({"tokens": out["token_ids"], "nll": nll.tolist(),
                  "generated": toks.tolist(), "extra": extra,
                  "streamed": streamed, "transports": transports,
                  "runtime": "grpc" in sys.modules,
                  "orchestrated": orchestrated, "bad": bad,
                  "warm": warm, "same_weights": same_weights,
                  "prefix_hits": prefix_hits, "readers": readers,
                  "bucketed": bucketed, "observed": observed,
                  "retraces": retraces, "healed": healed,
                  "heal_enabled": heal_enabled, "xgb": xgb_out,
                  "xgb_backend": xgb.tags()["backend"],
                  "forest": forest_out, "sanitized": sanitized,
                  "san_clean": san_clean, "tp_tokens": tp_tokens,
                  "tp_route": tp_route, "orbax_tokens": orbax_tokens,
                  "program_runs": program_runs,
                  "orbax_same": orbax_same,
                  "orbax_record": record["streams"][0]}))
"""


def test_runtime_imports_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PROBE_CKPT_DIR=str(tmp_path / "ckpt"),
               PROBE_ORBAX_FIXTURE=str(ROOT / "tests" / "data" /
                                       "torch_orbax_tiny_bf16"))
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["tokens"], res
    assert res["program_runs"] > 0, res
    assert len(res["nll"]) == 2
    assert [len(row) for row in res["generated"]] == [4, 4]
    assert all(1 <= len(t) <= 3 for t in res["extra"]), res["extra"]
    assert res["streamed"] == res["tokens"]
    assert res["transports"] == [], res["transports"]
    assert res["runtime"]
    assert res["orchestrated"] == ["simple-model"]
    assert res["bad"] == [], res["bad"]
    assert res["warm"][0] == res["warm"][1] and res["warm"][0], res["warm"]
    assert res["same_weights"] and res["prefix_hits"] == 1
    assert res["readers"] == [], res["readers"]
    assert res["bucketed"][0] == res["bucketed"][1] == res["bucketed"][2]
    assert res["bucketed"][0], res["bucketed"]
    assert res["observed"] == ["compile", "hbm", "pilot", "roof", "sched",
                               "timeline"], res["observed"]
    assert res["retraces"] == 0
    assert res["healed"] == res["tokens"] and res["heal_enabled"]
    sig = [1 / (1 + np.exp(-0.5)), 1 / (1 + np.exp(0.5))]
    np.testing.assert_allclose(res["xgb"], sig, rtol=1e-6)
    assert res["xgb_backend"] == "torch-trees"
    assert len(res["forest"]) == 3 and all(0 < v <= 1 for v in res["forest"])
    assert res["sanitized"] == res["tokens"] and res["san_clean"]
    assert res["tp_tokens"] == res["tokens"] and res["tp_route"] == "gloo"
    assert res["orbax_same"]
    assert res["orbax_tokens"][0][:3] == res["warm"][0], res["orbax_tokens"]
    assert res["orbax_tokens"][1] == res["orbax_record"], res["orbax_tokens"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    files = sorted((ROOT / "seldon_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_smoke_unit.py"]
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for sub in ("proto/prediction_pb2.py", "proto/prediction_grpc.py",
                "core/payloads.py", "core/http.py", "core/tracing.py",
                "core/openapi.py", "core/metrics.py",
                "runtime/wrapper.py", "runtime/microservice.py",
                "runtime/seldon_methods.py", "runtime/user_model.py",
                "runtime/metrics_server.py", "runtime/fastpath.py",
                "runtime/persistence.py", "native/__init__.py",
                "core/annotations.py", "orchestrator/__init__.py",
                "orchestrator/spec.py", "orchestrator/units.py",
                "orchestrator/client.py", "orchestrator/walker.py",
                "orchestrator/batcher.py", "orchestrator/reqlogger.py",
                "orchestrator/server.py", "servers/prefix_cache.py",
                "servers/storage.py", "servers/hf_loader.py",
                "servers/tokenizer.py", "models/spec_decode.py",
                "servers/spec_decode.py", "servers/shape_lattice.py",
                "servers/compile_ledger.py", "servers/flight_recorder.py",
                "servers/hbm_ledger.py", "servers/cost_model.py",
                "servers/sched_ledger.py", "servers/controller.py",
                "client.py", "loadtester.py", "runtime/tester.py",
                "components/__init__.py", "components/routers.py",
                "components/outliers.py", "servers/chaos.py",
                "servers/supervisor.py", "servers/lock_order.py",
                "servers/graftsan.py", "ops/trees.py",
                "servers/xgboostserver.py", "servers/sklearnserver.py",
                "servers/mlflowserver.py", "servers/tfproxy.py",
                "servers/sagemakerproxy.py",
                "components/outliers_learned.py",
                "components/explainers.py", "models/tp_sharding.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/distributed.py", "parallel/ring_attention.py",
                "servers/mesh_engine.py", "data/__init__.py",
                "data/loader.py", "operator/__init__.py",
                "operator/types.py", "operator/webhook.py",
                "operator/credentials.py", "operator/reconciler.py",
                "operator/localstore.py", "operator/kubestore.py",
                "operator/controller.py", "packaging.py",
                "models/train.py", "parallel/sharding.py",
                "parallel/pipeline.py", "ops/lt_gemm.py",
                "servers/dp_replicas.py", "servers/checkpoint.py",
                "servers/ocdbt.py", "servers/zarr_v2.py", "servers/zstd.py"):
        assert f"seldon_tpu_torch/{sub}" in names, sub
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "seldon_tpu"), (path, mod)


CONTROL_PROBE = r"""
import importlib, json, subprocess, sys
before = set(sys.modules)
import numpy as np
from seldon_tpu_torch import native, packaging
from seldon_tpu_torch.data import TokenDataLoader, write_token_shard
from seldon_tpu_torch.operator import (InMemoryStore, Reconciler,
                                       SeldonDeployment, controller,
                                       credentials, kubestore, localstore)
fused = native.fuse_rows([np.ones((1, 2), np.float32)] * 3).shape
shard = write_token_shard(sys.argv[1], list(range(300)))
dl = TokenDataLoader([shard], batch_size=2, seq_len=8, seed=1)
batch = next(dl).shape
dl.close()
cr = packaging.render_template("single-model", name="m",
                               implementation="JAX_SERVER",
                               model_uri="file:///nonexistent")
cr["spec"]["predictors"][0]["graph"]["children"] = [
    {"name": "t", "type": "MODEL", "image": "local/pkg.Unit:1"}]
state = Reconciler(InMemoryStore()).reconcile(
    SeldonDeployment.from_dict(json.loads(json.dumps(cr)))).state
# The commands the spawned pods run, as the local store builds them (the
# spawn itself replaced by a recorder; the model download resolved).
spawned = []
class Recorder:
    def __init__(self, cmd, **kw):
        spawned.append(cmd)
    def poll(self):
        return None
localstore.subprocess.Popen = Recorder
store = localstore.LocalProcessStore()
Reconciler(store, istio_enabled=False).reconcile(
    SeldonDeployment.from_dict(json.loads(json.dumps(cr))))
manifest = next(iter(store.manifests.values()))
inits = [c["command"] for c in manifest["spec"]["template"]["spec"][
    "initContainers"]]
modules = sorted({c[c.index("-m") + 1] for c in spawned + inits})
classes = sorted({c[c.index("-m") + 2] for c in spawned
                  if c[c.index("-m") + 1].endswith("microservice")})
for mod in modules:
    importlib.import_module(mod)
for path in classes:
    if not path.startswith("pkg."):
        mod, cls = path.rsplit(".", 1)
        getattr(importlib.import_module(mod), cls)
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "seldon_tpu"))
print(json.dumps({"fused": fused, "batch": batch, "state": state,
                  "modules": modules, "classes": classes,
                  "interpreters": sorted({c[0] for c in spawned}),
                  "bad": bad, "executable": sys.executable}))
"""


def test_control_plane_imports_no_jax(tmp_path):
    """The native libraries, the loader, the operator and packaging, and
    every module the local store's pods run (the unit microservice, the
    engine, the model initializer, the prepackaged server class), in a
    fresh interpreter: none loads jax or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", CONTROL_PROBE,
                           str(tmp_path / "shard.bin")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["fused"] == [3, 2] and res["batch"] == [2, 9]
    assert res["state"] == "Available"
    assert res["modules"] == ["seldon_tpu_torch.orchestrator.server",
                              "seldon_tpu_torch.runtime.microservice",
                              "seldon_tpu_torch.servers.storage"]
    assert res["classes"] == [
        "pkg.Unit", "seldon_tpu_torch.servers.torchserver.TorchServer"]
    assert res["interpreters"] == [res["executable"]]
    assert res["bad"] == [], res["bad"]


TRAIN_PROBE = r"""
import json, sys
before = set(sys.modules)
import numpy as np
from seldon_tpu_torch.models import train
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.parallel import (make_pipeline_forward, mesh,
                                       param_pspecs, pp_param_pspecs,
                                       sharding)
cfg = get_config("tiny")
init_fn, step_fn = train.make_sharded_train_step(
    mesh.make_mesh(mesh.MeshPlan(), ["cpu"]), cfg,
    train.make_optimizer(total_steps=10), device="cpu")
state = init_fn(0)
rng = np.random.default_rng(0)
tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
losses = []
for _ in range(2):
    state, m = step_fn(state, tokens, np.ones((2, 16), np.float32))
    losses.append(m["loss"])
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "seldon_tpu"))
print(json.dumps({"losses": losses, "step": state.step, "bad": bad}))
"""


def test_training_imports_no_jax():
    """The training step, its tables and the pipeline in a fresh
    interpreter: two tiny steps on the CPU load neither jax nor the JAX
    package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", TRAIN_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["step"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    assert res["bad"] == [], res["bad"]
