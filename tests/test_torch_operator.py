"""The port's control plane (seldon_tpu_torch/operator) against the JAX
package's (seldon_tpu/operator): every CR fixture of tests/test_operator.py
and tests/test_credentials.py goes through both packages. The defaulted
CRs must be equal, the validation errors equal, and the port's manifests
equal to `translate(jax_manifests)`: the translation table of
seldon_tpu_torch/operator/__init__.py and nothing else. The stale-
generation GC's sequence of InMemoryStore calls must be equal too."""

import base64
import copy
import importlib
import json

import pytest

from seldon_tpu.operator import credentials as jc
from seldon_tpu.operator import reconciler as jr
from seldon_tpu.operator import types as jt
from seldon_tpu.operator import webhook as jw
from seldon_tpu_torch.operator import credentials as pc
from seldon_tpu_torch.operator import reconciler as pr
from seldon_tpu_torch.operator import types as pt
from seldon_tpu_torch.operator import webhook as pw

# -- the translation table ---------------------------------------------------

MODULES = {
    "seldon_tpu.runtime.microservice": "seldon_tpu_torch.runtime.microservice",
    "seldon_tpu.servers.storage": "seldon_tpu_torch.servers.storage",
    "seldon_tpu.orchestrator.server": "seldon_tpu_torch.orchestrator.server",
}
CLASSES = {
    "seldon_tpu.servers.sklearnserver.SKLearnServer":
        "seldon_tpu_torch.servers.sklearnserver.SKLearnServer",
    "seldon_tpu.servers.xgboostserver.XGBoostServer":
        "seldon_tpu_torch.servers.xgboostserver.XGBoostServer",
    "seldon_tpu.servers.mlflowserver.MLFlowServer":
        "seldon_tpu_torch.servers.mlflowserver.MLFlowServer",
    "seldon_tpu.servers.tfproxy.TFServingProxy":
        "seldon_tpu_torch.servers.tfproxy.TFServingProxy",
    "seldon_tpu.servers.jaxserver.JAXServer":
        "seldon_tpu_torch.servers.torchserver.TorchServer",
}
TPU_TOPOLOGY = "cloud.google.com/gke-tpu-topology"
TPU_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"


def translate(obj):
    """A JAX-package manifest (or call record) as the port must emit it."""
    if isinstance(obj, dict):
        if TPU_ACCELERATOR in obj:  # the TPU node selector
            assert set(obj) <= {TPU_ACCELERATOR, TPU_TOPOLOGY}, obj
            acc = obj[TPU_ACCELERATOR]
            return {"cloud.google.com/gke-accelerator":
                    "nvidia-h100-80gb" if acc.startswith("tpu-") else acc}
        return {("nvidia.com/gpu" if k == "google.com/tpu" else k):
                translate(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(translate(v) for v in obj)
    if isinstance(obj, str):
        return MODULES.get(obj, CLASSES.get(obj, obj))
    return obj


def test_prepackaged_classes_are_the_ports_servers():
    assert set(pw.PREPACKAGED_CLASSES) == set(jw.PREPACKAGED_CLASSES)
    assert pw.PREPACKAGED == jw.PREPACKAGED
    for impl, path in jw.PREPACKAGED_CLASSES.items():
        assert pw.PREPACKAGED_CLASSES[impl] == CLASSES[path]
        mod, cls = CLASSES[path].rsplit(".", 1)
        assert isinstance(getattr(importlib.import_module(mod), cls), type)


# -- CR fixtures (tests/test_operator.py) -------------------------------------


def _cr(name="mymodel", generation=1, tpu=None, predictors=None,
        annotations=None):
    pred = {
        "name": "main",
        "replicas": 1,
        "graph": {
            "name": "classifier",
            "type": "MODEL",
            "implementation": "JAX_SERVER",
            "modelUri": "file:///models/demo",
        },
    }
    if tpu:
        pred["tpu"] = tpu
    return {
        "metadata": {"name": name, "namespace": "test",
                     "generation": generation,
                     "annotations": dict(annotations or {})},
        "spec": {"predictors": predictors or [pred]},
    }


def _simple(name, traffic=None, unit="m"):
    p = {"name": name,
         "graph": {"name": unit, "implementation": "SIMPLE_MODEL"}}
    if traffic is not None:
        p["traffic"] = traffic
    return p


_JAX_CLF = {"name": "clf", "type": "MODEL", "implementation": "JAX_SERVER",
            "modelUri": "file:///m"}

FIXTURES = {
    "default": _cr(),
    "uid_owner_refs": dict(_cr(), metadata=dict(
        _cr()["metadata"], uid="1234-abcd")),
    "tpu_placement": _cr(tpu={"chips": 4, "topology": "2x2",
                              "accelerator": "tpu-v5-lite-podslice"}),
    "gpu_accelerator_named": _cr(tpu={"chips": 2,
                                      "accelerator": "nvidia-a100-80gb"}),
    "accelerator_annotations": _cr(
        tpu={"chips": 1},
        annotations={"seldon.io/tpu-topology": "1x1",
                     "seldon.io/tpu-accelerator": "tpu-v6e-slice"}),
    "multihost": _cr(tpu={"chips": 4, "topology": "2x4", "hosts": 2}),
    "multihost_no_topology": _cr(tpu={"chips": 4, "hosts": 2}),
    "zero_hosts": _cr(tpu={"chips": 4, "topology": "2x4", "hosts": 0}),
    "fastpath_stride": _cr(predictors=[{
        "name": "main", "replicas": 1,
        "graph": {
            "name": "t", "type": "TRANSFORMER",
            "image": "seldon-tpu/microservice:0.1.0",
            "children": [{"name": "m", "type": "MODEL",
                          "image": "other-registry/foreign:1"}],
        },
    }]),
    "foreign_fastpath_annotation": _cr(
        predictors=[{"name": "main", "replicas": 1,
                     "graph": {"name": "m", "type": "MODEL",
                               "image": "other-registry/foreign:1"}}],
        annotations={"seldon.io/fastpath": "true"}),
    "native_fastpath_off": _cr(annotations={"seldon.io/fastpath": "false"}),
    "separate_engine": _cr(
        annotations={"seldon.io/engine-separate-pod": "true"}),
    "missing_model_uri": dict(_cr(), spec={"predictors": [{
        "name": "main", "replicas": 1,
        "graph": {"name": "classifier", "type": "MODEL",
                  "implementation": "JAX_SERVER"}}]}),
    "traffic_over": _cr(predictors=[_simple("a", 50), _simple("b", 40)]),
    "duplicate_predictors": _cr(predictors=[_simple("a"), _simple("a")]),
    "no_predictors": dict(_cr(), spec={"predictors": []}),
    "istio_weights": _cr(predictors=[_simple("a", 75, "m1"),
                                     _simple("b", 25, "m2")]),
    "ambassador_shadow_headers": _cr(annotations={
        "seldon.io/ambassador-shadow": "true",
        "seldon.io/ambassador-header": "x-team: ml : x-env:prod",
        "seldon.io/ambassador-regex-header": "x-user: canary-.*",
        "seldon.io/ambassador-service-name": "extname",
        "seldon.io/ambassador-id": "amb-a"}),
    "ambassador_custom": _cr(
        annotations={"seldon.io/ambassador-config": "my: config\n"}),
    "traffic_default": _cr(predictors=[_simple("a", unit="m1"),
                                       _simple("b", unit="m2")]),
    "canary_traffic": _cr(predictors=[_simple("main", unit="m1"),
                                      _simple("canary", 10, "m2")]),
    "two_prepackaged": _cr(predictors=[{
        "name": "p",
        "graph": {
            "name": "top", "type": "MODEL",
            "implementation": "SKLEARN_SERVER",
            "modelUri": "file:///models/a",
            "children": [{"name": "leaf", "type": "MODEL",
                          "implementation": "XGBOOST_SERVER",
                          "modelUri": "file:///models/b"}],
        },
    }]),
    "every_prepackaged": _cr(predictors=[{
        "name": "p",
        "graph": {
            "name": "comb", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [
                {"name": f"u{i}", "type": "MODEL", "implementation": impl,
                 "modelUri": f"gs://bucket/{i}"}
                for i, impl in enumerate(
                    ("SKLEARN_SERVER", "XGBOOST_SERVER", "MLFLOW_SERVER",
                     "TENSORFLOW_SERVER", "JAX_SERVER"))],
        },
    }]),
    "multihost_env": _cr(predictors=[{
        "name": "p",
        "graph": {
            "name": "pre", "type": "TRANSFORMER",
            "endpoint": {"service_port": 9500, "type": "GRPC"},
            "image": "user/transformer:1",
            "children": [{"name": "llm", "type": "MODEL",
                          "implementation": "JAX_SERVER",
                          "modelUri": "file:///models/llm"}],
        },
        "tpu": {"chips": 4, "topology": "2x4", "hosts": 2},
    }]),
    "multihost_no_gpu_unit": _cr(predictors=[{
        "name": "p",
        "graph": {"name": "pre", "type": "MODEL",
                  "image": "user/model:1"},
        "tpu": {"chips": 4, "topology": "2x4", "hosts": 2},
    }]),
    "resources_override": _cr(predictors=[{
        "name": "main", "graph": dict(_JAX_CLF),
        "tpu": {"chips": 1},
        "resources": {"clf": {"limits": {"memory": "64Gi"},
                              "requests": {"cpu": "4"}}},
    }]),
    "hpa": _cr(predictors=[{
        "name": "main", "replicas": 1, "graph": dict(_JAX_CLF),
        "hpaSpec": {"minReplicas": 1, "maxReplicas": 5, "metrics": [
            {"type": "Resource", "resource": {
                "name": "cpu", "target": {"type": "Utilization",
                                          "averageUtilization": 60}}}]},
    }]),
    "hpa_default_metric": _cr(predictors=[{
        "name": "main", "graph": dict(_JAX_CLF),
        "hpaSpec": {"maxReplicas": 3}}]),
    "hpa_multihost": _cr(predictors=[{
        "name": "main", "graph": dict(_JAX_CLF),
        "tpu": {"chips": 4, "topology": "2x4", "hosts": 2},
        "hpaSpec": {"maxReplicas": 3}}]),
    "explainer": _cr(predictors=[{
        "name": "main", "replicas": 1, "graph": dict(_JAX_CLF),
        "explainer": {"type": "anchor_tabular",
                      "modelUri": "gs://bucket/explainer"},
    }]),
    "explainer_rest_no_uri": _cr(predictors=[{
        "name": "main", "replicas": 1, "graph": dict(_JAX_CLF),
        "explainer": {"type": "anchor_images",
                      "endpoint": {"type": "REST", "servicePort": 9100}},
    }]),
    "podinfo_annotation": _cr(
        annotations={"seldon.io/rest-read-timeout": "9000"}),
    "long_names": _cr(name="a" * 70, predictors=[{
        "name": "predictor-with-a-rather-long-name-" + "x" * 20,
        "graph": dict(_JAX_CLF, name="unit_" + "y" * 40)}]),
    "service_account": _cr(predictors=[{
        "name": "p", "serviceAccountName": "model-sa",
        "graph": {"name": "clf", "implementation": "SKLEARN_SERVER",
                  "modelUri": "s3://bucket/model"}}]),
}


def _both(d):
    return (jt.SeldonDeployment.from_dict(copy.deepcopy(d)),
            pt.SeldonDeployment.from_dict(copy.deepcopy(d)))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_defaulted_cr_equal(name):
    j, p = _both(FIXTURES[name])
    assert p.to_dict() == j.to_dict()
    jw.default_deployment(j)
    pw.default_deployment(p)
    assert p.to_dict() == j.to_dict()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_validation_errors_equal(name):
    j, p = _both(FIXTURES[name])
    jw.default_deployment(j)
    pw.default_deployment(p)
    assert pw.validate_deployment(p) == jw.validate_deployment(j)


@pytest.mark.parametrize("istio", [True, False])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_manifests_equal_translated(name, istio):
    j, p = _both(FIXTURES[name])
    js, ps = jr.InMemoryStore(), pr.InMemoryStore()
    jstat = jr.Reconciler(js, istio_enabled=istio).reconcile(j)
    pstat = pr.Reconciler(ps, istio_enabled=istio).reconcile(p)
    assert (pstat.state, pstat.description) == (jstat.state,
                                                jstat.description)
    assert ps.objects == translate(js.objects)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_ingress_config_equal(name):
    j, p = _both(FIXTURES[name])
    jw.default_deployment(j)
    pw.default_deployment(p)
    assert pr.ambassador_annotations(p) == jr.ambassador_annotations(j)
    assert pr.build_istio_manifests(p) == jr.build_istio_manifests(j)


def test_gpu_placement_reads_as_the_table_says():
    _, p = _both(FIXTURES["tpu_placement"])
    store = pr.InMemoryStore()
    pr.Reconciler(store).reconcile(p)
    pod = store.list("Deployment", "test")[0]["spec"]["template"]["spec"]
    assert pod["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    unit = next(c for c in pod["containers"] if c["name"] == "classifier")
    assert unit["resources"]["limits"] == {"nvidia.com/gpu": 4}
    assert unit["resources"]["requests"] == {"nvidia.com/gpu": 4}
    assert unit["command"] == [
        "python", "-m", "seldon_tpu_torch.runtime.microservice",
        "seldon_tpu_torch.servers.torchserver.TorchServer"]
    text = json.dumps(list(store.objects.values()))
    assert "google.com/tpu" not in text and "gke-tpu" not in text
    assert "seldon_tpu." not in text


def test_machine_names_equal():
    for parts in (("a" * 100, "b"), ("MyModel", "p"), ("x_y", "", "z")):
        assert pt.machine_name(*parts) == jt.machine_name(*parts)
    assert pr._parse_header_annotation("a:b:c") == \
        jr._parse_header_annotation("a:b:c")


# -- credential fixtures (tests/test_credentials.py) ---------------------------

KF = "serving.kubeflow.org"
SELDON = "machinelearning.seldon.io"


def _b64(s):
    return base64.b64encode(s.encode()).decode()


def _secret(name, data, annotations=None):
    return {"apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": name, "namespace": "default",
                         "annotations": annotations or {}},
            "data": {k: _b64(v) for k, v in data.items()}}


def _sa(name, secret_names):
    return {"apiVersion": "v1", "kind": "ServiceAccount",
            "metadata": {"name": name, "namespace": "default"},
            "secrets": [{"name": n} for n in secret_names]}


def _cm(ns, credentials):
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "seldon-config", "namespace": ns},
            "data": {"credentials": credentials}}


S3 = {"awsAccessKeyID": "k", "awsSecretAccessKey": "s"}
GCS = {"gcloud-application-credentials.json": "{}"}

STORES = {
    "s3_endpoint": [_secret("s3-secret", S3,
                            {SELDON + "/s3-endpoint": "minio:9000"}),
                    _sa("model-sa", ["s3-secret"])],
    "s3_kubeflow_https": [_secret("s3-secret", S3, {
        KF + "/s3-endpoint": "s3.aws.com", KF + "/s3-usehttps": "0",
        KF + "/s3-verifyssl": "0", KF + "/s3-region": "eu-west-1"}),
        _sa("model-sa", ["s3-secret"])],
    "gcs": [_secret("gcs-secret", GCS), _sa("model-sa", ["gcs-secret"])],
    "no_sa": [],
    "ghost_secret": [_sa("model-sa", ["ghost-secret"])],
    "first_match_wins": (
        [_secret(n, GCS) for n in ("gcs-a", "gcs-b")]
        + [_secret(n, S3) for n in ("s3-a", "s3-b")]
        + [_sa("model-sa", ["gcs-a", "gcs-b", "s3-a", "s3-b"])]),
    "non_matching": [_secret("token-secret", {"token": "abc"}),
                     _sa("model-sa", ["token-secret"])],
    "nameless_ref": [dict(_sa("model-sa", []), secrets=[{}])],
    "configmap_gcs_filename": [
        _cm("seldon-system", '{"gcs": {"gcsCredentialFileName": "sa.json"}}'),
        _secret("gcs-secret", {"sa.json": "{}"}),
        _sa("model-sa", ["gcs-secret"])],
    "configmap_s3_endpoint_and_keys": [
        _cm("default", json.dumps({"s3": {
            "s3AccessKeyIDName": "id", "s3SecretAccessKeyName": "key",
            "s3Endpoint": "cm-endpoint:9000", "s3UseHttps": "0"}})),
        _secret("s3-secret", {"id": "k", "key": "s"}),
        _sa("model-sa", ["s3-secret"])],
}


@pytest.mark.parametrize("store_name", sorted(STORES))
def test_credentials_manifests_equal_translated(store_name):
    sdep = {"metadata": {"name": "dep", "namespace": "default"},
            "spec": {"predictors": [{
                "name": "p", "serviceAccountName": "model-sa",
                "graph": {"name": "clf", "implementation": "SKLEARN_SERVER",
                          "modelUri": "s3://bucket/model"}}]}}
    j, p = _both(sdep)
    js, ps = jr.InMemoryStore(), pr.InMemoryStore()
    for obj in STORES[store_name]:
        js.apply(copy.deepcopy(obj))
        ps.apply(copy.deepcopy(obj))
    jb = jc.CredentialBuilder.from_store(js)
    pb = pc.CredentialBuilder.from_store(ps)
    assert pb.config == pc.CredentialConfig(
        s3=pc.S3Config(**vars(jb.config.s3)),
        gcs=pc.GCSConfig(**vars(jb.config.gcs)))
    got = pr.build_predictor_manifests(p, p.predictors[0], pb)
    want = jr.build_predictor_manifests(j, j.predictors[0], jb)
    assert got == translate(want)
    jr.Reconciler(js).reconcile(j)
    pr.Reconciler(ps).reconcile(p)
    assert ps.objects == translate(js.objects)


@pytest.mark.parametrize("annotations,cfg", [
    ({KF + "/s3-endpoint": "s3.aws.com"}, {}),
    ({KF + "/s3-endpoint": "s3.aws.com", KF + "/s3-usehttps": "0",
      KF + "/s3-verifyssl": "0"}, {}),
    ({SELDON + "/s3-endpoint": "a", KF + "/s3-endpoint": "b",
      SELDON + "/s3-region": "r"}, {}),
    ({}, {"endpoint": "cm:9000", "use_https": "0",
          "access_key_id_name": "id", "secret_access_key_name": "key"}),
    ({}, {}),
])
def test_s3_envs_equal(annotations, cfg):
    secret = _secret("s3-secret", S3, annotations)
    assert pc.build_s3_envs(secret, pc.S3Config(**cfg)) == \
        jc.build_s3_envs(secret, jc.S3Config(**cfg))


def test_malformed_configmap_raises_equal():
    for mod_r, mod_c in ((jr, jc), (pr, pc)):
        store = mod_r.InMemoryStore()
        store.apply(_cm("seldon-system", "[1, 2]"))
        with pytest.raises(ValueError, match="malformed credentials"):
            mod_c.CredentialBuilder.from_store(store)


# -- the stale-generation GC: the store calls, in order -----------------------


def _recording(mod):
    class Recording(mod.InMemoryStore):
        def __init__(self):
            super().__init__()
            self.calls = []

        def apply(self, manifest):
            self.calls.append(("apply", manifest["kind"],
                               manifest["metadata"]["name"],
                               copy.deepcopy(manifest)))
            super().apply(manifest)

        def delete(self, kind, namespace, name):
            self.calls.append(("delete", kind, namespace, name))
            super().delete(kind, namespace, name)

        def list(self, kind, namespace, label_selector=None):
            out = super().list(kind, namespace, label_selector)
            self.calls.append(("list", kind, namespace,
                               dict(label_selector or {}),
                               [o["metadata"]["name"] for o in out]))
            return out

        def is_ready(self, kind, namespace, name):
            ready = super().is_ready(kind, namespace, name)
            self.calls.append(("is_ready", kind, namespace, name, ready))
            return ready

    return Recording()


def _gc_scenario(mod_r, mod_t, scenario):
    store = _recording(mod_r)
    rec = mod_r.Reconciler(store, istio_enabled=scenario != "no_istio")
    states = []

    def cr(gen, pred_name="main", explainer=True):
        pred = {"name": pred_name, "replicas": 1, "graph": dict(_JAX_CLF)}
        if explainer:
            pred["explainer"] = {"type": "anchor_tabular"}
        return mod_t.SeldonDeployment.from_dict(
            _cr(generation=gen, predictors=[pred]))

    states.append(rec.reconcile(cr(1)).state)
    if scenario == "explainer_dropped":
        states.append(rec.reconcile(cr(2, explainer=False)).state)
    else:
        sdep2 = cr(2, pred_name="canary")
        new = mod_t.predictor_deployment_name(sdep2, sdep2.predictors[0])
        store.not_ready.add(("Deployment", "test", new))
        states.append(rec.reconcile(sdep2).state)
        store.not_ready.clear()
        states.append(rec.reconcile(sdep2).state)
        if scenario == "separate_engine":
            sdep3 = cr(3, pred_name="v3")
            sdep3.annotations[mod_t.ANNOTATION_SEPARATE_ENGINE] = "true"
            states.append(rec.reconcile(sdep3).state)
    states.append(rec.delete_all("mymodel", "test"))
    return states, store.calls


@pytest.mark.parametrize("scenario", ["rolling_update", "no_istio",
                                      "explainer_dropped",
                                      "separate_engine"])
def test_gc_store_calls_equal(scenario):
    jstates, jcalls = _gc_scenario(jr, jt, scenario)
    pstates, pcalls = _gc_scenario(pr, pt, scenario)
    assert pstates == jstates
    assert pcalls == translate(jcalls)
    deletes = [c for c in pcalls if c[0] == "delete"]
    assert deletes, "the scenario deletes nothing"
    if scenario == "rolling_update":
        # The old engine-labelled workload goes last among the GC deletes
        # (before delete_all's sweep).
        gc = deletes[:next(i for i, c in enumerate(deletes)
                           if c[3].startswith("mymodel-canary"))]
        assert gc[-1][1] == "Deployment" and gc[-1][3] == "mymodel-main-0"
