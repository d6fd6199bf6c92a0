"""The port's KubeStore, controller loop and admission webhooks against
the JAX package's, on tests/test_kubestore.py's fake k8s API: the HTTP
requests each package sends (method, path, query, body) must be equal
after the translation table (tests/test_torch_operator.translate), and
the admission responses equal."""

import asyncio
import copy
import json
import threading

import pytest
import requests as rq
from aiohttp import web

from seldon_tpu.operator import controller as jctl
from seldon_tpu.operator import kubestore as jks
from seldon_tpu_torch.operator import controller as pctl
from seldon_tpu_torch.operator import kubestore as pks
from tests.test_kubestore import FakeKubeApi, _sdep_dict
from tests.test_torch_operator import FIXTURES, translate


class RecordingApi(FakeKubeApi):
    """The fake API server, logging every request it is sent."""

    def __init__(self):
        super().__init__()
        self.log = []

    async def handle(self, request):
        raw = await request.read()  # cached: the handler reads it again
        self.log.append((request.method, request.path,
                         sorted(request.query.items()),
                         json.loads(raw) if raw else None,
                         request.headers.get("Content-Type", "")
                         if raw else ""))
        return await super().handle(request)


class Served:
    """An aiohttp app on a background event loop (port 0)."""

    def __init__(self, app):
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def serve():
            asyncio.set_event_loop(self.loop)

            async def run():
                self.runner = web.AppRunner(app)
                await self.runner.setup()
                site = web.TCPSite(self.runner, "127.0.0.1", 0)
                await site.start()
                self.port = site._server.sockets[0].getsockname()[1]
                started.set()

            self.loop.run_until_complete(run())
            self.loop.run_forever()

        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()
        assert started.wait(5)
        self.url = f"http://127.0.0.1:{self.port}"

    def close(self):
        async def stop():
            await self.runner.cleanup()

        asyncio.run_coroutine_threadsafe(stop(), self.loop).result(5)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


@pytest.fixture()
def apis():
    pair = {}
    for name in ("jax", "torch"):
        api = RecordingApi()
        pair[name] = (api, Served(api.make_app()))
    yield pair
    for _, served in pair.values():
        served.close()


def _drive(mod_ks, mod_ctl, api, url):
    """One store and controller session: CRUD, resync, readiness, status,
    watch, credentials reads, delete_all. Returns what it observed."""
    store = mod_ks.KubeStore(base_url=url)
    seen = []
    dep = {"apiVersion": "apps/v1", "kind": "Deployment",
           "metadata": {"name": "d1", "namespace": "default",
                        "labels": {"app": "x"}},
           "spec": {"replicas": 2}}
    store.apply(copy.deepcopy(dep))
    store.apply(dict(copy.deepcopy(dep), spec={"template": {}}))  # HPA-owned
    seen.append(store.list("Deployment", "default", {"app": "x"}))
    seen.append(store.get("Deployment", "default", "d1"))
    seen.append(store.get("Deployment", "default", "absent"))
    seen.append(store.is_ready("Deployment", "default", "d1"))
    store.delete("Deployment", "default", "d1")
    store.delete("Deployment", "default", "d1")  # 404 tolerated
    with pytest.raises(mod_ks.KubeApiError):
        store.update_status("Deployment", "default", "nope", {"x": 1})

    prefix, plural = mod_ks.KIND_ROUTES["SeldonDeployment"]
    api.objects[(prefix, plural, "default", "mymodel")] = _sdep_dict()
    sa = {"apiVersion": "v1", "kind": "ServiceAccount",
          "metadata": {"name": "default", "namespace": "default"},
          "secrets": [{"name": "s3"}]}
    api.objects[("api/v1", "serviceaccounts", "default", "default")] = sa
    loop = mod_ctl.ControllerLoop(store, namespace="default",
                                  istio_enabled=True)
    seen.append(loop.resync())
    for obj in list(api.objects.values()):
        if obj.get("kind") == "Deployment":
            obj["status"] = {"readyReplicas": obj["spec"].get("replicas", 1)}
    seen.append(loop.resync())
    seen.append(api.objects[(prefix, plural, "default",
                             "mymodel")]["status"])
    # One watch cycle, as run() drives it.
    api.watch_events = [
        {"type": "ADDED", "object": _sdep_dict(name="watched")},
        {"type": "MODIFIED", "object": _sdep_dict(name="watched",
                                                  generation=2)},
        {"type": "DELETED", "object": _sdep_dict(name="watched")},
    ]
    for ev in store.watch("SeldonDeployment", "default",
                          resource_version=loop._list_rv, timeout_s=5):
        seen.append(ev["type"])
        if ev["type"] in ("ADDED", "MODIFIED"):
            seen.append(loop.reconcile_object(ev["object"]).state)
        else:
            seen.append(loop.reconciler.delete_all(
                ev["object"]["metadata"]["name"], "default"))
    seen.append(loop.reconciler.delete_all("mymodel", "default"))
    seen.append(sorted(k[1:] for k in api.objects))
    return seen


def test_kubestore_requests_equal(apis):
    (japi, jsrv), (papi, psrv) = apis["jax"], apis["torch"]
    jseen = _drive(jks, jctl, japi, jsrv.url)
    pseen = _drive(pks, pctl, papi, psrv.url)
    assert pseen == translate(jseen)
    assert len(papi.log) == len(japi.log) > 20
    for got, want in zip(papi.log, translate(japi.log)):
        assert got == want


def test_kube_routes_equal():
    assert pks.KIND_ROUTES == jks.KIND_ROUTES


def _reviews():
    out = []
    for name in sorted(FIXTURES):
        out.append({"request": {"uid": name, "object": FIXTURES[name]}})
    out.append({"request": {"uid": "bad",
                            "object": {"spec": {"predictors": 3}}}})
    out.append({"request": {"uid": "empty"}})
    return out


@pytest.mark.parametrize("mutate", [True, False])
def test_admission_responses_equal(mutate):
    for review in _reviews():
        want = jctl.handle_admission_review(copy.deepcopy(review), mutate)
        got = pctl.handle_admission_review(copy.deepcopy(review), mutate)
        assert got == want, review["request"]["uid"]


def test_webhook_apps_answer_equal():
    served = {n: Served(m.build_webhook_app())
              for n, m in (("jax", jctl), ("torch", pctl))}
    try:
        for path in ("/mutate", "/validate"):
            for review in _reviews():
                answers = [rq.post(served[n].url + path, json=review,
                                   timeout=10) for n in ("jax", "torch")]
                assert [a.status_code for a in answers] == [200, 200]
                assert answers[1].json() == answers[0].json()
        health = [rq.get(served[n].url + "/healthz", timeout=10).text
                  for n in ("jax", "torch")]
        assert health == ["ok", "ok"]
    finally:
        for s in served.values():
            s.close()
