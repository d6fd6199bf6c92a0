"""The port's packaging layer (seldon_tpu_torch/packaging) against the JAX
package's (seldon_tpu/packaging): the generated files are equal after the
translation table (the entrypoint's module, the Dockerfile's base image
and install lines); the templates render equal and reconcile through the
port; the packaged entrypoint boots the port's microservice."""

import os
import re
import subprocess
import sys
import time

import pytest
import requests as rq

from seldon_tpu import packaging as jpk
from seldon_tpu_torch import packaging as ppk
from seldon_tpu_torch.operator import InMemoryStore, Reconciler
from seldon_tpu_torch.operator import SeldonDeployment
from tests.test_torch_operator import translate

TEXT = (
    ("python -m seldon_tpu.runtime.microservice",
     "python -m seldon_tpu_torch.runtime.microservice"),
    ("FROM us-docker.pkg.dev/cloud-tpu-images/jax/tpu:latest",
     "FROM pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel"),
    ("RUN pip install --no-cache-dir jax[cpu]",
     "RUN pip install --no-cache-dir torch "
     "--index-url https://download.pytorch.org/whl/cpu"),
)


def translate_text(text: str) -> str:
    for old, new in TEXT:
        text = text.replace(old, new)
    return text


def test_entrypoint_translated():
    assert ppk.generate_entrypoint() == translate_text(
        jpk.generate_entrypoint())
    assert "seldon_tpu." not in ppk.generate_entrypoint()


@pytest.mark.parametrize("tpu", [False, True])
@pytest.mark.parametrize("kw", [
    {}, {"requirements": False},
    {"env": {"MODEL_NAME": "M", "SERVICE_TYPE": "MODEL"}},
    {"base_image": "python:3.11-slim"},
])
def test_dockerfile_translated(tpu, kw):
    got = ppk.generate_dockerfile(tpu=tpu, **kw)
    assert got == translate_text(jpk.generate_dockerfile(tpu=tpu, **kw))
    assert "jax" not in got and "cloud-tpu" not in got
    if tpu:
        assert got.startswith(f"FROM {ppk.CUDA_BASE_IMAGE}\n")
        assert "devel" in ppk.CUDA_BASE_IMAGE  # nvcc builds the kernels


@pytest.mark.parametrize("language", ["python", "nodejs", "r", "java"])
@pytest.mark.parametrize("tpu", [False, True])
def test_package_model_files_translated(tmp_path, language, tpu):
    outs = {}
    for name, mod in (("jax", jpk), ("torch", ppk)):
        d = tmp_path / name
        d.mkdir()
        out = mod.package_model(str(d), "MyModel", service_type="MODEL",
                                tpu=tpu, language=language)
        outs[name] = {k: (os.path.relpath(v, d), open(v).read(),
                          os.access(v, os.X_OK)) for k, v in out.items()}
    assert set(outs["torch"]) == set(outs["jax"])
    for key, (rel, text, exe) in outs["jax"].items():
        assert outs["torch"][key] == (rel, translate_text(text), exe), key


def test_unknown_language_raises_equal(tmp_path):
    msgs = []
    for mod in (jpk, ppk):
        with pytest.raises(ValueError) as e:
            mod.package_model(str(tmp_path), "M", language="cobol")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


TEMPLATES = [
    ("single-model", {"model_uri": "gs://b/m"}),
    ("single-model", {"model_uri": "gs://b/m", "replicas": 2,
                      "tpu": {"chips": 1, "accelerator": "tpu-v5e"}}),
    ("abtest", {"model_uri_a": "gs://b/a", "model_uri_b": "gs://b/b",
                "ratio_a": 0.3}),
    ("mab", {"model_uri_a": "gs://b/a", "model_uri_b": "gs://b/b",
             "epsilon": 0.2}),
    ("outlier-transformer", {"model_uri": "gs://b/m",
                             "detector_uri": "gs://b/d"}),
]


@pytest.mark.parametrize("template,kw", TEMPLATES)
def test_templates_render_equal_and_reconcile(template, kw):
    from seldon_tpu.operator import InMemoryStore as JStore
    from seldon_tpu.operator import Reconciler as JRec
    from seldon_tpu.operator import SeldonDeployment as JSdep

    cr = ppk.render_template(template, name=f"t-{template}", **kw)
    assert cr == jpk.render_template(template, name=f"t-{template}", **kw)
    store, jstore = InMemoryStore(), JStore()
    status = Reconciler(store, istio_enabled=True).reconcile(
        SeldonDeployment.from_dict(cr))
    assert status.state == "Available", status
    assert store.list("Deployment", "default")
    JRec(jstore, istio_enabled=True).reconcile(JSdep.from_dict(cr))
    assert store.objects == translate(jstore.objects)


def test_template_unknown_raises():
    with pytest.raises(ValueError):
        ppk.render_template("nope", name="x")


def test_packaged_entrypoint_boots_port_microservice(tmp_path):
    """The generated run script itself (its /microservice dir and its
    `python` pointed at this checkout and interpreter) starts the port's
    microservice, which serves the packaged model."""
    (tmp_path / "EchoModel.py").write_text(
        "import numpy as np\n"
        "class EchoModel:\n"
        "    def predict(self, X, names, meta=None):\n"
        "        return np.asarray(X) * 3\n"
    )
    out = ppk.package_model(str(tmp_path), "EchoModel")
    run = open(out["run"]).read()
    assert "exec python -m seldon_tpu_torch.runtime.microservice" in run
    script = tmp_path / "run_here.sh"
    script.write_text(run.replace("cd /microservice", f"cd {tmp_path}")
                      .replace("exec python ", f"exec {sys.executable} "))
    env = dict(os.environ)
    env.update({
        "MODEL_NAME": "EchoModel",
        "SERVICE_TYPE": "MODEL",
        "API_TYPE": "REST",
        "PREDICTIVE_UNIT_SERVICE_PORT": "0",  # ephemeral
        "PYTHONPATH": (str(tmp_path) + os.pathsep
                       + os.path.dirname(os.path.dirname(__file__))),
    })
    proc = subprocess.Popen(["/bin/sh", str(script)], cwd=str(tmp_path),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        port = None
        deadline = time.time() + 60
        lines = []
        while time.time() < deadline and port is None:
            line = proc.stdout.readline().decode()
            lines.append(line)
            m = re.search(r"REST serving on [^:]*:(\d+)", line)
            if m:
                port = int(m.group(1))
            if proc.poll() is not None:
                raise AssertionError("".join(lines)[-2000:])
        assert port, "no 'REST serving on' line printed"
        assert any("starting seldon-tpu microservice" in ln for ln in lines)
        r = rq.post(f"http://127.0.0.1:{port}/predict",
                    json={"data": {"ndarray": [[2.0]]}}, timeout=10)
        assert r.status_code == 200, r.text
        assert r.json()["data"]["ndarray"] == [[6.0]]
    finally:
        proc.terminate()
        proc.wait(timeout=10)
