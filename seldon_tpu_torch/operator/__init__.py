"""Control plane: SeldonDeployment -> k8s manifests -> the port's pods.

Port of seldon_tpu/operator/ (Seldon's Go operator: CRD types + naming,
mutating/validating webhooks, a reconciler emitting Deployments /
Services / HPAs / Istio resources, engine + prepackaged-server +
model-initializer injection). The defaulting and validating webhooks are
pure functions over the CR, the manifests plain dicts, and reconcile
semantics (the zero-downtime stale-generation GC that deletes the engine
last included) run against a pluggable cluster-state store: in memory,
the k8s API (`KubeStore`), or local processes (`LocalProcessStore`).

The port's output equals the JAX package's except in these places, and
nowhere else (`tests/test_torch_operator.py` holds the manifests to
`translate(jax_manifests)`):

| Where (JAX package) | JAX package | Port |
|---|---|---|
| `reconciler.py:112` unit command | `python -m seldon_tpu.runtime.microservice <cls>` | `python -m seldon_tpu_torch.runtime.microservice <cls>` |
| `reconciler.py:179` model initializer | `python -m seldon_tpu.servers.storage` | `python -m seldon_tpu_torch.servers.storage` |
| `reconciler.py:192` engine command | `python -m seldon_tpu.orchestrator.server` | `python -m seldon_tpu_torch.orchestrator.server` |
| `webhook.py:34-40` `PREPACKAGED_CLASSES` | `seldon_tpu.servers.{sklearnserver.SKLearnServer, xgboostserver.XGBoostServer, mlflowserver.MLFlowServer, tfproxy.TFServingProxy, jaxserver.JAXServer}` | `seldon_tpu_torch.servers.{...the same four..., torchserver.TorchServer}` |
| `reconciler.py:154-156` unit resources | `google.com/tpu` in limits and requests | `nvidia.com/gpu` |
| `reconciler.py:359-362` multi-host container pick | containers with `google.com/tpu` limits | containers with `nvidia.com/gpu` limits |
| `reconciler.py:295-305` node selector | `cloud.google.com/gke-tpu-topology` (when set) and `cloud.google.com/gke-tpu-accelerator` (default `tpu-v5-lite-podslice`) | one label, `cloud.google.com/gke-accelerator`: the predictor's accelerator when it names a GPU, else `nvidia-h100-80gb` (a TPU value or none); GPU nodes have no slice topology |
| `localstore.py:159` pod environment | `JAX_PLATFORMS=cpu` unless set | the caller's: a `TorchServer` pod serves on the card unless its parameters name `{"name": "device", "value": "cpu"}` |
| `localstore.py:167` model download | `seldon_tpu.servers.storage.download` | `seldon_tpu_torch.servers.storage.download` |
| `localstore.py:200` container command | the manifest's `python` as found on `PATH` | the caller's interpreter (`sys.executable`), as the store already runs custom images and the engine: a host may have `python3` and no `python` |
| `localstore.py:215` custom-image default | `seldon_tpu.orchestrator.units.SimpleModel` | `seldon_tpu_torch.orchestrator.units.SimpleModel` |
| `localstore.py:217`, `:257` spawned commands | `seldon_tpu.runtime.microservice`, `seldon_tpu.orchestrator.server` | `seldon_tpu_torch.runtime.microservice`, `seldon_tpu_torch.orchestrator.server` |
| `packaging.py:39` `ENTRYPOINT` | `exec python -m seldon_tpu.runtime.microservice` | `exec python -m seldon_tpu_torch.runtime.microservice` |
| `packaging.py:63-80` Dockerfile | base `python:3.12-slim` + `pip install jax[cpu]`; `tpu=True`: the Cloud TPU JAX image | base `python:3.12-slim` + `pip install torch` from PyTorch's CPU wheel index; `tpu=True` (the accelerator variant): a CUDA PyTorch devel image (`nvcc` builds the kernels at first use) and no extra install line |

Names, labels, ports, env (`TPU_WORKER_HOSTNAMES_SVC` /
`TPU_WORKER_COUNT` included, which `parallel/distributed.py` reads),
probes, annotations, generations and image names stay byte-equal, and so
does the CR schema (the predictor's `tpu:` block and the
`seldon.io/tpu-*` annotations are wire names).
"""

from seldon_tpu_torch.operator.types import (
    SeldonDeployment,
    DeploymentStatus,
    machine_name,
)
from seldon_tpu_torch.operator.webhook import (
    default_deployment,
    validate_deployment,
)
from seldon_tpu_torch.operator.reconciler import Reconciler, InMemoryStore
from seldon_tpu_torch.operator.kubestore import KubeStore

__all__ = [
    "SeldonDeployment",
    "DeploymentStatus",
    "machine_name",
    "default_deployment",
    "validate_deployment",
    "Reconciler",
    "InMemoryStore",
    "KubeStore",
]
