"""Storage credential injection for the model initializer.

Port of seldon_tpu/operator/credentials.py, line for line (host logic;
its output is the JAX package's byte for byte). Seldon parity:
  operator/controllers/resources/credentials/service_account_credentials.go:1-113
  operator/controllers/resources/credentials/s3/s3_secret.go:1-156
  operator/controllers/resources/credentials/gcs/gcs_secret.go:1-49

The reference reads a `credentials` JSON blob from the `seldon-config`
ConfigMap, walks the predictor's ServiceAccount's secrets, and wires the
first matching S3 secret as env vars (secretKeyRef) and the first GCS
secret as a mounted volume + GOOGLE_APPLICATION_CREDENTIALS. This module
reproduces that contract against our raw-manifest Store (kubestore /
InMemoryStore / LocalProcessStore) so `gs://` and `s3://` model URIs work
for private buckets, with the port's `servers/storage.py` consuming the standard
env/credential-file conventions on the other end.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# ConfigMap contract (the operator's own config object).
CONFIGMAP_NAME = "seldon-config"
CREDENTIAL_CONFIG_KEY = "credentials"

# S3 env contract (s3_secret.go:23-35).
AWS_ACCESS_KEY_ID = "AWS_ACCESS_KEY_ID"
AWS_SECRET_ACCESS_KEY = "AWS_SECRET_ACCESS_KEY"
AWS_ENDPOINT_URL = "AWS_ENDPOINT_URL"
AWS_REGION = "AWS_REGION"
S3_ENDPOINT = "S3_ENDPOINT"
S3_USE_HTTPS = "S3_USE_HTTPS"
S3_VERIFY_SSL = "S3_VERIFY_SSL"
# Secret DATA key names holding the credential material (overridable via
# the ConfigMap).
S3_ACCESS_KEY_ID_NAME = "awsAccessKeyID"
S3_SECRET_ACCESS_KEY_NAME = "awsSecretAccessKey"
# Secret ANNOTATION suffixes (s3_secret.go:45-50); both API-group
# prefixes are honored, ours first.
API_GROUP = "machinelearning.seldon.io"
FALLBACK_API_GROUP = "serving.kubeflow.org"
_ANN_ENDPOINT = "/s3-endpoint"
_ANN_REGION = "/s3-region"
_ANN_VERIFY_SSL = "/s3-verifyssl"
_ANN_USE_HTTPS = "/s3-usehttps"

# GCS contract (gcs_secret.go:23-28).
GCS_CREDENTIAL_FILE_NAME = "gcloud-application-credentials.json"
GCS_VOLUME_NAME = "user-gcp-sa"
GCS_MOUNT_PATH = "/var/secrets/"
GCS_CREDENTIAL_ENV = "GOOGLE_APPLICATION_CREDENTIALS"


@dataclasses.dataclass(frozen=True)
class S3Config:
    access_key_id_name: str = ""
    secret_access_key_name: str = ""
    endpoint: str = ""
    use_https: str = ""


@dataclasses.dataclass(frozen=True)
class GCSConfig:
    credential_file_name: str = ""


@dataclasses.dataclass(frozen=True)
class CredentialConfig:
    s3: S3Config = dataclasses.field(default_factory=S3Config)
    gcs: GCSConfig = dataclasses.field(default_factory=GCSConfig)

    @staticmethod
    def from_configmap(cm: Optional[Dict]) -> "CredentialConfig":
        """Parse the `credentials` key of a seldon-config ConfigMap
        manifest; malformed JSON is a config error worth failing loudly
        on (the reference panics — service_account_credentials.go:55)."""
        if not cm:
            return CredentialConfig()
        raw = (cm.get("data") or {}).get(CREDENTIAL_CONFIG_KEY)
        if not raw:
            return CredentialConfig()
        d = json.loads(raw)
        if not isinstance(d, dict):
            raise ValueError(
                f"credentials entry must be a JSON object, got {type(d).__name__}"
            )
        s3d, gcsd = d.get("s3", {}), d.get("gcs", {})
        return CredentialConfig(
            s3=S3Config(
                access_key_id_name=s3d.get("s3AccessKeyIDName", ""),
                secret_access_key_name=s3d.get("s3SecretAccessKeyName", ""),
                endpoint=s3d.get("s3Endpoint", ""),
                use_https=s3d.get("s3UseHttps", ""),
            ),
            gcs=GCSConfig(
                credential_file_name=gcsd.get("gcsCredentialFileName", ""),
            ),
        )


def _store_get(store, kind: str, namespace: str, name: str) -> Optional[Dict]:
    """Fetch one object by name: a Store exposing `get` (KubeStore —
    single apiserver GET) is preferred; otherwise fall back to list+filter
    (InMemoryStore / LocalProcessStore)."""
    getter = getattr(store, "get", None)
    if callable(getter):
        return getter(kind, namespace, name)
    for obj in store.list(kind, namespace):
        if obj["metadata"]["name"] == name:
            return obj
    return None


def _annotation(secret: Dict, suffix: str) -> Optional[str]:
    anns = secret.get("metadata", {}).get("annotations") or {}
    for group in (API_GROUP, FALLBACK_API_GROUP):
        if group + suffix in anns:
            return anns[group + suffix]
    return None


def build_s3_envs(secret: Dict, cfg: S3Config) -> List[Dict]:
    """S3 secret -> env var list (s3_secret.go:52-156): key material via
    secretKeyRef (values never enter the manifest), endpoint/region/ssl
    via secret annotations, falling back to the ConfigMap endpoint."""
    key_id_name = cfg.access_key_id_name or S3_ACCESS_KEY_ID_NAME
    secret_key_name = cfg.secret_access_key_name or S3_SECRET_ACCESS_KEY_NAME
    name = secret["metadata"]["name"]
    envs = [
        {"name": AWS_ACCESS_KEY_ID,
         "valueFrom": {"secretKeyRef": {"name": name, "key": key_id_name}}},
        {"name": AWS_SECRET_ACCESS_KEY,
         "valueFrom": {"secretKeyRef": {"name": name,
                                        "key": secret_key_name}}},
    ]
    endpoint = _annotation(secret, _ANN_ENDPOINT)
    use_https = _annotation(secret, _ANN_USE_HTTPS)
    if endpoint is None and cfg.endpoint:
        endpoint, use_https = cfg.endpoint, (cfg.use_https or None)
    if endpoint is not None:
        scheme = "http" if use_https == "0" else "https"
        if use_https is not None:
            envs.append({"name": S3_USE_HTTPS, "value": use_https})
        envs.append({"name": S3_ENDPOINT, "value": endpoint})
        envs.append(
            {"name": AWS_ENDPOINT_URL, "value": f"{scheme}://{endpoint}"}
        )
    region = _annotation(secret, _ANN_REGION)
    if region is not None:
        envs.append({"name": AWS_REGION, "value": region})
    verify = _annotation(secret, _ANN_VERIFY_SSL)
    if verify is not None:
        envs.append({"name": S3_VERIFY_SSL, "value": verify})
    return envs


def build_gcs_volume(secret: Dict, file_name: str):
    """GCS secret -> (volume, volumeMount, env) (gcs_secret.go:34-49)."""
    volume = {
        "name": GCS_VOLUME_NAME,
        "secret": {"secretName": secret["metadata"]["name"]},
    }
    mount = {"name": GCS_VOLUME_NAME, "mountPath": GCS_MOUNT_PATH,
             "readOnly": True}
    env = {"name": GCS_CREDENTIAL_ENV, "value": GCS_MOUNT_PATH + file_name}
    return volume, mount, env


class CredentialBuilder:
    """Walks a ServiceAccount's secrets and injects the first S3 match as
    envs and the first GCS match as a volume, onto the model-initializer
    container (service_account_credentials.go:64-113)."""

    def __init__(self, store, config: Optional[CredentialConfig] = None):
        self.store = store
        self.config = config or CredentialConfig()
        # Memo for SA/Secret reads: one builder instance lives for one
        # desired_manifests() pass, so a multi-unit graph hits the
        # apiserver once per object, not once per unit.
        self._cache: Dict[tuple, Optional[Dict]] = {}

    @staticmethod
    def from_store(store, namespaces=("seldon-system", "default")) -> (
            "CredentialBuilder"):
        """Locate the seldon-config ConfigMap in the usual namespaces.
        API errors (403 without the read RBAC, transient apiserver
        failures) degrade to no-credentials rather than wedging every
        reconcile — public-bucket deployments must keep working."""
        for ns in namespaces:
            try:
                cm = _store_get(store, "ConfigMap", ns, CONFIGMAP_NAME)
            except Exception as e:
                logger.warning("cannot read %s ConfigMap in %s: %s",
                               CONFIGMAP_NAME, ns, e)
                continue
            if cm is not None:
                try:
                    cfg = CredentialConfig.from_configmap(cm)
                except (ValueError, KeyError) as e:
                    raise ValueError(
                        f"seldon-config ConfigMap in {ns} has a "
                        f"malformed credentials entry: {e}"
                    ) from e
                return CredentialBuilder(store, cfg)
        return CredentialBuilder(store)

    def _get(self, kind: str, namespace: str, name: str) -> Optional[Dict]:
        key = (kind, namespace, name)
        if key in self._cache:
            return self._cache[key]
        try:
            obj = _store_get(self.store, kind, namespace, name)
        except Exception as e:
            logger.warning("cannot read %s %s/%s: %s", kind, namespace,
                           name, e)
            obj = None
        self._cache[key] = obj
        return obj

    def inject(self, namespace: str, service_account_name: str,
               container: Dict, volumes: List[Dict]) -> None:
        """Mutate `container` env/volumeMounts (+ pod `volumes`) with the
        credentials reachable from the ServiceAccount. Missing SA or
        secrets are logged and skipped, not fatal — matching the
        reference's lenient path so public-bucket deployments keep
        working without any RBAC on secrets."""
        sa_name = service_account_name or "default"
        sa = self._get("ServiceAccount", namespace, sa_name)
        if sa is None:
            if service_account_name:
                logger.warning("serviceAccount %s/%s not found",
                               namespace, sa_name)
            return
        s3_key = (self.config.s3.secret_access_key_name
                  or S3_SECRET_ACCESS_KEY_NAME)
        gcs_file = (self.config.gcs.credential_file_name
                    or GCS_CREDENTIAL_FILE_NAME)
        env = container.setdefault("env", [])
        mounts = container.setdefault("volumeMounts", [])
        # First S3 match and first GCS match win; later duplicates are
        # skipped (duplicate env names / identical mountPaths would fail
        # apiserver validation of the container).
        s3_done = gcs_done = False
        for ref in sa.get("secrets") or []:
            if not ref.get("name"):
                continue  # ObjectReference.name is optional in the API
            secret = self._get("Secret", namespace, ref["name"])
            if secret is None:
                logger.warning("secret %s/%s not found", namespace,
                               ref.get("name"))
                continue
            data = secret.get("data") or {}
            if s3_key in data and not s3_done:
                env.extend(build_s3_envs(secret, self.config.s3))
                s3_done = True
            elif gcs_file in data and not gcs_done:
                volume, mount, cred_env = build_gcs_volume(secret, gcs_file)
                # Pod volumes are shared across initContainers: two units
                # with the same SA must not duplicate the volume entry.
                if all(v["name"] != volume["name"] for v in volumes):
                    volumes.append(volume)
                mounts.append(mount)
                env.append(cred_env)
                gcs_done = True
            else:
                logger.debug("skipping secret %s",
                             secret["metadata"]["name"])
