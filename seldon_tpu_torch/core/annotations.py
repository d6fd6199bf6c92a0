"""Downward-API annotation config (port of seldon_tpu/core/annotations.py).

K8s mounts pod annotations at /etc/podinfo/annotations in the downward
API format — one `key="value"` per line. The operator wires that volume
onto the engine container (reconciler.py) so runtime knobs set as CR
annotations (timeouts, retries, gRPC message caps) reach the process
without an image rebuild, as in Seldon's engine.

Known knobs (Seldon's names):
  seldon.io/rest-read-timeout        ms, engine->unit REST read timeout
  seldon.io/rest-connection-timeout  ms, connect timeout
  seldon.io/rest-connect-retries     engine->unit retry count
  seldon.io/grpc-read-timeout        ms, engine->unit gRPC deadline
  seldon.io/grpc-max-message-size    bytes, server + channel caps
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

logger = logging.getLogger(__name__)

PODINFO_PATH = "/etc/podinfo/annotations"

REST_READ_TIMEOUT = "seldon.io/rest-read-timeout"
REST_CONNECTION_TIMEOUT = "seldon.io/rest-connection-timeout"
REST_CONNECT_RETRIES = "seldon.io/rest-connect-retries"
GRPC_READ_TIMEOUT = "seldon.io/grpc-read-timeout"
GRPC_MAX_MSG_SIZE = "seldon.io/grpc-max-message-size"


def parse_downward_api(text: str) -> Dict[str, str]:
    """Parse the downward-API annotations format: `key="escaped value"`
    per line (the value is a Go-quoted string)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or "=" not in line:
            continue
        key, _, raw = line.partition("=")
        raw = raw.strip()
        if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
            raw = raw[1:-1]
            # Unescape Go escapes in a SINGLE pass — sequential replaces
            # corrupt values like 'C:\\network' (the \\ pair must not be
            # re-read as the start of \n).
            import re as _re

            raw = _re.sub(
                r"\\(.)",
                lambda m: {"n": "\n", "t": "\t"}.get(m.group(1),
                                                     m.group(1)),
                raw,
            )
        out[key.strip()] = raw
    return out


class AnnotationsConfig:
    """Lazy view over the podinfo annotations file (missing file -> {})."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("PODINFO_ANNOTATIONS",
                                           PODINFO_PATH)
        self._annotations: Optional[Dict[str, str]] = None

    @property
    def annotations(self) -> Dict[str, str]:
        if self._annotations is None:
            try:
                with open(self.path) as f:
                    self._annotations = parse_downward_api(f.read())
                logger.info("loaded %d pod annotations from %s",
                            len(self._annotations), self.path)
            except FileNotFoundError:
                self._annotations = {}
        return self._annotations

    def get(self, key: str, default: str = "") -> str:
        return self.annotations.get(key, default)

    def get_int(self, key: str, default: int) -> int:
        raw = self.annotations.get(key)
        if raw is None:
            return default
        try:
            return int(raw)
        except ValueError:
            logger.warning("annotation %s=%r is not an int; using %d",
                           key, raw, default)
            return default

    # Typed accessors for the engine's knobs.

    def rest_timeout_s(self, default_ms: int = 5000) -> float:
        return self.get_int(REST_READ_TIMEOUT, default_ms) / 1000.0

    def connect_retries(self, default: int = 3) -> int:
        return self.get_int(REST_CONNECT_RETRIES, default)

    def grpc_timeout_s(self, default_ms: int = 5000) -> float:
        return self.get_int(GRPC_READ_TIMEOUT, default_ms) / 1000.0

    def grpc_max_msg_bytes(self, default: int = 512 * 1024 * 1024) -> int:
        return self.get_int(GRPC_MAX_MSG_SIZE, default)
