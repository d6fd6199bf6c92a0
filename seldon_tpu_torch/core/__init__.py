"""Host-side building blocks of the serving runtime.

`payloads` (and with it protobuf) loads on first use, not with this
package: the server and the engine import `core.tracing` and
`core.metrics` and must run where no transport library is installed.
"""

import importlib

from seldon_tpu_torch.core.metrics import (create_counter, create_gauge,
                                           create_timer, validate_metrics)

__all__ = ["payloads", "create_counter", "create_gauge", "create_timer",
           "validate_metrics"]


def __getattr__(name):
    if name == "payloads":
        return importlib.import_module("seldon_tpu_torch.core.payloads")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
