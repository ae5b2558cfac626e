#
# serving/ — the online inference subsystem, the port of
# spark_rapids_ml_tpu/serving/: transform traffic from models kept on the
# card.  Four pieces:
#
#   control.py    the closed-loop control plane: per-model AIMD feedback
#                 on the coalescing cap and max-wait against the measured
#                 `slo_burn_rate`, priority classes (`interactive` |
#                 `batch`), the brownout phase machine, and the padding
#                 classes of the row-bucket grid.
#   registry.py   model residency: a registered model's weight arrays
#                 move to the card ONCE (booked in parallel/
#                 device_cache.py's external-reservation ledger,
#                 LRU-evicted under pressure, re-pinned on the next
#                 request).
#   server.py     the micro-batch coalescer and its staged pipeline:
#                 concurrent small requests per model concatenate into
#                 one padded batch under `serving_max_wait_ms`, each
#                 in-flight batch on its own CUDA stream, with admission
#                 control (`serving_max_queue` -> typed ServingOverload)
#                 and policy-driven degradation.
#   http.py       the opt-in stdlib HTTP JSON endpoint (`serving_port`,
#                 loopback).
#
# Metrics land in the telemetry registry (telemetry/registry.py);
# `ServingServer.report()` renders per-model p50/p99.
#
#   from spark_rapids_ml_torch.serving import ServingServer, ServingClient
#   server = ServingServer()
#   server.register("pca", pca_model)
#   server.start()
#   client = ServingClient(server)
#   projected = client.transform("pca", rows)
#
from .control import ServingController  # noqa: F401
from .registry import ModelRegistry, PinnedModel  # noqa: F401
from .server import (  # noqa: F401
    ServingClient,
    ServingDeviceError,
    ServingOverload,
    ServingServer,
)

__all__ = [
    "ModelRegistry",
    "PinnedModel",
    "ServingClient",
    "ServingController",
    "ServingDeviceError",
    "ServingOverload",
    "ServingServer",
]
