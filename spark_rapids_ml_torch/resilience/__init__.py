#
# resilience/ — the port of spark_rapids_ml_tpu/resilience/ for one card:
# the failure-handling layer every fit and transform goes through.
#
#   guard.py       `guarded`: blocking device work under a watchdog, ending
#                  in a device synchronization; a hang raises DispatchTimeout
#   retry.py       RetryPolicy and the error classifiers: OOM frees memory
#                  and re-dispatches, transient errors back off, preemption
#                  and a simulated device loss re-dispatch (checkpointed
#                  solvers resume), a sticky CUDA error propagates
#   faults.py      deterministic fault injection at named dispatch sites
#   checkpoint.py  the checkpoint contract of every iterative solver (the JAX
#                  package's file names and layout)
#   elastic.py     device-loss recovery on one card (the full retry); the
#                  mesh shrink waits for several devices
#   metrics.py     the counters and events the JAX package writes to its
#                  telemetry, as plain counts until that item is ported
#
# Not ported: the pod layer (resilience/pod.py: rank loss, bounded
# cross-process waits), ROADMAP.md item 8.
#
from .checkpoint import (  # noqa: F401
    checkpoint_file_for,
    clear_checkpoint,
    load_checkpoint,
    resolve_checkpoint_dir,
    save_checkpoint,
    sweep_orphaned_tmps,
)
from .elastic import (  # noqa: F401
    RECOVERY_METRICS,
    probe_lost_devices,
    recover_from_device_loss,
    reset_elastic,
    simulate_device_loss,
)
from .faults import (  # noqa: F401
    FAULT_KINDS,
    KNOWN_SITES,
    RankLost,
    ReduceTimeout,
    SimulatedPreemption,
    fault_inject,
    maybe_inject,
    reset_faults,
)
from .guard import DispatchTimeout, guarded, wait_abandoned  # noqa: F401
from .metrics import counts_snapshot, get_events, reset_metrics  # noqa: F401
from .retry import (  # noqa: F401
    RetryPolicy,
    classify_error,
    is_device_loss,
    is_oom,
    is_preemption,
    is_rank_loss,
    is_remote_compile_flake,
    is_sticky_cuda_error,
    is_transient,
    retry_call,
)

__all__ = [
    "DispatchTimeout",
    "FAULT_KINDS",
    "KNOWN_SITES",
    "RECOVERY_METRICS",
    "RankLost",
    "ReduceTimeout",
    "RetryPolicy",
    "SimulatedPreemption",
    "checkpoint_file_for",
    "classify_error",
    "clear_checkpoint",
    "counts_snapshot",
    "fault_inject",
    "get_events",
    "guarded",
    "is_device_loss",
    "is_oom",
    "is_preemption",
    "is_rank_loss",
    "is_remote_compile_flake",
    "is_sticky_cuda_error",
    "is_transient",
    "load_checkpoint",
    "maybe_inject",
    "probe_lost_devices",
    "recover_from_device_loss",
    "reset_elastic",
    "reset_faults",
    "reset_metrics",
    "resolve_checkpoint_dir",
    "retry_call",
    "save_checkpoint",
    "simulate_device_loss",
    "sweep_orphaned_tmps",
    "wait_abandoned",
]
