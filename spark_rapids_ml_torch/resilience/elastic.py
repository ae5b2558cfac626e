#
# Device-loss recovery on one card: the one-device half of
# spark_rapids_ml_tpu/resilience/elastic.py.  The JAX package's state
# machine probes which devices are gone, then either shrinks the mesh to
# the survivors or falls back to a full retry on the same devices.  On one
# card a lost device leaves no survivors, so the port always takes the
# fallback, as the JAX package does below `elastic_min_devices`: the retry
# loop re-dispatches, and a checkpointed solver resumes from its file.  The
# shrink (mesh exclusions, re-staging onto survivors) needs several devices
# and waits for ROADMAP.md item 8; `exclude_devices` raises until then.
#
# The `device_lost` fault kind registers a simulated loss here, so the
# probe reports it like a real one.  The full retry assumes the device is
# back, so the fallback clears the simulated loss.  A real sticky CUDA error
# never reaches this module: resilience/retry.py does not retry it.
#
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..utils import get_logger
from . import metrics

logger = get_logger("spark_rapids_ml_torch.resilience")

_lock = threading.Lock()

# process-wide recovery counters, the JAX package's keys
RECOVERY_METRICS: Dict[str, int] = {
    "losses_detected": 0,
    "meshes_rebuilt": 0,
    "iterations_salvaged": 0,
    "full_retry_fallbacks": 0,
    "remote_host_losses": 0,
}

_sim_lost: set = set()


def _default_device():
    from ..parallel.context import resolve_device

    return resolve_device()


def simulate_device_loss(device_id: Optional[int] = None) -> int:
    """Mark a device lost without real hardware: the probe reports it as
    it would a failed round trip.  Default: the default device.  Returns
    the id."""
    if device_id is None:
        device_id = int(_default_device().index or 0)
        if device_id in simulated_lost_ids():
            raise RuntimeError("no active device left to simulate losing")
    with _lock:
        _sim_lost.add(int(device_id))
    return int(device_id)


def simulated_lost_ids() -> frozenset:
    with _lock:
        return frozenset(_sim_lost)


def reset_elastic() -> None:
    """Clear the simulated losses and zero the counters (tests)."""
    with _lock:
        _sim_lost.clear()
        for k in RECOVERY_METRICS:
            RECOVERY_METRICS[k] = 0


def _answers(device) -> bool:
    """Whether the device answers a round trip."""
    import torch

    try:
        return float(torch.ones(1, device=device).sum().item()) == 1.0
    except Exception:
        return False


def probe_lost_devices() -> List[int]:
    """The ids of the devices that are gone: a simulated loss, else the
    default device if it fails a round trip."""
    dev = _default_device()
    did = int(dev.index or 0)
    if did in simulated_lost_ids():
        return [did]
    return [] if _answers(dev) else [did]


def exclude_devices(device_ids) -> None:
    """Take devices out of service, the JAX package's mesh shrink: it needs
    several devices."""
    raise NotImplementedError(
        "shrinking to the surviving devices needs several devices: the multi-GPU item (8) "
        "of ROADMAP.md")


def recover_from_device_loss(logger_=None) -> bool:
    """Handle a failure classified `device_loss`: probe, count the loss,
    and fall back to the full retry (one card leaves no survivors).
    Returns False: the caller re-dispatches on the same device."""
    lg = logger_ or logger
    lost = probe_lost_devices()
    metrics.event("elastic_recovery[probe]", detail=f"n_dev=1 lost={lost}", log=lg)
    if lost:
        with _lock:
            RECOVERY_METRICS["losses_detected"] += len(lost)
        metrics.event("elastic_recovery[fallback]", detail="1 device: no survivors", log=lg)
        lg.warning(f"Device loss ({lost}) on one device: full retry on the same device")
    else:
        lg.warning("device-loss-shaped error but the device answers the probe; "
                   "falling back to the full retry")
    _fallback_full_retry()
    return False


def _fallback_full_retry() -> None:
    with _lock:
        RECOVERY_METRICS["full_retry_fallbacks"] += 1
        # the retry runs on the same device and assumes it is back
        _sim_lost.clear()


__all__ = [
    "RECOVERY_METRICS",
    "exclude_devices",
    "probe_lost_devices",
    "recover_from_device_loss",
    "reset_elastic",
    "simulate_device_loss",
    "simulated_lost_ids",
]
