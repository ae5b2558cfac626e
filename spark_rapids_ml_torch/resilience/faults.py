#
# Deterministic fault injection: the port of spark_rapids_ml_tpu/
# resilience/faults.py.  Dispatch sites call `maybe_inject("<site>")`;
# tests (the `fault_inject` context manager) or whole-process runs (the
# `fault_inject_spec` conf, "site:kind[:times[:skip]]") arm a site with a
# fault kind and exact occurrence counts, so every recovery path runs on the
# CPU and each injected failure fires on the iteration it names.
#
# `KNOWN_SITES` and `FAULT_KINDS` are the JAX package's sets, so a spec
# parses the same way in both packages.  Sites whose callers the port does
# not have yet stay registered: `serving_*` (the serving item, 7) and
# `kv_wait` (the pod layer, item 8).  `rank_lost` and `kv_timeout` raise
# the typed errors of the JAX package's pod layer; with no pod layer on one
# process they classify as fatal (resilience/retry.py).
#
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Sequence

from ..config import get_config
from ..utils import get_logger
from . import metrics

logger = get_logger("spark_rapids_ml_torch.resilience")

_lock = threading.Lock()

KNOWN_SITES = frozenset({
    "fit_kernel",
    "transform_dispatch",
    "stage_parquet",
    "kmeans_lloyd",
    "lbfgs_iteration",
    "linreg_fista",
    "fused_accumulate",
    "serving_dispatch",
    "serving_admission",
    "serving_collect",
    "chunk_cache_spill",
    "stat_program_step",
    "kv_wait",
})

FAULT_KINDS = (
    "oom",
    "timeout",
    "preemption",
    "hang",
    "device_lost",
    "rank_lost",
    "kv_timeout",
)


class SimulatedPreemption(RuntimeError):
    """An injected preemption of the worker (the message carries
    'preempted', so the classifier routes it like a real one)."""

    def __init__(self, site: str) -> None:
        super().__init__(f"injected fault: worker preempted at dispatch site '{site}'")
        self.site = site


class RankLost(RuntimeError):
    """A peer process declared dead (the JAX package's pod-layer error)."""

    def __init__(self, ranks: Sequence[int], tag: str = "") -> None:
        super().__init__(f"rank(s) {list(ranks)} lost at '{tag}' (DEADLINE_EXCEEDED)")
        self.ranks = list(ranks)
        self.tag = tag


class ReduceTimeout(RuntimeError):
    """A bounded cross-process wait that expired (the JAX package's
    pod-layer error)."""

    def __init__(self, site: str, key: str = "", waited_s: float = 0.0) -> None:
        super().__init__(f"bounded wait at '{site}' for {key!r} expired after "
                         f"{waited_s:.1f}s (DEADLINE_EXCEEDED)")
        self.site = site
        self.key = key
        self.waited_s = waited_s


class _Fault:
    __slots__ = ("kind", "times", "skip", "seconds")

    def __init__(self, kind: str, times: int, skip: int, seconds: float) -> None:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind: {kind!r}")
        self.kind = kind
        self.times = int(times)
        self.skip = int(skip)
        self.seconds = float(seconds)


# faults armed by `fault_inject` blocks and by the conf are kept apart, so
# that a new conf spec never drops a fault a block armed
_armed: Dict[str, List[_Fault]] = {}
_armed_conf: Dict[str, List[_Fault]] = {}
_conf_spec_seen: str = ""


@contextlib.contextmanager
def fault_inject(site: str, kind: str, times: int = 1, skip: int = 0,
                 seconds: float = 5.0) -> Iterator[None]:
    """Arm `site` while the block runs: `skip` occurrences pass, then the
    next `times` fire.  Kinds: `oom` (a RESOURCE_EXHAUSTED RuntimeError),
    `timeout` (a DispatchTimeout), `preemption` (SimulatedPreemption),
    `hang` (sleeps `seconds`, so that a `guarded` watchdog with a positive
    `dispatch_deadline_s` fires), `device_lost` (a device-lost
    RuntimeError that also registers a simulated loss with
    resilience/elastic.py), `rank_lost` (RankLost), `kv_timeout`
    (ReduceTimeout)."""
    f = _Fault(kind, times, skip, seconds)
    with _lock:
        _armed.setdefault(site, []).append(f)
    try:
        yield
    finally:
        with _lock:
            faults = _armed.get(site, [])
            if f in faults:
                faults.remove(f)
            if not faults:
                _armed.pop(site, None)


def _parse_spec(spec: str) -> Dict[str, List[_Fault]]:
    """`"site:kind[:times[:skip]]"` comma list -> armed-fault table."""
    out: Dict[str, List[_Fault]] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault_inject_spec entry {entry!r} is not 'site:kind[:times[:skip]]'")
        site, kind = parts[0], parts[1]
        times = int(parts[2]) if len(parts) > 2 else 1
        skip = int(parts[3]) if len(parts) > 3 else 0
        out.setdefault(site, []).append(_Fault(kind, times, skip, 5.0))
    return out


def _sync_conf_locked() -> None:
    global _conf_spec_seen, _armed_conf
    spec = str(get_config("fault_inject_spec") or "")
    if spec == _conf_spec_seen:
        return
    _armed_conf = _parse_spec(spec)
    _conf_spec_seen = spec


def reset_faults() -> None:
    """Disarm every fault, the conf's included (tests)."""
    global _conf_spec_seen, _armed_conf
    with _lock:
        _armed.clear()
        _armed_conf = {}
        _conf_spec_seen = ""


def maybe_inject(site: str) -> None:
    """Fire the armed fault for `site`, if any.  Unarmed sites cost one
    dict lookup."""
    with _lock:
        _sync_conf_locked()
        # an occurrence counts once against every armed fault's skip window,
        # and the first fault that is ready fires
        fault = None
        for table in (_armed, _armed_conf):
            for f in table.get(site, []):
                if f.skip > 0:
                    f.skip -= 1
                elif fault is None and f.times > 0:
                    f.times -= 1
                    fault = f
    if fault is None:
        return
    metrics.inc("faults_injected_total", site=site, kind=fault.kind)
    metrics.event(f"fault_injected[{site}]", detail=fault.kind, log=logger)
    if fault.kind == "oom":
        raise RuntimeError(f"RESOURCE_EXHAUSTED: injected OOM fault at dispatch site '{site}'")
    if fault.kind == "timeout":
        from .guard import DispatchTimeout

        raise DispatchTimeout(site, fault.seconds)
    if fault.kind == "preemption":
        raise SimulatedPreemption(site)
    if fault.kind == "device_lost":
        from .elastic import simulate_device_loss

        dev = simulate_device_loss()
        raise RuntimeError(
            "INTERNAL: failed to execute XLA Runtime executable: device "
            f"{dev} has been lost (injected fault at dispatch site '{site}')")
    if fault.kind == "rank_lost":
        raise RankLost([1], tag=site)
    if fault.kind == "kv_timeout":
        raise ReduceTimeout(site, key=f"injected/{site}", waited_s=fault.seconds)
    # "hang": stall inside the dispatch; only a guarded watchdog turns it
    # into an error
    time.sleep(fault.seconds)
