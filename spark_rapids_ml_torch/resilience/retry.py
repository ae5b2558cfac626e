#
# Retry policies: the port of spark_rapids_ml_tpu/resilience/retry.py.
# Every failure maps to an action, and the action decides the recovery:
#
#   oom          free the failed dispatch's memory (gc + the CUDA caching
#                allocator's cache, or the site's own hook) and re-dispatch
#   transient    RPC/DEADLINE errors and the watchdog's DispatchTimeout:
#                exponential backoff + jitter, then re-dispatch
#   preemption   the worker went away: re-dispatch; an iterative solver
#                with `checkpoint_dir` set resumes from its checkpoint
#   device_loss  the device failed.  On one card there are no survivors to
#                shrink to, so a simulated loss (the `device_lost` fault
#                kind) takes the JAX package's full-retry path.  A real
#                sticky CUDA error ("an illegal memory access", "device-side
#                assert triggered", "unspecified launch failure", ...)
#                poisons the process's CUDA context, so it is classified as
#                a device loss but never retried here: it propagates, and
#                the fit resumes from its checkpoint in a fresh process
#   fatal        everything else propagates on the first raise, the pod
#                layer's rank loss among it (that layer is ROADMAP.md item
#                8: one process has no quorum to shrink)
#
# The classifiers keep the JAX package's strings (its tests port as they
# are) and add CUDA's.  No recovery ever moves work to the CPU.
#
from __future__ import annotations

import gc
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from ..config import get_config
from ..utils import get_logger
from . import metrics

logger = get_logger("spark_rapids_ml_torch.resilience")

# Messages of CUDA errors that leave the process's context unusable: every
# later CUDA call fails, so a retry in the same process cannot succeed.
_STICKY_CUDA = (
    "illegal memory access",
    "device-side assert triggered",
    "unspecified launch failure",
    "illegal instruction",
    "misaligned address",
    "uncorrectable ecc error",
    "hardware stack error",
)


def is_oom(e: BaseException) -> bool:
    """Device memory exhausted: `torch.cuda.OutOfMemoryError`, CUDA's "out
    of memory", and the JAX package's strings."""
    try:
        import torch

        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
    except ImportError:  # pragma: no cover - the port always has torch
        pass
    s = str(e)
    return "RESOURCE_EXHAUSTED" in s or "Out of memory" in s or "out of memory" in s


def is_sticky_cuda_error(e: BaseException) -> bool:
    """A CUDA error that poisons the process's context (see `_STICKY_CUDA`)."""
    low = str(e).lower()
    return any(m in low for m in _STICKY_CUDA)


def is_preemption(e: BaseException) -> bool:
    """The worker or its coordinator went away mid-fit: 'preempted',
    DATA_LOSS, heartbeat timeouts and the coordination channel's socket
    closing (the JAX package's strings); plain user errors stay fatal."""
    from .faults import SimulatedPreemption

    if isinstance(e, SimulatedPreemption):
        return True
    s = str(e)
    low = s.lower()
    return (
        "preempted" in s
        or "PREEMPTED" in s
        or "DATA_LOSS" in s
        or "coordinator disconnected" in s
        or "worker has been restarted" in s
        or ("heartbeat" in low and ("timed out" in low or "failed" in low))
        or ("coordination" in low and "socket closed" in low)
    )


def is_device_loss(e: BaseException) -> bool:
    """The device failed mid-execution: an error carrying `lost_devices`,
    one naming a device as lost or in an invalid state (the JAX package's
    strings), or a sticky CUDA error.  Not 'failed to execute' alone: that
    wrapper also carries deterministic failures, which stay fatal."""
    if getattr(e, "lost_devices", None) is not None:
        return True
    if is_sticky_cuda_error(e):
        return True
    low = str(e).lower()
    return "device" in low and ("lost" in low or "is in an invalid state" in low)


def is_remote_compile_flake(e: BaseException) -> bool:
    """A remote compile service's server-side flake (HTTP 5xx, reset,
    timeout): transient.  A rejected program (HTTP 4xx) stays fatal.  The
    port compiles nothing remotely; the classifier is kept so that the two
    packages classify the same errors alike."""
    s = str(e)
    if "remote_compile" not in s and "remote compile" not in s:
        return False
    return ("HTTP 5" in s or "UNAVAILABLE" in s or "Connection reset" in s
            or "Socket closed" in s or "timed out" in s)


def is_transient(e: BaseException) -> bool:
    """Retryable without repair: deadline and availability errors, the
    watchdog's DispatchTimeout, remote-compile flakes."""
    from .guard import DispatchTimeout

    if isinstance(e, DispatchTimeout):
        return True
    if is_remote_compile_flake(e):
        return True
    s = str(e)
    return ("DEADLINE_EXCEEDED" in s or "UNAVAILABLE" in s or "Socket closed" in s
            or "RPC failed" in s or "Connection reset" in s)


def is_rank_loss(e: BaseException) -> bool:
    """The pod layer's typed errors (RankLost, ReduceTimeout)."""
    from .faults import RankLost, ReduceTimeout

    return isinstance(e, (RankLost, ReduceTimeout))


def classify_error(e: BaseException) -> str:
    """'device_loss' | 'preemption' | 'oom' | 'transient' | 'fatal'.  The
    pod layer's rank loss is tested first (its typed messages carry
    DEADLINE markers): with no pod layer on one process it is fatal."""
    if is_rank_loss(e):
        return "fatal"
    if is_device_loss(e):
        return "device_loss"
    if is_preemption(e):
        return "preemption"
    if is_oom(e):
        return "oom"
    if is_transient(e):
        return "transient"
    return "fatal"


def _default_oom_hook() -> None:
    # free the failed dispatch's temporaries and hand the caching
    # allocator's free blocks back, so that the re-dispatch can use them;
    # the caller's staged inputs are still referenced and survive
    gc.collect()
    try:
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    except ImportError:  # pragma: no cover
        pass


def _default_device_loss_hook() -> None:
    from .elastic import recover_from_device_loss

    recover_from_device_loss(logger)


def _default_preemption_hook() -> None:
    # one process, no distributed runtime to re-initialise: the re-dispatch
    # itself is the repair, and a checkpointed solver resumes from its file
    pass


@dataclass
class RetryPolicy:
    """Total attempts, exponential backoff + jitter, and the retryable
    actions; `classify` maps an exception to an action."""

    max_attempts: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    jitter: float = 0.25
    classify: Callable[[BaseException], str] = classify_error
    retryable: Tuple[str, ...] = ("oom", "transient", "preemption", "device_loss")
    # one gc'd re-dispatch recovers fragmentation and injected faults; a
    # dataset beyond the card fails every attempt, so the caller's own
    # fallback must engage after one repair
    oom_attempts: int = 1

    @classmethod
    def from_config(cls) -> "RetryPolicy":
        return cls(
            max_attempts=int(get_config("retry_max_attempts")),
            backoff_s=float(get_config("retry_backoff_s")),
            backoff_mult=float(get_config("retry_backoff_mult")),
            jitter=float(get_config("retry_jitter")),
        )

    def backoff(self, attempt: int) -> float:
        """Delay before retry number `attempt` (1-based)."""
        delay = self.backoff_s * self.backoff_mult ** (attempt - 1)
        return delay * (1.0 + random.uniform(0.0, self.jitter))

    def admits(self, e: BaseException, action: str, attempt: int, oom_left: bool = True,
               label: str = "dispatch", log: Optional[object] = None) -> bool:
        """Whether failed attempt `attempt` may be retried with `action`
        (`classify(e)`): a retryable action, an attempt left, and for an
        OOM a repair left.  A sticky CUDA error never is; it records a
        `sticky_error[label]` event."""
        if action == "device_loss" and is_sticky_cuda_error(e):
            metrics.event(f"sticky_error[{label}]", detail=f"{type(e).__name__}: {e}",
                          log=log or logger)
            return False
        return (action in self.retryable and attempt < self.max_attempts
                and (action != "oom" or oom_left))

    def recover(self, action: str, attempt: int, label: str, detail: str,
                log: Optional[object] = None, on_oom: Optional[Callable[[], None]] = None,
                on_preemption: Optional[Callable[[], None]] = None,
                on_device_loss: Optional[Callable[[], None]] = None) -> None:
        """Record retry `attempt` (a `retries_total` count and a
        `retry[label]` event with `detail`), then repair by `action`: the
        `on_*` hook or its default, or for a transient error the backoff.
        Call it outside the `except` block: the exception's traceback pins
        the failed dispatch's frames, whose locals hold the device memory
        the repair is meant to free."""
        lg = log or logger
        metrics.inc("retries_total", label=label, action=action)
        metrics.event(f"retry[{label}]", detail=detail, log=lg)
        lg.warning(f"Dispatch '{label}' failed; recovery={action} ({detail})")
        if action == "oom":
            (on_oom or _default_oom_hook)()
        elif action == "preemption":
            (on_preemption or _default_preemption_hook)()
        elif action == "device_loss":
            (on_device_loss or _default_device_loss_hook)()
        else:  # transient
            time.sleep(self.backoff(attempt))


def retry_call(
    fn: Callable[[], Any],
    label: str = "dispatch",
    policy: Optional[RetryPolicy] = None,
    log: Optional[object] = None,
    on_oom: Optional[Callable[[], None]] = None,
    on_preemption: Optional[Callable[[], None]] = None,
    on_device_loss: Optional[Callable[[], None]] = None,
) -> Any:
    """Run `fn` under `policy` (default `RetryPolicy.from_config()`): each
    failure that `policy.admits` is repaired by `policy.recover` (the
    `on_*` hooks replace the default repairs) and `fn` runs again.  A
    sticky CUDA error propagates on its first raise."""
    if policy is None:
        policy = RetryPolicy.from_config()
    attempt = 1
    oom_count = 0
    while True:
        try:
            return fn()
        except Exception as e:
            action = policy.classify(e)
            if not policy.admits(e, action, attempt, oom_count < policy.oom_attempts, label, log):
                raise
            detail = f"attempt={attempt} action={action} ({type(e).__name__}: {e})"
        policy.recover(action, attempt, label, detail, log, on_oom=on_oom,
                       on_preemption=on_preemption, on_device_loss=on_device_loss)
        oom_count += action == "oom"
        attempt += 1
