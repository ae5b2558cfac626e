#
# Closed-loop serving control plane: the port of spark_rapids_ml_tpu/
# serving/control.py.  Three cooperating mechanisms, all consumed by
# serving/server.py:
#
#   AIMD feedback   per model the controller scales the coalescing cap
#                   and the max-wait knob against the measured burn
#                   rate (the p99-target breach fraction over the 1%
#                   budget): burn at or above
#                   `serving_controller_burn_high` HALVES both, burn at
#                   or below `serving_controller_burn_low` regrows both
#                   additively toward the configured values, and the
#                   band between the thresholds HOLDS (hysteresis).  The
#                   dispatcher's OOM halving stays the emergency memory
#                   actuator; this is the SLO actuator layered on top.
#   priority        two admission classes (`interactive` | `batch`,
#                   per request or per-model default): batch-class load
#                   is admitted only into a `serving_batch_share`
#                   fraction of the queue and wins only a
#                   credit-weighted share of contested dispatch rounds.
#   brownout        burn held at or above `serving_brownout_burn` for
#                   `serving_brownout_sustain_s` escalates a per-model
#                   phase machine normal -> shed_batch ->
#                   shed_interactive; burn back at or below the low water
#                   for `serving_brownout_recover_s` de-escalates one
#                   phase at a time.  Every transition is a trace
#                   instant; an escalation is a typed failure for the
#                   flight recorder (a logged seam until it is ported).
#
# Plus padding classes: coalesced batches stage into the {1, 1.5} x 2^k
# bucket grid (parallel/mesh.py `bucket_rows`), pinned on for serving by
# `serving_padding_buckets` regardless of `shape_bucketing`.  On the card
# every batch size of a class then computes with one product shape, so a
# request's output does not depend on what it was coalesced with.  Each
# dispatch records its decision in `LAST_BUCKET_DECISION` and the
# per-model bucket set surfaces in the serving report.
#
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..config import get_config
from ..telemetry.locks import named_lock
from ..telemetry.registry import counter, gauge
from ..tracing import event
from ..utils import get_logger

logger = get_logger("spark_rapids_ml_torch.serving")

# admission/dispatch priority classes, ordered by dispatch preference
# (the batch take drains `interactive` heads first)
PRIORITY_CLASSES = ("interactive", "batch")

# brownout phases, ordered by severity; the phase index is what the
# `serving_controller_brownout_phase` gauge exports
BROWNOUT_PHASES = ("normal", "shed_batch", "shed_interactive")

CTRL_CAP = gauge(
    "serving_controller_cap",
    "Controller-effective coalescing cap (rows) per served model",
)
CTRL_WAIT = gauge(
    "serving_controller_max_wait_ms",
    "Controller-effective coalescing max-wait (ms) per served model",
)
CTRL_ADJ = counter(
    "serving_controller_adjustments_total",
    "AIMD actuator adjustments by model and direction "
    "(increase|decrease)",
)
BROWNOUT_PHASE = gauge(
    "serving_controller_brownout_phase",
    "Brownout phase index per model (0 normal, 1 shed_batch, "
    "2 shed_interactive)",
)
SHED = counter(
    "serving_shed_total",
    "Requests shed by the brownout controller, by model and priority "
    "class",
)

# AIMD shape: halve on breach, regrow an eighth of full scale per clean
# tick — the same halving the OOM cap degradation uses, with the regrow
# made additive (classic AIMD converges; multiplicative regrow
# oscillates at the boundary)
_MD_FACTOR = 0.5
_AI_STEP = 0.125
# actuator floor: a cap/wait scaled below this stops coalescing from
# working at all — the brownout machine is the next escalation, not
# ever-smaller batches
_MIN_SCALE = 1.0 / 64.0

# shed_interactive: the queue fraction interactive admission tightens
# to (1/this of `serving_max_queue`); batch is already fully shed
_INTERACTIVE_TIGHTEN = 8

# padding-class bookkeeping bound: distinct buckets retained per model
# for the report (the grid is coarse; real traffic sees a handful)
_MAX_BUCKETS_TRACKED = 32

# the last serving padding-class decision, exposed live
LAST_BUCKET_DECISION: Dict[str, Any] = {}


def resolve_priority(
    requested: Optional[str], model_default: Optional[str]
) -> str:
    """One request's admission class: the caller's explicit class, else
    the model's registered default, else `serving_priority_default`.
    ValueError for names outside PRIORITY_CLASSES (the HTTP front end
    maps it to a 400)."""
    cls = (
        requested
        or model_default
        or str(get_config("serving_priority_default") or "interactive")
    )
    cls = str(cls).strip().lower()
    if cls not in PRIORITY_CLASSES:
        raise ValueError(
            f"unknown priority class {cls!r}; expected one of "
            f"{'|'.join(PRIORITY_CLASSES)}"
        )
    return cls


class _ModelState:
    __slots__ = (
        "cap_scale", "wait_scale", "phase", "hi_since", "lo_since",
        "last_tick", "p99_ms", "buckets",
    )

    def __init__(self) -> None:
        self.cap_scale = 1.0
        self.wait_scale = 1.0
        self.phase = 0
        # monotonic time burn first crossed the brownout / recovery
        # water marks (None = not currently across); sustain windows
        # are measured from these
        self.hi_since: Optional[float] = None
        self.lo_since: Optional[float] = None
        self.last_tick = 0.0
        self.p99_ms: Optional[float] = None
        self.buckets: List[int] = []


class ServingController:
    """Per-server feedback controller: AIMD actuator scales, the
    brownout phase machine, weighted-credit class dispatch, and the
    padding-class record.  One instance per ServingServer; all state
    behind the `serving_control` named lock.  Lock ordering: the
    dispatcher condition (`serving_dispatch`) may be held when calling
    in here; this lock never wraps an acquire of the condition."""

    def __init__(self) -> None:
        self._mu = named_lock("serving_control")
        self._models: Dict[str, _ModelState] = {}
        # weighted round-robin credit for contested dispatch rounds
        # (both classes have a due head): batch accrues
        # `serving_batch_share` credit per interactive win and
        # dispatches when a full credit accumulates
        self._credit = 0.0

    # -- conf accessors ------------------------------------------------------

    def enabled(self) -> bool:
        return str(get_config("serving_controller")).lower() == "on"

    def interval_s(self) -> float:
        return max(
            0.0, float(get_config("serving_controller_interval_s"))
        )

    def burn_high(self) -> float:
        return float(get_config("serving_controller_burn_high"))

    def burn_low(self) -> float:
        return float(get_config("serving_controller_burn_low"))

    def batch_share(self) -> float:
        share = float(get_config("serving_batch_share"))
        return min(1.0, max(0.0, share))

    def padding_enabled(self) -> bool:
        return bool(get_config("serving_padding_buckets"))

    # -- actuator reads (dispatcher + admission) -----------------------------

    def cap_scale(self, name: str) -> float:
        if not self.enabled():
            return 1.0
        with self._mu:
            st = self._models.get(name)
            return st.cap_scale if st is not None else 1.0

    def wait_scale(self, name: str) -> float:
        if not self.enabled():
            return 1.0
        with self._mu:
            st = self._models.get(name)
            return st.wait_scale if st is not None else 1.0

    def scales(self, name: str) -> Tuple[float, float]:
        """(cap_scale, wait_scale) under ONE lock acquisition — the
        dispatcher's coalesce path reads both per queued model per
        round, and at hundreds of pinned models the two separate locked
        reads above double the hot-path lock traffic.  Also gives the
        caller one CONSISTENT snapshot: a controller tick between
        separate reads could pair an old cap with a new wait."""
        if not self.enabled():
            return 1.0, 1.0
        with self._mu:
            st = self._models.get(name)
            if st is None:
                return 1.0, 1.0
            return st.cap_scale, st.wait_scale

    def phase(self, name: str) -> int:
        if not self.enabled():
            return 0
        with self._mu:
            st = self._models.get(name)
            return st.phase if st is not None else 0

    def admit(
        self, name: str, cls: str, queued_total: int, queued_cls: int,
        max_queue: int,
    ) -> Tuple[bool, str, str]:
        """Admission verdict for one `cls` request: (admitted, reason,
        detail).  Reasons: `queue_full` (capacity — the global bound or
        the batch class-share bound) and `shed` (brownout policy).
        With the controller off only the global bound applies."""
        if queued_total >= max_queue:
            return False, "queue_full", (
                f"{queued_total} requests queued "
                f"(serving_max_queue={max_queue})"
            )
        if not self.enabled():
            return True, "", ""
        phase = self.phase(name)
        if cls == "batch":
            if phase >= 1:
                return False, "shed", (
                    f"brownout {BROWNOUT_PHASES[phase]} sheds "
                    "batch-class load"
                )
            limit = max(1, int(max_queue * self.batch_share()))
            reason = "queue_full"
        elif phase >= 2:
            limit = max(1, max_queue // _INTERACTIVE_TIGHTEN)
            reason = "shed"
        else:
            return True, "", ""
        if queued_cls >= limit:
            return False, reason, (
                f"{queued_cls} {cls}-class requests queued "
                f"(class limit {limit} of serving_max_queue={max_queue})"
            )
        return True, "", ""

    def note_shed(self, name: str, cls: str) -> None:
        SHED.inc(model=name, **{"class": cls})

    def pick_class(self) -> str:
        """Contested dispatch round (both classes hold a due head
        somewhere): weighted round-robin credit.  Batch accrues
        `serving_batch_share` credit per interactive win and dispatches
        once a full credit accumulates — one batch round per
        ceil(1/share) contested rounds, so neither class starves."""
        share = self.batch_share()
        with self._mu:
            if self._credit >= 1.0:
                self._credit -= 1.0
                return "batch"
            self._credit += share
            return "interactive"

    # -- feedback ------------------------------------------------------------

    def tick(
        self,
        name: str,
        burn: Optional[float],
        p99_ms: Optional[float],
        base_cap: int,
        base_wait_ms: float,
        now: Optional[float] = None,
    ) -> None:
        """One feedback step for `name`, rate-limited to
        `serving_controller_interval_s` per model.  `burn` is the 1m
        `slo_burn_rate` gauge (None when no SLO target is declared —
        the actuators then only regrow); `p99_ms` rides into the state
        for the report.  Burn >= the high water multiplicatively
        shrinks both actuators, burn <= the low water additively
        regrows them, in between HOLDS (hysteresis).  The brownout
        machine escalates/recovers on its own sustained thresholds."""
        if not self.enabled():
            return
        now = time.monotonic() if now is None else now
        transition = None
        b = 0.0 if burn is None else float(burn)
        with self._mu:
            st = self._models.setdefault(name, _ModelState())
            if now - st.last_tick < self.interval_s():
                return
            st.last_tick = now
            st.p99_ms = p99_ms
            hi, lo = self.burn_high(), self.burn_low()
            if burn is not None and b >= hi:
                if st.cap_scale > _MIN_SCALE or st.wait_scale > _MIN_SCALE:
                    st.cap_scale = max(_MIN_SCALE, st.cap_scale * _MD_FACTOR)
                    st.wait_scale = max(
                        _MIN_SCALE, st.wait_scale * _MD_FACTOR
                    )
                    CTRL_ADJ.inc(model=name, direction="decrease")
            elif b <= lo and (st.cap_scale < 1.0 or st.wait_scale < 1.0):
                st.cap_scale = min(1.0, st.cap_scale + _AI_STEP)
                st.wait_scale = min(1.0, st.wait_scale + _AI_STEP)
                CTRL_ADJ.inc(model=name, direction="increase")
            # brownout phase machine: sustained burn across the high
            # water escalates one phase per sustain window; sustained
            # recovery below the AIMD low water de-escalates one phase
            # per recovery window (each step restarts its timer, so a
            # flapping burn cannot ratchet straight to the worst phase)
            if burn is not None and b >= float(
                get_config("serving_brownout_burn")
            ):
                st.lo_since = None
                if st.hi_since is None:
                    st.hi_since = now
                elif (
                    now - st.hi_since
                    >= float(get_config("serving_brownout_sustain_s"))
                    and st.phase < len(BROWNOUT_PHASES) - 1
                ):
                    transition = (st.phase, st.phase + 1)
                    st.phase += 1
                    st.hi_since = now
            elif b <= lo:
                st.hi_since = None
                if st.lo_since is None:
                    st.lo_since = now
                elif (
                    now - st.lo_since
                    >= float(get_config("serving_brownout_recover_s"))
                    and st.phase > 0
                ):
                    transition = (st.phase, st.phase - 1)
                    st.phase -= 1
                    st.lo_since = now
            else:
                st.hi_since = None
                st.lo_since = None
            CTRL_CAP.set(
                max(1, int(base_cap * st.cap_scale)), model=name
            )
            CTRL_WAIT.set(
                round(base_wait_ms * st.wait_scale, 3), model=name
            )
            BROWNOUT_PHASE.set(st.phase, model=name)
        if transition is not None:
            self._note_transition(name, transition, b)

    def _note_transition(
        self, name: str, transition: Tuple[int, int], burn: float
    ) -> None:
        """A brownout phase change: always a trace instant; escalations
        additionally note a reason="brownout" failure (outside the
        controller lock)."""
        old, new = transition
        detail = (
            f"model={name} {BROWNOUT_PHASES[old]}->{BROWNOUT_PHASES[new]} "
            f"burn={burn:.2f}"
        )
        event(f"serving_brownout[{name}]", detail=detail, log=logger)
        if new > old:
            from ._seams import note_failure

            note_failure("brownout", detail=detail, log=logger)

    # -- padding classes -----------------------------------------------------

    def note_bucket(self, name: str, rows: int) -> int:
        """Record one dispatch's padding-class decision and return the
        bucket the stager will pad to (`parallel/mesh.bucket_rows`)."""
        from ..parallel.mesh import bucket_rows

        bucket = int(bucket_rows(int(rows)))
        decision = {
            "model": name,
            "rows": int(rows),
            "bucket": bucket,
            "pad_rows": bucket - int(rows),
            "stamp": round(time.time(), 3),
        }
        with self._mu:
            LAST_BUCKET_DECISION.clear()
            LAST_BUCKET_DECISION.update(decision)
            st = self._models.setdefault(name, _ModelState())
            if (
                bucket not in st.buckets
                and len(st.buckets) < _MAX_BUCKETS_TRACKED
            ):
                st.buckets.append(bucket)
        return bucket

    # -- report --------------------------------------------------------------

    def model_state(self, name: str) -> Dict[str, Any]:
        """One model's controller state for the serving report."""
        with self._mu:
            st = self._models.get(name)
            if st is None:
                return {
                    "cap_scale": 1.0,
                    "wait_scale": 1.0,
                    "brownout_phase": BROWNOUT_PHASES[0],
                    "padding_classes": [],
                }
            return {
                "cap_scale": round(st.cap_scale, 4),
                "wait_scale": round(st.wait_scale, 4),
                "brownout_phase": BROWNOUT_PHASES[st.phase],
                "padding_classes": sorted(st.buckets),
                **(
                    {"p99_ms": round(st.p99_ms, 3)}
                    if st.p99_ms is not None
                    else {}
                ),
            }

    def brownout_summary(self) -> Dict[str, str]:
        """Models currently in any brownout phase -> phase name."""
        with self._mu:
            return {
                name: BROWNOUT_PHASES[st.phase]
                for name, st in sorted(self._models.items())
                if st.phase > 0
            }


__all__ = [
    "BROWNOUT_PHASES",
    "LAST_BUCKET_DECISION",
    "PRIORITY_CLASSES",
    "ServingController",
    "resolve_priority",
]
