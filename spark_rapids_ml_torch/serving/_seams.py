#
# The two hooks the serving layer calls into modules the port has not
# written yet (ROADMAP.md section 1, item 6): the failure flight recorder's
# `note_failure` (the JAX package's telemetry/flight_recorder.py) and the
# drift monitor (its monitor/).  Until those land, a failure is logged and
# no bundle is written, and no model is monitored, so the serving report
# has no "drift" key.
#
from __future__ import annotations

from typing import Any, Optional

from ..utils import get_logger

logger = get_logger("spark_rapids_ml_torch.serving")


def note_failure(reason: str, detail: str = "", log: Optional[Any] = None) -> None:
    """A typed failure path the flight recorder would leave a post-mortem
    bundle for; logged only."""
    (log or logger).warning(f"failure[{reason}] {detail}")


class _NoMonitor:
    """The drift monitor's surface, tracking nothing."""

    def register(self, name: str, baseline: Any) -> None:
        pass

    def drop(self, name: str) -> None:
        pass

    def tracks(self, name: str) -> bool:
        return False

    def summary(self, name: str) -> None:
        return None


MONITOR = _NoMonitor()
