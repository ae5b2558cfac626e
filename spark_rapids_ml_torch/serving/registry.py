#
# Serving model registry: the port of spark_rapids_ml_tpu/serving/
# registry.py — device residency for the inference side.  A model is
# PINNED once: a shallow copy of it carries its ndarray attributes of at
# least `_PIN_MIN_BYTES` as tensors on the port's default device, copied
# once (the caller's object is never mutated), and its `_transform_device`
# uses them where they lie (core.py `weights_on`), so no request pays a
# weight upload.  Pinning resolves the default device: with no card and
# no request for the CPU it raises, as every entry point does.
#
# Residency is budget-accounted: a pin books its weight bytes through
# `parallel/device_cache.py`'s external-reservation ledger, so fit-side
# staging decisions see serving residency and vice versa; under pressure
# the registry LRU-evicts its own pins and an evicted model transparently
# RE-PINS on its next request.  After a (simulated) device loss the
# dispatcher calls `repin_all`: one card has no survivors, so every
# resident model re-pins on the same card (the full retry).
#
# Models that manage their own staging (kNN, DBSCAN, UMAP — no
# `_transform_device`) register as HOST-path models: their requests still
# coalesce into micro-batches, but dispatch goes through the model's own
# `_transform_array` (or the `transform=` callable) and no residency is
# claimed.
#
from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..telemetry.locks import named_lock
from ..telemetry.registry import counter, gauge
from ..utils import get_logger
from ._seams import MONITOR

logger = get_logger("spark_rapids_ml_torch.serving")

PINS = counter(
    "serving_pins_total",
    "Serving model-pin lifecycle events (pin/repin/evict/unpin) by model",
)
PINNED_MODELS = gauge(
    "serving_pinned_models", "Models currently pinned on the serving device"
)
PINNED_BYTES = gauge(
    "serving_pinned_bytes",
    "Budget-accounted bytes of pinned serving-model residency",
)


def _external_tag(name: str) -> str:
    return f"serving:{name}"


# arrays below this stay host-resident when a model pins: reading an
# element of a pinned (device) tensor is a blocking device fetch, which
# binomial logreg does per dispatch (`self.intercept_[0]`) — scalars and
# tiny vectors (intercepts, variance ratios) are exactly the attrs
# transforms read elementwise, and their per-call upload is noise next to
# one weight matrix
_PIN_MIN_BYTES = 64


class PinnedModel:
    """One registered model, ready to dispatch: the pinned shallow copy
    (device-resident weight tensors when `device` is True), the torch
    device it is pinned on (`torch_device`), and its accounting size."""

    __slots__ = (
        "name", "model", "device", "torch_device", "dtype", "n_features",
        "nbytes", "last_used", "transform_fn",
    )

    def __init__(self, name: str, model: Any, device: bool, torch_device,
                 dtype: np.dtype, n_features: Optional[int],
                 nbytes: int, transform_fn=None) -> None:
        self.name = name
        self.model = model
        self.device = device
        self.torch_device = torch_device
        self.dtype = np.dtype(dtype)
        self.n_features = n_features
        self.nbytes = int(nbytes)
        self.last_used = time.monotonic()
        # host-path dispatch callable (X) -> {col: array}; None for
        # device-pinned models (they dispatch via _transform_device)
        self.transform_fn = transform_fn


class ModelRegistry:
    """Name-keyed registry of serveable models.  `register` keeps the
    caller's HOST model (the re-pin source) and pins it; `resolve`
    returns the pinned entry, transparently re-pinning one that was
    LRU-evicted under budget pressure.  All mutations hold the instance
    lock; pinning itself (device transfers) runs outside it so a slow
    replication cannot stall concurrent resolves of other models."""

    def __init__(self) -> None:
        self._mu = named_lock("serving_registry", kind="rlock")
        self._host: Dict[str, Dict[str, Any]] = {}  # name -> registration
        self._pinned: Dict[str, PinnedModel] = {}
        # incremental sum of pinned nbytes, maintained by _publish_locked
        # and _drop: pinned_bytes()/_sync_gauges() are polled per report
        # and per pin/drop, and a full-table scan there is O(pins) work
        # under the registry lock every time — at hundreds of pinned
        # models that scan IS the report path's cost
        self._pinned_total_bytes = 0

    # -- registration --------------------------------------------------------

    def register(
        self,
        name: str,
        model: Any,
        dtype: Any = np.float32,
        n_features: Optional[int] = None,
        transform: Any = None,
        priority: Optional[str] = None,
    ) -> PinnedModel:
        """Register `model` under `name` and pin it.  Models with a
        device transform (`_transform_device`) pin device-resident;
        models without one (kNN and friends manage their own staging)
        register as host-path — coalesced micro-batching still applies,
        residency accounting does not.  `transform` overrides the
        host-path dispatch callable (`(X) -> {col: array}`; default
        `model._transform_array`) — the kNN hook, whose query surface is
        `kneighbors`, not transform.  `priority` sets the model's
        DEFAULT admission class (`interactive` | `batch`) for requests
        that do not name one — a background scoring model registers as
        `batch` once instead of tagging every request."""
        from ..core import _TpuModel
        from .control import PRIORITY_CLASSES

        if priority is not None and priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {priority!r}; expected one of "
                f"{'|'.join(PRIORITY_CLASSES)}"
            )

        if not isinstance(model, _TpuModel):
            raise TypeError(
                f"serving requires a fitted _TpuModel, got {type(model)!r}"
            )
        has_device = (
            type(model)._transform_device is not _TpuModel._transform_device
        )
        if not has_device and transform is None and (
            type(model)._transform_array is _TpuModel._transform_array
        ):
            raise ValueError(
                f"model {name!r} implements neither _transform_device nor "
                "_transform_array; pass transform=<callable> to serve it"
            )
        if n_features is None:
            nc = model._get_model_attributes().get("n_cols")
            if nc is not None:
                n_features = int(nc)
        with self._mu:
            self._host[name] = {
                "model": model,
                "dtype": np.dtype(dtype),
                "n_features": n_features,
                "transform": transform,
                "priority": priority,
            }
        # the drift monitor (a seam until it is ported): a model carrying a
        # fit-time baseline registers it WITH the pin; the port's models
        # carry none yet
        fp = getattr(model, "_drift_baseline", None)
        if fp is not None:
            MONITOR.register(name, fp)
        else:
            MONITOR.drop(name)
        return self._pin(name, event="pin")

    def unregister(self, name: str) -> None:
        with self._mu:
            self._host.pop(name, None)
        MONITOR.drop(name)
        self._drop(name, event="unpin")

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._host)

    def info(self, name: str) -> Dict[str, Any]:
        """Registration facts for the admission check — never pins."""
        with self._mu:
            reg = self._host.get(name)
            if reg is None:
                raise KeyError(f"no serving model registered as {name!r}")
            return dict(reg)

    def pin_feature_width(self, name: str, d: int) -> int:
        """Adopt the first observed request width for a model registered
        WITHOUT `n_features`, atomically; returns the canonical width.
        Without this, two concurrent first requests of different widths
        would coalesce into one batch and the np.concatenate failure
        would poison the valid request alongside the bad one — admission
        must reject the mismatch instead."""
        with self._mu:
            reg = self._host.get(name)
            if reg is None:
                raise KeyError(f"no serving model registered as {name!r}")
            if reg.get("n_features") is None:
                reg["n_features"] = int(d)
            return int(reg["n_features"])

    def pinned_names(self) -> List[str]:
        with self._mu:
            return sorted(self._pinned)

    def is_pinned(self, name: str) -> bool:
        """O(1) pin probe for the per-model report paths: building the
        sorted `pinned_names()` list just to test membership is an
        O(n log n) sort per poll, paid once per model row at hundreds
        of pinned models."""
        with self._mu:
            return name in self._pinned

    # -- resolution ----------------------------------------------------------

    def resolve(self, name: str) -> PinnedModel:
        """The pinned entry for `name`, re-pinning an evicted model (a
        cache-miss-shaped event: the host model is the re-pin source)."""
        with self._mu:
            if name not in self._host:
                raise KeyError(f"no serving model registered as {name!r}")
            entry = self._pinned.get(name)
            if entry is not None:
                entry.last_used = time.monotonic()
                return entry
        return self._pin(name, event="repin")

    # -- pinning -------------------------------------------------------------

    def _pin(self, name: str, event: str) -> PinnedModel:
        from ..core import _TpuModel
        from ..parallel.context import resolve_device
        from ..parallel.device_cache import reserve_external

        with self._mu:
            reg = dict(self._host[name])
        model = reg["model"]
        has_device = (
            type(model)._transform_device is not _TpuModel._transform_device
        )
        if not has_device:
            entry = PinnedModel(
                name, model, device=False, torch_device=None,
                dtype=reg["dtype"], n_features=reg["n_features"], nbytes=0,
                transform_fn=reg.get("transform") or model._transform_array,
            )
            with self._mu:
                self._publish_locked(name, entry)
            PINS.inc(model=name, event=event)
            self._sync_gauges()
            return entry
        # the default device: raises without a card unless the caller
        # asked for the CPU — never a quiet fallback
        target = resolve_device()
        nbytes = self._pinned_bytes_of(model)
        # book the residency BEFORE copying: under pressure, evict our own
        # LRU pins (never the one being pinned) until it fits — the
        # dataset-cache side of the ledger LRU-evicts its entries first.
        # Eviction is BATCHED: one shortfall read sizes a single sorted
        # LRU pass and one ledger round-trip frees every victim.  The
        # per-victim loop stays as a fallback for the race where another
        # pinner claims the freed headroom between our release and retry.
        if not reserve_external(_external_tag(name), nbytes):
            self._evict_batch(exclude=name, shortfall=self._shortfall(
                name, nbytes))
            while not reserve_external(_external_tag(name), nbytes):
                if not self._evict_lru(exclude=name):
                    raise RuntimeError(
                        f"serving model {name!r} (~{nbytes/2**20:.1f} MiB) "
                        "does not fit the device budget even with every "
                        "other pin evicted"
                    )
        pinned_model = self._replicate_arrays(model, target)
        entry = PinnedModel(
            name, pinned_model, device=True, torch_device=target,
            dtype=reg["dtype"], n_features=reg["n_features"], nbytes=nbytes,
        )
        with self._mu:
            self._publish_locked(name, entry)
        PINS.inc(model=name, event=event)
        from ..tracing import event as trace_event

        trace_event(
            f"serving_pin[{name}]",
            detail=f"{event} bytes={nbytes} n_dev=1",
            log=logger,
        )
        self._sync_gauges()
        return entry

    @staticmethod
    def _pinned_arrays(model: Any) -> Dict[str, np.ndarray]:
        """The arrays a pin moves to the device, by attribute name: each
        numeric ndarray model attribute of at least `_PIN_MIN_BYTES`, as
        the model instance holds it (the array its transform reads)."""
        out: Dict[str, np.ndarray] = {}
        for key, val in model._get_model_attributes().items():
            inst = getattr(model, key, None)
            if isinstance(inst, np.ndarray):
                val = inst
            if (isinstance(val, np.ndarray) and val.dtype != object
                    and val.nbytes >= _PIN_MIN_BYTES):
                out[key] = val
        return out

    def _pinned_bytes_of(self, model: Any) -> int:
        return int(sum(v.nbytes for v in self._pinned_arrays(model).values()))

    def _replicate_arrays(self, model: Any, target) -> Any:
        """A shallow copy of `model` whose pinned arrays are tensors on
        `target`, copied once in their dtype: its instance attributes of
        those names, and its attribute dict where the shapes agree.  The
        copy ends in a synchronization of the current stream, so every
        serving stream may read the weights at once."""
        import torch

        pinned = copy.copy(model)
        attrs = dict(model._get_model_attributes())
        for key, val in self._pinned_arrays(model).items():
            dev = torch.tensor(val, device=target)
            if isinstance(getattr(pinned, key, None), np.ndarray):
                setattr(pinned, key, dev)
            if np.shape(attrs.get(key)) == tuple(dev.shape):
                attrs[key] = dev
        if target.type == "cuda":
            torch.cuda.current_stream(target).synchronize()
        pinned._model_attributes = attrs
        return pinned

    def _publish_locked(self, name: str, entry: PinnedModel) -> None:
        """Install `entry` in the pin table keeping the incremental byte
        counter exact — a re-register overwrites an existing pin, whose
        bytes must leave the sum (its ledger claim was already replaced
        by the same-tag `reserve_external`)."""
        old = self._pinned.get(name)
        if old is not None:
            self._pinned_total_bytes -= old.nbytes
        self._pinned[name] = entry
        self._pinned_total_bytes += entry.nbytes

    def _shortfall(self, name: str, nbytes: int) -> int:
        from ..parallel.device_cache import get_device_cache

        return get_device_cache().external_shortfall(_external_tag(name), nbytes)

    # -- eviction ------------------------------------------------------------

    def _evict_batch(self, exclude: Optional[str], shortfall: int) -> int:
        """Evict LRU pins covering `shortfall` bytes in ONE sorted pass,
        releasing their ledger claims through ONE batched round-trip
        (`release_external_many`).  Returns the number of victims; 0
        when nothing is evictable (the caller's per-victim fallback
        then raises the does-not-fit error)."""
        from ..parallel.device_cache import release_external_many

        if shortfall <= 0:
            return 0
        with self._mu:
            candidates = sorted(
                (e for e in self._pinned.values()
                 if e.device and e.name != exclude),
                key=lambda e: e.last_used,
            )
            victims: List[PinnedModel] = []
            freed = 0
            for e in candidates:
                if freed >= shortfall:
                    break
                victims.append(e)
                freed += e.nbytes
            for e in victims:
                self._pinned.pop(e.name, None)
                self._pinned_total_bytes -= e.nbytes
        if not victims:
            return 0
        release_external_many([_external_tag(e.name) for e in victims])
        for e in victims:
            PINS.inc(model=e.name, event="evict")
        self._sync_gauges()
        logger.info(
            f"serving: batch-evicted {len(victims)} pin(s) "
            f"({freed/2**20:.1f} MiB) to fit a new pin"
        )
        return len(victims)

    def _evict_lru(self, exclude: Optional[str] = None) -> bool:
        with self._mu:
            candidates = [
                e for e in self._pinned.values()
                if e.device and e.name != exclude
            ]
            if not candidates:
                return False
            victim = min(candidates, key=lambda e: e.last_used)
        self._drop(victim.name, event="evict")
        return True

    def _drop(self, name: str, event: str) -> None:
        from ..parallel.device_cache import release_external

        with self._mu:
            entry = self._pinned.pop(name, None)
            if entry is not None:
                self._pinned_total_bytes -= entry.nbytes
        if entry is None:
            return
        if entry.device:
            release_external(_external_tag(name))
        PINS.inc(model=name, event=event)
        self._sync_gauges()

    def repin_all(self, reason: str = "elastic") -> None:
        """Drop every device-resident pin and re-pin on the current
        default device — the dispatcher's hook after a simulated device
        loss: one card has no survivors, so the full retry re-pins every
        model on the same card.  The drop phase is BATCHED: one pin-table
        pass plus one ledger round-trip frees every claim at once.  A
        real sticky CUDA error never reaches this: the server stops
        instead of re-pinning on a poisoned context."""
        from ..parallel.device_cache import release_external_many

        with self._mu:
            dropped = [e for e in self._pinned.values() if e.device]
            for e in dropped:
                self._pinned.pop(e.name, None)
                self._pinned_total_bytes -= e.nbytes
        names = [e.name for e in dropped]
        logger.warning(
            f"serving: re-pinning {len(names)} model(s) on the default "
            f"device ({reason})"
        )
        if not names:
            return
        release_external_many([_external_tag(n) for n in names])
        for name in names:
            PINS.inc(model=name, event="evict")
        self._sync_gauges()
        for name in names:
            self._pin(name, event="repin")

    def pin_info(self, name: str) -> Dict[str, Any]:
        """Pin status + accounting for ONE model (the per-model HTTP
        detail endpoint): KeyError for unregistered names."""
        with self._mu:
            reg = self._host.get(name)
            if reg is None:
                raise KeyError(f"no serving model registered as {name!r}")
            e = self._pinned.get(name)
            return {
                "pinned": e is not None,
                "device": bool(e.device) if e is not None else False,
                "pinned_bytes": int(e.nbytes) if e is not None else 0,
                "n_features": reg.get("n_features"),
                "dtype": str(np.dtype(reg["dtype"])),
            }

    def clear(self) -> None:
        with self._mu:
            names = list(self._pinned)
            hosted = list(self._host)
        for name in names:
            self._drop(name, event="unpin")
        for name in hosted:
            MONITOR.drop(name)
        with self._mu:
            self._host.clear()

    def pinned_bytes(self) -> int:
        # incremental counter, NOT a table scan: this is polled per
        # report/admission check and must stay O(1) at hundreds of pins
        with self._mu:
            return self._pinned_total_bytes

    def _sync_gauges(self) -> None:
        with self._mu:
            PINNED_MODELS.set(len(self._pinned))
            PINNED_BYTES.set(self._pinned_total_bytes)


__all__ = ["ModelRegistry", "PinnedModel"]
