#
# Utilities — the port of the pieces of spark_rapids_ml_tpu/utils.py the
# port uses: the per-class logger, the host batch record, the partition
# layout of a fit and `prefetch_iter`, the producer thread of the fused
# pass and of the parquet streams; and `timer_span`, the layer timer hook
# of the ops that take `timer=`.
#
from __future__ import annotations

import contextlib
import logging
import queue
import sys
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Type, Union

import numpy as np

_logger_initialized = set()


def timer_span(timer, name: str):
    """`timer.span(name)` where a caller times the layers, else nothing."""
    return timer.span(name) if timer is not None else contextlib.nullcontext()


def get_logger(cls: Union[Type, str], level: int = logging.INFO) -> logging.Logger:
    """Per-class stderr logger."""
    name = cls if isinstance(cls, str) else f"spark_rapids_ml_torch.{cls.__name__}"
    logger = logging.getLogger(name)
    if name not in _logger_initialized:
        logger.setLevel(level)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.propagate = False
        _logger_initialized.add(name)
    return logger


@dataclass
class _ArrayBatch:
    """A host batch: features plus optional label/weight/id columns."""

    X: np.ndarray
    y: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    row_id: Optional[np.ndarray] = None


@dataclass
class PartitionDescriptor:
    """Row layout of a fit: m rows, n features, and (part, rows) per part.
    One device holds one part."""

    m: int
    n: int
    parts_rank_size: List[tuple]

    @classmethod
    def build(cls, partition_rows: List[int], total_cols: int) -> "PartitionDescriptor":
        return cls(
            m=int(sum(partition_rows)),
            n=int(total_cols),
            parts_rank_size=[(i, int(r)) for i, r in enumerate(partition_rows)],
        )


def prefetch_iter(it: Iterable, depth: int) -> Iterator:
    """Run `it` on a daemon thread up to `depth` items ahead of the
    consumer (a queue of depth - 1 plus the item in the producer's hand).
    A producer exception is raised on the consumer; a consumer that stops
    early stops the producer.  depth <= 1: plain iteration, no thread."""
    if depth <= 1:
        yield from it
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth - 1)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # raised again on the consumer
            put(e)
            return
        put(done)

    t = threading.Thread(target=producer, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)
