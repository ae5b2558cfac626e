#
# Utilities — the port of the pieces of spark_rapids_ml_tpu/utils.py the
# port uses: the per-class logger, the host batch record and the partition
# layout of a fit.
#
from __future__ import annotations

import logging
import sys
from dataclasses import dataclass
from typing import List, Optional, Type, Union

import numpy as np

_logger_initialized = set()


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
