#
# Utilities — the port of the pieces of spark_rapids_ml_tpu/utils.py the
# kNN slice uses: the per-class logger and the host batch record.
#
from __future__ import annotations

import logging
import sys
from dataclasses import dataclass
from typing import Optional, Type, Union

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
