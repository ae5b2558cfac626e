#
# Matmul precision for distance forms whose output is a ranking (kNN
# neighbour ids) and for the sufficient statistics of PCA and
# LinearRegression: the port of spark_rapids_ml_tpu/ops/precision.py.
#
# The conf key `distance_precision` keeps the JAX package's names, mapped
# onto what the card offers for a float32 matmul:
#
#   "highest"  IEEE float32 (TF32 off).  The default, and the only level
#              at which neighbour ranks match the JAX package's.
#   "high"     also IEEE float32.  On the TPU "high" is three bf16 passes
#              (about 2^-14 relative error).  PyTorch's own "high" is TF32,
#              a 10-bit mantissa (about 2^-11), which re-orders near ties
#              that the TPU's "high" keeps; no cuBLAS mode reachable from
#              PyTorch gives 2^-14, so the port takes the exact one.
#   "default"  TF32: the fastest, and rank-unsafe, as the TPU's default
#              single bf16 pass is.
#
# `ieee_matmul` is the level of the solvers' and statistics' matmuls
# (ops/stats.py, ops/logistic.py): always IEEE float32, whatever the conf,
# as the JAX package's "highest".  Those products are matrix-vector
# products, bound by memory, so TF32 would buy nothing and cost accuracy.
#
# Only the plain torch distance forms read `distance_precision`
# (ops/distances.py `sqdist` and the plain twin of the fused kernel).  The hand-written CUDA kernels ignore
# it: float32 runs 3xTF32 on the tensor cores at every level (hi*hi +
# hi*lo + lo*hi with hi = tf32(x), lo = tf32(x - hi), summed in float32:
# about float32's accuracy, rank-exact at the port's tolerances), float64
# runs IEEE FMA in float64.  float64 matmuls are never affected.  The level
# is set around each matmul and restored after it, never for the whole
# process.
#
# The conf key `stats_precision` sets the level of the sufficient-statistics
# products (PCA covariance and projected moments, the LinearRegression Gram
# and cross terms, ops/stats.py, ops/pca.py, ops/linear.py):
#
#   "highest"           IEEE float32 (TF32 off).  The default.
#   "high"              also IEEE float32, for the reason given above: the
#                       TPU's three bf16 passes (about 2^-14) have no cuBLAS
#                       counterpart reachable from PyTorch.
#   "high_compensated"  IEEE float32 products, and each chunk accumulator
#                       carries a Kahan compensation term (ops/stats.py),
#                       so the error across chunks stays bounded however
#                       many chunks a pass folds.
#   "default"           TF32.
#
# float64 statistics are never affected.
#
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from ..config import get_config

_ALLOW_TF32 = {"highest": False, "high": False, "default": True}


def distance_precision() -> str:
    """The checked `distance_precision` level ("highest", "high" or
    "default")."""
    name = str(get_config("distance_precision")).lower()
    if name not in _ALLOW_TF32:
        raise ValueError(
            f"distance_precision must be one of {sorted(_ALLOW_TF32)}, got {name!r}"
        )
    return name


@contextlib.contextmanager
def _tf32(allow: bool) -> Iterator[None]:
    cuda_mm = torch.backends.cuda.matmul
    before = cuda_mm.allow_tf32
    cuda_mm.allow_tf32 = allow
    try:
        yield
    finally:
        cuda_mm.allow_tf32 = before


def matmul_precision():
    """Run the enclosed float32 matmuls at the `distance_precision` level."""
    return _tf32(_ALLOW_TF32[distance_precision()])


def ieee_matmul():
    """Run the enclosed float32 matmuls in IEEE float32 (TF32 off)."""
    return _tf32(False)


_STATS_ALLOW_TF32 = dict(_ALLOW_TF32, high_compensated=False)


def stats_precision() -> str:
    """The checked `stats_precision` level ("highest", "high",
    "high_compensated" or "default")."""
    name = str(get_config("stats_precision")).lower()
    if name not in _STATS_ALLOW_TF32:
        raise ValueError(
            f"stats_precision must be one of {sorted(_STATS_ALLOW_TF32)}; got {name!r}"
        )
    return name


def stats_compensated() -> bool:
    """Whether the chunk accumulators carry a Kahan compensation term per
    accumulated array (`stats_precision="high_compensated"`)."""
    return str(get_config("stats_precision")).lower() == "high_compensated"


def stats_matmul():
    """Run the enclosed float32 statistics matmuls at the `stats_precision`
    level."""
    return _tf32(_STATS_ALLOW_TF32[stats_precision()])
