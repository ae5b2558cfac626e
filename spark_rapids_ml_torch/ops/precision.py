#
# Matmul precision for distance forms whose output is a ranking (kNN
# neighbour ids): the port of spark_rapids_ml_tpu/ops/precision.py.
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
