#
# Squared euclidean distances by the matmul identity: the port of
# `sqdist` in spark_rapids_ml_tpu/ops/distances.py.  The matmul runs at the
# `distance_precision` level (ops/precision.py); it is a plain cuBLAS
# product, as the JAX package left it to XLA.
#
from __future__ import annotations

from typing import Optional

import torch

from .precision import matmul_precision


def sqdist(
    Q: torch.Tensor,  # (q, d)
    X: torch.Tensor,  # (m, d)
    q2: Optional[torch.Tensor] = None,  # (q, 1) precomputed norms
    x2: Optional[torch.Tensor] = None,  # (m,)
) -> torch.Tensor:
    """(q, m) squared euclidean distances, clamped at 0."""
    if q2 is None:
        q2 = (Q * Q).sum(dim=1, keepdim=True)
    if x2 is None:
        x2 = (X * X).sum(dim=1)
    with matmul_precision():
        qx = Q @ X.T
    # in place, in the JAX form's order: (q2 - 2 qx) + x2, then the clamp;
    # -2 qx is exact, so the roundings are those of q2 - 2.0 * qx + x2
    return qx.mul_(-2.0).add_(q2).add_(x2).clamp_(min=0.0)
