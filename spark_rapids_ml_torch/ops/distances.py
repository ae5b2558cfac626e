#
# Distance forms and the metric zoo of the kNN graphs: the port of
# spark_rapids_ml_tpu/ops/distances.py.
#
#   sqdist, sqdist_gathered  squared euclidean by the matmul identity, the
#                            products at the `distance_precision` level
#                            (ops/precision.py): all rows against all
#                            items, and each row against its own gathered
#                            candidates (IVF and CAGRA);
#   metric_kind, preprocess_rows, finalize_sqdist
#                            the "matmul" metrics (cosine, correlation,
#                            hellinger) as euclidean distance of rows
#                            transformed on the host, and the squared
#                            distance turned into the metric's own;
#   knn_topk_metric          brute force under an "elementwise" metric
#                            (manhattan, chebyshev, canberra, minkowski,
#                            hamming, jaccard), a host loop over (query
#                            block, item block) tiles folded into a running
#                            top-k;
#   umap_knn_graph           the dispatch of UMAP's brute-force graph: the
#                            matmul family through `knn_topk_single` (the
#                            fused kernel on the card), the rest tiled.
#
# One device: a mesh of several devices raises (ROADMAP.md item 8).  Tiles
# are sized by bytes, not the TPU's (512, 2048) blocks; the result does not
# depend on the tiling, since ties go to the lower item position in every
# fold.
#
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .precision import matmul_precision

# bytes of one (query block, item block, d) broadcast tile of the
# elementwise metrics
_TILE_BYTES = 256 << 20


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


def sqdist_gathered(
    B: torch.Tensor,  # (r, d) one vector per row
    Xc: torch.Tensor,  # (r, C, d) gathered candidates per row
    b2: torch.Tensor,  # (r,) row-vector norms
    c2: torch.Tensor,  # (r, C) candidate norms
) -> torch.Tensor:
    """(r, C) squared euclidean distances of each row to its own
    candidates, clamped at 0: one batched matrix-vector product."""
    with matmul_precision():
        dot = torch.bmm(Xc, B[:, :, None])[:, :, 0]
    return dot.mul_(-2.0).add_(b2[:, None]).add_(c2).clamp_(min=0.0)


MATMUL_METRICS = {
    "euclidean", "l2", "sqeuclidean", "cosine", "correlation", "hellinger",
}
ELEMENTWISE_METRICS = {
    "manhattan", "l1", "cityblock", "taxicab", "chebyshev", "linf",
    "canberra", "minkowski", "hamming", "jaccard",
}
SUPPORTED_METRICS = MATMUL_METRICS | ELEMENTWISE_METRICS


def metric_kind(metric: str) -> str:
    if metric in MATMUL_METRICS:
        return "matmul"
    if metric in ELEMENTWISE_METRICS:
        return "elementwise"
    raise ValueError(
        f"metric '{metric}' is not supported; choose from "
        + ", ".join(sorted(SUPPORTED_METRICS))
    )


def preprocess_rows(X, metric: str):
    """Host-side row transform that maps a matmul-family metric onto plain
    euclidean distance of the transformed rows."""
    X = np.asarray(X)
    if metric == "cosine":
        return X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    if metric == "correlation":
        Xc = X - X.mean(axis=1, keepdims=True)
        return Xc / np.maximum(np.linalg.norm(Xc, axis=1, keepdims=True), 1e-12)
    if metric == "hellinger":
        if (X < 0).any():
            raise ValueError("hellinger requires non-negative features")
        # ||sqrt(x)-sqrt(y)|| / sqrt(2): fold the 1/sqrt(2) into the rows
        return np.sqrt(X) / np.sqrt(2.0)
    return X


def finalize_sqdist(d2: torch.Tensor, metric: str) -> torch.Tensor:
    """Squared euclidean distance -> the metric's reported distance: cosine
    and correlation report 1 - cos (unit rows: ||u - v||^2 / 2),
    euclidean, l2 and hellinger the root."""
    if metric == "sqeuclidean":
        return d2
    if metric in ("cosine", "correlation"):
        return d2 / 2.0
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _pairwise_elementwise(Qb, Xb, metric: str, p: float):
    """(qb, mb) distances from (qb, d) x (mb, d), one broadcast tile."""
    diff = Qb[:, None, :] - Xb[None, :, :]  # (qb, mb, d)
    if metric in ("manhattan", "l1", "cityblock", "taxicab"):
        return diff.abs_().sum(dim=2)
    if metric in ("chebyshev", "linf"):
        return diff.abs_().amax(dim=2)
    if metric == "canberra":
        denom = Qb.abs()[:, None, :] + Xb.abs()[None, :, :]
        ratio = diff.abs_() / torch.clamp(denom, min=1e-30)
        return torch.where(denom > 0, ratio, 0.0).sum(dim=2)
    if metric == "minkowski":
        return (diff.abs_() ** p).sum(dim=2) ** (1.0 / p)
    if metric == "hamming":
        return (Qb[:, None, :] != Xb[None, :, :]).to(Qb.dtype).mean(dim=2)
    if metric == "jaccard":
        # binarized set distance 1 - |x & y| / |x | y|; two all-zero rows
        # are at distance 0, as in scipy and umap-learn.  The union comes
        # from the per-row nonzero counts: nnz(q) + nnz(x) - inter
        qa = Qb != 0
        xa = Xb != 0
        inter = (qa[:, None, :] & xa[None, :, :]).sum(dim=2).to(Qb.dtype)
        union = (qa.sum(dim=1).to(Qb.dtype)[:, None]
                 + xa.sum(dim=1).to(Qb.dtype)[None, :] - inter)
        return torch.where(union > 0, 1.0 - inter / torch.clamp(union, min=1.0), 0.0)
    raise ValueError(f"not an elementwise metric: {metric}")


def knn_topk_metric(
    items: torch.Tensor,  # (n, d)
    item_valid: torch.Tensor,  # (n,)
    item_ids: torch.Tensor,  # (n,)
    queries: torch.Tensor,  # (q, d)
    k: int,
    metric: str,
    p: float = 2.0,
    tile_bytes: int = _TILE_BYTES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force kNN under an elementwise metric, tiled over queries and
    items: peak memory is one (query block, item block, d) tile of at most
    `tile_bytes`.  Returns (distances (q, k), ids (q, k)), best first;
    invalid items never appear (distance +inf, tail ids -1 when k exceeds
    the valid count)."""
    from .knn import _merge_topk

    q, d = queries.shape
    n = items.shape[0]
    per_pair = max(d, 1) * queries.element_size()
    iblock = max(1, min(n, 2048, tile_bytes // per_pair))
    qblock = max(1, min(q, tile_bytes // (per_pair * iblock)))
    valid = item_valid > 0
    out_d = torch.empty((q, k), dtype=queries.dtype, device=queries.device)
    out_i = torch.empty((q, k), dtype=item_ids.dtype, device=queries.device)
    for q0 in range(0, q, qblock):
        Qb = queries[q0 : q0 + qblock]
        run_d = torch.full((Qb.shape[0], k), float("inf"), dtype=queries.dtype,
                           device=queries.device)
        run_i = torch.full((Qb.shape[0], k), -1, dtype=item_ids.dtype,
                           device=queries.device)
        for i0 in range(0, n, iblock):
            dist = _pairwise_elementwise(Qb, items[i0 : i0 + iblock], metric, p)
            dist = torch.where(valid[None, i0 : i0 + iblock], dist, float("inf"))
            run_d, run_i = _merge_topk(run_d, run_i, dist,
                                       item_ids[None, i0 : i0 + iblock], k)
        out_d[q0 : q0 + qblock] = run_d
        out_i[q0 : q0 + qblock] = run_i
    return out_d, out_i


def umap_knn_graph(
    X_items,
    item_valid,
    item_ids,
    queries,
    k: int,
    metric: str,
    p: float = 2.0,
    mesh=None,
):
    """Metric-dispatching kNN of the UMAP fit and transform: matmul-family
    metrics ride `knn_topk_single` (callers transform the rows with
    `preprocess_rows` first), elementwise metrics the tiled form.  Returns
    FINAL distances (not squared) and ids.  One device: a `mesh` of more
    than one device raises."""
    from .knn import knn_topk_single

    kind = metric_kind(metric)
    if mesh is not None and np.asarray(mesh.devices).size > 1:
        raise NotImplementedError(
            "umap_knn_graph over a mesh of several devices (the ring and the "
            "query-sharded tiled form) is the 'Multi-GPU and multi-process' "
            "item (8) of ROADMAP.md"
        )
    if kind == "matmul":
        d2, ids = knn_topk_single(X_items, item_valid, item_ids, queries, k=k)
        return finalize_sqdist(d2, metric), ids
    return knn_topk_metric(X_items, item_valid, item_ids, queries, k=k, metric=metric, p=p)
