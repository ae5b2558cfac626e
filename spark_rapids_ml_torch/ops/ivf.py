#
# IVF (inverted-file) approximate nearest neighbours: the port of
# spark_rapids_ml_tpu/ops/ivf.py.
#
#   build_ivfflat   the coarse quantizer (ops/kmeans.py k-means++ on a
#                   sample of at most max(256 nlist, 16384) rows), every
#                   row's nearest centre on the device, and the padded
#                   inverted file assembled on the host: a stable argsort,
#                   oversized lists split into sub-lists of `cap` rows,
#                   `sub_table` naming each parent cell's sub-lists;
#   search_ivfflat  the probe (the nprobe nearest parent cells), their
#                   sub-lists front-packed in descending id order, and a
#                   host loop over the batch's live steps that gathers one
#                   sub-list per query and folds it into a running top-k;
#   build_ivfpq, search_ivfpq
#                   the same inverted file holding uint8 product-quantizer
#                   codes of each row's residual to its parent centre, one
#                   codebook per subspace, and the asymmetric search: each
#                   (query, probed parent) pair's lookup tables computed
#                   once, then the same fold over the codes.
#
# Torch ops throughout, on the device of the tensors given: gathers,
# batched products at the `distance_precision` level, and `smallest_k`
# (ops/knn.py), which orders ties as `lax.top_k` does.  The training
# draws cannot be reproduced across packages (the k-means seeding uses
# `jax.random` there), so `centers=` and `codebooks=` hand trained ones in
# and skip the training; the numpy sample draws are the JAX package's.
# The bucket fill is vectorised (one copy per list instead of a loop over
# sub-lists), with the same result.
#
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel import resolve_device
from ..utils import timer_span
from .distances import sqdist, sqdist_gathered
from .kmeans import row_norms
from .knn import smallest_k
from .precision import matmul_precision

# Host seconds of each part of the last build: "sample", "quantizer",
# "assign", "bucketize"; IVF-PQ adds "residuals", "codebooks", "codes",
# "code_fill".  The device parts end in a fetch, so their time is the
# device's work plus the copies.
LAST_BUILD: dict = {}


class IVFFlatIndex(NamedTuple):
    """Inverted file with oversized lists split into capped SUB-LISTS:
    `centers` stays the (nlist, d) coarse parents a query probes;
    `sub_table[p]` names the sub-lists storing parent p's rows (-1 pad).
    Host numpy arrays."""

    centers: np.ndarray  # (nlist, d) coarse PARENT centroids
    buckets: np.ndarray  # (nsub, cap, d) capped sub-list vectors
    bucket_ids: np.ndarray  # (nsub, cap) int32 positional item ids, -1 pad
    bucket_valid: np.ndarray  # (nsub, cap) 1.0 real / 0.0 pad
    sub_table: np.ndarray  # (nlist, max_sub) int32 sub-list ids, -1 pad


class IVFPQIndex(NamedTuple):
    centers: np.ndarray  # (nlist, d) coarse PARENT centroids
    codebooks: np.ndarray  # (M, ksub, dsub) per-subspace codebooks
    codes: np.ndarray  # (nsub, cap, M) uint8 PQ codes of residuals
    bucket_ids: np.ndarray  # (nsub, cap) int32
    bucket_valid: np.ndarray  # (nsub, cap)
    sub_table: np.ndarray  # (nlist, max_sub) int32 sub-list ids, -1 pad


def _quantizer_train_rows(n: int, nlist: int) -> int:
    """Coarse-quantizer training-set size: all rows at small n, 256 rows a
    list (at least 16384) past it, capped at n."""
    return min(n, max(nlist * 256, 16384))


def _assign_chunked(X: np.ndarray, centers: torch.Tensor) -> np.ndarray:
    """The nearest centre of every host row, int32: rows staged to the
    centres' device in chunks whose (chunk, k) distances and (chunk, d)
    rows take about 1 GiB."""
    from .kmeans import kmeans_predict

    n, d = X.shape
    k = int(centers.shape[0])
    chunk = int(max(8192, min(n, (1 << 28) // max(k + d, 1))))
    out = np.empty((n,), np.int32)
    for at in range(0, n, chunk):
        Xc = torch.from_numpy(np.ascontiguousarray(X[at : at + chunk])).to(centers.device)
        out[at : at + chunk] = kmeans_predict(Xc, centers).cpu().numpy()
    return out


def _train_kmeans_budgeted(Xtr: torch.Tensor, k: int, seed: int, max_iter: int,
                           init: str = "k-means++") -> torch.Tensor:
    """Quantizer and codebook k-means through ops/kmeans.py's gate."""
    from .kmeans import kmeans_fit_auto

    w = torch.ones((int(Xtr.shape[0]),), dtype=Xtr.dtype, device=Xtr.device)
    centers, _, _, _ = kmeans_fit_auto(Xtr, w, k=k, seed=seed, max_iter=max_iter,
                                       tol=1e-4, init=init)
    return centers


def _train_sample(n: int, n_train: int, seed: int):
    """The JAX package's training sample: `default_rng(seed).choice`
    without replacement, or every row."""
    if n_train < n:
        return np.random.default_rng(seed).choice(n, size=n_train, replace=False)
    return slice(None)


def _tick(name: str, t0: float) -> float:
    t = time.perf_counter()
    LAST_BUILD[name] = LAST_BUILD.get(name, 0.0) + (t - t0)
    return t


def build_ivfflat(X: np.ndarray, nlist: int, seed: int = 42, kmeans_iters: int = 20,
                  centers: Optional[np.ndarray] = None, device=None) -> IVFFlatIndex:
    """Train the coarse quantizer on `device` (or take `centers`) and
    assemble the padded inverted file on the host."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    n, d = X.shape
    dev = resolve_device(device)
    LAST_BUILD.clear()
    t = time.perf_counter()
    if centers is None:
        sel = _train_sample(n, _quantizer_train_rows(n, nlist), seed)
        Xtr = torch.from_numpy(np.ascontiguousarray(X[sel])).to(dev)
        t = _tick("sample", t)
        C = _train_kmeans_budgeted(Xtr, nlist, seed, kmeans_iters)
        del Xtr
        centers = C.cpu().numpy()
    else:
        centers = np.ascontiguousarray(centers, dtype=np.float32)
        C = torch.tensor(centers, device=dev)
    t = _tick("quantizer", t)
    assign = _assign_chunked(X, C)
    t = _tick("assign", t)
    index = _bucketize(X, assign, centers, nlist)
    _tick("bucketize", t)
    return index


def _bucketize(X: np.ndarray, assign: np.ndarray, centers: np.ndarray,
               nlist: int) -> IVFFlatIndex:
    """The padded inverted file of rows assigned to `nlist` parents.

    Rows go to their parent's sub-lists in the order of a stable argsort
    (row order within a list); a parent with c rows gets ceil(c / cap)
    sub-lists, numbered parent by parent, and an empty parent none (an
    all -1 `sub_table` row, which the search masks).  `cap` is 1.25 times
    the mean list length, at least 32, so padding stays near 1.25x the
    data however skewed the lists."""
    n, d = X.shape
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nlist)
    n_mean = max(int(np.ceil(n / max(nlist, 1))), 1)
    cap = max(32, int(np.ceil(1.25 * n_mean)))
    subs = -(-counts // cap)  # sub-lists of each parent
    nsub = max(int(subs.sum()), 1)
    max_sub = max(int(subs.max()), 1) if nlist else 1
    sub_base = np.concatenate([[0], np.cumsum(subs)[:-1]]).astype(np.int64)
    sub_table = np.full((nlist, max_sub), -1, np.int32)
    parent = np.repeat(np.arange(nlist), subs)
    sub_table[parent, np.arange(parent.size) - sub_base[parent]] = np.arange(
        parent.size, dtype=np.int32)
    buckets = np.zeros((nsub, cap, d), np.float32)
    bucket_ids = np.full((nsub, cap), -1, np.int32)
    bucket_valid = np.zeros((nsub, cap), np.float32)
    # a parent's rows fill its sub-lists' slots in one contiguous run
    flat_rows = buckets.reshape(nsub * cap, d)
    flat_ids = bucket_ids.reshape(-1)
    flat_valid = bucket_valid.reshape(-1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for lst in np.flatnonzero(counts):
        c = int(counts[lst])
        at = int(sub_base[lst]) * cap
        idx = order[starts[lst] : starts[lst] + c]
        np.take(X, idx, axis=0, out=flat_rows[at : at + c])
        flat_ids[at : at + c] = idx
        flat_valid[at : at + c] = 1.0
    return IVFFlatIndex(centers, buckets, bucket_ids, bucket_valid, sub_table)


def _probe(queries: torch.Tensor, centers: torch.Tensor, sub_table: torch.Tensor,
           nprobe: int):
    """(q2 (q, 1), probe (q, nprobe) parent ids, expanded (q, nprobe *
    max_sub) sub-list ids aligned with the probe's ranks)."""
    q2 = (queries * queries).sum(dim=1, keepdim=True)
    dc = sqdist(queries, centers, q2=q2)  # (q, nlist)
    _, probe = smallest_k(dc, nprobe)
    expanded = sub_table[probe].reshape(queries.shape[0], -1)
    return q2, probe, expanded


def _fold_step(run_d, run_i, d2, cid, kk: int):
    """The running (q, kk) top-k with one step's (q, cap) candidates
    appended; ties keep the earlier entry."""
    cat_d = torch.cat([run_d, d2], dim=1)
    cat_i = torch.cat([run_i, cid], dim=1)
    vals, pos = smallest_k(cat_d, kk)
    return vals, torch.gather(cat_i, 1, pos)


def _finish(dist, ids, k: int, kk: int):
    """Pad a (q, kk) result to k columns with (inf, -1), and mark every
    unreachable (inf) slot as id -1."""
    if kk < k:
        qn = dist.shape[0]
        dist = torch.cat([dist, dist.new_full((qn, k - kk), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((qn, k - kk), -1)], dim=1)
    return dist, torch.where(torch.isinf(dist), -1, ids)


def search_ivfflat(
    queries: torch.Tensor,  # (q, d)
    centers: torch.Tensor,  # (nlist, d) parent centroids
    buckets: torch.Tensor,  # (nsub, cap, d) sub-list vectors
    bucket_ids: torch.Tensor,  # (nsub, cap)
    bucket_valid: torch.Tensor,  # (nsub, cap)
    sub_table: torch.Tensor,  # (nlist, max_sub) sub-list ids, -1 pad
    nprobe: int,
    k: int,
    timer=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the nprobe nearest PARENT cells per query, expand each to its
    sub-lists, and fold ONE sub-list per step into a running top-k: peak
    memory is one (q, cap, d) gather.  The sub-list ids are front-packed
    in descending order, so the -1 padding sinks to the tail and the loop
    runs only the batch's live steps (one fetch of that count per call).
    Returns (sq_distances (q, k), ids (q, k), -1 = none).  `timer`, where
    given, has a `span(name)` context around "probe" and "fold"."""
    qn = queries.shape[0]
    cap = buckets.shape[1]
    with timer_span(timer, "probe"):
        q2, _, expanded = _probe(queries, centers, sub_table, nprobe)
        expanded = torch.sort(expanded, dim=1, descending=True).values
        n_live = int((expanded >= 0).sum(dim=1).max()) if qn else 0
    kk = min(k, expanded.shape[1] * cap)
    with timer_span(timer, "fold"):
        x2_all = row_norms(buckets.reshape(-1, buckets.shape[2])).reshape(buckets.shape[:2])
        run_d = queries.new_full((qn, kk), float("inf"))
        run_i = torch.full((qn, kk), -1, dtype=bucket_ids.dtype, device=queries.device)
        for r in range(n_live):
            lists = expanded[:, r]  # (q,) sub-list ids, may be -1
            safe = torch.clamp(lists, min=0)
            cv = (bucket_valid[safe] > 0) & (lists >= 0)[:, None]
            d2 = sqdist_gathered(queries, buckets[safe], q2[:, 0], x2_all[safe])
            d2 = torch.where(cv, d2, float("inf"))
            run_d, run_i = _fold_step(run_d, run_i, d2, bucket_ids[safe], kk)
    return _finish(run_d, run_i, k, kk)


def build_ivfpq(
    X: np.ndarray,
    nlist: int,
    M: int = 8,
    n_bits: int = 8,
    seed: int = 42,
    kmeans_iters: int = 20,
    centers: Optional[np.ndarray] = None,
    codebooks: Optional[np.ndarray] = None,
    device=None,
) -> IVFPQIndex:
    """IVF-PQ build: the IVF-Flat inverted file, then per subspace m a
    residual codebook (k-means on seed + m + 1, on the sample drawn with
    seed + 7) and every row's uint8 code.  `centers` and `codebooks`
    (M, ksub, d / M) replace the trainings."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    n, d = X.shape
    if d % M != 0:
        raise ValueError(f"feature dim {d} not divisible by pq M={M}")
    dsub = d // M
    ksub = min(2**n_bits, max(n // 4, 2))
    flat = build_ivfflat(X, nlist, seed=seed, kmeans_iters=kmeans_iters,
                         centers=centers, device=device)
    dev = resolve_device(device)
    t = time.perf_counter()
    nsub, cap = flat.bucket_ids.shape
    real = flat.bucket_valid.reshape(-1) > 0
    slot_ids = flat.bucket_ids.reshape(-1)[real]
    # each row's sub-list, then that sub-list's parent: residuals (and the
    # search's tables) are against the PARENT centre
    parent_of = np.zeros((nsub,), np.int64)
    live = flat.sub_table >= 0
    parent_of[flat.sub_table[live]] = np.nonzero(live)[0]
    row_parent = np.zeros((n,), np.int64)
    row_parent[slot_ids] = parent_of[np.repeat(np.arange(nsub), cap)[real]]
    resid = X - flat.centers[row_parent]
    t = _tick("residuals", t)
    tr = _train_sample(n, _quantizer_train_rows(n, ksub), seed + 7)
    if codebooks is None:
        codebooks = np.zeros((M, ksub, dsub), np.float32)
        for m in range(M):
            sub = torch.from_numpy(
                np.ascontiguousarray(resid[tr, m * dsub : (m + 1) * dsub])).to(dev)
            codebooks[m] = _train_kmeans_budgeted(sub, ksub, seed + m + 1,
                                                  kmeans_iters).cpu().numpy()
    else:
        codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
    t = _tick("codebooks", t)
    codes = np.zeros((n, M), np.uint8)
    for m in range(M):
        cb = torch.tensor(codebooks[m], device=dev)
        codes[:, m] = _assign_chunked(
            np.ascontiguousarray(resid[:, m * dsub : (m + 1) * dsub]), cb).astype(np.uint8)
    t = _tick("codes", t)
    bucket_codes = np.zeros((nsub, cap, M), np.uint8)
    bucket_codes.reshape(nsub * cap, M)[real] = codes[slot_ids]
    _tick("code_fill", t)
    return IVFPQIndex(flat.centers, codebooks, bucket_codes, flat.bucket_ids,
                      flat.bucket_valid, flat.sub_table)


def search_ivfpq(
    queries: torch.Tensor,  # (q, d)
    centers: torch.Tensor,  # (nlist, d) parent centroids
    codebooks: torch.Tensor,  # (M, ksub, dsub)
    codes: torch.Tensor,  # (nsub, cap, M) uint8
    bucket_ids: torch.Tensor,  # (nsub, cap)
    bucket_valid: torch.Tensor,  # (nsub, cap)
    sub_table: torch.Tensor,  # (nlist, max_sub)
    nprobe: int,
    k: int,
    timer=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC search: per (query, probed parent) lookup tables over the
    residual codebooks, computed once, summed across subspaces per
    candidate code.  Probes parent cells and folds ONE sub-list per step,
    as `search_ivfflat`; each step indexes its parent's tables by the
    parent's probe rank, carried through the front-packing permutation.
    `timer` spans "probe" (the tables included) and "fold"."""
    M, ksub, dsub = codebooks.shape
    qn, d = queries.shape
    max_sub = sub_table.shape[1]
    cap = codes.shape[1]
    with timer_span(timer, "probe"):
        _, probe, expanded = _probe(queries, centers, sub_table, nprobe)
        ranks = torch.arange(nprobe, device=queries.device).repeat_interleave(max_sub)
        expanded, ordr = torch.sort(expanded, dim=1, descending=True, stable=True)
        ranks = ranks[ordr]  # (q, nprobe * max_sub)
        n_live = int((expanded >= 0).sum(dim=1).max()) if qn else 0
        # ||r_m - c_{m,j}||^2 for each probed parent, subspace m and code j
        resid = (queries[:, None, :] - centers[probe]).reshape(qn, nprobe, M, dsub)
        with matmul_precision():
            dot = torch.einsum("qpmd,mjd->qpmj", resid, codebooks)
        r2 = (resid * resid).sum(dim=3, keepdim=True)
        cb2 = (codebooks * codebooks).sum(dim=2)  # (M, ksub)
        luts = (r2 + cb2[None, None]) - 2.0 * dot  # (q, nprobe, M, ksub)
        luts = luts.reshape(qn, nprobe, M * ksub)
    kk = min(k, expanded.shape[1] * cap)
    with timer_span(timer, "fold"):
        code_base = torch.arange(M, device=queries.device) * ksub
        rows = torch.arange(qn, device=queries.device)
        run_d = queries.new_full((qn, kk), float("inf"))
        run_i = torch.full((qn, kk), -1, dtype=bucket_ids.dtype, device=queries.device)
        for r in range(n_live):
            lists = expanded[:, r]
            safe = torch.clamp(lists, min=0)
            lut = luts[rows, ranks[:, r]]  # (q, M * ksub)
            slot = codes[safe].to(torch.int64) + code_base  # (q, cap, M)
            d2 = torch.gather(lut, 1, slot.reshape(qn, cap * M)).reshape(qn, cap, M).sum(dim=2)
            cv = (bucket_valid[safe] > 0) & (lists >= 0)[:, None]
            d2 = torch.where(cv, torch.clamp(d2, min=0.0), float("inf"))
            run_d, run_i = _fold_step(run_d, run_i, d2, bucket_ids[safe], kk)
    return _finish(run_d, run_i, k, kk)
