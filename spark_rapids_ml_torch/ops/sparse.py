#
# Sparse rows in ELL form: the port of spark_rapids_ml_tpu/ops/sparse.py.
# Every row is padded to K = the largest nnz of a row, giving (N, K) value
# and int32 column-id tensors; a padding entry is (0.0, column 0), a no-op
# in every operation below.
#
#   X @ beta      gather beta[cols] and sum over K (`ell_matvec`,
#                 `ell_matmat`), in row tiles whose size does not change a
#                 row's result, in the wider of the two types (float32
#                 rows times float64 coefficients sum in float64)
#   X^T r         the gradient.  The JAX package gets it from autodiff as a
#                 scatter-add; on a card `index_add_` adds with atomics in
#                 another order every run, so neither two fits nor a resumed
#                 and an uninterrupted fit would be bit-equal.  Here it is
#                 written out without atomics: once per fit the nonzero
#                 entries are sorted by column, stably (`ell_column_layout`),
#                 and each product is summed per column by
#                 `torch.segment_reduce` over the fixed segment lengths, in
#                 float64 whatever the rows' dtype: a popular column holds
#                 millions of entries, and a float32 sum of them loses
#                 enough digits that a float32 L-BFGS stops early (at
#                 10,000,000 x 2^18 rows it stopped after 28
#                 iterations, 6.6e-5 above the float64 fit; with float64
#                 sums it takes the float64 fit's 40 and ends 8.5e-9 from
#                 it on an H100; PERF.md)
#   moments       the same per-column segment sums (`ell_weighted_moments`),
#                 in float64
#
# `ell_from_csr` is the JAX package's host conversion, unchanged.
#
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# bytes of the (rows, K, C) gather tile of the products over X
_TILE_BYTES = 256 << 20


def ell_from_csr(csr) -> Tuple[np.ndarray, np.ndarray]:
    """Host CSR -> ELL: (values (n, K) float, cols (n, K) int32), padded
    with (0.0, col 0) entries, which are no-ops in every operation."""
    csr = csr.tocsr()
    if not csr.has_canonical_format:
        csr.sum_duplicates()
    n = csr.shape[0]
    lengths = np.diff(csr.indptr)
    K = max(int(lengths.max()) if n else 1, 1)
    vals = np.zeros((n, K), csr.data.dtype)
    cols = np.zeros((n, K), np.int32)
    mask = np.arange(K)[None, :] < lengths[:, None]
    vals[mask] = csr.data
    cols[mask] = csr.indices.astype(np.int32)
    return vals, cols


def tile_rows(K: int, C: int, itemsize: int, tile: Optional[int] = None) -> int:
    """Rows of one gather tile: `tile` when given, else a tile of
    `_TILE_BYTES`."""
    if tile is not None:
        return max(1, int(tile))
    return max(1, _TILE_BYTES // max(K * C * itemsize, 1))


def ell_matvec(vals: torch.Tensor, cols: torch.Tensor, beta: torch.Tensor,
               tile: Optional[int] = None) -> torch.Tensor:
    """(N,) margins: sum_k vals[i, k] * beta[cols[i, k]], a row tile at a
    time, in the wider of the two types; each row's sum is taken the same
    way whatever the tile."""
    N, K = vals.shape
    out = torch.empty(N, dtype=torch.promote_types(vals.dtype, beta.dtype), device=vals.device)
    rows = tile_rows(K, 1, out.element_size(), tile)
    for lo in range(0, N, rows):
        hi = min(lo + rows, N)
        g = torch.index_select(beta, 0, cols[lo:hi].reshape(-1)).reshape(hi - lo, K)
        torch.sum(vals[lo:hi] * g, dim=1, out=out[lo:hi])
    return out


def ell_matmat(vals: torch.Tensor, cols: torch.Tensor, W: torch.Tensor,
               tile: Optional[int] = None) -> torch.Tensor:
    """(N, C) margins for W (C, d): gather rows of W^T, a row tile at a
    time, each (tile, K, C) product summed over K in the wider of the two
    types."""
    N, K = vals.shape
    C = W.shape[0]
    Wt = W.T.contiguous()
    out = torch.empty((N, C), dtype=torch.promote_types(vals.dtype, W.dtype), device=vals.device)
    rows = tile_rows(K, C, out.element_size(), tile)
    for lo in range(0, N, rows):
        hi = min(lo + rows, N)
        g = torch.index_select(Wt, 0, cols[lo:hi].reshape(-1)).reshape(hi - lo, K, C)
        torch.sum(vals[lo:hi].unsqueeze(2) * g, dim=1, out=out[lo:hi])
    return out


@dataclass
class EllColumns:
    """The nonzero ELL entries sorted by column, stably (so within a column
    in row-major order): `entries` their flat positions in the (N, K)
    tensors (int64), `rows` their rows (int32), `lengths` (d,) the entries
    of each column (int64).  Built once per fit."""

    entries: torch.Tensor
    rows: torch.Tensor
    lengths: torch.Tensor

    def gather(self, vals: torch.Tensor) -> torch.Tensor:
        """The values of the sorted entries, from (N, K) `vals`."""
        return vals.reshape(-1)[self.entries]

    def column_sums(self, data: torch.Tensor) -> torch.Tensor:
        """(d,) sums of `data` (one value per sorted entry) per column, in a
        fixed order (no atomics), accumulated in float64 and returned in
        `data`'s dtype."""
        sums = torch.segment_reduce(data.to(torch.float64), "sum", lengths=self.lengths,
                                    unsafe=True)
        return sums.to(data.dtype)


def ell_column_layout(vals: torch.Tensor, cols: torch.Tensor, d: int) -> EllColumns:
    """The column-sorted layout of the entries of `vals` that are not 0
    (padding and explicit zeros add nothing to any column sum)."""
    K = vals.shape[1]
    nz = torch.nonzero(vals.reshape(-1)).squeeze(1)
    keys = cols.reshape(-1)[nz]
    keys, order = torch.sort(keys, stable=True)
    entries = nz[order]
    del nz, order
    lengths = torch.bincount(keys, minlength=d)
    if lengths.numel() > d:
        raise ValueError(f"ELL column id {lengths.numel() - 1} beyond the {d} columns")
    rows = torch.div(entries, K, rounding_mode="floor").to(torch.int32)
    return EllColumns(entries=entries, rows=rows, lengths=lengths)


def ell_rmatvec(layout: EllColumns, sorted_vals: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(d,) X^T r for r (N,): per column, the sum of value * r[row] over
    its sorted entries."""
    return layout.column_sums(sorted_vals * torch.index_select(r, 0, layout.rows))


def ell_rmatmat(layout: EllColumns, sorted_vals: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(C, d) R^T X for R (N, C), one column of R at a time."""
    Rt = R.T.contiguous()
    return torch.stack([ell_rmatvec(layout, sorted_vals, Rt[c]) for c in range(Rt.shape[0])])


def ell_weighted_moments(vals: torch.Tensor, cols: torch.Tensor, w: torch.Tensor, d: int,
                         layout: Optional[EllColumns] = None):
    """Per-column weighted (mean, std) over the sparse rows, exact: the
    implicit zeros add nothing to either sum.  ddof 1 and the zero-std
    guard of ops/stats.py `weighted_moments`.  In float64 whatever the
    rows' type, so float32 rows give the float64 rows' moments."""
    if layout is None:
        layout = ell_column_layout(vals, cols, d)
    w = w.to(torch.float64)
    wsum = w.sum()
    sv = layout.gather(vals).to(torch.float64)
    wv = sv * torch.index_select(w, 0, layout.rows)
    s1 = layout.column_sums(wv)
    s2 = layout.column_sums(wv * sv)
    mean = s1 / wsum
    ssq = torch.clamp_min(s2 - wsum * mean * mean, 0.0)
    std = torch.sqrt(ssq / torch.clamp_min(wsum - 1.0, 1.0))
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return mean, std


def ell_scale_columns(vals: torch.Tensor, cols: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """vals[i, k] * scale[cols[i, k]]: std-only standardization (no
    centring, so the rows stay sparse)."""
    return vals * torch.index_select(scale, 0, cols.reshape(-1)).reshape(vals.shape)
